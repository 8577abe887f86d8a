"""The port's ``parity`` command (``scripts/parity_harness_torch.py``) on the
CPU: narrow ``.pth`` files written from the port's own ``state_dict()``s in
torchvision's key layout (a ResNet-18 CAM classifier at width 0.25, a
DeepLabV3-ResNet50 at width 0.125), run through the CLI against the goldens
of ``tests/torch_ref.py``. Matching weights PASS, a missing file SKIPs, and a
weight changed on the port's side only FAILs: a harness that compared a model
with itself would pass that too."""

import os
import re
import subprocess
import sys

import pytest
import torch
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu_torch import cli
from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.resnet import init_weights

pytestmark = pytest.mark.usefixtures("single_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(REPO, "scripts", "parity_harness_torch.py")


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """classifier_weights_narrow.pth and deeplabv3_narrow.pth from seeded
    port models; no basnet.pth."""
    root = tmp_path_factory.mktemp("weights")
    classifier = init_weights(CamClassifier(37, 18, 0.25), torch.Generator().manual_seed(0))
    torch.save(classifier.state_dict(), root / "classifier_weights_narrow.pth")
    deeplab = init_weights(DeepLabV3(2, 50, 0.125), torch.Generator().manual_seed(1))
    torch.save(deeplab.state_dict(), root / "deeplabv3_narrow.pth")
    return root


@pytest.fixture(scope="module")
def harness():
    """The harness script's globals (what the CLI runs)."""
    import runpy

    return runpy.run_path(HARNESS, run_name="parity_harness_torch")


def _verdicts(text: str) -> list[str]:
    return re.findall(r"\((PASS|FAIL|INDETERMINATE)", text)


def test_parity_command_passes_on_matching_weights(weights_dir, tmp_path):
    out = tmp_path / "PARITY.md"
    proc = subprocess.run(
        [sys.executable, "-m", "weaklysuperviseddl_tpu_torch", "parity", "--weights-dir",
         str(weights_dir), "--device", "cpu", "--num-images", "2", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})  # one thread, as the in-process tests
    assert proc.returncode == 0, proc.stderr
    text = out.read_text()
    assert "## Classifier + LayerCAM" in text and "## DeepLabV3" in text
    assert re.search(r"- logits max-abs-diff over 2 images: \S+ \(PASS\)", text)
    assert re.search(r"- LayerCAM mean-abs-diff: \S+ \(max \S+\) \(PASS\)", text)
    assert re.search(r"- argmax-prediction agreement: \S+ \(PASS\)", text)
    assert _verdicts(text) == ["PASS"] * 4, text
    assert "## BASNet saliency\n- SKIP: no basnet.pth in weights dir" in text
    assert f"wrote {out}" in proc.stdout


def test_parity_reports_fail_on_a_weight_changed_on_one_side(harness, weights_dir, tmp_path,
                                                              monkeypatch):
    """The port's side loads a copy with one bias moved by 0.5, the golden
    the file as it is: each logits line FAILs. The classifier file uses the
    reference's stem names (``layer0.0``/``layer0.1``), which the harness
    maps to torchvision's for both sides."""
    state = torch.load(weights_dir / "classifier_weights_narrow.pth", weights_only=True)
    reference = {re.sub(r"^bn1\.", "layer0.1.", re.sub(r"^conv1\.", "layer0.0.", k)): v
                 for k, v in state.items()}
    planted_dir = tmp_path / "weights"
    planted_dir.mkdir()
    torch.save(reference, planted_dir / "classifier_weights_reference.pth")
    os.symlink(weights_dir / "deeplabv3_narrow.pth", planted_dir / "deeplabv3_narrow.pth")
    builders = {"port_classifier": ("fc.bias", harness["port_classifier"]),
                "port_deeplab": ("classifier.4.bias", harness["port_deeplab"])}

    def planted(name):
        key, build = builders[name]

        def port_side(state, device):
            state = dict(state)
            state[key] = state[key].clone()
            state[key][0] += 0.5
            return build(state, device)
        return port_side

    out = tmp_path / "PARITY.md"
    main = harness["main"]
    for name in builders:
        monkeypatch.setitem(main.__globals__, name, planted(name))
    assert main(["--weights-dir", str(planted_dir), "--device", "cpu", "--num-images", "2",
                 "--out", str(out)]) == 0
    text = out.read_text()
    assert re.search(r"- logits max-abs-diff over 2 images: 5\.00e-01 \(FAIL\)", text), text
    assert len(re.findall(r"logits max-abs-diff over 2 images: \S+ \(FAIL\)", text)) == 2


def test_parity_without_the_harness_script_returns_2(monkeypatch, capsys):
    exists = os.path.exists
    monkeypatch.setattr(cli.os.path, "exists",
                        lambda p: False if str(p).endswith("parity_harness_torch.py")
                        else exists(p))
    assert cli.main(["parity", "--weights-dir", "nowhere"]) == 2
    assert "requires a source checkout" in capsys.readouterr().err


@pytest.mark.parametrize("model,depth,width", [("classifier", 18, 0.25), ("classifier", 34, 0.5),
                                               ("deeplab", 50, 0.125), ("deeplab", 50, 1.0)])
def test_depth_and_width_come_from_the_state_dict(harness, model, depth, width):
    """The harness builds both sides from the file alone."""
    if model == "classifier":
        state, prefix = CamClassifier(37, depth, width).state_dict(), ""
    else:
        state, prefix = DeepLabV3(2, depth, width).state_dict(), "backbone."
    assert harness["resnet_shape"](state, prefix) == (depth, width)
