"""The port's foundation baseline (``pipelines/foundation.py``,
``compat/two_stage_foundation.py``, the ``foundation`` command) against the
JAX package's, on the same models: JAX's backends built as the JAX package
builds them (tiny configs after ``torch.manual_seed``), their state dicts
bridged into the port through ``models/foundation_import.py``.

At random weights SAM's logits stay near 0 and the 0.5 threshold leaves
every mask empty, so the fixture scales the hypernetwork MLPs' output layer
by the same factor in both packages' SAM: the masks then hold both values
and the pipelines' masks, IoU and accuracy are compared on real masks."""

import inspect
import os
import re

import numpy as np
import pytest
import torch
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.compat import two_stage_foundation as JT
from weaklysuperviseddl_tpu.data import download_data as jax_download_data
from weaklysuperviseddl_tpu.pipelines import foundation as JF
from weaklysuperviseddl_tpu_torch import cli
from weaklysuperviseddl_tpu_torch.compat import two_stage_foundation as PT
from weaklysuperviseddl_tpu_torch.data.dataset import download_data
from weaklysuperviseddl_tpu_torch.models import foundation_config as C
from weaklysuperviseddl_tpu_torch.models import foundation_import
from weaklysuperviseddl_tpu_torch.pipelines import foundation as PF

pytestmark = pytest.mark.usefixtures("single_torch_thread")

MASK_GAIN = 300.0


def _state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def backends():
    """(JAX's detect and segment functions, their models, the port's detector
    and segmenter on the same weights)."""
    torch.manual_seed(11)
    jdet = JF.hf_detector(config=JF.tiny_gdino_config())
    jseg = JF.hf_segmenter(config=JF.tiny_sam_config())
    jdm = inspect.getclosurevars(jdet).nonlocals["model"]
    jsm = inspect.getclosurevars(jseg).nonlocals["model"]
    with torch.no_grad():
        for mlp in jsm.mask_decoder.output_hypernetworks_mlps:
            mlp.proj_out.weight.mul_(MASK_GAIN)
    det = PF.hf_detector(config=C.GroundingDinoConfig.from_dict(JF.tiny_gdino_config().to_dict()),
                         device="cpu")
    seg = PF.hf_segmenter(config=C.SamConfig.from_dict(JF.tiny_sam_config().to_dict()),
                          device="cpu")
    foundation_import.load_weights(det.model, _state(jdm))
    foundation_import.load_weights(seg.model, _state(jsm))
    return jdet, jseg, jdm, jsm, det, seg


def _png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def test_pipeline_and_evaluation_match_jax(backends, tmp_path):
    """``run_segmentation_pipeline`` gives JAX's masks on seeded images, and
    ``evaluate_pipeline_on_dataset`` on 4 synthetic pets JAX's IoU, accuracy,
    log lines and files (the mask PNGs equal)."""
    jdet, jseg, _, _, det, seg = backends
    jpipe = JF.FoundationPipeline(detector=jdet, segmenter=jseg, output_size=224)
    pipe = PF.FoundationPipeline(detector=det, segmenter=seg, output_size=224)
    rng = np.random.default_rng(2)
    fractions = []
    for shape in [(64, 64), (224, 224), (97, 150)]:
        img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        want = jpipe.run_segmentation_pipeline(img)
        got = pipe.run_segmentation_pipeline(img)
        assert got.dtype == want.dtype == np.uint8 and got.shape == (224, 224)
        np.testing.assert_array_equal(got, want)
        fractions.append(got.mean())
    assert 0.02 < np.mean(fractions) < 0.98, fractions  # the masks are not trivial

    jlog, log = [], []
    want = JF.evaluate_pipeline_on_dataset(
        jax_download_data(None, split="test", synthetic_size=4), jpipe, num_images=4,
        save_dir=str(tmp_path / "jax"), log=jlog.append)
    got = PF.evaluate_pipeline_on_dataset(
        download_data(None, split="test", synthetic_size=4), pipe, num_images=4,
        save_dir=str(tmp_path / "port"), log=log.append)
    assert got == want and 0 < got[0] < 1
    assert log == jlog
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    assert len([f for f in files if f.startswith("mask_")]) == 4
    for f in files:
        if f.startswith("mask_"):
            np.testing.assert_array_equal(_png(tmp_path / "port" / f), _png(tmp_path / "jax" / f))


def boxfill_segmenter(image, boxes):
    """Stub SAM: fills each box (tests/test_aux.py)."""
    arr = np.asarray(image)
    masks = np.zeros((len(boxes), *arr.shape[:2]), np.float32)
    for i, (x0, y0, x1, y1) in enumerate(boxes):
        masks[i, int(y0):int(y1) + 1, int(x0):int(x1) + 1] = 1.0
    return masks


def ellipse_detector(image, prompts):
    """Stub GroundingDINO: a box around the pixels far from the median colour."""
    arr = np.asarray(image).astype(np.float32)
    med = np.median(arr.reshape(-1, 3), axis=0)
    fg = np.linalg.norm(arr - med, axis=-1) > 60
    if fg.sum() < 10:
        return np.zeros((0, 4))
    ys, xs = np.where(fg)
    return np.array([[xs.min(), ys.min(), xs.max(), ys.max()]], np.float32)


def test_stub_backends_and_no_detection_match_jax(tmp_path):
    """The JAX package's stub-backend and no-detection cases
    (tests/test_aux.py) in both packages, with their helpers."""
    results = []
    for mod, data, name in ((JF, jax_download_data, "jax"), (PF, download_data, "port")):
        ds = data(None, split="test", synthetic_size=4, image_size=64)
        pipe = mod.FoundationPipeline(detector=ellipse_detector, segmenter=boxfill_segmenter,
                                      output_size=64)
        logs = []
        out = mod.evaluate_pipeline_on_dataset(ds, pipe, num_images=4, save_outputs=True,
                                               save_dir=str(tmp_path / name), log=logs.append)
        assert out[0] > 0.4 and any("Final Evaluation" in s for s in logs)
        names = sorted(os.listdir(tmp_path / name))
        assert len([f for f in names if f.startswith("mask_")]) == 4
        assert len([f for f in names if f.startswith("viz_")]) == 4
        none = mod.FoundationPipeline(detector=lambda img, p: np.zeros((0, 4)),
                                      segmenter=boxfill_segmenter, output_size=32)
        assert none.run_segmentation_pipeline(np.zeros((32, 32, 3), np.uint8)) is None
        results.append((out, logs, names))
    assert results[0] == results[1]
    for mask in sorted(f for f in results[0][2] if f.startswith("mask_")):
        np.testing.assert_array_equal(_png(tmp_path / "port" / mask),
                                      _png(tmp_path / "jax" / mask))
    three = np.stack([np.eye(4), np.zeros((4, 4)), np.zeros((4, 4))])
    np.testing.assert_array_equal(PF.convert_3channel_to_mask(three),
                                  JF.convert_3channel_to_mask(three))
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 2, (2, 8, 8))
    for pair in ((a, b), (np.zeros((4, 4)), np.zeros((4, 4))), (np.ones((4, 4)), np.ones((4, 4)))):
        assert PF.calculate_iou_and_accuracy(*pair) == JF.calculate_iou_and_accuracy(*pair)


def _snapshot(root, name: str, model, extra: dict[str, str]):
    org, model_name = name.split("/")
    repo = root / f"models--{org}--{model_name}"
    snap = repo / "snapshots" / "0123abc"
    model.save_pretrained(snap)
    for fname, text in extra.items():
        (snap / fname).write_text(text)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123abc\n")


def test_foundation_command_and_hub_names(backends, tmp_path, monkeypatch):
    """The hub names with an empty cache raise, naming the path; the
    ``foundation`` command on a local cache of the tiny snapshots gives the
    IoU of JAX's ``evaluate_pipeline_on_dataset`` on the same models; the
    compat module keeps JAX's names."""
    jdet, jseg, jdm, jsm, _, _ = backends
    for jmod, mod in ((JT, PT), (JF, PF)):
        public = {n for n in vars(jmod) if not n.startswith("_") and n != "annotations"
                  and getattr(getattr(jmod, n), "__module__", jmod.__name__).startswith(
                      "weaklysuperviseddl_tpu.")}
        assert public and public <= set(vars(mod)), public - set(vars(mod))
        for name in public:
            if callable(getattr(jmod, name)):
                want = list(inspect.signature(getattr(jmod, name)).parameters)
                got = list(inspect.signature(getattr(mod, name)).parameters)
                # the port's builders also take the device (and the draw of random weights)
                assert got[:len(want)] == want, name
                assert set(got[len(want):]) <= {"device", "generator"}, name
    assert PT.DEFAULT_PROMPTS == JT.DEFAULT_PROMPTS == PF.DEFAULT_PROMPTS

    cache = tmp_path / "hub"
    cache.mkdir()
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(cache / "models--facebook--sam-vit-base" / "refs" / "main"))):
        PF.hf_segmenter(device="cpu")
    with pytest.raises(FileNotFoundError, match="models--IDEA-Research--grounding-dino-base"):
        PF.hf_detector(device="cpu")

    _snapshot(cache, "facebook/sam-vit-base", jsm, {})
    _snapshot(cache, "IDEA-Research/grounding-dino-base", jdm, {
        "vocab.txt": "\n".join(JF.tiny_gdino_vocab()),
        "preprocessor_config.json": '{"size": {"shortest_edge": 224, "longest_edge": 224}}'})
    seen = []

    def recording(*args, **kwargs):
        seen.append(PF_evaluate(*args, **kwargs))
        return seen[-1]

    PF_evaluate = PF.evaluate_pipeline_on_dataset
    monkeypatch.setattr(PF, "evaluate_pipeline_on_dataset", recording)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["foundation", "--num-images", "3", "--device", "cpu"]) == 0
    want = JF.evaluate_pipeline_on_dataset(
        jax_download_data(None, split="test", synthetic_size=3),
        JF.FoundationPipeline(detector=jdet, segmenter=jseg), num_images=3,
        save_outputs=False, log=lambda s: None)
    assert seen == [want]
    assert len([f for f in os.listdir(tmp_path / "pseudo_masks") if f.startswith("mask_")]) == 3

