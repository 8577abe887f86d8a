"""Guards of the port: it imports no JAX and nothing of the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "weaklysuperviseddl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "weaklysuperviseddl_tpu")
# the foundation models are the port's own: no Hugging Face library either
FORBIDDEN_HF = ("transformers", "safetensors", "tokenizers")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert PORT / "pipelines" / "foundation.py" in files
    bad = [(f.relative_to(ROOT), mod) for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN + FORBIDDEN_HF]
    assert not bad, bad


def test_guard_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom weaklysuperviseddl_tpu.ops import resize\n"
                 "from weaklysuperviseddl_tpu_torch.ops import cc\nimport flax\n")
    mods = [m for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN]
    assert mods == ["jax.numpy", "weaklysuperviseddl_tpu.ops", "flax"]
    f.write_text("from transformers import SamModel\nimport safetensors.torch\n"
                 "import tokenizers\nimport torch\n")
    mods = [m for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN_HF]
    assert mods == ["transformers", "safetensors.torch", "tokenizers"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_there_is_no_card(no_cuda):
    from weaklysuperviseddl_tpu_torch import resolve_device
    from weaklysuperviseddl_tpu_torch.cli import main
    from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
    from weaklysuperviseddl_tpu_torch.pipelines.serve import Predictor

    model = DeepLabV3(2, 18, 0.25)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model, size=32)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["serve", "--smoke"])
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert Predictor(model, size=32, device="cpu").device == torch.device("cpu")


def test_foundation_entry_points_without_device_raise_when_there_is_no_card(no_cuda):
    from weaklysuperviseddl_tpu_torch.cli import main
    from weaklysuperviseddl_tpu_torch.models.foundation_config import (
        tiny_gdino_config,
        tiny_sam_config,
    )
    from weaklysuperviseddl_tpu_torch.pipelines.foundation import (
        FoundationPipeline,
        hf_detector,
        hf_segmenter,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        hf_segmenter(config=tiny_sam_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hf_detector(config=tiny_gdino_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoundationPipeline()
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["foundation", "--num-images", "1"])
    assert hf_segmenter(config=tiny_sam_config(), device="cpu").device == torch.device("cpu")


def test_training_entry_points_without_device_raise_when_there_is_no_card(no_cuda):
    from weaklysuperviseddl_tpu_torch.cli import main
    from weaklysuperviseddl_tpu_torch.config import smoke_config
    from weaklysuperviseddl_tpu_torch.pipelines.weakly import (
        run_weakly_supervised,
        run_weakly_supervised_alternating,
    )

    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["weakly", "--alternating", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_weakly_supervised_alternating(smoke_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_weakly_supervised(smoke_config())


def test_kernel_wrapper_rejects_cpu_tensors():
    from weaklysuperviseddl_tpu_torch.ops.cc import label_components_cuda
    from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda

    before = label_components_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        label_components_cuda(torch.zeros((1, 4, 4), dtype=torch.uint8))
    assert label_components_cuda.launches == before
    before = refine_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        refine_cuda(torch.zeros((1, 4, 4, 2)), torch.zeros((1, 4, 4, 3)),
                    torch.zeros((1, 4, 4), dtype=torch.int32))
    assert refine_cuda.launches == before


def test_crf_and_cam_fusion_kernel_wrappers_reject_cpu_tensors():
    from weaklysuperviseddl_tpu_torch.ops.bilateral import gaussian_filter_cuda
    from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion_cuda

    before = gaussian_filter_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        gaussian_filter_cuda(torch.zeros((1, 6, 5)), torch.zeros((1, 4, 5)), torch.zeros((1, 4, 2)))
    assert gaussian_filter_cuda.launches == before
    before = cam_fusion_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        cam_fusion_cuda(torch.zeros((1, 8, 3, 3)), torch.zeros((1, 8, 3, 3)))
    assert cam_fusion_cuda.launches == before
