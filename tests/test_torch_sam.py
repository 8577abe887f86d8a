"""The port's SAM (``models/sam``, ``data/foundation_preprocess.sam_preprocess``,
``pipelines/foundation.hf_segmenter``) against the JAX package's
``hf_segmenter``, which runs ``transformers``' SamModel and SamProcessor.

JAX's backend is built as the JAX package builds it, at its tiny config after
``torch.manual_seed``; its model's state dict crosses into the port through
``models/foundation_import.py`` as numpy arrays. The same seeded images and
boxes go through both packages' functions."""

import inspect
import json

import numpy as np
import pytest
import torch
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.pipelines import foundation as JF
from weaklysuperviseddl_tpu_torch.models import foundation_config as C
from weaklysuperviseddl_tpu_torch.models import foundation_import
from weaklysuperviseddl_tpu_torch.models.safetensors_io import read_safetensors
from weaklysuperviseddl_tpu_torch.models.sam import SamModel
from weaklysuperviseddl_tpu_torch.pipelines import foundation as PF

pytestmark = pytest.mark.usefixtures("single_torch_thread")

# (H, W) of the input images: grown to 256, shrunk to 256, not square either way
SHAPES = [(64, 64), (300, 420), (90, 70), (256, 256)]


def _numpy_state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    """(JAX's segment function, its SamModel, its SamProcessor, the port's
    segmenter on the same weights)."""
    torch.manual_seed(3)
    jseg = JF.hf_segmenter(config=JF.tiny_sam_config())
    names = inspect.getclosurevars(jseg).nonlocals
    seg = PF.hf_segmenter(config=C.SamConfig.from_dict(JF.tiny_sam_config().to_dict()),
                          device="cpu")
    foundation_import.load_weights(seg.model, _numpy_state(names["model"]))
    return jseg, names["model"], names["processor"], seg


def _case(seed: int, shape):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    H, W = shape
    x0 = rng.uniform(0, W / 2, 3)
    y0 = rng.uniform(0, H / 2, 3)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, W / 2, 3), y0 + rng.uniform(2, H / 2, 3)],
                     1).astype(np.float32)
    return img, boxes


@pytest.mark.parametrize("shape", SHAPES)
def test_sam_processor_matches_transformers(pair, shape):
    """pixel_values and the rescaled float64 boxes equal SamProcessor's, to the bit."""
    from PIL import Image

    _, _, processor, seg = pair
    img, boxes = _case(sum(shape), shape)
    want = processor(Image.fromarray(img), input_boxes=[[list(b) for b in boxes]],
                     return_tensors="pt")
    pixel_values, input_boxes = seg.preprocess(img, boxes)
    assert pixel_values.dtype == want["pixel_values"].dtype
    assert torch.equal(pixel_values, want["pixel_values"])
    assert input_boxes.dtype == torch.float64
    assert torch.equal(input_boxes, want["input_boxes"])


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_sam_outputs_match_jax(pair, shape):
    """JAX's ``segment`` (the first box's three masks) and every box's raw
    logits and IoU predictions, within 1e-5 of the largest value."""
    jseg, jmodel, processor, seg = pair
    img, boxes = _case(7 + shape[0], shape)
    want = jseg(img, boxes)
    got = seg(img, boxes)
    assert got.shape == want.shape == (3, 64, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    from PIL import Image

    inputs = processor(Image.fromarray(img), input_boxes=[[list(b) for b in boxes]],
                       return_tensors="pt")
    with torch.no_grad():
        ref = jmodel(**inputs)
    iou, masks = seg.raw(img, boxes)
    assert masks.shape == ref.pred_masks.shape == (1, 3, 3, 64, 64)
    scale = ref.pred_masks.abs().max()
    assert (masks - ref.pred_masks).abs().max() <= 1e-5 * scale
    assert (iou - ref.iou_scores).abs().max() <= 1e-5 * ref.iou_scores.abs().max()


def test_sam_save_pretrained_round_trip(pair, tmp_path):
    """JAX's model through ``save_pretrained``, the port's safetensors reader
    and the bridge: every tensor equal to the bit, the tied Fourier matrix
    restored, the same outputs; strict checks name the key at fault."""
    jseg, jmodel, _, _ = pair
    jmodel.save_pretrained(tmp_path)
    state = read_safetensors(str(tmp_path / "model.safetensors"))
    want = jmodel.state_dict()
    tied = "prompt_encoder.shared_embedding.positional_embedding"
    assert tied not in state  # written once
    with open(tmp_path / "config.json") as f:
        config = C.SamConfig.from_dict(json.load(f))
    model = foundation_import.load_weights(SamModel(config).eval(), state)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert torch.equal(model.prompt_encoder.shared_embedding.positional_embedding,
                       model.shared_image_embedding.positional_embedding)
    img, boxes = _case(11, (90, 70))
    seg = PF.SamSegmenter(model, config.vision_config.image_size, torch.device("cpu"))
    np.testing.assert_array_equal(seg(img, boxes), PF.SamSegmenter(
        pair[3].model, 256, torch.device("cpu"))(img, boxes))

    bad = dict(state)
    del bad["mask_decoder.iou_token.weight"]
    with pytest.raises(ValueError, match="mask_decoder.iou_token.weight"):
        foundation_import.port_state_dict(model, bad)
    bad = dict(state, **{"vision_encoder.pos_embed": torch.zeros(1, 8, 8, 768)})
    with pytest.raises(ValueError, match="vision_encoder.pos_embed.*shape"):
        foundation_import.port_state_dict(model, bad)
    bad = dict(state, **{"mask_decoder.iou_token.weight":
                         state["mask_decoder.iou_token.weight"].double()})
    with pytest.raises(ValueError, match="iou_token.weight.*dtype"):
        foundation_import.port_state_dict(model, bad)
    with pytest.raises(ValueError, match="extra.key"):
        foundation_import.port_state_dict(model, dict(state, **{"extra.key": torch.zeros(1)}))


def test_sam_vit_base_layout_matches_transformers():
    """sam_vit_base()'s state-dict keys and shapes equal SamModel(SamConfig())'s
    (facebook/sam-vit-base), both built on the meta device."""
    from transformers import SamConfig, SamModel as HFSamModel

    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in HFSamModel(SamConfig()).state_dict().items()}
        got = {k: tuple(v.shape) for k, v in SamModel(C.sam_vit_base()).state_dict().items()}
    assert got == want
    assert got["vision_encoder.pos_embed"] == (1, 64, 64, 768)
    assert len([k for k in got if k.endswith("attn.rel_pos_h")]) == 12
    assert got["vision_encoder.layers.2.attn.rel_pos_h"] == (127, 64)  # global: 2·64 − 1
    assert got["vision_encoder.layers.0.attn.rel_pos_h"] == (27, 64)  # window 14
