"""The port's GroundingDINO (``models/gdino``, ``data/foundation_preprocess.
gdino_preprocess``, ``data/wordpiece.py``, ``pipelines/foundation.hf_detector``)
against the JAX package's ``hf_detector``, which runs ``transformers``'
GroundingDinoForObjectDetection and GroundingDinoProcessor.

JAX's backend is built as the JAX package builds it, at its tiny config after
``torch.manual_seed``; its state dict crosses into the port through
``models/foundation_import.py`` as numpy arrays. The same seeded images go
through both packages' functions with the reference's prompts."""

import inspect
import json

import numpy as np
import pytest
import torch
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.pipelines import foundation as JF
from weaklysuperviseddl_tpu_torch.data.wordpiece import WordPieceTokenizer
from weaklysuperviseddl_tpu_torch.models import foundation_config as C
from weaklysuperviseddl_tpu_torch.models import foundation_import
from weaklysuperviseddl_tpu_torch.models.gdino import GroundingDinoForObjectDetection
from weaklysuperviseddl_tpu_torch.models.gdino.bert import SPECIAL_TOKENS, phrase_masks
from weaklysuperviseddl_tpu_torch.models.safetensors_io import (
    read_safetensors,
    write_safetensors,
)
from weaklysuperviseddl_tpu_torch.pipelines import foundation as PF

pytestmark = pytest.mark.usefixtures("single_torch_thread")

# (H, W): grown to 224, shrunk, not square either way (the tiny processor's
# shortest and longest edge are both 224)
SHAPES = [(64, 64), (300, 420), (90, 70), (224, 224)]


@pytest.fixture(scope="module")
def pair():
    """(JAX's detect function, its model, its processor, the port's detector
    on the same weights)."""
    torch.manual_seed(5)
    jdet = JF.hf_detector(config=JF.tiny_gdino_config())
    names = inspect.getclosurevars(jdet).nonlocals
    det = PF.hf_detector(config=C.GroundingDinoConfig.from_dict(JF.tiny_gdino_config().to_dict()),
                         device="cpu")
    state = {k: v.detach().numpy().copy() for k, v in names["model"].state_dict().items()}
    foundation_import.load_weights(det.model, state)
    return jdet, names["model"], names["processor"], det


def deep_gdino_config():
    """JAX's tiny config deepened where the full-width model branches: two
    Swin blocks a stage (every second one on shifted windows, under its
    attention mask), two backbone outputs feeding three levels (the extra
    level from the last map), and two encoder and decoder layers (the box
    refined across layers, the head on the last-but-one reference)."""
    from transformers import BertConfig, GroundingDinoConfig, SwinConfig

    text = BertConfig(vocab_size=len(JF.tiny_gdino_vocab()), hidden_size=64,
                      num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=128, max_position_embeddings=64)
    backbone = SwinConfig(image_size=224, embed_dim=16, depths=[2, 2, 2],
                          num_heads=[1, 1, 1], out_indices=[2, 3])
    return GroundingDinoConfig(
        text_config=text.to_dict(), backbone_config=backbone.to_dict(),
        d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        num_queries=20, num_feature_levels=3)


@pytest.fixture(scope="module")
def deep_pair():
    """``pair`` at ``deep_gdino_config()``. ``transformers`` starts the box
    head's last layer and the deformable attentions' offset and weight
    projections at zero, which would leave every reference box unmoved and
    the positions unread: each weight matrix that starts at zero gets seeded
    values here, before the weights cross."""
    torch.manual_seed(6)
    config = deep_gdino_config()
    jdet = JF.hf_detector(config=config)
    names = inspect.getclosurevars(jdet).nonlocals
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for p in names["model"].parameters():
            if p.dim() == 2 and not p.any():
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)))
    det = PF.hf_detector(config=C.GroundingDinoConfig.from_dict(config.to_dict()), device="cpu")
    state = {k: v.detach().numpy().copy() for k, v in names["model"].state_dict().items()}
    foundation_import.load_weights(det.model, state)
    return jdet, names["model"], names["processor"], det


def _image(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_gdino_processor_matches_transformers(pair, shape):
    """pixel_values, pixel_mask, input_ids, attention_mask and token_type_ids
    equal GroundingDinoProcessor's, to the bit."""
    from PIL import Image

    _, _, processor, det = pair
    img = _image(sum(shape), shape)
    want = processor(images=Image.fromarray(img), text=[list(JF.DEFAULT_PROMPTS)],
                     return_tensors="pt")
    got = det.preprocess(img, PF.DEFAULT_PROMPTS)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# (which model, image shape); the deep model on a shrunk image and on a thin
# one whose last stage (5×14) is padded up to the 7×7 window
CASES = [("pair", s) for s in SHAPES[:3]] + [("deep_pair", (300, 420)), ("deep_pair", (100, 320))]


@pytest.mark.parametrize("which,shape", CASES,
                         ids=[f"shape{i}" for i in range(3)] + ["deep-300x420", "deep-100x320"])
def test_gdino_outputs_and_boxes_match_jax(request, which, shape):
    """Raw logits (-inf at the same places) and pred_boxes within 1e-5; JAX's
    ``detect`` boxes within 1e-4 px, the same ones in the same order."""
    from PIL import Image

    jdet, jmodel, processor, det = request.getfixturevalue(which)
    if which == "deep_pair":  # the branches the tiny model never takes are taken
        shifts = [m.shift_size for m in det.model.modules() if hasattr(m, "shift_size")]
        assert shifts == [0, 3] * 3
        assert len(det.model.model.backbone.conv_encoder.model.out_indices) == 2
        assert len(det.model.model.decoder.layers) == 2
    img = _image(3 + shape[1], shape)
    inputs = processor(images=Image.fromarray(img), text=[list(JF.DEFAULT_PROMPTS)],
                       return_tensors="pt")
    with torch.no_grad():
        ref = jmodel(**inputs)
    logits, boxes = det.raw(img, PF.DEFAULT_PROMPTS)
    finite = torch.isfinite(ref.logits)
    assert torch.equal(torch.isfinite(logits), finite)
    assert finite.sum() == 20 * 8  # 20 queries × 8 tokens
    assert (logits[finite] - ref.logits[finite]).abs().max() <= 1e-5
    assert (boxes - ref.pred_boxes).abs().max() <= 1e-5
    want = jdet(img, JF.DEFAULT_PROMPTS)
    got = det(img, PF.DEFAULT_PROMPTS)
    assert got.dtype == np.float32 and got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_gdino_save_pretrained_round_trip(pair, tmp_path):
    """JAX's model through ``save_pretrained``, the port's safetensors reader
    and the bridge: every tensor equal to the bit, the tied box heads
    restored, the same logits; the reader's dtypes and refusals."""
    jdet, jmodel, _, det = pair
    jmodel.save_pretrained(tmp_path)
    state = read_safetensors(str(tmp_path / "model.safetensors"))
    want = jmodel.state_dict()
    tied = [k for k in want if "bbox_embed.0." in k and k not in state]
    assert tied  # save_pretrained writes the shared head once
    with open(tmp_path / "config.json") as f:
        config = C.GroundingDinoConfig.from_dict(json.load(f))
    model = foundation_import.load_weights(GroundingDinoForObjectDetection(config).eval(), state)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert model.model.decoder.bbox_embed[0] is model.bbox_embed[0]
    img = _image(17, (80, 120))
    other = PF.GroundingDinoDetector(model, det.tokenizer, det.size, 0.3, 0.25, det.device)
    a, b = other.raw(img, PF.DEFAULT_PROMPTS), det.raw(img, PF.DEFAULT_PROMPTS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    tensors = {"f32": torch.randn(3, 2), "f16": torch.randn(4).half(),
               "bf16": torch.randn(2, 2).bfloat16(), "i64": torch.arange(5)}
    path = str(tmp_path / "t.safetensors")
    write_safetensors(path, tensors)
    back = read_safetensors(path)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    from safetensors.torch import load_file, save_file

    for k, v in load_file(path).items():  # the library reads the port's file alike
        assert torch.equal(v, tensors[k])

    save_file({"i32": torch.arange(3, dtype=torch.int32)}, str(tmp_path / "i32.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        read_safetensors(str(tmp_path / "i32.safetensors"))


def test_grounding_dino_base_layout_matches_transformers():
    """grounding_dino_base()'s state-dict keys and shapes equal those of
    ``transformers``' GroundingDinoForObjectDetection built from the
    published config (Swin-B 384, BERT-base), both on the meta device."""
    from transformers import GroundingDinoConfig, GroundingDinoForObjectDetection as HF

    base = C.grounding_dino_base()
    hf_config = GroundingDinoConfig(backbone_config=dict(base.backbone_config.to_dict(),
                                                         model_type="swin"),
                                    text_config={"model_type": "bert"})
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in HF(hf_config).state_dict().items()}
        got = {k: tuple(v.shape) for k, v in
               GroundingDinoForObjectDetection(base).state_dict().items()}
    assert got == want
    assert got["model.text_backbone.embeddings.word_embeddings.weight"] == (30522, 768)
    swin = "model.backbone.conv_encoder.model.encoder.layers"
    assert len({k.split(".blocks.")[1].split(".")[0] for k in got
                if k.startswith(f"{swin}.2.blocks.")}) == 18
    assert got[f"{swin}.0.blocks.0.attention.self.relative_position_bias_table"] == (23 ** 2, 4)
    assert got["model.query_position_embeddings.weight"] == (900, 256)
    assert base.image_processor_size == {"shortest_edge": 800, "longest_edge": 1333}


def test_wordpiece_and_phrase_masks_match_transformers(tmp_path):
    """The tokenizer against BertTokenizerFast on one vocab; GroundingDINO's
    phrase masks and position ids against ``transformers``' function on
    bert-base-like ids (the phrases split at 101/102/1012/1029) and on the
    JAX package's tiny ids (no split)."""
    from transformers import BertTokenizerFast
    from transformers.models.grounding_dino.modeling_grounding_dino import (
        generate_masks_with_special_tokens_and_transfer_map as want_masks,
    )

    vocab = (JF.tiny_gdino_vocab() + ["##s", "ca", "##t", "!", ",", "?", "é", "zebra"])
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    ref = BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"))
    tok = WordPieceTokenizer(str(tmp_path / "vocab.txt"))
    for text in ["a cat. a dog.", "A Cats, an   animal!", "cAT\tdogé zebras", "Cát. dogs?",
                 "an一animal", "a cat​."]:
        want = ref(text)
        assert tok.encode(text) == {k: want[k] for k in
                                    ("input_ids", "attention_mask", "token_type_ids")}, text
    assert tok.encode(["A cat", "a dog"]) == tok.encode("a cat. a dog.")
    with pytest.raises(ValueError):
        WordPieceTokenizer(["a", "b"])

    rng = np.random.default_rng(0)
    for L in (2, 7, 16):
        ids = rng.integers(2000, 3000, (3, L))
        ids[:, 0], ids[:, -1] = 101, 102
        for row in range(3):
            ids[row, rng.choice(np.arange(1, L - 1), size=min(L - 2, 3), replace=False)] = (
                rng.choice(SPECIAL_TOKENS, size=min(L - 2, 3)))
        ids = torch.from_numpy(ids)
        m, p = phrase_masks(ids)
        wm, wp = want_masks(ids)
        assert torch.equal(m, wm) and torch.equal(p, wp)
    tiny = torch.tensor([[2, 5, 6, 8, 5, 7, 8, 3]])
    m, p = phrase_masks(tiny)
    assert torch.equal(m[0], torch.eye(8, dtype=torch.bool)) and not p.any()
