"""int8 serving (ops/quant.py, ops/qconv.py, Predictor.quantize) against the
JAX package's int8 PTQ (weaklysuperviseddl_tpu/ops/quant.py).

* The unit cases of ``tests/test_quant.py`` on the port's quantizer (the
  tiny CNN with a 1e3 weight-channel dynamic range, the running max, the
  calibration round trip and every refusal of ``load_calibration``), with
  the same weights and inputs through JAX's quantizer: the same sites, amax
  and outputs.
* The quantization helpers bit for bit against JAX's.
* The sites of DeepLabV3-ResNet50 at 256² against JAX's targets over its
  serving forward (shapes only: the port's model on the meta device, JAX's
  traced), and the smoke DeepLabV3 end to end with bridged weights: the
  calibration file, amax, int8 logits and masks against JAX's ``Predictor``;
  each package loads the other's calibration file.
* Q1/Q2's plain versions against an independent numpy quantize-and-im2col
  and epilogue, bit for bit; the exact int32 GEMM.
* ``Predictor.quantize(state_path=)`` and ``/healthz``'s ``int8``.

The serving quality of a trained model is in ``test_torch_quant_quality.py``.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from test_torch_serve import SIZE, _requests, centred_pair

from weaklysuperviseddl_tpu.ops import quant as jax_quant
from weaklysuperviseddl_tpu.pipelines.serve import Predictor as JaxPredictor
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.ops import quant
from weaklysuperviseddl_tpu_torch.ops.qconv import (
    Geometry,
    dequant_epilogue,
    int8_gemm,
    padded,
    quantize_gather,
)
from weaklysuperviseddl_tpu_torch.pipelines.serve import MaskClient, Predictor, model_inputs

pytestmark = pytest.mark.usefixtures("single_torch_thread")


# ---- the unit cases of tests/test_quant.py ----------------------------------------------

def _tiny_weights():
    """test_quant.py's weights: channel dynamic range 1e3 in the first conv."""
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    w1 *= np.logspace(-2, 1, 8, dtype=np.float32)
    w2 = rng.normal(size=(1, 1, 8, 4)).astype(np.float32)
    wd = rng.normal(size=(4, 5)).astype(np.float32)
    return w1, w2, wd


class TinyCNN(nn.Module):
    """conv3x3 → relu → conv1x1 → spatial mean → matmul, NCHW."""

    def __init__(self, w1, w2, wd):
        super().__init__()
        self.c1 = nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.c2 = nn.Conv2d(8, 4, 1, bias=False)
        self.fc = nn.Linear(4, 5, bias=False)
        with torch.no_grad():
            self.c1.weight.copy_(torch.from_numpy(w1.transpose(3, 2, 0, 1)))
            self.c2.weight.copy_(torch.from_numpy(w2.transpose(3, 2, 0, 1)))
            self.fc.weight.copy_(torch.from_numpy(wd.T))

    def forward(self, x):
        h = torch.relu(self.c1(x))
        return self.fc(self.c2(h).mean(dim=(2, 3)))


def _jax_tiny(w1, w2, wd):
    def fn(x):
        h = jax.lax.conv_general_dilated(x, w1, (1, 1), ((1, 1), (1, 1)),
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        h = jax.nn.relu(h)
        h = jax.lax.conv_general_dilated(h, w2, (1, 1), ((0, 0), (0, 0)),
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.mean(h, axis=(1, 2)) @ wd

    return fn


def _batches(n=3, B=4, size=8, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, size, size, 3)).astype(np.float32) for _ in range(n)]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def tiny():
    """The port's and JAX's quantized tiny CNN, calibrated on the same batches."""
    w = _tiny_weights()
    batches = _batches()
    model = TinyCNN(*w).eval()
    q = quant.Int8Quantizer(model, _nchw(batches[0]))
    for b in batches:
        q.observe(_nchw(b))
    qmodel, report = q.build()
    jq = jax_quant.Int8Quantizer(_jax_tiny(*w), (jnp.asarray(batches[0]),))
    for b in batches:
        jq.observe(jnp.asarray(b))
    jfn, jreport = jq.build()
    return model, q, qmodel, report, jq, jfn, jreport


def test_sites_and_calibration_match_jax(tiny):
    _, q, _, report, jq, _, jreport = tiny
    assert [r["kind"] for r in report.rows] == ["conv", "conv", "dot"]
    state, jstate = q.calibration_state(), jq.calibration_state()
    assert list(state) == list(jstate)  # JAX's keys, in JAX's order
    assert state["kinds"] == jstate["kinds"]
    assert state["weight_shapes"] == jstate["weight_shapes"] == [[3, 3, 3, 8], [1, 1, 8, 4],
                                                                 [4, 5]]
    np.testing.assert_allclose(state["amax"], jstate["amax"], rtol=1e-5)
    np.testing.assert_allclose([r["act_scale"] for r in report.rows],
                               [r["act_scale"] for r in jreport.rows], rtol=1e-5)


def test_quantized_fn_matches_float_and_jax(tiny):
    """Within int8 PTQ's tolerance of the float model (test_quant.py's 5 %),
    and close to JAX's int8 output: the convolutions' integer products and
    epilogues are equal, the spatial mean's float sum order is not."""
    model, _, qmodel, _, _, jfn, _ = tiny
    x = _batches(n=1, seed=5)[0]
    with torch.no_grad():
        ref = model(_nchw(x)).numpy()
        got = qmodel(_nchw(x)).numpy()
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.05, rel
    want = np.asarray(jfn(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_per_channel_weight_scales_survive_dynamic_range(tiny):
    """With a 1e3 weight-channel dynamic range, per-channel scales keep every
    channel's relative error small (test_quant.py's 0.08)."""
    model, _, qmodel, _, _, _, _ = tiny
    x = _nchw(_batches(n=1, seed=7)[0])
    with torch.no_grad():
        ref = model.c1(x).numpy()
        got = qmodel.c1(x).numpy()
    col = np.abs(got - ref).max(axis=(0, 2, 3)) / (np.abs(ref).max(axis=(0, 2, 3)) + 1e-9)
    assert col.max() < 0.08, col
    with torch.no_grad():
        ref, got = model(x).numpy(), qmodel(x).numpy()
    col = np.abs(got - ref).max(0) / (np.abs(ref).max(0) + 1e-9)
    assert col.max() < 0.08, col


def test_calibration_running_max():
    batches = _batches(n=4, seed=3)
    q = quant.Int8Quantizer(TinyCNN(*_tiny_weights()).eval(), _nchw(batches[0]))
    assert q.num_targets == 3
    for b in batches:
        q.observe(_nchw(b))
    want = max(float(np.abs(b).max()) for b in batches)
    np.testing.assert_allclose(q._amax[0], want, rtol=1e-6)


def test_no_calibration_raises():
    q = quant.Int8Quantizer(TinyCNN(*_tiny_weights()).eval(), _nchw(_batches(n=1)[0]))
    with pytest.raises(ValueError, match="calibration"):
        q.build()
    with pytest.raises(ValueError, match="at least one"):
        quant.quantize_for_serving(TinyCNN(*_tiny_weights()), [])


def test_calibration_state_roundtrip_and_fingerprint(tiny):
    """calibration_state() → JSON → load_calibration() reproduces the
    quantized model exactly; a different graph, another version, an
    uncalibrated, a negative or a non-finite amax are refused with JAX's
    messages."""
    model, q1, qmodel1, report1, _, _, _ = tiny
    batches = _batches()
    state = json.loads(json.dumps(q1.calibration_state()))
    q2 = quant.Int8Quantizer(model, _nchw(batches[0]))
    q2.load_calibration(state)
    qmodel2, report2 = q2.build()
    assert [r["act_scale"] for r in report2.rows] == [r["act_scale"] for r in report1.rows]
    x = _nchw(_batches(n=1, seed=9)[0])
    with torch.no_grad():
        torch.testing.assert_close(qmodel2(x), qmodel1(x), rtol=0, atol=0)

    other = nn.Sequential(model, nn.Linear(5, 3, bias=False))
    with pytest.raises(ValueError, match="does not match"):
        quant.Int8Quantizer(other, _nchw(batches[0])).load_calibration(state)
    q4 = quant.Int8Quantizer(model, _nchw(batches[0]))
    with pytest.raises(ValueError, match="version"):
        q4.load_calibration({**state, "version": 2})
    with pytest.raises(ValueError, match="uncalibrated"):
        q4.load_calibration({**state, "amax": [0.0] * state["n_targets"]})
    with pytest.raises(ValueError, match="finite non-negative"):
        q4.load_calibration({**state, "amax": [-1.0] + state["amax"][1:]})
    with pytest.raises(ValueError, match="finite non-negative"):
        q4.load_calibration({**state, "amax": [float("nan")] + state["amax"][1:]})
    with pytest.raises(ValueError, match="finite non-negative"):
        q4.load_calibration({**state, "amax": state["amax"][1:]})


def test_quantize_helpers_match_jax_bit_for_bit():
    """_quantize_weight (per output channel, amax/127, 1 where amax is 0,
    round half to even, clip) and _quantize_act, on values with exact .5
    ties and an all-zero channel."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 3, 16, 8)).astype(np.float32)
    w[..., 3] = 0.0
    w[0, 0, 0, 5] = 12.7  # amax 12.7: scale 0.1, and 0.05-multiples land on ties
    w[0, 0, 1:6, 5] = [0.05, 0.15, -0.25, 1.25, -0.35]
    q, s = quant._quantize_weight(torch.from_numpy(w), 3)
    jq, js = jax_quant._quantize_weight(jnp.asarray(w), 3)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[3] == 1.0
    x = np.concatenate([rng.normal(size=200), np.arange(-130, 131) * 0.5]).astype(np.float32)
    for scale in (1.0, 0.0123, 3.7):
        np.testing.assert_array_equal(quant._quantize_act(torch.from_numpy(x), scale).numpy(),
                                      np.asarray(jax_quant._quantize_act(jnp.asarray(x), scale)))


def test_input_shape_that_changes_the_sites_raises():
    """The smoke DeepLabV3 at 48² runs every ASPP rate as taps, at 160² rate
    12 as a dilated conv: a structurally different graph, refused as JAX
    refuses it."""
    model = DeepLabV3(2, 18, 0.25).eval()
    q = quant.Int8Quantizer(model, torch.zeros(1, 3, 48, 48))
    q.observe(torch.randn(1, 3, 48, 48))
    with pytest.raises(ValueError, match="structurally identical"):
        q.observe(torch.randn(1, 3, 160, 160))
    qmodel, _ = q.build()
    with pytest.raises(ValueError, match="structurally identical"), torch.no_grad():
        qmodel(torch.randn(1, 3, 160, 160))


# ---- DeepLabV3: sites, calibration file, logits and masks against JAX -------------------

def test_resnet50_sites_match_jax_at_256():
    """77 sites (58 conv, 19 dot: ASPP's taps at rates 12, 24, 36 on the
    32x32 map are 9 + 9 + 1) with JAX's kinds and weight shapes, the stem as
    the s2d plan's [4,4,12,64]. Shapes only: the port's model on the meta
    device, JAX's serving forward traced over zero weights."""
    from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
    from weaklysuperviseddl_tpu.pipelines.serve import _serve_forward

    with torch.device("meta"):
        model = DeepLabV3(2, 50, 1.0).eval()
    state = quant.Int8Quantizer(model, torch.empty(2, 3, 256, 256, device="meta")) \
        .calibration_state()
    jmodel = JaxDeepLabV3(num_classes=2, backbone_depth=50, width_multiplier=1.0)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)))
    v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    def fn(images):
        return _serve_forward(jmodel, v["params"], v["batch_stats"], images, 256, True, True)

    jstate = jax_quant.Int8Quantizer(fn, (jnp.zeros((2, 256, 256, 3), jnp.uint8),)) \
        .calibration_state()
    assert state["n_targets"] == jstate["n_targets"] == 77
    assert state["kinds"].count("conv") == 58 and state["kinds"].count("dot") == 19
    assert state["kinds"] == jstate["kinds"]
    assert state["weight_shapes"] == jstate["weight_shapes"]
    assert state["weight_shapes"][0] == [4, 4, 12, 64]


@pytest.fixture(scope="module")
def served():
    """The smoke DeepLabV3 (depth 18, width 0.25, 48²) with bridged weights,
    quantized by both packages' Predictors on the same calibration images."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        calib = _requests(31, 6, (SIZE, SIZE))  # ragged: 6 = 4 + a tail of 2
        model, variables, port = centred_pair(calib)
        state = types.SimpleNamespace(
            params=jax.tree.map(jnp.asarray, variables["params"]),
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
        jpred = JaxPredictor(model, state, size=SIZE, max_batch=4, clean=True, packed=True)
        tpred = Predictor(port, size=SIZE, max_batch=4, clean=True, packed=True, device="cpu")
        imgs = _requests(32, 4, (SIZE, SIZE))
        float_masks = tpred(imgs)
        jreport = jpred.quantize(calib)
        treport = tpred.quantize(calib)
        out = dict(model=model, variables=variables, jpred=jpred, tpred=tpred, calib=calib,
                   imgs=imgs, jreport=jreport, treport=treport, float_masks=float_masks,
                   jmasks=jpred(imgs), tmasks=tpred(imgs))
    finally:
        torch.set_num_threads(threads)
    return out


def _states(served, tmp_path):
    """Both packages' calibration files of ``served``'s calibration."""
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    served["jpred"].quantize(served["calib"], state_path=str(jpath))
    served["tpred"].quantize(served["calib"], state_path=str(tpath))
    return json.loads(jpath.read_text()), json.loads(tpath.read_text()), jpath, tpath


def test_smoke_calibration_file_matches_jax(served, tmp_path):
    jstate, tstate, _, _ = _states(served, tmp_path)
    assert list(tstate) == list(jstate)
    assert tstate["n_targets"] == jstate["n_targets"] == 28
    assert tstate["kinds"] == jstate["kinds"]
    assert tstate["kinds"].count("dot") == 3
    assert tstate["weight_shapes"] == jstate["weight_shapes"]
    np.testing.assert_allclose(tstate["amax"], jstate["amax"], rtol=1e-5)
    assert len(served["treport"].rows) == len(served["jreport"].rows) == 28


def test_each_package_loads_the_others_calibration(served, tmp_path):
    """JAX's file in the port and the port's in JAX: each loads, and serves
    the masks its own calibration gives (the amax agree within 1e-5)."""
    _, _, jpath, tpath = _states(served, tmp_path)
    imgs = served["imgs"]
    tpred, jpred = served["tpred"], served["jpred"]
    tpred.quantize(state_path=str(jpath))
    got_port = tpred(imgs)
    jpred.quantize(state_path=str(tpath))
    got_jax = jpred(imgs)
    assert (got_port == served["tmasks"]).mean() >= 0.999
    assert (got_jax == served["jmasks"]).mean() >= 0.999
    # back to each package's own calibration for the other tests
    tpred.quantize(state_path=str(tpath))
    jpred.quantize(state_path=str(jpath))


def test_int8_masks_match_jax(served):
    """The port's int8 masks against JAX's int8 Predictor's: ≥ 0.995 of
    pixels (all of them here; the bias is centred, so many logits sit near
    the class tie, where an activation rounding to the other int8 level
    would flip a pixel). Both stay near the float masks."""
    got, want = served["tmasks"], served["jmasks"]
    assert got.shape == want.shape == (4, SIZE, SIZE)
    assert 0.1 < want.mean() < 0.9
    assert (got == want).mean() >= 0.995
    assert (got == served["float_masks"]).mean() >= 0.95


def test_int8_logits_match_jax(served, tmp_path):
    """The int8 model's logits against JAX's int8 rewrite of the same model
    under the same calibration (JAX's file). The integer products and the
    epilogues are JAX's; only the float layers between them (BN, the pooled
    mean, the resize) round differently, so the logits agree to about 1e-7
    (1.2e-7 of a 0.69 span here). Held to 1e-3 of the logits' span at the
    largest, room for an activation within float noise of a rounding
    boundary to land on the other int8 level, and 1e-5 on average."""
    from weaklysuperviseddl_tpu.data.preprocess import preprocess_batch as jax_preprocess
    from weaklysuperviseddl_tpu.train.segmentation import _normalize_images as jax_normalize

    jstate, _, _, _ = _states(served, tmp_path)
    model, variables, imgs = served["model"], served["variables"], served["imgs"]
    x, _ = jax_preprocess(jnp.asarray(imgs), None, size=SIZE)
    x = jax_normalize(x)
    jq = jax_quant.Int8Quantizer(lambda a: model.apply(variables, a, train=False), (x,))
    jq.load_calibration(jstate)
    want = np.asarray(jq.build()[0](x))
    tq = quant.Int8Quantizer(served["tpred"].model, model_inputs(torch.from_numpy(imgs), SIZE))
    tq.load_calibration(jstate)
    qmodel, _ = tq.build()
    with torch.no_grad():
        got = qmodel(model_inputs(torch.from_numpy(imgs), SIZE)).permute(0, 2, 3, 1).numpy()
    span = float(want.max() - want.min())
    np.testing.assert_allclose(got, want, atol=1e-3 * span)
    assert np.abs(got - want).mean() < 1e-5 * span


def test_quantize_state_path_and_healthz(served, tmp_path):
    """quantize(state_path=) writes the file atomically (no temporary left)
    and a fresh Predictor loads it without images and serves the same
    masks; without images and without a file it raises; /healthz reports
    int8 once quantized."""
    port = served["tpred"].model
    path = tmp_path / "calib.json"
    first = Predictor(port, size=SIZE, max_batch=4, clean=True, packed=True, device="cpu")
    with pytest.raises(ValueError, match="calibration_images"):
        first.quantize(state_path=str(path))
    report = first.quantize(served["calib"], state_path=str(path))
    assert path.exists() and not (tmp_path / "calib.json.tmp").exists()
    assert len(report.rows) == 28 and first.quantized is not None
    second = Predictor(port, size=SIZE, max_batch=4, clean=True, packed=True, device="cpu")
    server = second.serve_http()
    try:
        assert MaskClient(f"http://127.0.0.1:{server.port}").healthz()["int8"] is False
        again = second.quantize(state_path=str(path))
        assert [r["act_scale"] for r in again.rows] == [r["act_scale"] for r in report.rows]
        assert MaskClient(f"http://127.0.0.1:{server.port}").healthz()["int8"] is True
        np.testing.assert_array_equal(second(served["imgs"]), first(served["imgs"]))
    finally:
        server.stop()


# ---- Q1, Q2 and the GEMM: plain versions against numpy ------------------------------------

def _numpy_patches(x, inv, kh, kw, stride, pad, dil, y0=0, x0=0, Ho=None, Wo=None):
    """Independent quantize-and-im2col: [B,H,W,C] float32 → int8 [B*Ho*Wo,
    kh*kw*C], columns (ky, kx, c), zeros in the padding."""
    B, H, W, C = x.shape
    q = np.clip(np.rint(x * np.float32(inv)), -127, 127).astype(np.int8)
    rows = []
    for b in range(B):
        for oy in range(Ho):
            for ox in range(Wo):
                row = np.zeros((kh, kw, C), np.int8)
                for ky in range(kh):
                    for kx in range(kw):
                        iy = y0 + oy * stride - pad + ky * dil
                        ix = x0 + ox * stride - pad + kx * dil
                        if 0 <= iy < H and 0 <= ix < W:
                            row[ky, kx] = q[b, iy, ix]
                rows.append(row.reshape(-1))
    return np.stack(rows)


@pytest.mark.parametrize("B,H,W,C,kh,stride,pad,dil", [
    (2, 9, 11, 8, 3, 1, 1, 1),       # 3x3, pad 1
    (2, 12, 10, 16, 3, 2, 1, 1),     # 3x3 stride 2 (layer2's first block)
    (1, 10, 10, 16, 3, 1, 4, 4),     # dilated (layer4 at output stride 8)
    (2, 14, 12, 3, 7, 2, 3, 1),      # the 7x7/2 stem, C = 3
    (2, 9, 9, 8, 1, 2, 0, 1),        # a strided 1x1 downsample
    (3, 1, 1, 24, 1, 1, 0, 1),       # the pooled branch: M = B <= 16
])
def test_quantize_gather_plain_equals_numpy(B, H, W, C, kh, stride, pad, dil):
    rng = np.random.default_rng(H * W + C)
    x = (rng.normal(size=(B, H, W, C)) * 3).astype(np.float32)
    x.reshape(-1)[:20] = np.arange(-10, 10) * 0.5 / 0.37  # ties after the scale
    inv = 0.37 / 0.5 * 1.0
    Ho = (H + 2 * pad - dil * (kh - 1) - 1) // stride + 1
    Wo = (W + 2 * pad - dil * (kh - 1) - 1) // stride + 1
    M, K = B * Ho * Wo, kh * kh * C
    Mp, Kp, _ = padded(M, K, 8)
    got = quantize_gather(torch.from_numpy(x), inv, Geometry(kh, kh, stride, pad, dil, 0, 0,
                                                             Ho, Wo), Mp, Kp).numpy()
    want = np.zeros((Mp, Kp), np.int8)
    want[:M, :K] = _numpy_patches(x, np.float32(inv), kh, kh, stride, pad, dil, Ho=Ho, Wo=Wo)
    np.testing.assert_array_equal(got, want)


def test_quantize_gather_tap_region_equals_numpy():
    """An ASPP tap: a 1x1 gather of the source region at (y0, x0)."""
    x = np.random.default_rng(0).normal(size=(2, 6, 7, 16)).astype(np.float32)
    g = Geometry(1, 1, 1, 0, 1, 2, 1, 3, 5)
    Mp, Kp, _ = padded(2 * 3 * 5, 16, 16)
    got = quantize_gather(torch.from_numpy(x), 21.0, g, Mp, Kp).numpy()
    want = np.zeros((Mp, Kp), np.int8)
    want[:30, :16] = _numpy_patches(x, 21.0, 1, 1, 1, 0, 1, 2, 1, 3, 5)
    np.testing.assert_array_equal(got, want)


def test_int8_gemm_plain_is_exact():
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, (40, 4608), dtype=np.int8)
    a[:, :64] = 127
    w = rng.integers(-127, 128, (24, 4608), dtype=np.int8)
    w[:, :64] = -127
    got = int8_gemm(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("bias,accumulate,norm", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True), (False, True, True)])
def test_dequant_epilogue_plain_equals_numpy(bias, accumulate, norm):
    """float32(acc) · rescale (+ bias), written, or added into a region, then
    (v − mean) · mul + beta: the same separately rounded float32 operations
    as numpy's."""
    rng = np.random.default_rng(3)
    B, outH, outW, N, Np = 2, 6, 7, 12, 16
    h, w, oy0, ox0 = (3, 4, 2, 1) if accumulate else (outH, outW, 0, 0)
    acc = rng.integers(-2**26, 2**26, (B * h * w + 5, Np), dtype=np.int32)
    rescale = rng.uniform(1e-5, 1e-3, N).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32) if bias else None
    bn = tuple(rng.normal(size=N).astype(np.float32) for _ in range(3)) if norm else None
    out = rng.normal(size=(B, outH, outW, N)).astype(np.float32)
    got = dequant_epilogue(torch.from_numpy(acc), torch.from_numpy(rescale),
                           None if b is None else torch.from_numpy(b), torch.from_numpy(out.copy()),
                           h, w, oy0, ox0, accumulate,
                           None if bn is None else tuple(torch.from_numpy(t) for t in bn)).numpy()
    v = acc[:B * h * w, :N].astype(np.float32) * rescale
    if b is not None:
        v = v + b
    want = out.copy()
    region = want[:, oy0:oy0 + h, ox0:ox0 + w]
    v = v.reshape(B, h, w, N)
    if accumulate:
        v = region + v
    if bn is not None:
        v = (v - bn[0]) * bn[1] + bn[2]
    region[...] = v
    np.testing.assert_array_equal(got, want)


def test_every_batchnorm_runs_in_its_sites_epilogue():
    """The smoke DeepLabV3's 27 BatchNorms each take a site's output and are
    folded into that site's epilogue (the identity in their place); the
    pooled branch's average is GlobalMean; with BatchNorms that do change
    their input, the int8 model stays within int8's error of the float one."""
    model = DeepLabV3(2, 18, 0.25).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
    x = torch.randn(2, 3, 48, 48)
    q = quant.Int8Quantizer(model, x)
    q.observe(x)
    qmodel, _ = q.build()
    bns = [n for n, m in model.named_modules() if isinstance(m, nn.BatchNorm2d)]
    assert len(bns) == 27 and sorted(q._norms.values()) == sorted(bns)
    assert all(isinstance(qmodel.get_submodule(n), nn.Identity) for n in bns)
    assert isinstance(qmodel.classifier[0].convs[4][0], quant.GlobalMean)
    with torch.no_grad():
        got = qmodel(x)
        ref = model(x)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel < 0.1, rel
def test_padded_meets_the_gemm_constraints():
    for M, K, N in ((1, 3 * 49, 2), (16, 2048, 256), (17, 1280, 256), (65536, 4608, 512)):
        Mp, Kp, Np = padded(M, K, N)
        assert Mp >= max(M, 17) and Mp % 8 == 0
        assert Kp >= K and Kp % 16 == 0 and Kp - K < 16
        assert Np >= N and Np % 8 == 0 and Np - N < 8


