"""The bfloat16 compute dtype against the JAX package's.

Every bfloat16 comparison computes three results from the same numpy inputs
and bridged weights: A, the JAX package in bfloat16; B, the JAX package in
float32; C, the port in bfloat16. It holds

    dist(C, A) <= 2 * dist(A, B) + 1e-3

where ``dist`` is the largest absolute difference (for masks, the share of
pixels that disagree): the port in bfloat16 sits no further from JAX's
bfloat16 than twice JAX's own bfloat16 rounding. The three distances are in
every assertion message and printed. DeepLabV3's and the classifier's
logits and three DeepLabV3 steps are in ``test_torch_dtype_models.py``. Also here: the ASPP's tap plan in
float32 against the dilated convolution and JAX's ``_AtrousTapConv``, the
LayerCAM fusion's plain version on bfloat16 inputs against the JAX kernel in
interpret mode and a numpy model of the CUDA kernel's bfloat16 loads, and
the dtypes the port refuses. The composed smoke cycle in bfloat16 is held to
JAX's in ``test_torch_cycle_parity.py``.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_basnet import _jax_variables, _perturb
from test_torch_classifier import jax_classifier_numpy
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

import weaklysuperviseddl_tpu.train.basnet as jax_train_basnet
from weaklysuperviseddl_tpu.cam.layercam import layercam as jax_layercam
from weaklysuperviseddl_tpu.data.dataset import load_split_data as jax_split
from weaklysuperviseddl_tpu.data.loader import batches as jax_batches
from weaklysuperviseddl_tpu.masks.pseudo import cam_to_mask as jax_cam_to_mask
from weaklysuperviseddl_tpu.models.basnet import BASNet as JaxBASNet
from weaklysuperviseddl_tpu.models.classifier import CamClassifier as JaxCamClassifier
from weaklysuperviseddl_tpu.models.deeplabv3 import _AtrousTapConv
from weaklysuperviseddl_tpu.ops.pallas_cam import fused_cam_fusion
from weaklysuperviseddl_tpu.train.classifier import train_fc_only as jax_train_fc
import weaklysuperviseddl_tpu_torch.pipelines.supervised as port_supervised
import weaklysuperviseddl_tpu_torch.train.basnet as port_train_basnet
from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
from weaklysuperviseddl_tpu_torch.cli import _config, main
from weaklysuperviseddl_tpu_torch.config import ExperimentConfig, SegConfig, smoke_config
from weaklysuperviseddl_tpu_torch.data.dataset import load_split_data
from weaklysuperviseddl_tpu_torch.data.loader import batches
from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask
from weaklysuperviseddl_tpu_torch.models.basnet import BASNet
from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import AtrousConv
from weaklysuperviseddl_tpu_torch.models.jax_import import cam_classifier_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.models.resnet import compute_dtype, init_weights
from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion, cam_fusion_plain
from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import build_basnet
from weaklysuperviseddl_tpu_torch.pipelines.weakly import build_seg_model
from weaklysuperviseddl_tpu_torch.train.classifier import train_fc_only

pytestmark = pytest.mark.usefixtures("single_torch_thread")

BF16 = jnp.bfloat16


def _quiet(*_):
    pass


def dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def tree_dist(a, b) -> float:
    return max(dist(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def disagree(a, b) -> float:
    return float((np.asarray(a) != np.asarray(b)).mean())


def assert_within_jax_rounding(what: str, c_a: float, a_b: float):
    """dist(C, A) <= 2 * dist(A, B) + 1e-3, the distances in the message."""
    msg = (f"{what}: dist(port 16-bit, JAX 16-bit) = {c_a:.6g}, "
           f"dist(JAX 16-bit, JAX fp32) = {a_b:.6g}, bound {2 * a_b + 1e-3:.6g}")
    print(msg)
    assert c_a <= 2 * a_b + 1e-3, msg


# ---- DeepLabV3 ------------------------------------------------------------------------


@pytest.mark.parametrize("rate,size", [(12, 32), (24, 32), (36, 32), (2, 20), (12, 48)])
def test_atrous_tap_plan_float32(rate, size):
    """The tap plan where 4·rate >= min(H, W), else the dilated convolution:
    within 1e-5 of ``F.conv2d`` with the same dilation and padding, and of
    JAX's ``_AtrousTapConv`` within rtol 1e-3 / atol 2e-3."""
    conv = AtrousConv(24, 16, rate)
    init_weights(conv, torch.Generator().manual_seed(rate))
    x = torch.from_numpy(np.random.default_rng(size).standard_normal((2, 24, size, size))
                         .astype(np.float32))
    assert (conv.taps(size, size) is not None) == (4 * rate >= size)
    with torch.no_grad():
        got = conv(x)
        want = F.conv2d(x, conv.weight, None, 1, rate, rate)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    kernel = conv.weight.detach().numpy().transpose(2, 3, 1, 0)        # OIHW → HWIO
    jax_out = _AtrousTapConv(16, rate).apply({"params": {"kernel": jnp.asarray(kernel)}},
                                             jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(jax_out),
                               rtol=1e-3, atol=2e-3)


class _NoDropout(flax.linen.Module):
    """Stands in for flax's Dropout: the identity."""

    rate: float = 0.0
    deterministic: bool | None = None

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


# ---- the CAM classifier, LayerCAM and pseudo-masks --------------------------------------


def _classifiers():
    _, variables = jax_classifier_numpy()
    jax_models = {dt: JaxCamClassifier(num_classes=37, depth=18, width_multiplier=0.25, dtype=dt)
                  for dt in (BF16, jnp.float32)}
    port = CamClassifier(37, 18, 0.25, dtype="bfloat16")
    port.load_state_dict(cam_classifier_state_dict_from_jax(variables), strict=True)
    return jax_models, variables, port.eval()


def _images(seed, n=4, size=64):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def cams():
    """CAMs of 4 synthetic pets (the cycle's images, with their labels as
    the class) for each target layer alone and for both, in each alpha mode:
    {(layers, mode): (A, B, C)}. (On uniform noise instead, JAX's own
    bfloat16 and float32 masks agree on only 0.989 of the pixels.)"""
    jax_models, variables, port = _classifiers()
    x, cls, _ = synthetic_pet_arrays(4, image_size=64, seed=3)
    out = {}
    for layers in (("layer3",), ("layer4",), ("layer3", "layer4")):
        for mode in ("per_layer", "final"):
            kw = dict(target_layers=layers, alpha=0.5 if mode == "final" else 1.0,
                      alpha_mode=mode, output_size=64)
            a, b = (np.asarray(jax_layercam(jax_models[dt], variables, jnp.asarray(x),
                                            jnp.asarray(cls), **kw)[0])
                    for dt in (BF16, jnp.float32))
            c, logits = layercam(port, torch.from_numpy(x), torch.from_numpy(cls), **kw)
            assert c.dtype == torch.float32 and logits.dtype == torch.bfloat16
            out[layers, mode] = a, b, c.numpy()
    return out


@pytest.mark.parametrize("layers", [("layer3",), ("layer4",), ("layer3", "layer4")],
                         ids=["layer3", "layer4", "both"])
@pytest.mark.parametrize("mode", ["per_layer", "final"])
def test_layercam_bf16(cams, layers, mode):
    a, b, c = cams[layers, mode]
    assert c.shape == (4, 64, 64) and np.isfinite(c).all()
    assert_within_jax_rounding(f"LayerCAM {'+'.join(layers)} {mode}", dist(c, a), dist(a, b))


def test_pseudo_masks_bf16(cams):
    """Threshold 0.3 and keep-largest on the layer3+layer4 CAMs: the share of
    pixels that disagree, and agreement with JAX's bfloat16 >= 0.99."""
    a, b, c = cams[("layer3", "layer4"), "per_layer"]
    ma, mb = (np.asarray(jax_cam_to_mask(jnp.asarray(m), 0.3, True)) for m in (a, b))
    mc = cam_to_mask(torch.from_numpy(c), 0.3, True).numpy()
    assert 0.02 < mc.mean() < 0.98  # masks with structure
    assert_within_jax_rounding("pseudo-masks", disagree(mc, ma), disagree(ma, mb))
    assert 1 - disagree(mc, ma) >= 0.99


def test_fc_training_bf16():
    """Three cached-feature epochs of ``train_fc_only`` from the bridged
    weights: the fc's kernel and bias (float32 parameters)."""
    jax_models, variables, port = _classifiers()
    kw = dict(train_ratio=0.8, seed=0, synthetic_size=16, image_size=64, num_classes=37)
    tr, va = load_split_data(None, **kw)
    jtr, jva = jax_split(None, **kw)
    fc = {}
    for dt in (BF16, jnp.float32):
        trained = jax_train_fc(
            jax_models[dt], variables,
            train_loader_fn=lambda: jax_batches(jtr, 4, shuffle=True, seed=0, pad_to_full=True),
            val_loader_fn=None, epochs=3, lr=1e-3, num_classes=37, image_size=64,
            cache_features=True, log=_quiet)
        fc[dt] = {k: np.asarray(v) for k, v in trained["params"]["fc"].items()}
    train_fc_only(port, train_loader_fn=lambda: batches(tr, 4, shuffle=True, seed=0,
                                                        pad_to_full=True),
                  epochs=3, lr=1e-3, num_classes=37, image_size=64, log=_quiet)
    assert port.fc.weight.dtype == torch.float32
    c = {"kernel": port.fc.weight.detach().numpy().T, "bias": port.fc.bias.detach().numpy()}
    a, b = fc[BF16], fc[jnp.float32]
    assert_within_jax_rounding("fc after 3 epochs", max(dist(c[k], a[k]) for k in c),
                               max(dist(a[k], b[k]) for k in a))


# ---- K5's plain version and the kernel's bfloat16 loads ---------------------------------


@pytest.mark.parametrize("shape", [(3, 14, 14, 160), (2, 7, 9, 130)])
def test_cam_fusion_plain_on_bf16_inputs(shape):
    """bfloat16 act and grad: the plain fusion equals itself on their float32
    upcasts bit for bit (it upcasts first), and the JAX kernel in interpret
    mode on the same bfloat16 inputs (its ``prep`` upcasts) within 1e-6;
    ``cam_fusion`` on CPU tensors is the plain version."""
    rng = np.random.default_rng(sum(shape))
    act, grad = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(torch.bfloat16) for _ in range(2))
    want = np.asarray(fused_cam_fusion(jnp.asarray(act.float().numpy(), BF16),
                                       jnp.asarray(grad.float().numpy(), BF16), interpret=True))
    a, g = (t.permute(0, 3, 1, 2).contiguous() for t in (act, grad))
    got = cam_fusion_plain(a, g)
    assert got.dtype == torch.float32 and got.shape == shape[:3]
    torch.testing.assert_close(got, cam_fusion_plain(a.float(), g.float()), rtol=0, atol=0)
    torch.testing.assert_close(cam_fusion(a, g), got, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_kernel_bf16_widening_model():
    """A numpy model of ``csrc/cam_fusion.cu``'s 8-byte bfloat16 load: two
    32-bit words, element k in bits [16k, 16k + 16), widened by moving its 16
    bits to the high half of a float32, gives torch's bfloat16 → float32 on
    every bit pattern (NaNs as NaNs)."""
    bits = np.arange(2**16, dtype=np.uint32)
    words = (bits[0::2] | (bits[1::2] << 16)).astype(np.uint32)
    lo = (words << 16).astype(np.uint32).view(np.float32)
    hi = (words & np.uint32(0xFFFF0000)).view(np.float32)
    got = np.stack([lo, hi], axis=1).reshape(-1)
    want = torch.from_numpy(bits.astype(np.int32).astype(np.int16)).view(torch.bfloat16)
    want = want.float().numpy()
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    np.testing.assert_array_equal(got[~nan], want[~nan])


# ---- BASNet -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def basnet_runs():
    """The bridged BASNet of ``test_torch_basnet.py`` at 32²: the eight eval
    maps of 2 images and the hybrid loss of a training-mode forward at batch
    4 (outputs promoted to float32 against float32 targets), in JAX bfloat16,
    JAX float32 and the port's one bfloat16 training step."""
    port = _perturb(init_weights(BASNet(), torch.Generator().manual_seed(0)), seed=1).eval()
    variables = _jax_variables(port.state_dict())
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    t = np.zeros((4, 32, 32), np.float32)
    t[:, 8:24, 6:20] = 1.0
    runs = {}
    for dt in (BF16, jnp.float32):
        model = JaxBASNet(dtype=dt)

        @jax.jit
        def run(v, x, t):
            maps = model.apply(v, x[:2], train=False)
            outs, _ = model.apply(v, x, train=True, mutable=["batch_stats"])
            loss = jax_train_basnet.fusion_loss([o.astype(jnp.float32) for o in outs], t)
            return [m[..., 0].astype(jnp.float32) for m in maps], loss

        maps, loss = run(variables, jnp.asarray(x), jnp.asarray(t))
        runs[dt] = [np.asarray(m) for m in maps], float(loss)
    model = BASNet(dtype="bfloat16")
    model.load_state_dict(port.state_dict())
    with torch.no_grad():
        maps = model.eval()(torch.from_numpy(x[:2]).permute(0, 3, 1, 2))
    assert all(m.dtype == torch.bfloat16 for m in maps)
    opt = port_train_basnet.Adam(model.parameters(), lr=3e-4)
    loss = port_train_basnet.make_basnet_train_step(model, opt, clip_norm=1.0)(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    assert loss.dtype == torch.float32 and all(p.dtype == torch.float32
                                               for p in model.parameters())
    return runs[BF16], runs[jnp.float32], ([m[:, 0].float().numpy() for m in maps], float(loss))


@pytest.mark.parametrize("index", range(8), ids=("dout", "d1", "d2", "d3", "d4", "d5", "d6",
                                                 "db"))
def test_basnet_maps_bf16(basnet_runs, index):
    (a, _), (b, _), (c, _) = basnet_runs
    assert_within_jax_rounding(f"BASNet map {index}", dist(c[index], a[index]),
                               dist(a[index], b[index]))


def test_basnet_train_step_loss_bf16(basnet_runs):
    (_, a), (_, b), (_, c) = basnet_runs
    assert np.isfinite(c)
    assert_within_jax_rounding("BASNet train-step loss", abs(c - a), abs(a - b))


def test_build_basnet_bf16_returns_float32_maps():
    from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import saliency_step

    model = build_basnet(weights_path=None, device="cpu", dtype="bfloat16")
    assert model.compute_dtype == torch.bfloat16
    images = torch.from_numpy((_images(5, n=2, size=40) * 255).astype(np.uint8))
    out = saliency_step(model, images)
    assert out.dtype == torch.float32 and out.shape == (2, 256, 256)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


# ---- refusals and the routes of the dtype ----------------------------------------------


def test_float16_and_other_dtypes_raise():
    """float16 is a compute dtype since it was ported
    (``test_torch_dtype_fp16.py``); float64 and the integer types raise."""
    for bad in ("float64", "int8"):
        with pytest.raises(ValueError, match="is not ported"):
            SegConfig(dtype=bad)
        with pytest.raises(ValueError, match="is not ported"):
            compute_dtype(bad)
        with pytest.raises(ValueError, match="is not ported"):
            build_basnet(weights_path=None, device="cpu", dtype=bad)
    assert SegConfig(dtype="float16").dtype == "float16"
    assert compute_dtype("float16") is compute_dtype(torch.float16) is torch.float16
    assert compute_dtype(torch.bfloat16) is torch.bfloat16
    assert compute_dtype("float32") is torch.float32


def test_cli_takes_the_dtype_overrides():
    import argparse

    parser = argparse.ArgumentParser()
    args = argparse.Namespace(smoke=True, command="weakly")
    cfg = _config(args, parser, ["--classifier.dtype", "bfloat16", "--seg.dtype", "bfloat16"])
    assert (cfg.classifier.dtype, cfg.seg.dtype) == ("bfloat16", "bfloat16")
    cfg = _config(args, parser, ["--classifier.dtype", "float16", "--seg.dtype", "float16"])
    assert (cfg.classifier.dtype, cfg.seg.dtype) == ("float16", "float16")
    with pytest.raises(ValueError, match="float64"):
        _config(args, parser, ["--seg.dtype", "float64"])


def test_supervised_and_ablations_ignore_seg_dtype(monkeypatch):
    """``seg.dtype = "bfloat16"``: the cycle's DeepLabV3 computes in
    bfloat16, the supervised baseline's (and the grid's, through the same
    ``build_seg_model`` default) in float32, as in the JAX package."""
    cfg = ExperimentConfig(seg=SegConfig(dtype="bfloat16", width_multiplier=0.25,
                                         backbone_depth=18))
    assert build_seg_model(cfg, cfg.seg.dtype).compute_dtype == torch.bfloat16
    assert build_seg_model(cfg).compute_dtype == torch.float32
    seen = []
    real = port_supervised.create_seg_state

    def spy(model, *args, **kwargs):
        seen.append(model.compute_dtype)
        return real(model, *args, **kwargs)

    monkeypatch.setattr(port_supervised, "create_seg_state", spy)
    smoke = smoke_config()
    smoke = dataclasses.replace(smoke, seg=dataclasses.replace(smoke.seg, dtype="bfloat16"))
    port_supervised.run_supervised_training(smoke, device="cpu", log=_quiet, test_runs=1)
    assert seen == [torch.float32]


def test_cli_weakly_alternating_bf16_on_cpu(capsys):
    """The acceptance command runs to its end on the CPU."""
    rc = main(["weakly", "--alternating", "--smoke", "--device", "cpu",
               "--classifier.dtype", "bfloat16", "--seg.dtype", "bfloat16"])
    assert rc == 0
    import json

    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["alt_iou"]) and 0.0 <= metrics["alt_iou"] <= 1.0
