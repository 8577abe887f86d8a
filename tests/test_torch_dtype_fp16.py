"""The float16 compute dtype against the JAX package's, by the rule of
``test_torch_dtype.py``: from the same numpy inputs and bridged weights, A is
the JAX package in float16, B the JAX package in float32, C the port in
float16, and dist(C, A) <= 2 · dist(A, B) + 1e-3 (the distances printed with
-s).

What JAX's float16 gives at smoke width on the CPU (ResNet-18 / DeepLabV3-
ResNet18 at width 0.25, 64²): finite logits, CAMs and masks, and a finite
segmentation step that the guard applies (its loss 0.66764 against float32's
0.66778 at 64², 0.65260 against 0.65266 at the 32² of the test), so the
port's step must apply too. JAX has no loss scale, and
neither has the port. K5's plain version on float16 inputs equals the
float32 fusion on their upcasts, and a numpy model of the CUDA kernel's
8-byte float16 load widens every bit pattern as torch does. The cycle runs
through the CLI in float16, and BASNet computes in float16 over float32
parameters, its loss in float32. (A BASNet training step in float16 takes
about 90 s on one CPU thread; the card's ``bf16`` phase covers the float16
training step of DeepLabV3.)"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_classifier import jax_classifier_numpy
from test_torch_dtype import _NoDropout, assert_within_jax_rounding, dist, disagree, tree_dist
from test_torch_models import jax_deeplab_numpy
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.cam.layercam import layercam as jax_layercam
from weaklysuperviseddl_tpu.masks.pseudo import cam_to_mask as jax_cam_to_mask
from weaklysuperviseddl_tpu.models.classifier import CamClassifier as JaxCamClassifier
from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from weaklysuperviseddl_tpu.models.torch_import import deeplab_variables
from weaklysuperviseddl_tpu.ops.pallas_cam import fused_cam_fusion
from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import make_seg_train_step
import weaklysuperviseddl_tpu_torch.train.basnet as port_train_basnet
from weaklysuperviseddl_tpu_torch import cli
from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
from weaklysuperviseddl_tpu_torch.cli import main
from weaklysuperviseddl_tpu_torch.data.synthetic import synthetic_pet_arrays
from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask
from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.jax_import import (
    cam_classifier_state_dict_from_jax,
    deeplab_state_dict_from_jax,
)
from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion, cam_fusion_plain
from weaklysuperviseddl_tpu_torch.pipelines.basnet_infer import build_basnet
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import SegTrainState, seg_train_step

pytestmark = pytest.mark.usefixtures("single_torch_thread")

F16 = jnp.float16


def test_classifier_logits_layercam_and_masks_fp16():
    """Logits of 4 synthetic pets, LayerCAM over layer3 and layer4 for their
    labels, and the threshold-0.3 keep-largest pseudo-masks of those CAMs."""
    _, variables = jax_classifier_numpy()
    x, cls, _ = synthetic_pet_arrays(4, image_size=64, seed=3)
    jax_models = {dt: JaxCamClassifier(num_classes=37, depth=18, width_multiplier=0.25, dtype=dt)
                  for dt in (F16, jnp.float32)}
    port = CamClassifier(37, 18, 0.25, dtype="float16")
    port.load_state_dict(cam_classifier_state_dict_from_jax(variables), strict=True)
    port.eval()

    a, b = (np.asarray(jax.jit(jax_models[dt].apply)(variables, jnp.asarray(x))[0])
            .astype(np.float32) for dt in (F16, jnp.float32))
    with torch.no_grad():
        c, feats = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert c.dtype == torch.float16 and all(f.dtype == torch.float16 for f in feats)
    assert np.isfinite(a).all()
    assert_within_jax_rounding("classifier logits fp16", dist(c.float(), a), dist(a, b))

    kw = dict(target_layers=("layer3", "layer4"), alpha=1.0, alpha_mode="per_layer",
              output_size=64)
    a, b = (np.asarray(jax_layercam(jax_models[dt], variables, jnp.asarray(x), jnp.asarray(cls),
                                    **kw)[0]) for dt in (F16, jnp.float32))
    c, logits = layercam(port, torch.from_numpy(x), torch.from_numpy(cls), **kw)
    assert c.dtype == torch.float32 and logits.dtype == torch.float16
    c = c.numpy()
    assert np.isfinite(a).all() and np.isfinite(c).all()
    assert_within_jax_rounding("LayerCAM fp16", dist(c, a), dist(a, b))

    ma, mb = (np.asarray(jax_cam_to_mask(jnp.asarray(m), 0.3, True)) for m in (a, b))
    mc = cam_to_mask(torch.from_numpy(c), 0.3, True).numpy()
    assert 0.02 < mc.mean() < 0.98
    assert_within_jax_rounding("pseudo-masks fp16", disagree(mc, ma), disagree(ma, mb))


def test_deeplab_logits_and_seg_step_fp16(monkeypatch):
    """DeepLabV3-ResNet18 at width 0.25: eval logits of 2 images at 64² (every
    ASPP rate on the tap plan) and their argmax, then one CE step at 32²
    (Adam 1e-4 behind the guard, dropout the identity) from the bridged
    weights: the loss and the parameters after it. JAX's float16 step is
    finite and applied; the port's must be too."""
    _, variables = jax_deeplab_numpy(18, 0.25)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    a, b = (np.asarray(jax.jit(lambda v, x, m=JaxDeepLabV3(
        num_classes=2, backbone_depth=18, width_multiplier=0.25, dtype=dt):
        m.apply(v, x, train=False))(variables, jnp.asarray(x))) for dt in (F16, jnp.float32))
    port = DeepLabV3(2, 18, 0.25, dtype="float16").eval()
    port.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        c = port.logits_nhwc(torch.from_numpy(x))
    assert c.dtype == torch.float32 and a.dtype == np.float32
    c = c.numpy()
    assert_within_jax_rounding("DeepLabV3-18 logits fp16", dist(c, a), dist(a, b))
    agree = float((c.argmax(-1) == a.argmax(-1)).mean())
    assert agree >= 0.999, f"argmax agreement with JAX fp16 {agree}"

    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    rng = np.random.default_rng(7)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    masks = rng.integers(0, 3, (4, 32, 32)).astype(np.int32)
    valid = np.arange(4) < 3
    runs = {}
    for dt in (F16, jnp.float32):
        jmodel = JaxDeepLabV3(num_classes=2, backbone_depth=18, width_multiplier=0.25, dtype=dt)
        tx = apply_if_finite_fast(optax.adam(1e-4))
        params = jax.tree.map(jnp.array, variables["params"])
        stats = jax.tree.map(jnp.array, variables["batch_stats"])
        params, stats, opt, loss = make_seg_train_step(jmodel, tx)(
            params, stats, tx.init(params), jnp.asarray(images), jnp.asarray(masks),
            jnp.asarray(valid), jax.random.PRNGKey(0))
        assert int(opt.notfinite_count) == 0 and np.isfinite(float(loss))
        runs[dt] = float(loss), jax.tree.map(np.asarray, params)
    port = DeepLabV3(2, 18, 0.25, dtype="float16")
    port.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
    port.classifier[0].project[3] = torch.nn.Identity()
    state = SegTrainState(port, GuardedAdam(port.parameters(), lr=1e-4))
    loss = float(seg_train_step(state, torch.from_numpy(images), torch.from_numpy(masks),
                                torch.from_numpy(valid)))
    assert int(state.optimizer.count) == 1 and int(state.optimizer.total_notfinite) == 0
    assert all(p.dtype == torch.float32 for p in port.parameters())
    (a_loss, a_params), (b_loss, b_params) = runs[F16], runs[jnp.float32]
    assert_within_jax_rounding("seg step loss fp16", abs(loss - a_loss), abs(a_loss - b_loss))
    c_params = deeplab_variables({k: v.detach().clone() for k, v in
                                  port.state_dict().items()})["params"]
    assert_within_jax_rounding("seg step parameters fp16", tree_dist(c_params, a_params),
                               tree_dist(a_params, b_params))


def test_cam_fusion_on_fp16_inputs():
    """float16 act and grad at a layer-like and a ragged shape: the plain
    fusion equals itself on their float32 upcasts bit for bit (what the
    kernel's float16 launch is held to on the card), ``cam_fusion`` on CPU
    tensors is the plain version, and at the first shape the JAX kernel in
    interpret mode on the same float16 inputs agrees within 1e-6.
    A numpy model of ``csrc/cam_fusion.cu``'s 8-byte float16 load (two
    32-bit words, element k in bits [16k, 16k + 16), each widened exactly)
    gives torch's float16 → float32 on every bit pattern."""
    for shape in ((3, 14, 14, 160), (2, 7, 9, 130)):
        rng = np.random.default_rng(sum(shape))
        act, grad = (torch.from_numpy(rng.standard_normal(shape).astype(np.float16))
                     for _ in range(2))
        a, g = (t.permute(0, 3, 1, 2).contiguous() for t in (act, grad))
        got = cam_fusion_plain(a, g)
        assert got.dtype == torch.float32 and got.shape == shape[:3]
        torch.testing.assert_close(got, cam_fusion_plain(a.float(), g.float()), rtol=0, atol=0)
        torch.testing.assert_close(cam_fusion(a, g), got, rtol=0, atol=0)
        if shape[-1] == 160:
            want = fused_cam_fusion(jnp.asarray(act.numpy()), jnp.asarray(grad.numpy()),
                                    interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    bits = np.arange(2**16, dtype=np.uint32)
    words = (bits[0::2] | (bits[1::2] << 16)).astype(np.uint32)
    halves = np.stack([words & np.uint32(0xFFFF), words >> 16], axis=1).reshape(-1)
    model = halves.astype(np.uint16).view(np.float16).astype(np.float32)
    ref = torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(torch.float16)
    ref = ref.float().numpy()
    nan = np.isnan(ref)
    assert (np.isnan(model) == nan).all()
    np.testing.assert_array_equal(model[~nan], ref[~nan])


def test_cycle_and_basnet_run_in_fp16(capsys, monkeypatch):
    """``weakly --alternating`` with both models in float16 through the CLI
    (the smoke config at 32²), ``basnet --dtype float16`` reaching the
    command, and BASNet in float16: its eight maps in float16 and finite,
    and the hybrid loss on them float32 against float32 targets."""
    rc = main(["weakly", "--alternating", "--smoke", "--device", "cpu", "--classifier.dtype",
               "float16", "--seg.dtype", "float16", "--data.image_size", "32",
               "--data.seg_size", "32", "--cam.output_size", "32"])
    assert rc == 0
    import json

    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["alt_iou"]) and 0.0 <= metrics["alt_iou"] <= 1.0

    seen = []
    monkeypatch.setattr(cli, "_basnet", lambda args: seen.append(args.dtype) or 0)
    assert main(["basnet", "--dtype", "float16", "--device", "cpu"]) == 0 and seen == ["float16"]

    model = build_basnet(weights_path=None, device="cpu", dtype="float16")
    assert model.compute_dtype == torch.float16
    pets, _, trimaps = synthetic_pet_arrays(2, image_size=32, seed=6)
    with torch.no_grad():
        maps = model(torch.from_numpy(pets).permute(0, 3, 1, 2))
    assert len(maps) == 8 and all(m.dtype == torch.float16 and torch.isfinite(m).all()
                                  for m in maps)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    loss = port_train_basnet.fusion_loss(maps, torch.from_numpy((trimaps == 1).astype(np.float32)))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
