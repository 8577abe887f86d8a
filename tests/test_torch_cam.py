"""Port parity: LayerCAM (both alpha modes), the CAM fusion of one layer
(the CPU side of kernel K5), CAM → mask, and pseudo-mask generation, against
the JAX package with the same classifier weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_classifier import jax_classifier_numpy, port_classifier

from weaklysuperviseddl_tpu.cam.layercam import layercam as jax_layercam
from weaklysuperviseddl_tpu.data.dataset import download_data as jax_download
from weaklysuperviseddl_tpu.data.loader import batches as jax_batches
from weaklysuperviseddl_tpu.masks.pseudo import cam_to_mask as jax_cam_to_mask
from weaklysuperviseddl_tpu.masks.pseudo import generate_pseudo_masks as jax_generate
from weaklysuperviseddl_tpu.ops.pallas_cam import fused_cam_fusion
from weaklysuperviseddl_tpu_torch.cam.layercam import layercam
from weaklysuperviseddl_tpu_torch.data.dataset import download_data
from weaklysuperviseddl_tpu_torch.data.loader import batches
from weaklysuperviseddl_tpu_torch.masks.pseudo import cam_to_mask, generate_pseudo_masks
from weaklysuperviseddl_tpu_torch.ops.cam_fusion import cam_fusion, cam_fusion_plain


@pytest.mark.parametrize("alpha,mode", [(1.0, "per_layer"), (0.5, "per_layer"), (0.5, "final")])
def test_layercam_matches_jax(alpha, mode):
    model, variables = jax_classifier_numpy()
    port = port_classifier(variables)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    cls = np.array([3, 11], np.int32)
    want, want_logits = jax_layercam(model, variables, jnp.asarray(x), jnp.asarray(cls),
                                     alpha=alpha, alpha_mode=mode, output_size=64)
    got, logits = layercam(port, torch.from_numpy(x), torch.from_numpy(cls), alpha=alpha,
                           alpha_mode=mode, output_size=64)
    assert got.shape == (2, 64, 64) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-3, atol=2e-3)


def test_layercam_argmax_class_and_fusion_option():
    _, variables = jax_classifier_numpy()
    port = port_classifier(variables)
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    got_none, logits = layercam(port, x, None, output_size=64, fusion="auto")
    got_arg, _ = layercam(port, x, logits.argmax(dim=1), output_size=64)
    torch.testing.assert_close(got_none, got_arg, rtol=0, atol=0)
    # on a CPU tensor fusion="pallas" runs the kernel's plain version
    got_pallas, _ = layercam(port, x, None, output_size=64, fusion="pallas")
    got_xla, _ = layercam(port, x, None, output_size=64, fusion="xla")
    torch.testing.assert_close(got_pallas, got_xla, rtol=0, atol=0)
    torch.testing.assert_close(got_pallas, got_none, rtol=0, atol=0)
    with pytest.raises(ValueError, match="fusion"):
        layercam(port, x, None, fusion="triton")


@pytest.mark.parametrize("shape", [(3, 14, 14, 160), (2, 7, 9, 130)])
def test_cam_fusion_matches_pallas_kernel_in_interpret_mode(shape):
    """The plain fusion against the TPU kernel run in interpret mode, atol 1e-6
    (tests/test_pallas_cam.py's tolerance); JAX takes NHWC, the port NCHW."""
    rng = np.random.default_rng(sum(shape))
    act = rng.standard_normal(shape).astype(np.float32)
    grad = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(fused_cam_fusion(jnp.asarray(act), jnp.asarray(grad), interpret=True))
    a, g = (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in (act, grad))
    got = cam_fusion(a, g)
    assert got.shape == shape[:3]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    torch.testing.assert_close(got, cam_fusion_plain(a, g), rtol=0, atol=0)


def test_cam_to_mask_equal_on_the_same_cams():
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (3, 40, 40)).astype(np.float32)
    cams = np.stack([np.kron(b[:8, :8], np.ones((5, 5), np.float32)) for b in base])
    for keep in (True, False):
        got = cam_to_mask(torch.from_numpy(cams), 0.3, keep)
        want = jax_cam_to_mask(jnp.asarray(cams), 0.3, keep)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_pseudo_masks_agrees_with_jax():
    model, variables = jax_classifier_numpy()
    port = port_classifier(variables)
    ds = download_data(None, synthetic_size=10, image_size=64)
    jds = jax_download(None, synthetic_size=10, image_size=64)
    kw = dict(cam_thresh=0.3, image_size=64, max_images=9)
    want = jax_generate(jax_batches(jds, 4, pad_to_full=True), model, variables, **kw)
    got = generate_pseudo_masks(batches(ds, 4, pad_to_full=True), port, **kw)
    w_images, w_masks, w_keys = want.as_arrays()
    g_images, g_masks, g_keys = got.as_arrays()
    assert g_keys == w_keys and len(g_keys) == 9
    assert (g_masks == w_masks).mean() >= 0.99
    assert 0.02 < g_masks.mean() < 0.98  # the masks have structure
    assert np.abs(g_images.astype(int) - w_images.astype(int)).max() <= 1
