"""Port parity: classic CAM (``cam/cam.py``: class_cams, cam_bg),
``layercam_bg``, and the loss helpers the compat surface needs
(``cross_entropy_loss``, ``kl_div_batchmean``, ``window_affinities``),
against the JAX package with the same weights and inputs. CAMs within 2e-3,
losses within 1e-5, affinities within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_classifier import jax_classifier_numpy, port_classifier
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)

from weaklysuperviseddl_tpu.cam.cam import cam_bg as jax_cam_bg
from weaklysuperviseddl_tpu.cam.cam import class_cams as jax_class_cams
from weaklysuperviseddl_tpu.cam.layercam import layercam_bg as jax_layercam_bg
from weaklysuperviseddl_tpu.losses.basic import cross_entropy_loss as jax_ce
from weaklysuperviseddl_tpu.losses.basic import kl_div_batchmean as jax_kl
from weaklysuperviseddl_tpu.losses.window import window_affinities as jax_affinities
from weaklysuperviseddl_tpu_torch.cam.cam import cam_bg, class_cams
from weaklysuperviseddl_tpu_torch.cam.layercam import layercam_bg
from weaklysuperviseddl_tpu_torch.losses.basic import cross_entropy_loss, kl_div_batchmean
from weaklysuperviseddl_tpu_torch.losses.window import window_affinities, window_offsets

pytestmark = pytest.mark.usefixtures("single_torch_thread")


@pytest.fixture(scope="module")
def classifier():
    """(JAX model, its variables, the port's classifier on the same weights)."""
    model, variables = jax_classifier_numpy()
    return model, variables, port_classifier(variables)


def _images(seed, B=2, size=64):
    return np.random.default_rng(seed).uniform(0, 1, (B, size, size, 3)).astype(np.float32)


def test_class_cams_match_jax(classifier):
    """Every class's CAM, [B,K,h,w] (layer4's 4x4 at 64²), and the logits."""
    model, variables, port = classifier
    x = _images(5)
    want, want_logits = jax_class_cams(model, variables, jnp.asarray(x))
    got, logits = class_cams(port, torch.from_numpy(x))
    assert got.shape == want.shape == (2, 37, 4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-3, atol=2e-3)
    assert float(got.amin(dim=(-2, -1)).max()) == 0.0  # min-max per (image, class)


@pytest.mark.parametrize("alpha,output_size,classes", [
    (1.0, 64, [[5], [9]]), (2.0, 224, [[3, 30], [0, 36]])])
def test_cam_bg_matches_jax(classifier, alpha, output_size, classes):
    model, variables, port = classifier
    x = _images(6)
    mask = np.zeros((2, 37), np.float32)
    for i, cls in enumerate(classes):
        mask[i, cls] = 1.0
    want = jax_cam_bg(model, variables, jnp.asarray(x), jnp.asarray(mask), alpha=alpha,
                      output_size=output_size)
    got = cam_bg(port, torch.from_numpy(x), torch.from_numpy(mask), alpha=alpha,
                 output_size=output_size)
    for g, w in zip(got, want):
        assert g.shape == (2, output_size, output_size)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3)


@pytest.mark.parametrize("target_layers,alpha", [
    (("layer2", "layer3", "layer4"), 2.0), (("layer3", "layer4"), 0.5)])
def test_layercam_bg_matches_jax(classifier, target_layers, alpha):
    """The default target layers are three (the CutLoss variant's), unlike
    layercam's two."""
    model, variables, port = classifier
    x = _images(7)
    cls = np.array([4, 21], np.int32)
    kw = dict(alpha=alpha, output_size=64)
    if target_layers != ("layer2", "layer3", "layer4"):
        kw["target_layers"] = target_layers
    want = jax_layercam_bg(model, variables, jnp.asarray(x), jnp.asarray(cls), **kw)
    got = layercam_bg(port, torch.from_numpy(x), torch.from_numpy(cls), **kw)
    for g, w in zip(got, want):
        assert g.shape == (2, 64, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3)


@pytest.mark.parametrize("shape,dim", [((2, 6, 7, 3), -1), ((2, 4, 6, 7), 1), ((5, 37), -1)])
def test_cross_entropy_loss_matches_jax_and_torch(shape, dim):
    rng = np.random.default_rng(sum(shape))
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    label_shape = tuple(s for i, s in enumerate(shape) if i != dim % len(shape))
    labels = rng.integers(0, shape[dim], label_shape).astype(np.int32)
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), dim=dim)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), axis=dim)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    moved = torch.from_numpy(np.moveaxis(logits, dim, 1).copy())
    ref = F.cross_entropy(moved, torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-5)


def test_kl_div_batchmean_matches_jax_and_torch():
    """p with exact zeros (0·log 0 = 0), log q from a softmax."""
    rng = np.random.default_rng(3)
    p = rng.uniform(0, 1, (3, 8, 9, 2)).astype(np.float32)
    p[rng.uniform(size=p.shape) < 0.2] = 0.0
    log_q = torch.log_softmax(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)),
                              dim=-1)
    got = kl_div_batchmean(log_q, torch.from_numpy(p))
    want = jax_kl(jnp.asarray(log_q.numpy()), jnp.asarray(p))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    ref = F.kl_div(log_q, torch.from_numpy(p), reduction="batchmean")
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,sigma_color,sigma_space,shape", [
    (5, 0.1, 5.0, (2, 12, 14)), (3, 0.05, 10.0, (1, 9, 16)), (7, 0.2, 3.0, (1, 11, 10))])
def test_window_affinities_match_jax(window, sigma_color, sigma_space, shape):
    """[B,K,H,W] in ``window_offsets`` order, which is JAX's ``_offsets``."""
    images = np.random.default_rng(window).uniform(0, 1, shape + (3,)).astype(np.float32)
    got = window_affinities(torch.from_numpy(images), sigma_color=sigma_color,
                            sigma_space=sigma_space, window_size=window)
    want = jax_affinities(jnp.asarray(images), sigma_color=sigma_color,
                          sigma_space=sigma_space, window_size=window)
    assert got.shape == (shape[0], window * window - 1) + shape[1:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # the centre pixel's spatial term alone where an offset's colours agree
    flat = np.zeros((1, 6, 6, 3), np.float32)
    aff = window_affinities(torch.from_numpy(flat), sigma_color, sigma_space, window)
    for k, (dy, dx) in enumerate(window_offsets(window)):
        np.testing.assert_allclose(aff[0, k].numpy(),
                                   np.exp(-(dy * dy + dx * dx) / (2 * sigma_space ** 2)),
                                   rtol=1e-6)
