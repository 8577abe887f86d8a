"""Port parity for refinement: the window losses, the plain refinement (the
golden of the CUDA kernel, ``ops/refine.py``) against the JAX package's XLA
path, the routing of ``refine_from_soft_predictions`` on a CPU tensor, and
the resident refinement sweep of the alternating loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_deeplab_numpy, port_from_jax

from weaklysuperviseddl_tpu.config import RefineConfig as JaxRefineConfig
from weaklysuperviseddl_tpu.losses.window import boundary_loss as jax_boundary
from weaklysuperviseddl_tpu.losses.window import local_normalized_cut_loss as jax_ncut
from weaklysuperviseddl_tpu.ops.pallas_refine import pallas_refine
from weaklysuperviseddl_tpu.train.alternating import make_refine_sweep as jax_make_sweep
from weaklysuperviseddl_tpu.train.refine import refine_from_soft_predictions as jax_refine
from weaklysuperviseddl_tpu_torch.config import RefineConfig
from weaklysuperviseddl_tpu_torch.data.preprocess import preprocess_batch
from weaklysuperviseddl_tpu_torch.losses.window import boundary_loss, local_normalized_cut_loss
from weaklysuperviseddl_tpu_torch.ops.refine import PLANS, refine_cuda, refine_plain
from weaklysuperviseddl_tpu_torch.train.alternating import _sweep_index_table, make_refine_sweep
from weaklysuperviseddl_tpu_torch.train.refine import refine_from_soft_predictions
from weaklysuperviseddl_tpu_torch.train.segmentation import _normalize_images


@pytest.fixture
def single_torch_thread():
    """One intra-op thread while the test runs: these tests run thousands of
    small CPU ops, and with several test workers on the host, torch's default
    of one thread per core oversubscribes it many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _case(seed=0, B=2, H=16, W=16, C=2):
    rng = np.random.default_rng(seed)
    S = rng.uniform(0.1, 1, (B, H, W, C)).astype(np.float32)
    S /= S.sum(-1, keepdims=True)
    images = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    masks = rng.integers(0, C, (B, H, W)).astype(np.int32)
    return S, images, masks


@pytest.mark.parametrize("window", [3, 5])
def test_window_losses_match_jax(window):
    rng = np.random.default_rng(1)
    preds = rng.standard_normal((2, 12, 15, 3)).astype(np.float32)
    images = rng.uniform(0, 1, (2, 12, 15, 3)).astype(np.float32)
    probs = np.asarray(torch.softmax(torch.from_numpy(preds), -1))
    got = local_normalized_cut_loss(torch.from_numpy(preds), torch.from_numpy(images),
                                    sigma_color=0.1, window_size=window)
    want = jax_ncut(jnp.asarray(preds), jnp.asarray(images), sigma_color=0.1, window_size=window)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    got = boundary_loss(torch.from_numpy(probs), torch.from_numpy(images), window_size=window)
    want = jax_boundary(jnp.asarray(probs), jnp.asarray(images), window_size=window)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 20, 24)])
@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("loss", ["ncut", "boundary"])
def test_plain_refinement_matches_jax_xla_path(loss, C, shape):
    """Masks equal and loss rtol 1e-4, the tolerance the JAX package holds its
    Pallas kernel to against this XLA path."""
    S, images, masks = _case(0, *shape, C)
    want_m, want_l = jax_refine(jnp.asarray(S), jnp.asarray(images), jnp.asarray(masks),
                                num_steps=6, loss=loss, use_pallas=False)
    got_m, got_l = refine_plain(torch.from_numpy(S), torch.from_numpy(images),
                                torch.from_numpy(masks), num_steps=6, loss=loss)
    assert got_m.dtype == torch.uint8 and got_m.shape == shape
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)


@pytest.mark.parametrize("loss", ["ncut", "boundary"])
def test_plain_refinement_matches_jax_where_masks_move(loss):
    """At the path's lr (1e-2) a logit moves about lr per step, too little for
    a one-hot start to cross the threshold in a few steps; at lr 0.2 many
    pixels flip, so mask equality tests the optimisation itself."""
    S, images, masks = _case(3, 2, 16, 16, 2)
    kw = dict(num_steps=8, lr=0.2, loss=loss)
    want_m, want_l = jax_refine(jnp.asarray(S), jnp.asarray(images), jnp.asarray(masks),
                                use_pallas=False, **kw)
    got_m, got_l = refine_plain(torch.from_numpy(S), torch.from_numpy(images),
                                torch.from_numpy(masks), **kw)
    assert (got_m.numpy() != masks).mean() > 0.1
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)


@pytest.mark.parametrize("plan", PLANS)
def test_refinement_matches_every_jax_plan(plan):
    """The port's refinement on the CPU (the plain version, the golden of
    every plan of the kernel) against each plan of the JAX package's Pallas
    kernel in interpret mode: masks equal, loss rtol 1e-4. At lr 0.2 many
    pixels leave their one-hot start, so equal masks test the optimisation."""
    S, images, masks = _case(4, 1, 16, 16, 2)
    want_m, want_l = pallas_refine(jnp.asarray(S), jnp.asarray(images), jnp.asarray(masks),
                                   num_steps=6, lr=0.2, interpret=True, plan=plan)
    got_m, got_l = refine_from_soft_predictions(torch.from_numpy(S), torch.from_numpy(images),
                                                torch.from_numpy(masks), num_steps=6, lr=0.2)
    assert (got_m.numpy() != masks).mean() > 0.1
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)


def test_plan_checks_match_jax():
    """"v1sym" needs C=2, in the JAX kernel and in the port; the port also
    refuses a plan it does not know, before it looks at the tensors."""
    S, images, masks = _case(5, 1, 16, 16, 3)
    with pytest.raises(ValueError, match="v1sym"):
        pallas_refine(jnp.asarray(S), jnp.asarray(images), jnp.asarray(masks), num_steps=1,
                      interpret=True, plan="v1sym")
    args = [torch.from_numpy(a) for a in (S, images, masks)]
    for fn in (refine_cuda, refine_plain):
        with pytest.raises(ValueError, match="v1sym"):
            fn(*args, num_steps=1, plan="v1sym")
        with pytest.raises(ValueError, match="unknown refinement plan"):
            fn(*args, num_steps=1, plan="v3")
    before = dict(refine_cuda.plan_launches)
    refine_plain(*args, num_steps=1, plan="v2_aff")
    assert refine_cuda.plan_launches == before


def test_plain_refinement_follows_predictions():
    """With λ=0 the KL term pulls X toward S's argmax (the JAX package's
    functional check, test_refine.test_refinement_moves_toward_predictions)."""
    rng = np.random.default_rng(1)
    target = (rng.uniform(0, 1, (1, 12, 12)) > 0.5).astype(np.int32)
    S = np.stack([1 - target, target], axis=-1).astype(np.float32) * 0.98 + 0.01
    images = rng.uniform(0, 1, (1, 12, 12, 3)).astype(np.float32)
    refined, _ = refine_plain(torch.from_numpy(S), torch.from_numpy(images),
                              torch.from_numpy(1 - target), lambda_boundary=0.0, lr=0.5,
                              num_steps=60)
    assert (refined.numpy() == target).mean() > 0.95


def test_refine_on_cpu_tensors_takes_the_plain_version():
    S, images, masks = (torch.from_numpy(a) for a in _case(2))
    before = refine_cuda.launches
    got = refine_from_soft_predictions(S, images, masks, num_steps=3)
    want = refine_plain(S, images, masks, num_steps=3)
    assert refine_cuda.launches == before
    assert torch.equal(got[0], want[0]) and float(got[1]) == float(want[1])
    with pytest.raises(ValueError, match="CUDA"):
        refine_cuda(S, images, masks)
    assert refine_cuda.launches == before


def test_resident_sweep_equals_direct_refinement_and_jax():
    """One sweep over resident arrays (ragged tail padded) writes back what a
    direct refinement of each batch gives; masks agree with the JAX sweep
    under the same DeepLabV3 weights."""
    model, variables = jax_deeplab_numpy(18, 0.25, seed=1)
    port = port_from_jax(variables, 18, 0.25)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (5, 48, 48, 3)).astype(np.uint8)
    masks = rng.integers(0, 2, (5, 64, 64)).astype(np.uint8)
    cfg = RefineConfig(num_steps=3)
    table = _sweep_index_table(5, 2)
    assert table.tolist() == [[0, 1], [2, 3], [4, 4]]

    dev_masks = torch.from_numpy(masks.copy())
    total = make_refine_sweep(port, cfg, seg_size=64)(dev_masks, torch.from_numpy(images),
                                                      torch.from_numpy(table))
    with torch.no_grad():
        x, _ = preprocess_batch(torch.from_numpy(images), None, size=64)
        x = _normalize_images(x)
        S = torch.softmax(port(x.permute(0, 3, 1, 2)), dim=1).permute(0, 2, 3, 1)
    direct, losses = [], 0.0
    for rows in ([0, 1], [2, 3], [4, 4]):
        m, loss = refine_from_soft_predictions(S[rows].contiguous(), x[rows].contiguous(),
                                               torch.from_numpy(masks[rows]), num_steps=3)
        direct.append(m[: len(set(rows))])
        losses += float(loss)
    assert torch.equal(dev_masks, torch.cat(direct))
    np.testing.assert_allclose(float(total), losses, rtol=1e-6)

    sweep = jax_make_sweep(model, JaxRefineConfig(num_steps=3, use_pallas=False), seg_size=64)
    want, want_total = sweep(variables["params"], variables["batch_stats"], jnp.asarray(masks),
                             jnp.asarray(images), jnp.asarray(table.astype(np.int32)))
    assert (dev_masks.numpy() == np.asarray(want)).mean() >= 0.99
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-3)


def test_refine_store_writes_the_sweep_back():
    """The standalone entry point: upload (masks nearest-resized to
    ``seg_size``), sweep, and the refined masks written back to the store."""
    from weaklysuperviseddl_tpu_torch.data.mask_store import MaskStore
    from weaklysuperviseddl_tpu_torch.train.alternating import refine_store, upload_store_resident

    _, variables = jax_deeplab_numpy(18, 0.25, seed=1)
    port = port_from_jax(variables, 18, 0.25)
    rng = np.random.default_rng(7)
    store = MaskStore()
    for i in range(3):
        store.put(f"{i:05d}", rng.integers(0, 256, (48, 48, 3)).astype(np.uint8),
                  rng.integers(0, 2, (48, 48)).astype(np.uint8))
    cfg = RefineConfig(num_steps=3, lr=0.2)
    images, masks, keys = upload_store_resident(store, seg_size=64)
    assert masks.shape == (3, 64, 64) and keys == ["00000", "00001", "00002"]
    make_refine_sweep(port, cfg, seg_size=64)(masks, images,
                                              torch.from_numpy(_sweep_index_table(3, 2)))
    refine_store(port, store, cfg, seg_size=64, batch_size=2)
    np.testing.assert_array_equal(store.as_arrays()[1], masks.numpy())
