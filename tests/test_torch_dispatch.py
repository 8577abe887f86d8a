"""Port parity for JAX's chunked training dispatch: the epoch loop
with ``steps_per_dispatch`` against the JAX package's, the device-side
non-finite guard against ``apply_if_finite_fast``, Adam's float32 bias
correction against optax, snapshots with the counters as ints, and
``BoundedCache`` against JAX's, and the atomics-free backward of DeepLabV3's
upsample against torch's. On the CPU the port runs a chunk's steps op by op,
so the grouping tests here check the epoch table, the split into chunks and
a tail, and the dropout keys of the global step; the CUDA graphs (K = 8
against K = 1, and against the eager loop, bit for bit) are checked in
``test_torch_cuda.py``.

    python -m pytest tests/test_torch_dispatch.py -q
"""

import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_deeplab_numpy, port_from_jax
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from test_torch_segmentation import _NoDropout

from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import SegTrainState as JaxSegTrainState
from weaklysuperviseddl_tpu.train.segmentation import (
    train_segmentation_model as jax_train_segmentation_model,
)
from weaklysuperviseddl_tpu.utils.cache import BoundedCache as JaxBoundedCache
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3, seed_dropout
from weaklysuperviseddl_tpu_torch.models.jax_import import deeplab_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.ops.resize import _UpsampleBilinear, upsample_bilinear
from weaklysuperviseddl_tpu_torch.train import guard
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    SegTrainState,
    _prep,
    create_seg_state,
    dropout_seed,
    seg_train_step,
    train_segmentation_model,
)
from weaklysuperviseddl_tpu_torch.utils.cache import BoundedCache
from weaklysuperviseddl_tpu_torch.utils.checkpoint import (
    load_seg_state,
    restore_state,
    save_state,
    seg_state_tree,
)

pytestmark = pytest.mark.usefixtures("single_torch_thread")

N, S = 10, 32            # JAX's test sizes (tests/test_train.py:297-320)
quiet = lambda *a: None  # noqa: E731


def _dataset(seed=1):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (N, S, S, 3)).astype(np.uint8)
    masks = np.zeros((N, S, S), np.uint8)
    masks[:, :, : S // 2] = 1
    images[:, :, : S // 2] += 60
    return images, masks


def _tensors(state):
    opt = state.optimizer
    return [*state.model.parameters(), *state.model.buffers(), *opt.m, *opt.v, opt.count,
            opt.notfinite_count, opt.total_notfinite]


def _l2_and_max(a: dict, b: dict):
    d = [np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64) for k in a]
    return np.sqrt(sum((x * x).sum() for x in d)), max(np.abs(x).max() for x in d)


def test_chunked_epochs_match_jax(monkeypatch):
    """JAX's test_chunked_epoch_trains on both packages from one set of
    weights, dropout the identity: K = 2 over 5 batches of 2 (two chunks and
    a single step an epoch), state.step 5 after one epoch and 20 after three
    more, the last epoch's loss below the first's.

    The port's losses and parameters are held to JAX's K = 2 run within the
    distance that the grouping alone puts between JAX's own K = 2 and K = 1
    runs (three times it for each call's loss, twice it for the parameters'
    L2 distance and largest difference). At batch 2 the ASPP's pooled
    BatchNorm normalises over two values a channel, which makes float noise
    grow a few-fold a step (ROADMAP.md queue 3), so the per-step tolerances
    of test_torch_segmentation.py (loss rtol 1e-5, parameters 1e-5) do not
    hold over 20 steps even between JAX's own runs: they part by about 1e-4
    of the loss after 5 steps and 1e-3 of a parameter after 20."""
    model, variables = jax_deeplab_numpy(18, 0.25, size=S)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    images, masks = _dataset()
    tx = apply_if_finite_fast(optax.adam(1e-4))   # one tx: both runs share JAX's programs
    names = [n for n, _ in port_from_jax(variables, 18, 0.25).named_parameters()]

    def jax_run(K):
        params = jax.tree.map(jnp.asarray, variables["params"])
        jstate = JaxSegTrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                                  tx.init(params))
        losses = []
        for epochs, steps in ((1, 5), (3, 20)):
            jstate, loss = jax_train_segmentation_model(
                model, jstate, tx, images, masks, num_epochs=epochs, batch_size=2,
                seg_size=S, steps_per_dispatch=K, log=quiet)
            assert jstate.step == steps
            losses.append(float(loss))
        back = deeplab_state_dict_from_jax({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats})
        return losses, {n: back[n].numpy() for n in names}

    port = port_from_jax(variables, 18, 0.25)
    port.classifier[0].project[3] = torch.nn.Identity()
    state = SegTrainState(port, GuardedAdam(port.parameters(), lr=1e-4))
    losses = []
    for epochs, steps in ((1, 5), (3, 20)):
        state, loss = train_segmentation_model(state, images, masks, num_epochs=epochs,
                                               batch_size=2, seg_size=S, steps_per_dispatch=2,
                                               log=quiet)
        assert state.step == steps
        losses.append(loss)
    assert int(state.optimizer.count) == 20 and losses[1] < losses[0]
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    (want, want_p), (alt, alt_p) = jax_run(2), jax_run(1)
    for g, w, a in zip(losses, want, alt):
        assert abs(g - w) <= 3 * abs(w - a) + 1e-5 * abs(w), (losses, want, alt)
    l2, largest = _l2_and_max(got, want_p)
    spread_l2, spread_largest = _l2_and_max(alt_p, want_p)
    assert l2 <= 2 * spread_l2 and largest <= 2 * spread_largest, \
        (l2, largest, spread_l2, spread_largest)


def _port_run(K, images, masks, epochs=2, start=None, batch=4):
    state = copy.deepcopy(start) if start is not None else create_seg_state(
        DeepLabV3(2, 18, 0.25), seed=5, lr=1e-3, device="cpu")
    state, loss = train_segmentation_model(state, images, masks, num_epochs=epochs,
                                           batch_size=batch, seg_size=S, seed=13,
                                           steps_per_dispatch=K, log=quiet)
    return state, loss


def test_chunk_grouping_changes_no_bit():
    """JAX's test_single_device_chunked_matches_per_step made exact, dropout
    on: K = 3 and K = 1 train to the same bits (parameters, statistics, the
    dropout key, Adam's moments and counters) and the same loss, since each
    step's dropout key is its global step's. On the CPU both run the steps
    op by op, so this holds the epoch table and its split into chunks and a
    tail; the graphs' grouping is test_torch_cuda.py's
    test_graphed_grouping_changes_no_bit."""
    images, masks = _dataset(9)
    a, loss_a = _port_run(3, images, masks)
    b, loss_b = _port_run(1, images, masks)
    assert a.step == b.step == 6 and loss_a == loss_b
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


def test_nan_step_inside_a_chunk_is_skipped():
    """A NaN image in the second step of a chunk of 3: K = 3 gives K = 1's
    bits, Adam applies the other two steps (count 2, one non-finite step),
    and the parameters and moments are those of steps 0 and 2 alone (the
    skipped step keeps them bit for bit)."""
    images, masks = _dataset(4)
    images = images[:6].astype(np.float32) / 255.0
    masks = masks[:6]
    order = np.random.default_rng(13).permutation(6)
    images[order[2]] = np.nan                      # step 1 is order[2:4]
    start = create_seg_state(DeepLabV3(2, 18, 0.25), seed=5, lr=1e-3, device="cpu")
    a, _ = _port_run(3, images, masks, epochs=1, start=start, batch=2)
    b, _ = _port_run(1, images, masks, epochs=1, start=start, batch=2)
    opt = a.optimizer
    assert (int(opt.count), int(opt.notfinite_count), int(opt.total_notfinite), a.step) == \
        (2, 0, 1, 3)
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a)[:len(opt.params)],
                                                 _tensors(b)[:len(opt.params)]))
    want = copy.deepcopy(start)                    # steps 0 and 2 alone, as the loop runs them
    x_all, m_all = torch.from_numpy(images), torch.from_numpy(masks)
    for t in (0, 2):
        idx = torch.from_numpy(order[2 * t:2 * t + 2])
        x, m = _prep(x_all[idx], m_all[idx], S)
        seed_dropout(want.model, dropout_seed(14, 0, t))
        seg_train_step(want, x, m, torch.ones(2, dtype=torch.bool))
    for x, y in zip([*opt.params, *opt.m, *opt.v],
                    [*want.optimizer.params, *want.optimizer.m, *want.optimizer.v]):
        assert torch.equal(x, y)


def _grad_sequence():
    """Gradients of two small tensors: finite, finite, NaN, finite, ±inf in
    one step (their sum NaN), finite, a lone -inf, finite."""
    rng = np.random.default_rng(0)
    seq = []
    for kind in ("ok", "ok", "nan", "ok", "infs", "ok", "-inf", "ok"):
        g = [rng.standard_normal((3, 4)).astype(np.float32),
             rng.standard_normal(5).astype(np.float32)]
        if kind == "nan":
            g[0][1, 2] = np.nan
        elif kind == "infs":
            g[0][0, 0], g[1][3] = np.inf, -np.inf
        elif kind == "-inf":
            g[1][0] = -np.inf
        seq.append(g)
    return seq


def _run_both(seq, limit=None, monkeypatch=None):
    """The port's GuardedAdam and JAX's apply_if_finite_fast(optax.adam) over
    ``seq`` from the same parameters; yields (port, jax params, jax state)
    after each step."""
    rng = np.random.default_rng(1)
    start = [rng.standard_normal((3, 4)).astype(np.float32),
             rng.standard_normal(5).astype(np.float32)]
    params = [torch.from_numpy(p.copy()).requires_grad_(True) for p in start]
    if limit is not None:
        monkeypatch.setattr(guard, "MAX_CONSECUTIVE_ERRORS", limit)
    opt = GuardedAdam(params, lr=1e-2)
    tx = apply_if_finite_fast(optax.adam(1e-2), max_consecutive_errors=limit or 100)
    jparams = [jnp.asarray(p) for p in start]
    jstate = tx.init(jparams)
    for g in seq:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()
        updates, jstate = tx.update([jnp.asarray(gi) for gi in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        yield opt, params, jparams, jstate


def _assert_same(opt, params, jparams, jstate):
    inner = jstate.inner_state[0]
    assert int(opt.count) == int(inner.count)
    assert int(opt.notfinite_count) == int(jstate.notfinite_count)
    assert int(opt.total_notfinite) == int(jstate.total_notfinite)
    for ours, theirs in ((params, jparams), (opt.m, inner.mu), (opt.v, inner.nu)):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-7, atol=0)


def test_device_guard_matches_jax_apply_if_finite_fast():
    """Step by step over finite, NaN and ±inf gradients: the port's counters
    (0-dim int32 tensors), Adam's count and moments and the parameters equal
    JAX's apply_if_finite_fast around optax.adam (within 2e-7 relative: the
    bias corrections 1 − β^t are float32 on both sides); a skipped step
    keeps the parameters and moments bit for bit."""
    before = None
    for i, (opt, params, jparams, jstate) in enumerate(_run_both(_grad_sequence())):
        assert opt.count.dtype == torch.int32 and opt.count.ndim == 0
        _assert_same(opt, params, jparams, jstate)
        now = [t.detach().clone() for t in (*params, *opt.m, *opt.v)]
        if i in (2, 4, 6):
            assert all(torch.equal(a, b) for a, b in zip(before, now))
        before = now
    assert (int(opt.count), int(opt.total_notfinite)) == (5, 3)


def test_escape_hatch_matches_jax(monkeypatch):
    """With a limit of 2: after two non-finite steps in a row the third is
    applied unprotected (NaN parameters), on both sides."""
    seq = _grad_sequence()
    nan = [g.copy() for g in seq[2]]
    for i, (opt, params, jparams, jstate) in enumerate(
            _run_both([seq[0], nan, nan, nan], limit=2, monkeypatch=monkeypatch)):
        if i < 3:
            _assert_same(opt, params, jparams, jstate)
    assert int(opt.notfinite_count) == int(jstate.notfinite_count) == 3
    assert int(opt.count) == int(jstate.inner_state[0].count) == 2
    assert torch.isnan(params[0]).any() and np.isnan(np.asarray(jparams[0])).any()


def test_adam_bias_correction_is_float32_as_optax():
    """The unguarded Adam over 6 steps against optax.adam, within 2e-7
    relative: the bias corrections are float32 on the parameters' device
    (float64 would differ from optax's by up to an ulp of the update)."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((64,)).astype(np.float32)
    p = torch.from_numpy(p0.copy()).requires_grad_(True)
    opt = guard.Adam([p], lr=3e-3)
    tx = optax.adam(3e-3)
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    for _ in range(6):
        g = rng.standard_normal((64,)).astype(np.float32) * 1e-3
        p.grad = torch.from_numpy(g)
        opt.step()
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
    bc1, bc2 = opt._bias_corrections(opt.count)
    assert bc1.dtype == bc2.dtype == torch.float32 and int(opt.count) == 6
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=2e-7, atol=0)
    np.testing.assert_allclose(opt.m[0].numpy(), np.asarray(js[0].mu), rtol=2e-7, atol=0)


def test_snapshot_with_int_counters_resumes_bit_equal(tmp_path):
    """A seg state tree with the optimizer's counters as Python ints (the
    snapshots written before they moved to the device) passes restore_state's
    check and loads; training on from it equals training on from the state
    it was taken from, bit for bit."""
    images, masks = _dataset(3)
    state, _ = _port_run(3, images, masks, epochs=1)
    tree = seg_state_tree(state)
    tree["optimizer"] = {**tree["optimizer"],
                         **{k: int(tree["optimizer"][k])
                            for k in ("count", "notfinite_count", "total_notfinite")}}
    save_state(str(tmp_path / "state.pt"), tree)
    fresh = create_seg_state(DeepLabV3(2, 18, 0.25), seed=9, lr=1e-3, device="cpu")
    resumed = load_seg_state(fresh, restore_state(str(tmp_path / "state.pt"),
                                                  seg_state_tree(fresh)))
    assert resumed.optimizer.count.dtype == torch.int32 and int(resumed.optimizer.count) == 3
    a, loss_a = train_segmentation_model(state, images, masks, num_epochs=1, batch_size=4,
                                         seg_size=S, seed=2, steps_per_dispatch=3, log=quiet)
    b, loss_b = train_segmentation_model(resumed, images, masks, num_epochs=1, batch_size=4,
                                         seg_size=S, seed=2, steps_per_dispatch=3, log=quiet)
    assert loss_a == loss_b and a.step == b.step == 6
    params_a = dict(a.model.named_parameters())
    assert all(torch.equal(params_a[n], p) for n, p in b.model.named_parameters())
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a)[len(params_a):],
                                                 _tensors(b)[len(params_a):]))


def test_bounded_cache_behaves_as_jax():
    """The same operations on both packages' BoundedCache give the same
    answers: LRU eviction at maxsize, get refreshing an entry, put replacing
    one, len, contains and clear."""
    ours, theirs = BoundedCache(maxsize=3), JaxBoundedCache(maxsize=3)
    ops = [("put", "a", 1), ("put", "b", 2), ("put", "c", 3), ("get", "a", None),
           ("put", "d", 4), ("get", "b", None), ("put", "a", 5), ("get", "a", None),
           ("put", "e", 6), ("get", "c", None), ("get", "d", None), ("len", None, None),
           ("contains", "e", None), ("contains", "b", None), ("clear", None, None),
           ("len", None, None), ("get", "e", None)]
    for op, key, value in ops:
        got = [getattr(c, op)(key, value) if op == "put" else getattr(c, op)(key)
               if op == "get" else len(c) if op == "len" else key in c if op == "contains"
               else c.clear() for c in (ours, theirs)]
        assert got[0] == got[1], (op, key, got)
    ours.put("x", 1)
    ours.discard("x")
    ours.discard("missing")
    assert "x" not in ours and len(ours) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(4, 4, 32, 32), (7, 5, 33, 17), (8, 9, 3, 5)])
def test_upsample_backward_is_the_adjoint(shape, dtype):
    """The card's backward of DeepLabV3's upsample (two float64 products with
    the interpolation's weight matrices, no atomics), run here on the CPU,
    against torch's own backward of ``F.interpolate``: the same values as
    the forward and gradients within 2e-6 of the largest; on the CPU
    ``upsample_bilinear`` is ``F.interpolate`` itself."""
    h, w, H, W = shape
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, h, w, dtype=dtype, generator=gen, requires_grad=True)
    want = torch.nn.functional.interpolate(x, (H, W), mode="bilinear", align_corners=False)
    g = torch.randn(want.shape, dtype=dtype, generator=gen)
    (want_gx,) = torch.autograd.grad(want, x, g)
    got = _UpsampleBilinear.apply(x, (H, W))
    (gx,) = torch.autograd.grad(got, x, g)
    assert torch.equal(got, want) and gx.dtype == dtype
    assert float((gx - want_gx).abs().max()) <= 2e-6 * float(want_gx.abs().max())
    assert torch.equal(upsample_bilinear(x, (H, W)), want)
