"""The supervised baseline and what it needs, against the JAX package: the
seeded dropout, DeepLabV3's bn_frozen mode, per_class_iou and mean_std, the
supervised and segmentation evaluators (on the same weights and numpy
inputs), run_supervised_training from the same initial weights, and the
CLI's ``supervised``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_deeplab_numpy, port_from_jax
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from test_torch_segmentation import _batch, _NoDropout, no_dropout  # noqa: F401  (fixture)

import weaklysuperviseddl_tpu.pipelines.supervised as jax_supervised
from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from weaklysuperviseddl_tpu.models.torch_import import deeplab_variables
from weaklysuperviseddl_tpu.train.guard import apply_if_finite_fast
from weaklysuperviseddl_tpu.train.segmentation import SegTrainState as JaxSegTrainState
from weaklysuperviseddl_tpu.train.segmentation import evaluate_multiclass as jax_eval_multiclass
from weaklysuperviseddl_tpu.train.segmentation import (
    evaluate_multiclass_dataset as jax_eval_multiclass_dataset,
)
from weaklysuperviseddl_tpu.train.segmentation import evaluate_segmentation as jax_eval_segmentation
from weaklysuperviseddl_tpu.train.segmentation import make_seg_train_step
from weaklysuperviseddl_tpu.utils.metrics import mean_std as jax_mean_std
from weaklysuperviseddl_tpu.utils.metrics import per_class_iou as jax_per_class_iou
import weaklysuperviseddl_tpu_torch.pipelines.supervised as supervised
from weaklysuperviseddl_tpu_torch.cli import main
from weaklysuperviseddl_tpu_torch.config import smoke_config
from weaklysuperviseddl_tpu_torch.data.dataset import download_data
from weaklysuperviseddl_tpu_torch.data.loader import batches
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3, Dropout, seed_dropout
from weaklysuperviseddl_tpu_torch.models.jax_import import deeplab_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.train.guard import GuardedAdam
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    SegTrainState,
    create_seg_state,
    dropout_seed,
    evaluate_multiclass,
    evaluate_multiclass_dataset,
    evaluate_segmentation,
    seg_train_step,
    train_segmentation_model,
)
from weaklysuperviseddl_tpu_torch.utils.metrics import mean_std, per_class_iou

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _pets(n=8, size=48):
    ds = download_data(None, split="trainval", synthetic_size=n, image_size=size)
    return np.stack(ds.images), np.stack([(t == 1).astype(np.uint8) for t in ds.trimaps])


def _train(seed, size=48):
    """Returns the trained state, the loss, and whether the training call left
    torch's global random state as it found it."""
    images, masks = _pets(size=size)
    state = create_seg_state(DeepLabV3(backbone_depth=18, width_multiplier=0.25), seed=0,
                             lr=1e-3, device="cpu")
    rng = torch.get_rng_state()
    state, loss = train_segmentation_model(state, images, masks, num_epochs=1, batch_size=4,
                                           seg_size=size, seed=seed, log=lambda s: None)
    return state, loss, torch.equal(rng, torch.get_rng_state())


def test_training_is_fixed_by_its_seed_alone():
    """Two runs with one seed give bit-equal parameters and statistics, though
    torch's global random state is drawn from between them; the training call
    draws nothing from it; another seed gives another run."""
    a, loss_a, untouched_a = _train(seed=3)
    torch.rand(1000)
    b, loss_b, untouched_b = _train(seed=3)
    assert untouched_a and untouched_b
    assert loss_a == loss_b
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    c, _, _ = _train(seed=4)
    assert not all(torch.equal(x, y) for x, y in zip(a.model.parameters(), c.model.parameters()))


def test_dropout_seed_is_a_fixed_mix():
    assert dropout_seed(1, 0, 0) == dropout_seed(1, 0, 0)
    seeds = {dropout_seed(s, e, t) for s in (0, 1) for e in range(3) for t in range(5)}
    assert len(seeds) == 30 and all(0 <= s < 2**64 for s in seeds)


@pytest.mark.parametrize("p", [0.5, 0.3])
def test_dropout_keeps_one_minus_p_and_scales(p):
    """nn.Dropout's function: a share of about 1 − p kept, each kept unit
    scaled by 1/(1 − p), the identity in eval mode; one seed, one mask."""
    model = DeepLabV3(backbone_depth=18, width_multiplier=0.25)
    drop = model.classifier[0].project[3]
    assert isinstance(drop, Dropout) and drop.p == 0.5 and not drop.state_dict()
    drop = Dropout(p).train()
    x = torch.rand(64, 100, 50) + 0.5
    drop.manual_seed(7, x.device)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=1e-6, atol=0)
    drop.manual_seed(7, x.device)
    assert torch.equal(drop(x), y)
    assert not torch.equal(drop(x), y)   # the stream goes on
    seed_dropout(model.train(), 7)   # on the device of the model's parameters
    twin = Dropout(0.5).train()
    twin.manual_seed(7, torch.device("cpu"))
    assert torch.equal(model.classifier[0].project[3](x), twin(x))
    assert torch.equal(drop.eval()(x), x)


def test_seg_bn_frozen_keeps_stats_and_trains():
    """As the JAX package's test of its bn_frozen: running statistics
    untouched by training, the BN affines still learn; the default mode still
    updates the statistics."""
    def run(bn_frozen):
        images, masks = _pets()
        state = create_seg_state(DeepLabV3(backbone_depth=18, width_multiplier=0.25,
                                           bn_frozen=bn_frozen), seed=0, lr=1e-3, device="cpu")
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, loss = train_segmentation_model(state, images, masks, num_epochs=2,
                                               batch_size=4, seg_size=48, log=lambda s: None)
        return before, state.model.state_dict(), loss

    before, after, loss = run(True)
    assert np.isfinite(loss)
    stats = [k for k in before if "running_" in k]
    assert len(stats) > 50
    assert all(torch.equal(before[k], after[k]) for k in stats)
    assert not torch.equal(before["classifier.2.weight"], after["classifier.2.weight"])
    before, after, _ = run(False)
    assert any(not torch.equal(before[k], after[k]) for k in stats)


def test_bn_frozen_ce_step_matches_jax(no_dropout):
    """One CE step of the bn_frozen model against the JAX package's, with the
    same weights and dropout the identity on both sides, at
    test_torch_segmentation.py's tolerances: loss rtol 1e-5, Adam's moments
    within 1e-3 of each tensor's largest value, parameters within 1e-5 where
    the gradient is zero or above 1e-6; the statistics unchanged on both
    sides. With the statistics frozen, more units sit at the ReLU's edge:
    0.66 % of the elements have 0 < |g| ≤ 1e-6 (0.06 % in the train-mode
    test), where float noise can flip Adam's first step, lr·sign(g); those
    are held to the 2·lr such a flip can give."""
    _, variables = jax_deeplab_numpy(18, 0.25)
    model = JaxDeepLabV3(num_classes=2, backbone_depth=18, width_multiplier=0.25,
                         bn_frozen=True)
    port = DeepLabV3(backbone_depth=18, width_multiplier=0.25, bn_frozen=True)
    port.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
    port.classifier[0].project[3] = torch.nn.Identity()
    images, masks, valid = _batch(4)
    tx = apply_if_finite_fast(optax.adam(1e-4))
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    w_params, w_stats, w_opt, w_loss = make_seg_train_step(model, tx)(
        params, stats, tx.init(params), jnp.asarray(images), jnp.asarray(masks),
        jnp.asarray(valid), jax.random.PRNGKey(0))
    state = SegTrainState(port, GuardedAdam(port.parameters(), lr=1e-4))
    loss = seg_train_step(state, torch.from_numpy(images), torch.from_numpy(masks),
                          torch.from_numpy(valid))
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-5)
    back = deeplab_variables(port.state_dict())
    for got, was, theirs in zip(jax.tree.leaves(back["batch_stats"]),
                                jax.tree.leaves(variables["batch_stats"]),
                                jax.tree.leaves(w_stats)):
        np.testing.assert_array_equal(np.asarray(got), was)
        np.testing.assert_array_equal(np.asarray(theirs), was)
    names = [n for n, _ in port.named_parameters()]
    adam = w_opt.inner_state[0]
    for ours, theirs in ((state.optimizer.m, adam.mu), (state.optimizer.v, adam.nu)):
        got = jax.tree.leaves(deeplab_variables(dict(zip(names, ours)))["params"])
        for g, w in zip(got, jax.tree.leaves(theirs)):
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-3 * np.abs(w).max())
    checked = total = 0
    for got, want, g in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(w_params),
                            jax.tree.leaves(adam.mu)):
        g = np.abs(np.asarray(g)) / 0.1
        sure = (g == 0) | (g > 1e-6)
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-5)
        np.testing.assert_allclose(got[~sure], want[~sure], atol=2e-4 + 1e-5)
        checked, total = checked + sure.sum(), total + sure.size
    assert checked / total > 0.99


@pytest.mark.parametrize("num_classes", [2, 3])
@pytest.mark.parametrize("with_valid", [False, True])
def test_per_class_iou_matches_jax(num_classes, with_valid):
    rng = np.random.default_rng(num_classes)
    preds = rng.integers(0, num_classes, (4, 9, 11))
    masks = rng.integers(0, 2, (4, 9, 11))           # class 2 absent from the truth
    valid = np.array([True, True, False, True]) if with_valid else None
    if with_valid:
        preds[2] = 0                                  # a padded row that would count
    want = jax_per_class_iou(jnp.asarray(preds), jnp.asarray(masks), num_classes,
                             valid=None if valid is None else jnp.asarray(valid))
    got = per_class_iou(torch.from_numpy(preds), torch.from_numpy(masks), num_classes,
                        valid=None if valid is None else torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    if with_valid:   # equal to slicing the padded row off
        keep = torch.from_numpy(valid)
        sliced = per_class_iou(torch.from_numpy(preds)[keep], torch.from_numpy(masks)[keep],
                               num_classes)
        for g, s in zip(got, sliced):
            np.testing.assert_allclose(g.numpy(), s.numpy(), atol=1e-6)


@pytest.mark.parametrize("values", [[0.5], [0.1, 0.4, 0.25], [1.0, 1.0]])
def test_mean_std_matches_jax(values):
    np.testing.assert_allclose(mean_std(values), jax_mean_std(values), atol=1e-6)


def _eval_case():
    model, variables = jax_deeplab_numpy(18, 0.25, seed=3)
    port = port_from_jax(variables, 18, 0.25)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (5, 56, 56, 3)).astype(np.uint8)
    trimaps = rng.integers(1, 4, (5, 56, 56)).astype(np.uint8)
    state = JaxSegTrainState(variables["params"], variables["batch_stats"], None)
    return model, state, port, images, trimaps


class _Set:
    """A dataset view over stacked arrays, for the port's loader."""

    def __init__(self, images, trimaps):
        self.images, self.trimaps = list(images), list(trimaps)
        self.labels = np.zeros(len(images), np.int64)

    def __len__(self):
        return len(self.images)


def test_multiclass_evaluators_match_jax():
    """evaluate_multiclass_dataset (padded last batch) and evaluate_multiclass
    (a loader) against the JAX package's, within 1e-5."""
    model, state, port, images, trimaps = _eval_case()
    want = jax_eval_multiclass_dataset(model, state, jnp.asarray(images), jnp.asarray(trimaps),
                                       batch_size=3, seg_size=64)
    got = evaluate_multiclass_dataset(port, images, trimaps, batch_size=3, seg_size=64)
    np.testing.assert_allclose(got, want, atol=1e-5)
    loader = list(batches(_Set(images, trimaps), 2, pad_to_full=True))
    want = jax_eval_multiclass(model, state, loader, seg_size=64)
    got = evaluate_multiclass(port, loader, seg_size=64)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("binarize", ["fg1", "shifted_inverted"])
def test_evaluate_segmentation_matches_jax(binarize):
    model, state, port, images, trimaps = _eval_case()
    loader = list(batches(_Set(images, trimaps), 2, pad_to_full=True))
    want = jax_eval_segmentation(model, state, loader, seg_size=64, eval_size=48,
                                 binarize=binarize)
    got = evaluate_segmentation(port, loader, seg_size=64, eval_size=48, binarize=binarize)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_supervised_training_matches_jax(monkeypatch, no_dropout):
    """run_supervised_training for 1 epoch from the JAX package's initial
    weights (bridged by patching each package's create_seg_state), dropout the
    identity: the summed epoch loss within rtol 1e-4 of JAX's, and the
    port's metrics within 1e-5 of the JAX evaluation of the same final
    weights."""
    cfg = smoke_config()
    _, variables = jax_deeplab_numpy(18, 0.25)

    def jax_start(model, rng, input_size, lr, **kw):
        tx = apply_if_finite_fast(optax.adam(lr))
        params = jax.tree.map(jnp.asarray, variables["params"])
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
        return JaxSegTrainState(params, stats, tx.init(params)), tx

    def port_start(model, seed, lr, device=None):
        model.load_state_dict(deeplab_state_dict_from_jax(variables), strict=True)
        model.classifier[0].project[3] = torch.nn.Identity()
        return SegTrainState(model.to(device), GuardedAdam(model.parameters(), lr=lr))

    losses = {}

    def recording(name, train):
        def wrapped(*args, **kw):
            out = train(*args, **kw)
            losses[name] = out[1]
            return out
        return wrapped

    monkeypatch.setattr(jax_supervised, "create_seg_state", jax_start)
    monkeypatch.setattr(jax_supervised, "train_segmentation_model",
                        recording("jax", jax_supervised.train_segmentation_model))
    monkeypatch.setattr(supervised, "create_seg_state", port_start)
    monkeypatch.setattr(supervised, "train_segmentation_model",
                        recording("port", supervised.train_segmentation_model))
    import weaklysuperviseddl_tpu.config as jax_config

    jax_cfg = jax_config.smoke_config()
    _, want = jax_supervised.run_supervised_training(jax_cfg, num_epochs=1, test_runs=1,
                                                     log=lambda s: None)
    logs = []
    state, got = supervised.run_supervised_training(cfg, num_epochs=1, test_runs=2,
                                                    log=logs.append, device="cpu")
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    assert set(got) == set(want) == {"acc_mean", "acc_std", "iou_mean", "iou_std"}
    assert got["acc_std"] == got["iou_std"] == 0.0
    assert any("Final Test Results:" in s for s in logs)

    # the JAX evaluation of the port's final weights, on the same test set
    back = deeplab_variables(state.model.state_dict())
    jax_model = JaxDeepLabV3(num_classes=2, backbone_depth=18, width_multiplier=0.25)
    test_images, test_trimaps = (a.numpy() for a in supervised.load_test_arrays(cfg, "cpu"))
    acc, iou = jax_eval_multiclass_dataset(
        jax_model, JaxSegTrainState(back["params"], back["batch_stats"], None),
        jnp.asarray(test_images), jnp.asarray(test_trimaps), batch_size=cfg.data.eval_batch_size,
        seg_size=cfg.data.seg_size)
    np.testing.assert_allclose([got["acc_mean"], got["iou_mean"]], [acc, iou], atol=1e-5)


def test_supervised_smoke_cli(capsys):
    assert main(["supervised", "--smoke", "--device", "cpu", "--seg.epochs", "1"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) == {"acc_mean", "acc_std", "iou_mean", "iou_std"}
    assert 0.0 <= metrics["iou_mean"] <= 1.0 and 0.0 <= metrics["acc_mean"] <= 1.0
    assert metrics["iou_std"] == 0.0
