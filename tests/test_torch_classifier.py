"""Port parity: the CAM classifier (weight bridge, logits), fc-only training
on cached features, classification metrics and the CE, against the JAX
package with the same weights and inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaklysuperviseddl_tpu.data.dataset import load_split_data as jax_split
from weaklysuperviseddl_tpu.data.loader import batches as jax_batches
from weaklysuperviseddl_tpu.losses.basic import per_example_nll as jax_nll
from weaklysuperviseddl_tpu.models.classifier import CamClassifier as JaxCamClassifier
from weaklysuperviseddl_tpu.models.torch_import import cam_classifier_variables
from weaklysuperviseddl_tpu.train.classifier import evaluate_classification as jax_eval_cls
from weaklysuperviseddl_tpu.train.classifier import train_fc_only as jax_train_fc
from weaklysuperviseddl_tpu.utils import metrics as jm
from weaklysuperviseddl_tpu_torch.data.dataset import load_split_data
from weaklysuperviseddl_tpu_torch.data.loader import batches
from weaklysuperviseddl_tpu_torch.losses.basic import per_example_nll
from weaklysuperviseddl_tpu_torch.models.classifier import CamClassifier
from weaklysuperviseddl_tpu_torch.models.jax_import import cam_classifier_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.train.classifier import evaluate_classification, train_fc_only
from weaklysuperviseddl_tpu_torch.utils import metrics as tm


def _quiet(*_):
    pass


@functools.lru_cache(maxsize=None)
def jax_classifier_numpy(depth=18, width=0.25, num_classes=37, seed=0, size=64):
    """A JAX CamClassifier and random numpy variables in its own tree (traced,
    not run), with non-trivial BN statistics. Cached; tests never write to it."""
    model = JaxCamClassifier(num_classes=num_classes, depth=depth, width_multiplier=width)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":  # LeCun normal over the fan-in
            value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "var":
            value = rng.uniform(0.75, 1.25, shape)
        elif name == "scale":
            value = rng.uniform(0.8, 1.2, shape)
        else:
            value = 0.1 * rng.standard_normal(shape)
        return value.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def port_classifier(variables, depth=18, width=0.25, num_classes=37):
    port = CamClassifier(num_classes=num_classes, depth=depth, width_multiplier=width)
    port.load_state_dict(cam_classifier_state_dict_from_jax(variables), strict=True)
    return port.eval()


def test_classifier_weight_bridge_round_trips_exactly():
    _, variables = jax_classifier_numpy()
    back = cam_classifier_variables(port_classifier(variables).state_dict())
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_classifier_logits_and_features_match_jax():
    model, variables = jax_classifier_numpy()
    port = port_classifier(variables)
    port.train()  # BN stays in eval, as in the JAX model
    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want_logits, want_feats = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-3, atol=2e-3)
    for got, want in zip(feats, want_feats):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=1e-3, atol=2e-3)


def test_fc_training_on_cached_features_matches_jax():
    """Two cached epochs from the same weights: fc params within 1e-5; the
    accuracy and macro-F1 of the trained classifiers equal."""
    model, variables = jax_classifier_numpy()
    port = port_classifier(variables)
    kw = dict(train_ratio=0.8, seed=0, synthetic_size=16, image_size=64, num_classes=37)
    tr, va = load_split_data(None, **kw)
    jtr, jva = jax_split(None, **kw)
    trained = jax_train_fc(
        model, variables,
        train_loader_fn=lambda: jax_batches(jtr, 4, shuffle=True, seed=0, pad_to_full=True),
        val_loader_fn=lambda: jax_batches(jva, 3), epochs=2, lr=1e-3, num_classes=37,
        image_size=64, cache_features=True, log=_quiet)
    train_fc_only(port, train_loader_fn=lambda: batches(tr, 4, shuffle=True, seed=0,
                                                        pad_to_full=True),
                  val_loader_fn=lambda: batches(va, 3), epochs=2, lr=1e-3, num_classes=37,
                  image_size=64, log=_quiet)
    np.testing.assert_allclose(port.fc.weight.detach().numpy().T,
                               np.asarray(trained["params"]["fc"]["kernel"]), atol=1e-5)
    np.testing.assert_allclose(port.fc.bias.detach().numpy(),
                               np.asarray(trained["params"]["fc"]["bias"]), atol=1e-5)
    want = jax_eval_cls(model, trained, jax_batches(jtr, 3), num_classes=37, image_size=64,
                        log=_quiet)
    got = evaluate_classification(port, batches(tr, 3), num_classes=37, image_size=64,
                                  log=_quiet)
    assert got == pytest.approx(want, abs=1e-5)


def test_metrics_and_nll_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 3, (2, 9, 11))
    true = rng.integers(0, 3, (2, 9, 11))
    for i in range(2):
        got = tm.compute_iou_and_acc(torch.from_numpy(pred[i]), torch.from_numpy(true[i]))
        want = jm.compute_iou_and_acc(jnp.asarray(pred[i]), jnp.asarray(true[i]))
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], rtol=1e-6)
    b_iou, b_acc = tm.compute_iou_and_acc(torch.from_numpy(pred), torch.from_numpy(true))
    want_b = jax.vmap(jm.compute_iou_and_acc)(jnp.asarray(pred), jnp.asarray(true))
    np.testing.assert_allclose(b_iou.numpy(), np.asarray(want_b[0]), rtol=1e-6)
    np.testing.assert_allclose(b_acc.numpy(), np.asarray(want_b[1]), rtol=1e-6)

    preds, labels = rng.integers(0, 5, 13), rng.integers(0, 5, 13)
    valid = rng.uniform(size=13) > 0.3
    got = tm.classification_counts(torch.from_numpy(preds), torch.from_numpy(labels), 5,
                                   torch.from_numpy(valid))
    want = jm.classification_counts(jnp.asarray(preds), jnp.asarray(labels), 5,
                                    jnp.asarray(valid))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose([float(v) for v in tm.finish_macro_f1(got)],
                               [float(v) for v in jm.finish_macro_f1(want)], rtol=1e-6)

    logits = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    lab = rng.integers(0, 2, (3, 4, 5))
    np.testing.assert_allclose(per_example_nll(torch.from_numpy(logits), torch.from_numpy(lab)),
                               np.asarray(jax_nll(jnp.asarray(logits), jnp.asarray(lab))),
                               rtol=1e-6, atol=1e-6)
