"""The port's ('data', 'model') mesh against the JAX package's on the same
weights (bridged by ``models/jax_import.py``) and inputs: the shape rules,
the tensor-parallel leaves, the sharded segmentation step at data 4 × model 1
and data 2 × model 2 (against the port's one-device step and JAX's mesh
step, JAX's tests/test_train.py tolerances), the guard's mesh-wide decision,
the data-parallel epoch with a ragged tail (against JAX's, and in chunks of
2 against step by step) and the sharded eval (against the counters and
JAX's). Data-parallel serving is in ``test_torch_mesh_serving.py``.

The port's side runs in gloo groups of 4 CPU processes, one group per mesh
shape, started once per module (``tests/torch_mesh_cases.py``), while this
process computes JAX's side on the virtual CPU devices of conftest.py."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_deeplab_numpy
from test_torch_segmentation import _NoDropout
from torch_mesh_cases import SGD, seg_cases

from weaklysuperviseddl_tpu.models.deeplabv3 import DeepLabV3 as JaxDeepLabV3
from weaklysuperviseddl_tpu.parallel import mesh as jax_mesh
from weaklysuperviseddl_tpu.train.segmentation import SegTrainState as JaxSegTrainState
from weaklysuperviseddl_tpu.train.segmentation import (
    evaluate_segmentation_sharded as jax_evaluate_sharded,
)
from weaklysuperviseddl_tpu.train.segmentation import make_seg_train_step
from weaklysuperviseddl_tpu.train.segmentation import (
    train_segmentation_model as jax_train_segmentation_model,
)
from weaklysuperviseddl_tpu_torch.config import MeshConfig
from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.models.jax_import import deeplab_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.parallel.mesh import (
    Ranks,
    make_mesh,
    mesh_from_config,
    tp_leaf_sharding,
)
from weaklysuperviseddl_tpu_torch.train.segmentation import SegTrainState, seg_train_step
from weaklysuperviseddl_tpu_torch.utils.metrics import binary_confusion_counts, finish_iou_and_acc

SHAPES = [(4, 1), (2, 2)]
SIZE = 32


def _state_numpy(variables) -> dict:
    return {k: v.numpy() for k, v in deeplab_state_dict_from_jax(variables).items()}


def _jax_mesh(data, model):
    return jax_mesh.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])


def _jax_sgd_state(mesh, variables, tx):
    params = jax_mesh.shard_params_tp(mesh, variables["params"])
    return JaxSegTrainState(params, jax_mesh.replicate_tree(mesh, variables["batch_stats"]),
                            jax_mesh.shard_params_tp(mesh, tx.init(params)))


def _jax_references(model, variables, step, epoch, evaluation) -> dict:
    """JAX's mesh step at each shape, its data-parallel epoch at 2 × 2 and
    its sharded eval at 4 × 1 (dropout the identity, SGD)."""
    tx = optax.sgd(1e-2)
    train_step = make_seg_train_step(model, tx)
    out = {}
    x, m, v = step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        for data, model_axis in SHAPES:
            mesh = _jax_mesh(data, model_axis)
            st = _jax_sgd_state(mesh, variables, tx)
            put = lambda a: jax.device_put(a, jax_mesh.batch_sharding(mesh, a.ndim))  # noqa: E731
            p, s, _, loss = train_step(st.params, st.batch_stats, st.opt_state, put(x), put(m),
                                       put(v), jax.random.PRNGKey(7))
            out[data, model_axis] = (float(loss), _state_numpy({"params": p, "batch_stats": s}))
        mesh = _jax_mesh(2, 2)
        ep_images, ep_masks, batch, epochs, seed = epoch
        st, loss = jax_train_segmentation_model(
            model, _jax_sgd_state(mesh, variables, tx), tx, ep_images, ep_masks,
            num_epochs=epochs, batch_size=batch, seg_size=SIZE, seed=seed, mesh=mesh,
            steps_per_dispatch=1, log=lambda *a: None)
        out["epoch"] = (loss, _state_numpy({"params": st.params,
                                            "batch_stats": st.batch_stats}))
        mesh = _jax_mesh(4, 1)
        out["eval"] = jax_evaluate_sharded(model, _jax_sgd_state(mesh, variables, tx),
                                           jnp.asarray(evaluation[0]),
                                           jnp.asarray(evaluation[1]), mesh)
    return out


@pytest.fixture(scope="module")
def runs():
    """Both gloo groups start first; JAX's references are computed while
    they run."""
    model, variables = jax_deeplab_numpy(18, 0.25, size=SIZE)
    weights = _state_numpy(variables)
    rng = np.random.default_rng(0)
    step = (rng.uniform(-1, 1, (8, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, 2, (8, SIZE, SIZE)).astype(np.int32),
            np.arange(8) < 7)                                   # a padded last row
    # 19 pets at batch 8 on 2 shards: 10 a shard (one wrap-around row), local
    # batch 4, each shard's last step 2 rows and 2 repeats. (With one real row
    # a shard in a step, the ASPP's pooled BatchNorm sees two distinct values
    # a channel; where they nearly agree its variance nears 0 and float noise
    # grows 1e3-fold a step: JAX's own 2x2 and 2x1 meshes then part by 5e-3.)
    ep_images = rng.uniform(0, 255, (19, SIZE, SIZE, 3)).astype(np.uint8)
    ep_masks = np.zeros((19, SIZE, SIZE), np.uint8)
    ep_masks[:, :, :SIZE // 2] = 1
    ep_images[:, :, :SIZE // 2] //= 2
    epoch = (ep_images, ep_masks, 8, 2, 11)
    evaluation = (rng.uniform(-1, 1, (8, SIZE, SIZE, 3)).astype(np.float32),
                  rng.integers(0, 2, (8, SIZE, SIZE)).astype(np.int32))
    groups = {(4, 1): Ranks(seg_cases, 4, "cpu", 4, 1, weights, step, None, evaluation),
              (2, 2): Ranks(seg_cases, 4, "cpu", 2, 2, weights, step, epoch, None)}
    try:
        jax_ref = _jax_references(model, variables, step, epoch, evaluation)
    finally:
        port = {shape: g.join() for shape, g in groups.items()}
    return {"weights": weights, "step": step, "evaluation": evaluation, "jax": jax_ref,
            "port": port}


def _one_device_step(weights, step):
    model = DeepLabV3(2, 18, 0.25)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    model.classifier[0].project[3].p = 0.0
    state = SegTrainState(model, SGD(model.parameters()))
    loss = seg_train_step(state, *(torch.from_numpy(a) for a in step))
    return float(loss), {k: v.numpy() for k, v in model.state_dict().items()}


def _assert_state_close(got: dict, want: dict, what: str, param_atol=1e-6):
    """Parameters within JAX's mesh-test tolerances (rtol 1e-3, atol 1e-6);
    BatchNorm's running statistics within 1e-5; its counters equal."""
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=param_atol,
                                       err_msg=f"{what} {k}")


def test_make_mesh_keeps_jax_shape_rules():
    cpu = [torch.device("cpu")] * 8
    mesh = make_mesh(devices=cpu)
    assert mesh.shape == {"data": 8, "model": 1} and not mesh.distributed
    mesh = make_mesh(data=-1, model=2, devices=cpu)
    assert mesh.shape == {"data": 4, "model": 2} and len(mesh.data_devices) == 4
    with pytest.raises(ValueError, match="8 devices not divisible by model=3"):
        make_mesh(model=3, devices=cpu)
    with pytest.raises(ValueError, match="mesh 2x2 != 8 devices"):
        make_mesh(data=2, model=2, devices=cpu)


@pytest.mark.parametrize("mesh_cfg,shape", [
    (MeshConfig(), None),
    (MeshConfig(data=1), None),
    (MeshConfig(data=2), "mesh 2x1 != 1 devices"),
    (MeshConfig(model=2), "1 devices not divisible by model=2"),
])
def test_mesh_from_config_on_one_device(mesh_cfg, shape):
    """JAX's rule on one device: no mesh (the one-device path) without a
    model axis; a mesh larger than the device raises."""
    if shape is None:
        assert mesh_from_config(mesh_cfg, "cpu") is None
    else:
        with pytest.raises(ValueError, match=shape):
            mesh_from_config(mesh_cfg, "cpu")


@pytest.mark.parametrize("depth,width", [(18, 0.25), (50, 1.0)])
def test_tp_leaf_sharding_picks_jax_leaves(depth, width):
    """The port shards dim 0 (output channels) of exactly the weights whose
    flax kernels JAX shards on their last axis, at the smoke and the full
    width (min_channels 64, model axis 2)."""
    jmesh = _jax_mesh(2, 2)
    model = JaxDeepLabV3(num_classes=2, backbone_depth=depth, width_multiplier=width)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))

    def flag(leaf):
        spec = jax_mesh.tp_leaf_sharding(jmesh, leaf).spec
        return np.full(leaf.shape, float("model" in spec), np.float32)

    flags = deeplab_state_dict_from_jax({"params": jax.tree.map(flag, shapes["params"]),
                                         "batch_stats": jax.tree.map(
                                             lambda x: np.zeros(x.shape, np.float32),
                                             shapes["batch_stats"])})
    want = {k for k, v in flags.items() if v.numel() and bool(v.reshape(-1)[0])}
    mesh = make_mesh(data=2, model=2, devices=[torch.device("cpu")] * 4)
    port = DeepLabV3(2, depth, width)
    got = {k for k, p in port.named_parameters() if tp_leaf_sharding(mesh, p) == 0}
    assert want and got == want


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_one_device_and_jax(runs, shape):
    port = runs["port"][shape]
    loss, state = port[0]["step_loss"], port[0]["step_state"]
    assert all(r["step_loss"] == loss for r in port)     # every rank holds the global loss
    ref_loss, ref_state = _one_device_step(runs["weights"], runs["step"])
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    _assert_state_close(state, ref_state, "one-device")
    jax_loss, jax_state = runs["jax"][shape]
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-5)
    _assert_state_close(state, jax_state, "JAX")
    assert sorted(r["index"] for r in port) == sorted(
        (d, m) for d in range(shape[0]) for m in range(shape[1]))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_guard_skips_on_every_rank_when_one_rank_is_not_finite(runs, shape):
    """Rank 1's gradients (under TP its shards) are not finite, the others'
    are: every rank skips the step, so the replicas never part."""
    for r in runs["port"][shape]:
        assert r["guard"] == {"applied_steps": 0, "notfinite": 1, "moved": 0.0}, r["rank"]


def test_data_parallel_epoch_matches_jax(runs):
    """Two epochs over 19 pets at batch 8 on data 2 × model 2: wrap-around
    padding, per-shard permutations and the ragged per-shard tail, as JAX's
    (its tests/test_train.py holds the DP epoch at atol 2e-5)."""
    port = runs["port"][2, 2][0]
    jax_loss, jax_state = runs["jax"]["epoch"]
    assert port["epoch_steps"] == 2 * 3
    np.testing.assert_allclose(port["epoch_loss"], jax_loss, rtol=1e-5)
    for k, want in jax_state.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(port["epoch_state"][k], want, atol=2e-5, err_msg=k)


def test_data_parallel_chunked_epoch_matches_per_step(runs):
    """JAX's test_dp_chunked_epoch_matches_per_step on the port, exact: the
    same two epochs in chunks of 2 (a chunk and a partly valid single step an
    epoch) and step by step give the same bits on every rank. A mesh of more
    than one rank runs a chunk's steps op by op, so this holds the per-shard
    tables, their split into a chunk and a tail and the global step's
    dropout keys; graphs are a one-rank path (test_torch_cuda.py)."""
    for port in runs["port"][2, 2]:
        assert port["epoch_steps"] == port["per_step_steps"] == 2 * 3
        assert port["epoch_loss"] == port["per_step_loss"]
        for k, want in port["per_step_state"].items():
            np.testing.assert_array_equal(port["epoch_state"][k], want, err_msg=k)


def test_sharded_eval_matches_counters_and_jax(runs):
    iou, acc = runs["port"][4, 1][0]["eval"]
    model = DeepLabV3(2, 18, 0.25).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in runs["weights"].items()})
    images, true_fg = (torch.from_numpy(a) for a in runs["evaluation"])
    with torch.no_grad():
        preds = model(images.permute(0, 3, 1, 2)).argmax(dim=1)
    ref_iou, ref_acc = finish_iou_and_acc(binary_confusion_counts(preds, true_fg))
    np.testing.assert_allclose(iou, float(ref_iou), rtol=1e-6)
    np.testing.assert_allclose(acc, float(ref_acc), rtol=1e-6)
    jax_iou, jax_acc = runs["jax"]["eval"]
    # the two frameworks' logits may order a near-tie differently: 1e-3 is 8 pixels
    np.testing.assert_allclose([iou, acc], [jax_iou, jax_acc], atol=1e-3)


