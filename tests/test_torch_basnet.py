"""BASNet in the port against the JAX package: the model (eight maps in eval
mode, one training-mode forward's running statistics), the hybrid loss, the
weight bridge both ways and the demo's record. One training step is in
``test_torch_basnet_step.py``; the cosine schedule, a ``basnet.pth`` file
through both ``build_basnet``s, ``run_inference`` on the same pets and the
CLI's ``basnet`` in ``test_torch_basnet_infer.py``.

Weights go from the port to JAX: the port's ``state_dict()`` through the JAX
package's own importer (``torch_to_flax``). Flax's ``BASNet.init`` runs op by
op for 40-100 s on a CPU, so it is never called; every JAX forward is jit'd
once and shared through module-scoped fixtures."""

import builtins
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_basnet_train import _naive_ssim
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from torch_bridge import host_state, jax_tree

import weaklysuperviseddl_tpu.train.basnet as jax_train
from weaklysuperviseddl_tpu.models.basnet import BASNet as JaxBASNet
from weaklysuperviseddl_tpu.models.resnet import BasicBlockDe as JaxBasicBlockDe
from weaklysuperviseddl_tpu.models.torch_import import torch_to_flax
from weaklysuperviseddl_tpu.pipelines import basnet_infer as jax_infer
import weaklysuperviseddl_tpu_torch.train.basnet as port_train
from weaklysuperviseddl_tpu_torch.data.dataset import download_data
from weaklysuperviseddl_tpu_torch.models.basnet import BASNet
from weaklysuperviseddl_tpu_torch.models.jax_import import basnet_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.models.resnet import BasicBlockDe, BatchNorm2d, init_weights
from weaklysuperviseddl_tpu_torch.pipelines import basnet_infer

pytestmark = pytest.mark.usefixtures("single_torch_thread")

MAPS = ("dout", "d1", "d2", "d3", "d4", "d5", "d6", "db")
SIZE = 32


@torch.no_grad()
def _perturb(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Non-trivial conv biases, BN affines and running statistics, so that
    eval-mode parity tests every leaf of the bridge."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
            m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
        elif isinstance(m, BatchNorm2d):
            m.weight.copy_(0.8 + 0.4 * torch.rand(m.weight.shape, generator=g))
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
            m.running_var.copy_(0.75 + 0.5 * torch.rand(m.running_var.shape, generator=g))
    return model


def _jax_variables(state_dict):
    params, stats = torch_to_flax(host_state(state_dict))
    return jax_tree({"params": params, "batch_stats": stats})


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def bridged():
    """The port's BASNet (seed 0, perturbed BN and biases) and the same
    weights in JAX's tree, with one jit'd JAX eval forward."""
    port = _perturb(init_weights(BASNet(), torch.Generator().manual_seed(0)), seed=1).eval()
    jmodel = JaxBASNet()
    forward = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return port, jmodel, _jax_variables(port.state_dict()), forward


@pytest.fixture(scope="module")
def eval_maps(bridged):
    port, _, variables, forward = bridged
    x = np.random.default_rng(0).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = forward(variables, jnp.asarray(x))
    return [g[:, 0].numpy() for g in got], [np.asarray(w)[..., 0] for w in want]


@pytest.mark.parametrize("index", range(8), ids=MAPS)
def test_eval_maps_match_jax(eval_maps, index):
    got, want = eval_maps
    assert got[index].shape == (2, SIZE, SIZE)
    np.testing.assert_allclose(got[index], want[index], atol=1e-5, rtol=0)


def test_state_dict_is_the_reference_layout(bridged):
    """The reference's keys (``encoderX.Y.``, ``downsample.0/1``, BASNet's
    own names, ``refunet.*``), 87.06 M parameters, and JAX's importer turns
    the state dict into exactly the tree JAX's own init would give."""
    port, jmodel, variables, _ = bridged
    keys = port.state_dict().keys()
    for key in ("inconv.weight", "inconv.bias", "inbn.running_var", "encoder1.0.conv1.weight",
                "encoder2.0.downsample.0.weight", "encoder2.0.downsample.1.running_mean",
                "resb5_1.conv1.weight", "resb6_3.bn2.bias", "convbg_1.weight", "bnbg_m.weight",
                "conv6d_1.bias", "bn6d_2.running_mean", "conv1d_m.weight", "outconvb.weight",
                "outconv1.bias", "refunet.conv0.weight", "refunet.bn_d1.weight",
                "refunet.conv_d0.bias"):
        assert key in keys, key
    assert "encoder1.0.downsample.0.weight" not in keys
    assert "encoder1.0.conv1.bias" not in keys
    assert sum(p.numel() for p in port.parameters()) == 87_060_360
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    want = jax.tree_util.tree_leaves_with_path(shapes)
    got = jax.tree_util.tree_leaves_with_path(variables)
    assert sorted((jax.tree_util.keystr(p), w.shape) for p, w in want) == \
        sorted((jax.tree_util.keystr(p), g.shape) for p, g in got)


def test_state_dict_round_trips_through_jax_bit_equal(bridged):
    port, _, _, _ = bridged
    sd = port.state_dict()
    params, stats = torch_to_flax(sd)
    back = basnet_state_dict_from_jax({"params": params, "batch_stats": stats})
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert back[key].dtype == value.dtype and torch.equal(back[key], value), key
    fresh = BASNet()
    fresh.load_state_dict(back, strict=True)


@pytest.mark.parametrize("stride", [1, 2])
def test_basic_block_de_matches_jax(stride):
    """BasicBlockDe in eval and training mode (outputs and running statistics)
    against JAX's, on the same weights."""
    block = _perturb(init_weights(BasicBlockDe(6, 8, stride), torch.Generator().manual_seed(3)), 4)
    jblock = JaxBasicBlockDe(planes=8, stride=stride)
    x = np.random.default_rng(5).normal(size=(2, 9, 11, 6)).astype(np.float32)
    variables = _jax_variables(block.state_dict())
    want = jblock.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    want, mutated = jblock.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = block.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    for (path, value) in jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]):
        module, leaf = path[0].key, path[1].key
        mine = getattr(block, module).running_mean if leaf == "mean" else \
            getattr(block, module).running_var
        np.testing.assert_allclose(mine.numpy(), np.asarray(value), atol=1e-6, rtol=0)


def test_jax_variables_do_not_follow_torch_in_place_changes():
    """The test above runs JAX's training-mode forward asynchronously and then
    the port's, which updates the running statistics in place. A JAX tree
    built from views of the torch buffers (``torch_to_flax(state_dict)`` then
    ``jnp.asarray``) may alias them and read the updated statistics: 0.09·(m −
    r) off, the size of a once-seen failure. ``_jax_variables`` hands JAX
    copies, so an in-place change leaves its tree as it was. Whether the old
    recipe aliases depends on the buffers' alignment, so only the helper's
    tree is held."""
    block = _perturb(init_weights(BasicBlockDe(6, 8, 2), torch.Generator().manual_seed(3)), 4)
    params, stats = torch_to_flax(block.state_dict())
    views = jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats})
    copies = _jax_variables(block.state_dict())
    want = jax.tree.map(lambda a: np.array(a, copy=True), copies)
    assert jax.tree.all(jax.tree.map(np.array_equal, want, jax.tree.map(np.asarray, views)))
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.mul_(2.0).add_(1.0)
                m.running_var.mul_(3.0)
    for (path, got), w in zip(jax.tree_util.tree_leaves_with_path(copies), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(got), w, err_msg=jax.tree_util.keystr(path))


# ---- the hybrid loss ------------------------------------------------------------------

def _maps(seed, shape=(2, 24, 20)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    pred[0, :3] = 0.0   # the clip's edges
    pred[1, -2:] = 1.0
    target = (rng.random(shape) > 0.5).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("name", ["ssim", "bce_loss", "iou_loss", "hybrid_loss"])
def test_loss_matches_jax(name):
    pred, target = _maps(0)
    got = getattr(port_train, name)(torch.from_numpy(pred), torch.from_numpy(target))
    want = getattr(jax_train, name)(jnp.asarray(pred), jnp.asarray(target))
    assert abs(float(got) - float(want)) <= 1e-6


def test_fusion_loss_matches_jax():
    rng = np.random.default_rng(1)
    outs = rng.uniform(0.02, 0.98, (8, 2, 1, 16, 16)).astype(np.float32)
    target = (rng.random((2, 16, 16)) > 0.5).astype(np.float32)
    got = port_train.fusion_loss(tuple(torch.from_numpy(o) for o in outs),
                                 torch.from_numpy(target))
    want = jax_train.fusion_loss(tuple(jnp.asarray(o).transpose(0, 2, 3, 1) for o in outs),
                                 jnp.asarray(target))
    assert abs(float(got) - float(want)) <= 1e-6


def test_ssim_matches_naive_golden():
    rng = np.random.default_rng(3)
    p = rng.random((2, 16, 16)).astype(np.float32)
    t = rng.random((2, 16, 16)).astype(np.float32)
    got = float(port_train.ssim(torch.from_numpy(p), torch.from_numpy(t)))
    assert got == pytest.approx(_naive_ssim(p.astype(np.float64), t.astype(np.float64)),
                                abs=2e-5)
    assert float(port_train.ssim(torch.from_numpy(p), torch.from_numpy(p))) == \
        pytest.approx(1.0, abs=1e-5)


def test_gaussian_window_matches_jax():
    assert torch.equal(port_train._gaussian_window(),
                       torch.from_numpy(np.array(jax_train._gaussian_window())))


# ---- one training step ----------------------------------------------------------------

# the training step's settings (test_torch_basnet_step.py, test_torch_basnet_infer.py)
LR, CLIP, LR_END, STEPS = 3e-4, 1.0, 1e-5, 4


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(6)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        mine = [torch.from_numpy(g.copy()) for g in grads]
        norm = port_train.clip_by_global_norm(mine, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        for m, w in zip(mine, want):
            np.testing.assert_allclose(m.numpy(), np.asarray(w), rtol=1e-6, atol=0)


# ---- weights from a file, inference, the CLI ------------------------------------------

def test_norm_pred_matches_jax():
    d = np.random.default_rng(8).uniform(0.3, 0.7, (3, 17, 19)).astype(np.float32)
    np.testing.assert_allclose(basnet_infer.norm_pred(torch.from_numpy(d)).numpy(),
                               np.asarray(jax_infer.norm_pred(jnp.asarray(d))), atol=1e-6, rtol=0)


def test_run_inference_without_pil_raises_before_the_model_runs(monkeypatch, tmp_path):
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    class Untouchable(torch.nn.Module):
        def forward(self, x):
            raise AssertionError("the model ran")

    monkeypatch.setattr(builtins, "__import__", no_pil)
    ds = download_data(None, split="test", synthetic_size=1)
    with pytest.raises(ImportError, match="PIL"):
        basnet_infer.run_inference(ds, model=Untouchable(), num_images=1,
                                   output_folder=str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")


def test_demo_writes_the_jax_record(bridged, monkeypatch, tmp_path):
    """The demo module at a tiny size (the engine at 32² too): the JAX demo's
    record keys, the trajectory at every --eval-every, the held-out PNGs."""
    import json

    from weaklysuperviseddl_tpu_torch.pipelines import basnet_demo

    monkeypatch.setattr(basnet_demo, "build_basnet", lambda **kw: copy.deepcopy(bridged[0]))
    monkeypatch.setattr(basnet_infer, "IMG_SIZE", SIZE)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "demo.json"
    assert basnet_demo.main(["--images", "2", "--holdout", "1", "--epochs", "1",
                             "--batch-size", "2", "--image-size", str(SIZE), "--eval-every", "1",
                             "--device", "cpu", "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    with open(os.path.join(os.path.dirname(__file__), "..", "E2E_BASNET_TRAIN.json")) as f:
        jax_record = json.load(f)
    assert set(record) >= set(jax_record) - {"phases"}
    assert set(record["protocol"]) >= set(jax_record["protocol"])
    assert record["protocol"]["device"] == "cpu"
    assert [p["epoch"] for p in record["iou_trajectory"]] == [1]
    assert os.listdir(tmp_path / "basnet_outputs_trained_torch") == ["0_saliency.png"]
