"""BASNet in the port against the JAX package: the model (eight maps in eval
mode, one training-mode forward's running statistics), the hybrid loss, one
training step and the cosine schedule, the weight bridge both ways, a
``basnet.pth`` file through both ``build_basnet``s, ``run_inference`` on the
same pets, and the CLI's ``basnet``.

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

import weaklysuperviseddl_tpu.train.basnet as jax_train
from weaklysuperviseddl_tpu.data import download_data as jax_download_data
from weaklysuperviseddl_tpu.models.basnet import BASNet as JaxBASNet
from weaklysuperviseddl_tpu.models.resnet import BasicBlockDe as JaxBasicBlockDe
from weaklysuperviseddl_tpu.models.torch_import import torch_to_flax
from weaklysuperviseddl_tpu.pipelines import basnet_infer as jax_infer
import weaklysuperviseddl_tpu_torch.train.basnet as port_train
from weaklysuperviseddl_tpu_torch.cli import main
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
    params, stats = torch_to_flax(state_dict)
    return jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats})


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

LR, CLIP, LR_END, STEPS = 3e-4, 1.0, 1e-5, 4


@pytest.fixture(scope="module")
def train_step(bridged):
    """One step from the same weights, in float64 on both sides: the port's
    ``make_basnet_train_step`` (clip 1.0, cosine lr) on the model in double,
    and JAX's loss, gradients and statistics (one jit'd value_and_grad under
    ``jax.enable_x64``, the SSIM window cast to float64) with the optax
    chain of ``train_basnet`` applied.

    Why float64 and batch 4: from random weights BASNet's training-mode
    gradient is ill-conditioned. In float32 both packages' gradients are
    10-27 % of a tensor's largest entry off a float64 gradient in the deep
    stages (32² and 64², batch 2 and 4), each as far off as the other. At
    batch 2 and 32² BatchNorm normalises the 1x1 bottleneck over 2 values,
    which zeroes the gradient of everything behind it but the side outputs
    and leaves even the float32 loss 5-9e-4 off. In float64 at batch 4 the
    two packages agree within 3e-6."""
    port, _, _, _ = bridged
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, SIZE, SIZE, 3))
    t = np.zeros((4, SIZE, SIZE))
    t[:, 8:24, 6:20] = 1.0

    before = {k: v.double() if v.is_floating_point() else v for k, v in port.state_dict().items()}
    model = copy.deepcopy(port).double()
    opt = port_train.Adam(model.parameters(), lr=LR)
    step = port_train.make_basnet_train_step(
        model, opt, clip_norm=CLIP, schedule=port_train.cosine_decay(LR, STEPS, LR_END / LR))
    loss = float(step(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t)))

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        window = jnp.asarray(np.asarray(jax_train._gaussian_window()), jnp.float64)
        mp.setattr(jax_train, "_gaussian_window", lambda *args: window)
        params, stats = torch_to_flax(before)
        params, stats = jax.tree.map(jnp.asarray, (params, stats))
        jmodel = JaxBASNet(dtype=jnp.float64)

        def loss_fn(params, stats, images, targets):
            outs, mutated = jmodel.apply({"params": params, "batch_stats": stats}, images,
                                         train=True, mutable=["batch_stats"])
            return jax_train.fusion_loss(outs, targets), mutated["batch_stats"]

        tx = optax.chain(optax.clip_by_global_norm(CLIP),
                         optax.adam(optax.cosine_decay_schedule(LR, STEPS, alpha=LR_END / LR),
                                    b1=0.9, b2=0.999, eps=1e-8))

        @jax.jit
        def jax_step(params, stats, images, targets):
            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, stats, images, targets)
            clipped, _ = optax.clip_by_global_norm(CLIP).update(grads, None)
            updates, _ = tx.update(grads, tx.init(params), params)
            return dict(loss=loss, stats=stats, grads=clipped,
                        new=optax.apply_updates(params, updates),
                        norms=(optax.global_norm(grads), optax.global_norm(clipped)))

        out = jax.tree.map(np.asarray, jax_step(params, stats, jnp.asarray(x), jnp.asarray(t)))
    return dict(model=model, before=before, loss=loss, jax_loss=float(out["loss"]),
                jax_grads=basnet_state_dict_from_jax({"params": out["grads"],
                                                      "batch_stats": out["stats"]}),
                jax_new=basnet_state_dict_from_jax({"params": out["new"],
                                                    "batch_stats": out["stats"]}),
                norm=float(out["norms"][0]), clipped_norm=float(out["norms"][1]))


def test_train_step_loss_matches_jax(train_step):
    assert train_step["loss"] == pytest.approx(train_step["jax_loss"], rel=1e-5)


def test_train_step_gradients_match_jax(train_step):
    """Each clipped gradient within 1e-4 of its tensor's largest entry, and
    the clipped global norm within 1e-5. The biases of convs that feed a
    training-mode BatchNorm have a zero gradient (the batch mean takes them
    out): both sides' are below 1e-9."""
    model, want = train_step["model"], train_step["jax_grads"]
    grads, zero = [], []
    for name, p in model.named_parameters():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        if scale < 1e-9:
            assert float(p.grad.abs().max()) < 1e-9, name
            zero.append(name)
            continue
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * scale, name
        grads.append(p.grad)
    feeding_bn = {f"{n}.bias" for n, m in model.named_modules()
                  if isinstance(m, torch.nn.Conv2d) and m.bias is not None
                  and not n.startswith("outconv") and n not in ("refunet.conv0", "refunet.conv_d0")}
    assert set(zero) == feeding_bn
    norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [p.grad for p in model.parameters()]))))
    assert train_step["norm"] > CLIP   # the clip did act
    assert norm == pytest.approx(train_step["clipped_norm"], abs=1e-5)


def test_train_step_running_statistics_match_jax(train_step):
    model, want = train_step["model"], train_step["jax_new"]
    checked = 0
    for name, value in model.state_dict().items():
        if "running_" in name:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
            checked += 1
    assert checked == 2 * sum(isinstance(m, BatchNorm2d) for m in model.modules())


def test_train_step_adam_update_matches_optax(train_step):
    """The first Adam step moves a parameter by about lr·sign(g): equal to
    optax's within 1e-3·lr except where |g| is at the noise of the two
    gradients (at most 0.1 % of the elements)."""
    model, want, before = train_step["model"], train_step["jax_new"], train_step["before"]
    off = total = 0
    for name, p in model.named_parameters():
        got = p.detach() - before[name]
        exp = want[name] - before[name]
        off += int(((got - exp).abs() > 1e-3 * LR).sum())
        total += p.numel()
    assert off <= 1e-3 * total


def test_cosine_schedule_matches_optax_over_a_run(bridged, monkeypatch):
    """train_basnet's learning rate at every step of a 2-epoch run against
    optax's cosine_decay_schedule, and the schedule alone over the demo's
    3,000 steps and past them; the loss history and the eval hook."""
    lrs, hook = [], []

    class Recording(port_train.Adam):
        def step(self):
            lrs.append(self.lr)
            return super().step()

    monkeypatch.setattr(port_train, "Adam", Recording)
    model = copy.deepcopy(bridged[0])
    rng = np.random.default_rng(1)
    images = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    targets = np.zeros((2, SIZE, SIZE), np.float32)
    targets[:, 8:24, 8:24] = 1.0
    _, history = port_train.train_basnet(
        model, images, targets, epochs=2, batch_size=2, lr=LR, clip_norm=CLIP, lr_end=LR_END,
        eval_hook=lambda m, e: hook.append((m is model, e)), eval_every=1, log=lambda s: None)
    sched = optax.cosine_decay_schedule(LR, 2, alpha=LR_END / LR)
    assert len(lrs) == 2
    for count, lr in enumerate(lrs):
        assert abs(lr - float(sched(count))) <= 1e-7
    counts = np.arange(0, 3200, 7)
    mine = port_train.cosine_decay(LR, 3000, LR_END / LR)
    want = optax.cosine_decay_schedule(LR, 3000, LR_END / LR)(counts)
    np.testing.assert_allclose([mine(int(c)) for c in counts], np.asarray(want), atol=1e-7,
                               rtol=0)
    assert len(history) == 2 and all(np.isfinite(history))
    assert hook == [(True, 1), (True, 2)]
    with pytest.raises(ValueError):
        port_train.train_basnet(model, images, targets, epochs=1, batch_size=3)


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

def test_basnet_pth_loads_in_both_packages(bridged, tmp_path):
    """A ``basnet.pth``-style file written by torch.save, loaded by both
    ``build_basnet``s, gives the same maps; without the file the port draws
    seeded random weights."""
    port, jmodel, _, forward = bridged
    path = str(tmp_path / "basnet.pth")
    torch.save(port.state_dict(), path)
    mine = basnet_infer.build_basnet(weights_path=path, device="cpu")
    assert not mine.training
    _, variables = jax_infer.build_basnet(weights_path=path)
    x = np.random.default_rng(7).normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = mine(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = forward(variables, jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:, 0].numpy(), np.asarray(w)[..., 0], atol=1e-5, rtol=0)
    # the bridged model's conv weights are init_weights' at seed 0 (only its
    # biases and BatchNorms were perturbed)
    drawn = basnet_infer.build_basnet(weights_path=str(tmp_path / "missing.pth"), device="cpu")
    convs = [n for n, m in port.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(torch.equal(drawn.get_submodule(n).weight, port.get_submodule(n).weight)
               for n in convs)
    with pytest.raises(NotImplementedError):
        basnet_infer.build_basnet(device="cpu", dtype="bfloat16")


def test_norm_pred_matches_jax():
    d = np.random.default_rng(8).uniform(0.3, 0.7, (3, 17, 19)).astype(np.float32)
    np.testing.assert_allclose(basnet_infer.norm_pred(torch.from_numpy(d)).numpy(),
                               np.asarray(jax_infer.norm_pred(jnp.asarray(d))), atol=1e-6, rtol=0)


def test_run_inference_matches_jax(bridged, tmp_path, monkeypatch):
    """The engine on 2 synthetic test pets in both packages: the raw dout
    maps, the normalised ones (where a map's range is above 1e-3: norm_pred
    magnifies float noise in a flat map), per-image IoU and accuracy, and the
    PNGs (the same size, within one grey level on at most 0.1 % of the
    pixels: 1-4 of 50,176 differ here)."""
    port, jmodel, variables, forward = bridged
    saliency_dout = basnet_infer.saliency_dout
    n = 2
    ds, jds = download_data(None, split="test", synthetic_size=n), \
        jax_download_data(None, split="test", synthetic_size=n)
    images = np.stack(ds.images)
    assert np.array_equal(images, np.stack(jds.images))

    raw = []
    monkeypatch.setattr(basnet_infer, "saliency_dout",
                        lambda *a: raw.append(saliency_dout(*a)) or raw[-1])
    logs = []
    results, mean_iou, mean_acc = basnet_infer.run_inference(
        ds, model=port, num_images=n, batch_size=8, output_folder=str(tmp_path / "port"),
        log=logs.append)
    dout = raw[0].numpy()
    x, _ = jax_infer.preprocess_batch(jnp.asarray(images), None, size=jax_infer.IMG_SIZE)
    jdout = np.asarray(forward(variables, jax_infer._normalize_images(x))[0])[..., 0]
    np.testing.assert_allclose(dout, jdout, atol=1e-5, rtol=0)
    norm = basnet_infer.norm_pred(torch.from_numpy(dout)).numpy()
    jnorm = np.asarray(jax_infer.norm_pred(jnp.asarray(jdout)))
    wide = (jdout.max(axis=(1, 2)) - jdout.min(axis=(1, 2))) > 1e-3
    assert wide.any()
    np.testing.assert_allclose(norm[wide], jnorm[wide], atol=1e-4, rtol=0)

    jresults, jmean_iou, jmean_acc = jax_infer.run_inference(
        jds, model=jmodel, variables=variables, num_images=n, batch_size=n,
        output_folder=str(tmp_path / "jax"), log=lambda s: None)
    assert len(results) == n
    np.testing.assert_allclose(results, jresults, atol=1e-6, rtol=0)
    assert mean_iou == pytest.approx(jmean_iou, abs=1e-6)
    assert mean_acc == pytest.approx(jmean_acc, abs=1e-6)
    assert logs[-1].startswith("Mean IoU: ")
    from PIL import Image

    for i in range(n):
        a = np.asarray(Image.open(tmp_path / "port" / f"{i}_saliency.png"))
        b = np.asarray(Image.open(tmp_path / "jax" / f"{i}_saliency.png"))
        assert a.shape == b.shape == ds.trimaps[i].shape
        # (map * 255).astype(uint8) truncates: float noise flips a pixel by one
        # grey level where the map lies within it of a level
        assert np.abs(a.astype(int) - b).max() <= 1 and (a != b).mean() <= 1e-3, i


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


def test_cli_basnet_on_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["basnet", "--device", "cpu", "--num-images", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("0 - IoU: ") and out[-1].startswith("Mean IoU: ")
    assert sorted(os.listdir(tmp_path / "basnet_outputs")) == ["0_saliency.png",
                                                               "1_saliency.png"]


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
