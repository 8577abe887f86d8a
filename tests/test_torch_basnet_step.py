"""BASNet's training step against the JAX package's, in float64 on both sides:
the loss, the gradients, the running statistics and the Adam update (moved
out of test_torch_basnet.py, whose module fixtures it shares by import, so
that xdist starts this heavy file after the long JAX files)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_basnet import CLIP, LR, LR_END, SIZE, STEPS, bridged  # noqa: F401  (fixtures)
from test_torch_refine import single_torch_thread  # noqa: F401  (fixture)
from torch_bridge import host_state, jax_tree

import weaklysuperviseddl_tpu.train.basnet as jax_train
from weaklysuperviseddl_tpu.models.basnet import BASNet as JaxBASNet
from weaklysuperviseddl_tpu.models.torch_import import torch_to_flax
import weaklysuperviseddl_tpu_torch.train.basnet as port_train
from weaklysuperviseddl_tpu_torch.models.jax_import import basnet_state_dict_from_jax
from weaklysuperviseddl_tpu_torch.models.resnet import BatchNorm2d

pytestmark = pytest.mark.usefixtures("single_torch_thread")


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
        params, stats = jax_tree(torch_to_flax(host_state(before)))
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

