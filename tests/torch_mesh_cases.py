"""The rank side of the port's mesh tests: each function runs in every rank of
a spawned gloo group (``parallel/mesh.Ranks``), imports nothing of JAX, and
returns numpy arrays and floats (rank 0's are what the tests read)."""

import numpy as np
import torch

from weaklysuperviseddl_tpu_torch.models.deeplabv3 import DeepLabV3
from weaklysuperviseddl_tpu_torch.parallel.mesh import (
    batch_sharding,
    full_state_dict,
    local_state_dict,
    make_mesh,
)
from weaklysuperviseddl_tpu_torch.parallel.spatial import (
    refine_spatial_sharded,
    shard_spatial,
    spatial_sharded_boundary_loss,
    spatial_sharded_ncut_loss,
)
from weaklysuperviseddl_tpu_torch.train.segmentation import (
    create_seg_state,
    evaluate_segmentation_sharded,
    seg_train_step,
    train_segmentation_model,
)


class SGD:
    """p −= lr·grad: the parity steps' optimizer. After one Adam step every
    parameter moves by about ±lr, so float noise that flips a near-zero
    gradient's sign would swamp the comparison (JAX's tests/test_train.py
    uses optax.sgd for its mesh step for the same reason)."""

    def __init__(self, params, lr: float = 1e-2):
        self.params, self.lr = list(params), 1e-2

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p -= self.lr * p.grad
        return True


def _numpy(tree: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def seg_model_state(mesh, weights: dict, sgd: bool = True):
    """DeepLabV3-18 at width 0.25 with ``weights`` (a whole state dict of
    numpy arrays) laid out on ``mesh``, its dropout the identity (JAX's bits
    cannot be drawn here); SGD in place of the guarded Adam."""
    state = create_seg_state(DeepLabV3(2, 18, 0.25), seed=0, lr=1e-4, mesh=mesh)
    full = {k: torch.from_numpy(v) for k, v in weights.items()}
    state.model.load_state_dict(local_state_dict(state.model, full), strict=True)
    state.model.classifier[0].project[3].p = 0.0
    if sgd:
        state.optimizer = SGD(state.model.parameters())
    return state


def seg_cases(data: int, model: int, weights: dict, step: tuple, epoch: tuple | None,
              evaluation: tuple | None) -> dict:
    """On a data × model mesh: one step on ``step`` = (images, masks, valid)
    (the global batch, split here); with ``epoch`` = (images, masks, batch,
    epochs, seed) a data-parallel training run; with ``evaluation`` =
    (images, true_fg) the sharded eval; and a guarded Adam step whose
    gradients are not finite on rank 1 alone."""
    mesh = make_mesh(data, model)
    out = {"rank": torch.distributed.get_rank(), "index": (mesh.index("data"),
                                                          mesh.index("model"))}
    state = seg_model_state(mesh, weights)
    rows = batch_sharding(mesh, step[0].shape[0])
    images, masks, valid = (torch.from_numpy(a[rows]) for a in step)
    out["step_loss"] = float(seg_train_step(state, images, masks, valid, mesh=mesh))
    out["step_state"] = _numpy(full_state_dict(state.model))

    guarded = seg_model_state(mesh, weights, sgd=False)
    opt = guarded.optimizer
    if out["rank"] == 1:
        grads = opt._grads
        opt._grads = lambda: [g.clone().fill_(float("nan")) if i == 0 else g
                              for i, g in enumerate(grads())]
    names = [n for n, _ in guarded.model.named_parameters()]
    before = _numpy(full_state_dict(guarded.model))
    seg_train_step(guarded, images, masks, valid, mesh=mesh)
    after = _numpy(full_state_dict(guarded.model))
    out["guard"] = {"applied_steps": int(opt.count), "notfinite": int(opt.notfinite_count),
                    "moved": max(float(np.abs(after[n] - before[n]).max()) for n in names)}

    if epoch is not None:
        ep_images, ep_masks, batch, epochs, seed = epoch
        for name, K in (("epoch", 2), ("per_step", 1)):   # chunks of 2, and step by step
            run = seg_model_state(mesh, weights)
            run, loss = train_segmentation_model(run, ep_images, ep_masks, num_epochs=epochs,
                                                 batch_size=batch, seg_size=ep_images.shape[1],
                                                 seed=seed, mesh=mesh, steps_per_dispatch=K,
                                                 log=lambda *a: None)
            out[f"{name}_loss"], out[f"{name}_state"] = loss, _numpy(full_state_dict(run.model))
            out[f"{name}_steps"] = run.step
    if evaluation is not None:
        out["eval"] = evaluate_segmentation_sharded(seg_model_state(mesh, weights).model,
                                                    *evaluation, mesh)
    return out


def spatial_cases(n: int, losses: tuple, grad: tuple, refine: tuple, refine_kwargs: dict) -> dict:
    """On n ranks along H: the three window losses of ``losses`` = (probs,
    images, probs_w3, images_w3), the ncut loss's gradient with respect to
    the logits of ``grad`` = (logits, images), and the refinement of
    ``refine`` = (S, images, masks). Returns this rank's rows where a result
    has rows."""
    mesh = make_mesh(data=n, model=1)
    probs, images, probs3, images3 = (shard_spatial(mesh, a) for a in losses)
    out = {
        "ncut": float(spatial_sharded_ncut_loss(probs, images, mesh, sigma_color=0.05,
                                                window_size=5)),
        "boundary": float(spatial_sharded_boundary_loss(probs, images, mesh, sigma_color=0.1,
                                                        sigma_space=5.0, window_size=5)),
        "ncut_w3": float(spatial_sharded_ncut_loss(probs3, images3, mesh, sigma_color=0.1,
                                                   window_size=3)),
    }
    logits, grad_images = (shard_spatial(mesh, a) for a in grad)
    logits = logits.clone().requires_grad_(True)
    spatial_sharded_ncut_loss(torch.softmax(logits, dim=-1), grad_images, mesh,
                              sigma_color=0.1, window_size=5).backward()
    out["grad_rows"] = logits.grad.numpy()
    S, r_images, r_masks = (shard_spatial(mesh, a) for a in refine)
    refined, loss = refine_spatial_sharded(S, r_images, r_masks, mesh, **refine_kwargs)
    out["refined_rows"], out["refine_loss"] = refined.numpy(), float(loss)
    return out
