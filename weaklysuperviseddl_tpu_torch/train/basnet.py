"""BASNet training: the paper's hybrid BCE + SSIM + IoU loss over all eight
side outputs (port of weaklysuperviseddl_tpu/train/basnet.py).

The reference ships BASNet for inference only, with weights trained
elsewhere; this is the recipe that produced them (Qin et al., CVPR 2019:
ℓ = ℓ_bce + ℓ_ssim + ℓ_iou on each of the 8 maps, Adam), so the model can be
trained and checked from random weights. The JAX package computes all of it in
XLA; here the convolutions go to cuDNN and the loss is plain PyTorch (the
SSIM window as two separable depthwise convs, as JAX's).

Optimizer semantics are optax's: Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, ``train/guard.Adam``), the cosine decay of
``optax.cosine_decay_schedule`` and the clip of ``optax.clip_by_global_norm``
(g · max_norm / ‖g‖ when ‖g‖ ≥ max_norm, with no epsilon in the denominator,
unlike ``torch.nn.utils.clip_grad_norm_``).

A bfloat16 BASNet (``BASNet(dtype="bfloat16")``) trains with float32
parameters, Adam state and targets; its eight maps are promoted to float32
before the loss. (JAX's ``train_basnet`` raises on a bfloat16 model: its SSIM
convolves the bfloat16 map with a float32 window.)
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from weaklysuperviseddl_tpu_torch.train.guard import Adam

_EPS = 1e-7


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities (the side outputs are already
    sigmoids), clipped to [1e-7, 1 − 1e-7]; mean over all pixels. [B,H,W]."""
    p = pred.clamp(_EPS, 1.0 - _EPS)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """The normalised 1-D Gaussian, built in float64 and cast to float32."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return torch.from_numpy((g / g.sum()).astype(np.float32))


def _separable_blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The Gaussian filter as two 1-D convs with 'SAME' zero padding (along H,
    then W); x: [B,H,W]."""
    k = win.shape[0]
    y = F.conv2d(x[:, None], win.view(1, 1, k, 1), padding=(k // 2, 0))
    return F.conv2d(y, win.view(1, 1, 1, k), padding=(0, k // 2))[:, 0]


def ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM with an 11×11 Gaussian window (pytorch_ssim's semantics, as
    the BASNet recipe uses: C1 = 0.01², C2 = 0.03², 'SAME' padding, so the
    borders count). pred/target: [B,H,W] in [0,1]."""
    win = _gaussian_window(window_size, sigma).to(pred.device, pred.dtype)
    mu_p = _separable_blur(pred, win)
    mu_t = _separable_blur(target, win)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    var_p = _separable_blur(pred * pred, win) - mu_pp
    var_t = _separable_blur(target * target, win) - mu_tt
    cov = _separable_blur(pred * target, win) - mu_pt
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_pt + c1) * (2 * cov + c2)) / ((mu_pp + mu_tt + c1) * (var_p + var_t + c2))
    return torch.mean(s)


def iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft-IoU loss (pytorch_iou's): per image 1 − Σpt / (Σp + Σt − Σpt),
    averaged over the batch."""
    inter = torch.sum(pred * target, dim=(1, 2))
    union = torch.sum(pred, dim=(1, 2)) + torch.sum(target, dim=(1, 2)) - inter
    return torch.mean(1.0 - (inter + _EPS) / (union + _EPS))


def hybrid_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """ℓ_bce + ℓ_ssim + ℓ_iou for one side output (the paper's eq. 8-11)."""
    return bce_loss(pred, target) + (1.0 - ssim(pred, target)) + iou_loss(pred, target)


def fusion_loss(outputs, target: torch.Tensor) -> torch.Tensor:
    """Deep supervision: the hybrid loss summed over the 8 maps ([B,1,H,W]
    each, in the model's compute dtype) against one [B,H,W] target, each map
    promoted to the target's float type (float32, or float64 in a float64
    model) first."""
    return sum(hybrid_loss(d[:, 0].to(torch.promote_types(d.dtype, target.dtype)), target)
               for d in outputs)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)``: the learning
    rate at step t (from 0) is lr·((1 − α)·½(1 + cos(π·min(t, T)/T)) + α)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: where the global norm ‖g‖ is at
    least ``max_norm``, every gradient becomes g / ‖g‖ · max_norm. Returns ‖g‖
    (0-dim, on the device; nothing is read back)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    denom = torch.where(norm < max_norm, torch.ones_like(norm), norm / max_norm)
    torch._foreach_div_(grads, denom)
    return norm


def make_basnet_train_step(model: torch.nn.Module, optimizer: Adam,
                           clip_norm: float | None = None,
                           schedule: Callable[[int], float] | None = None):
    """One training step: the forward in training mode (BatchNorm on batch
    statistics, running statistics updated), the fused 8-map loss, backward,
    the optional global-norm clip, then Adam at ``schedule(step)`` (steps
    counted from 0; the optimizer's own lr without one). ``step(images,
    targets)`` takes normalised [B,3,H,W] images and [B,H,W] {0,1} targets and
    returns the loss (0-dim, on the device)."""

    def step(images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        model.train()
        loss = fusion_loss(model(images), targets)
        optimizer.zero_grad()
        loss.backward()
        if clip_norm is not None:
            clip_by_global_norm(optimizer._grads(), clip_norm)
        if schedule is not None:
            optimizer.lr = schedule(optimizer.count)
        optimizer.step()
        return loss.detach()

    return step


def train_basnet(model: torch.nn.Module, images, targets, *, epochs: int = 10,
                 batch_size: int = 8, lr: float = 1e-3, clip_norm: float | None = None,
                 lr_end: float | None = None, seed: int = 0, eval_hook=None,
                 eval_every: int = 0, log=print):
    """Train BASNet with the paper's recipe (Adam, the hybrid deep-supervision
    loss). ``images`` [N,H,W,3] float32, ImageNet-normalised, and ``targets``
    [N,H,W] in {0,1} (numpy or tensors) are uploaded once to the model's
    device; each batch is a gather there, in the epoch order
    ``np.random.default_rng(seed).permutation(n)`` as in the JAX package. N
    must be a multiple of ``batch_size``. Losses are read back once an epoch.
    Images and targets are uploaded in the parameters' float type (float32;
    float64 for a model in double).

    From random weights the paper's Adam(1e-3) diverges; pass ``clip_norm``
    and a lower ``lr`` (3e-4 with clip 1.0 descends). ``lr_end`` turns on a
    cosine decay lr → lr_end over the run. ``eval_hook(model, epoch)`` runs
    every ``eval_every`` epochs (it may switch the model to eval mode; the
    next step switches it back).

    Returns (model, per-epoch mean losses)."""
    n = images.shape[0]
    if n % batch_size:
        raise ValueError(f"{n} images are not a multiple of batch_size {batch_size}; "
                         "pad the dataset first")
    param = next(model.parameters())
    dev, dtype = param.device, param.dtype
    dev_images = torch.as_tensor(images, dtype=dtype).to(dev).permute(0, 3, 1, 2)
    dev_images = dev_images.contiguous()
    dev_targets = torch.as_tensor(targets, dtype=dtype).to(dev)
    optimizer = Adam(model.parameters(), lr=lr)
    schedule = (cosine_decay(lr, epochs * (n // batch_size), alpha=lr_end / lr)
                if lr_end is not None else None)
    step = make_basnet_train_step(model, optimizer, clip_norm, schedule)
    rng = np.random.default_rng(seed)
    history = []
    for epoch in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = [step(dev_images[idx], dev_targets[idx])
                  for idx in order.split(batch_size)]
        history.append(float(torch.stack(losses).mean()))
        log(f"basnet epoch {epoch + 1}/{epochs}: loss {history[-1]:.4f}")
        if eval_hook is not None and eval_every and (epoch + 1) % eval_every == 0:
            eval_hook(model, epoch + 1)
    return model, history
