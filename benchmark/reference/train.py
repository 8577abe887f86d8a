"""The plain reference of the alternating round: the segmentation training
step and the refinement sweep, from their published definitions.

* ``preprocess``: uint8 [B,H,W,3] → /255 → bilinear resize with half-pixel
  centres (antialiased when it shrinks) → clamp to [0,1] → ImageNet mean and
  std, as [B,3,S,S].
* ``train_steps``: DeepLabV3 in training mode (batch statistics, the keyed
  dropout), the per-image mean cross-entropy on masks clamped to {0,1}, its
  mean over the batch, and Adam as optax writes it (β 0.9/0.999, eps 1e-8,
  bias-corrected, lr 1e-4).
* ``refine``: per image, X = one_hot(mask), ``num_steps`` Adam steps on
  KL(S ‖ softmax X) + λ·W with λ = λ_b·KL/(W + 1e-6) held constant in each
  step, W the normalised-cut window loss of softmax(softmax X) (colour
  affinities exp(−‖I − I_o‖²/(2σ²)) over the window's offsets, reflect-padded
  edges, a mean per class and offset, over K·C); then
  mask = softmax(X)[1] > threshold, and each image's loss KL + λ·W summed
  over the steps, each step's taken before its update.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """Run the block with TF32 on or off for cuDNN and cuBLAS."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def to_unit(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 [B,H,W,3] → float32 [B,3,size,size] in [0,1]."""
    x = (images_u8.permute(0, 3, 1, 2).double() / 255.0).float()
    if x.shape[-2:] != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=x.shape[-2] > size)
    return x.clamp(0.0, 1.0)


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def preprocess(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    return normalize(to_unit(images_u8, size))


def resize_masks(masks: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize with half-pixel centres of [B,h,w] masks."""
    if masks.shape[-2:] == (size, size):
        return masks
    m = F.interpolate(masks[:, None].float(), size=(size, size), mode="nearest-exact")
    return m[:, 0].to(masks.dtype)


def train_steps(model, batches, size: int, lr: float = 1e-4):
    """Run ``model`` through one training step per (uint8 images, masks,
    dropout key) of ``batches``. Returns a dict: ``losses`` (floats),
    ``first_grads`` (each parameter's gradient in the first step) and
    ``params`` (each parameter after the last step), by name."""
    model.train()
    params = dict(model.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for t, (images, masks, key) in enumerate(batches, start=1):
        x = preprocess(images, size)
        y = resize_masks(masks, size).long().clamp(0, 1)
        model.dropout.key = key
        logits = model(x)
        loss = F.cross_entropy(logits, y, reduction="none").mean(dim=(1, 2)).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            bc1, bc2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                v[k].mul_(ADAM_B2).add_(g * g, alpha=1.0 - ADAM_B2)
                p.sub_(lr * (m[k] / bc1) / ((v[k] / bc2).sqrt() + ADAM_EPS))
    model.dropout.key = None
    return {"losses": losses, "first_grads": first,
            "params": {k: p.detach().clone() for k, p in params.items()}}


def _offsets(window: int):
    pad = window // 2
    return [(dy, dx) for dy in range(-pad, pad + 1) for dx in range(-pad, pad + 1)
            if (dy, dx) != (0, 0)]


def ncut_window_loss(probs: torch.Tensor, images: torch.Tensor, sigma_color: float,
                     window: int) -> torch.Tensor:
    """[B,C,H,W] probabilities (softmaxed once more here, as the criterion
    does), [B,3,H,W] images → [B] normalised-cut window losses."""
    B, C, H, W = probs.shape
    pad = window // 2
    p = torch.softmax(probs, dim=1)
    pp = F.pad(p, (pad,) * 4, mode="reflect")
    ip = F.pad(images, (pad,) * 4, mode="reflect")
    total = torch.zeros(B, device=probs.device)
    offsets = _offsets(window)
    for dy, dx in offsets:
        di = images - ip[:, :, pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        aff = torch.exp(-(di * di).sum(dim=1) / (2.0 * sigma_color ** 2))
        dp = p - pp[:, :, pad + dy:pad + dy + H, pad + dx:pad + dx + W]
        total = total + (aff[:, None] * dp * dp).mean(dim=(2, 3)).sum(dim=1)
    return total / (len(offsets) * C)


def refine(S: torch.Tensor, images: torch.Tensor, masks: torch.Tensor, lr: float,
           num_steps: int, lambda_boundary: float, threshold: float, sigma_color: float,
           window: int) -> torch.Tensor:
    """S [B,C,H,W] softmax of the model, [B,3,H,W] normalised images, [B,H,W]
    {0,1} masks → (refined uint8 [B,H,W], float64 [B] losses summed over
    the steps)."""
    C = S.shape[1]
    x = F.one_hot(masks.long(), C).permute(0, 3, 1, 2).float()
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    totals = torch.zeros(S.shape[0], dtype=torch.float64, device=S.device)
    plogp = torch.where(S > 0, S * torch.log(S.clamp(min=1e-38)), torch.zeros_like(S))
    for t in range(1, num_steps + 1):
        x.requires_grad_(True)
        with torch.enable_grad():
            q = torch.softmax(x, dim=1)
            kl = (plogp - S * torch.log(q + 1e-8)).sum(dim=(1, 2, 3))
            w = ncut_window_loss(q, images, sigma_color, window)
            lam = lambda_boundary * kl.detach() / (w.detach() + 1e-6)
            per_image = kl + lam * w
            (g,) = torch.autograd.grad(per_image.sum(), x)
        x = x.detach()
        totals += per_image.detach().double()
        m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
        x = x - lr * (m / (1.0 - ADAM_B1 ** t)) / ((v / (1.0 - ADAM_B2 ** t)).sqrt() + ADAM_EPS)
    return (torch.softmax(x, dim=1)[:, 1] > threshold).to(torch.uint8), totals
