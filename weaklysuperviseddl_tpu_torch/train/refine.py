"""Alternating-direction pseudo-mask refinement (port of
weaklysuperviseddl_tpu/train/refine.py).

Reference: AlternatingDirectionCutLoss.py:709-767. Per image, freeze the net,
take its soft prediction S, set X = one_hot(mask) and run Adam on X for
``num_steps`` minimising KL(softmax(X) ‖ S) + λ_dyn·window_loss(softmax(X),
image), λ_dyn = λ·KL/window as a stop-gradient scalar; threshold the
foreground probability for the new mask. The reference's quirks are kept: the
ncut criterion softmaxes its (already softmaxed) input again, and KL uses
log(X_norm + 1e-8) summed over the image.

On a CUDA tensor with ``use_pallas=True`` (the config's name for "the
kernel") this launches the CUDA kernel (``ops/refine.py`` + ``csrc/refine.cu``)
with its default plan, as the JAX package calls ``pallas_refine``: "v1sym"
for the binary masks of the cycle, "v1" otherwise. ``use_pallas=False``
forces the plain version, as it forces XLA in the JAX package. The kernel
takes any H×W, so there is no size fallback.

``refine_pseudo_masks`` is the model-facing form (the reference's
``refine_pseudo_mask`` signature, :709): S is the eval-mode model's softmax,
without gradient.
"""

from __future__ import annotations

import torch

from weaklysuperviseddl_tpu_torch.ops.refine import refine_cuda, refine_plain


def refine_from_soft_predictions(
    S: torch.Tensor,        # [B,H,W,C] the frozen net's softmax predictions
    images: torch.Tensor,   # [B,H,W,3] normalised (the seg model's input space)
    masks: torch.Tensor,    # [B,H,W] int {0,1}
    lambda_boundary: float = 0.1,
    threshold: float = 0.5,
    lr: float = 1e-2,
    num_steps: int = 20,
    sigma_color: float = 0.1,
    sigma_space: float = 5.0,
    window_size: int = 5,
    loss: str = "ncut",
    use_pallas: bool = True,
):
    """Batched refinement. Returns (refined uint8 [B,H,W], mean over images of
    the summed step losses, a 0-dim tensor)."""
    kw = dict(lambda_boundary=lambda_boundary, threshold=threshold, lr=lr,
              num_steps=num_steps, sigma_color=sigma_color, sigma_space=sigma_space,
              window_size=window_size, loss=loss)
    if use_pallas and S.is_cuda:
        return refine_cuda(S.float().contiguous(), images.float().contiguous(),
                           masks.contiguous(), **kw)
    return refine_plain(S, images, masks, **kw)


def refine_pseudo_masks(model: torch.nn.Module, images: torch.Tensor, masks: torch.Tensor,
                        **kwargs):
    """S = softmax of ``model``'s logits on the normalised [B,H,W,3]
    ``images`` (eval mode, no gradient; the model's mode is restored after),
    then ``refine_from_soft_predictions(S, images, masks, **kwargs)``."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            logits = model(images.permute(0, 3, 1, 2))
            S = torch.softmax(logits, dim=1).permute(0, 2, 3, 1).contiguous()
    finally:
        model.train(was_training)
    return refine_from_soft_predictions(S, images, masks, **kwargs)
