"""The plain reference of the pseudo-mask stage: LayerCAM of a classifier,
the threshold, the dense CRF and the largest component, from their
published definitions.

* ``layercam``: the gradients of each image's labelled logit with respect to
  the target stages' outputs; per stage relu(Σ_channels relu(g ⊙ a)), then
  per image (c − min)/(max − min + 1e-8), raised to ``alpha`` and normalised
  again, upsampled bilinearly (half-pixel centres) to the output size; the
  mean over stages (Jiang et al., LayerCAM, IEEE TIP 2021).
* ``dense_crf``: two labels, unary −log([1 − cam, cam]) (clipped to 1e-8),
  mean-field for ``n_iters`` iterations with Potts messages: a spatial
  Gaussian (σ ``gauss_sxy``, truncated at max(1, ⌊3σ⌋), zero padding) and a
  bilateral Gaussian over [x/σ_xy, y/σ_xy, rgb/σ_rgb] whose keys are the
  stride-``key_stride`` subgrid of pixels; each kernel normalised
  symmetrically by its row sums n = K·1 as K(Q/√n)/√n;
  Q ← softmax(−U + Σ w·message) (Krähenbühl and Koltun, NeurIPS 2011; the
  reference's pydensecrf call with its σ and compat).
* ``masks``: the CAM zeroed below the threshold, binarised (> 0), or the
  CRF's argmax on it; the largest 8-connected component is kept after.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _minmax(c: torch.Tensor) -> torch.Tensor:
    c = c - c.amin(dim=(-2, -1), keepdim=True)
    return c / (c.amax(dim=(-2, -1), keepdim=True) + 1e-8)


def to_unit(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] → float32 [B,3,H,W] in [0,1]."""
    return (images_u8.permute(0, 3, 1, 2).double() / 255.0).float()


def layercam(model, x: torch.Tensor, labels: torch.Tensor, layers=("layer3", "layer4"),
             alpha: float = 1.0, size: int = 224) -> torch.Tensor:
    """[B,3,H,W] images in [0,1], [B] labels → CAMs [B,size,size] in [0,1]."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        logits, feats = model(x)
        acts = [feats[n] for n in layers]
        score = logits.gather(1, labels.long().view(-1, 1)).sum()
        grads = torch.autograd.grad(score, acts)
    with torch.no_grad():
        cams = []
        for a, g in zip(acts, grads):
            c = _minmax(torch.relu(torch.relu(g * a).sum(dim=1)))
            c = _minmax(c ** alpha)
            cams.append(F.interpolate(c[:, None], size=(size, size), mode="bilinear",
                                      align_corners=False)[:, 0])
        return sum(cams) / len(cams)


def _gaussian(v: torch.Tensor, sxy: float) -> torch.Tensor:
    """Separable truncated Gaussian of [B,C,H,W], zero padding."""
    r = max(1, int(3 * sxy))
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=v.device)
    k = torch.exp(-0.5 * (t / sxy) ** 2).to(v.dtype)
    C = v.shape[1]
    v = F.conv2d(v, k.view(1, 1, -1, 1).expand(C, 1, -1, 1), padding=(r, 0), groups=C)
    return F.conv2d(v, k.view(1, 1, 1, -1).expand(C, 1, 1, -1), padding=(0, r), groups=C)


def _bilateral(fq: torch.Tensor, fk: torch.Tensor, vk: torch.Tensor,
               chunk: int = 4096) -> torch.Tensor:
    """Σ_k exp(−|f_q − f_k|²/2) v_k for one image: fq [Nq,5], fk [Nk,5],
    vk [Nk,C] → [Nq,C]. The distances in float64 (|q|² + |k|² − 2q·k), the
    kernel and its product in ``vk``'s dtype (float64 where that is float32)."""
    dt = torch.float64 if vk.dtype == torch.float32 else vk.dtype
    q, k = fq.double(), fk.double()
    kk = (k * k).sum(dim=1)
    out = []
    for s in range(0, q.shape[0], chunk):
        qs = q[s:s + chunk]
        d2 = (qs * qs).sum(dim=1, keepdim=True) + kk - 2.0 * qs @ k.t()
        out.append((torch.exp(-0.5 * d2).to(dt) @ vk.to(dt)).to(vk.dtype))
    return torch.cat(out)


def dense_crf(images255: torch.Tensor, cams: torch.Tensor, gauss_sxy: float,
              gauss_compat: float, bilat_sxy: float, bilat_srgb: float, bilat_compat: float,
              n_iters: int, key_stride: int, dtype=torch.float32):
    """[B,3,H,W] colours in [0,255], [B,H,W] CAMs → (uint8 [B,H,W] labels,
    float32 [B,H,W] margins |Q₁ − Q₀|); the marginals and messages in
    ``dtype``."""
    B, _, H, W = images255.shape
    dev = images255.device
    probs = torch.stack([1.0 - cams, cams], dim=1).clamp(1e-8, 1.0)
    unary = (-torch.log(probs)).to(dtype)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    out = []
    for b in range(B):
        feats = torch.cat([xx[None] / bilat_sxy, yy[None] / bilat_sxy,
                           images255[b] / bilat_srgb])                # [5,H,W]
        fq = feats.reshape(5, -1).t()
        fk = feats[:, ::key_stride, ::key_stride].reshape(5, -1).t()

        def bilateral(v):                                            # [C,H,W]
            vk = v[:, ::key_stride, ::key_stride].reshape(v.shape[0], -1).t()
            return _bilateral(fq, fk, vk).t().reshape(v.shape)

        def gauss(v):
            return _gaussian(v[None], gauss_sxy)[0]

        ones = torch.ones((1, H, W), dtype=dtype, device=dev)
        inv_g = torch.rsqrt(gauss(ones).clamp(min=1e-20))
        inv_b = torch.rsqrt(bilateral(ones).clamp(min=1e-20))
        u = unary[b]
        Q = torch.softmax(-u, dim=0)
        for _ in range(n_iters):
            logits = -u
            logits = logits + gauss_compat * gauss(Q * inv_g) * inv_g
            logits = logits + bilat_compat * bilateral(Q * inv_b) * inv_b
            Q = torch.softmax(logits, dim=0)
        out.append((Q.argmax(dim=0).to(torch.uint8), (Q[1] - Q[0]).abs().float()))
    return torch.stack([m for m, _ in out]), torch.stack([g for _, g in out])


def cams(model, images_u8: torch.Tensor, labels: torch.Tensor, layers=("layer3", "layer4"),
         alpha: float = 1.0, batch: int = 16) -> torch.Tensor:
    """LayerCAM of uint8 [N,H,W,3] pets for their labels → [N,H,W]."""
    out = []
    for s in range(0, images_u8.shape[0], batch):
        x = to_unit(images_u8[s:s + batch])
        out.append(layercam(model, x, labels[s:s + batch], layers, alpha, x.shape[-1]))
    return torch.cat(out)


@torch.no_grad()
def masks(images_u8: torch.Tensor, cam: torch.Tensor, cam_thresh: float, crf: dict | None,
          dtype=torch.float32):
    """CAMs → ({0,1} masks before the largest component is kept, each
    pixel's margin from a tie), numpy: the CAM zeroed below the threshold,
    then binarised (margin infinite: the same CAM gives the same mask) or
    the CRF's labels (margin |Q₁ − Q₀|), with the CAM and the CRF in
    ``dtype``."""
    cam = cam.to(dtype)
    cam = torch.where(cam < cam_thresh, torch.zeros_like(cam), cam)
    if crf is None:
        m = (cam > 0).to(torch.uint8).cpu().numpy()
        return m, np.full(m.shape, np.inf, np.float32)
    out = [dense_crf(to_unit(images_u8[s:s + 8]) * 255.0, cam[s:s + 8].float(), **crf,
                     dtype=dtype) for s in range(0, cam.shape[0], 8)]
    return (torch.cat([m for m, _ in out]).cpu().numpy(),
            torch.cat([g for _, g in out]).cpu().numpy())
