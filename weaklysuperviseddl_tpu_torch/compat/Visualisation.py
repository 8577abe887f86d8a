"""Reference surface: TraditionalModel/Visualisation.py and the mask view of
AlternatingDirectionBoundaryLoss.py:79-95 (port of
weaklysuperviseddl_tpu/compat/Visualisation.py). matplotlib is imported
where a function draws."""

from __future__ import annotations

import numpy as np

from weaklysuperviseddl_tpu_torch.compat._adapt import to_numpy


def _hwc_float(x) -> np.ndarray:
    """An image as float32 numpy, a [3,H,W] one transposed to [H,W,3]."""
    img = to_numpy(x).astype(np.float32)
    if img.ndim == 3 and img.shape[0] == 3 and img.shape[-1] != 3:
        img = img.transpose(1, 2, 0)
    return img


def overlay_cam_on_image(image_tensor, cam_tensor, alpha: float = 0.5, colormap: str = "gray"):
    """Reference Visualisation.py:5-33: a min-max normalised CAM's heat map
    blended over the image; (H,W,3) float in [0,1]."""
    import matplotlib

    img = _hwc_float(image_tensor)
    if img.max() > 1.5:
        img = img / 255.0
    cam = to_numpy(cam_tensor).astype(np.float32)
    cam = (cam - cam.min()) / (cam.max() + 1e-8)
    heatmap = matplotlib.colormaps[colormap](cam)[:, :, :3]
    return np.clip((1 - alpha) * img + alpha * heatmap, 0, 1)


def visualize_mask(img_tensor, mask_tensor, title: str = "", save_path: str | None = None):
    """Reference AlternatingDirectionBoundaryLoss.py:79-95: the image beside
    the mask, saved to ``save_path`` where the reference shows it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = _hwc_float(img_tensor)
    img = (img - img.min()) / (img.max() - img.min() + 1e-8)
    mask = to_numpy(mask_tensor).astype(np.float32)

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(img)
    axes[0].set_title("Image")
    axes[0].axis("off")
    axes[1].imshow(mask, cmap="gray")
    axes[1].set_title(title)
    axes[1].axis("off")
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path)
    plt.close(fig)
    return fig


def plot_segmentation(image, mask_np, title: str = "Predicted Mask", save_path: str | None = None):
    """Reference two_stage_foundation.py:76-87."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].imshow(np.asarray(image))
    axes[0].set_title("Original Image")
    axes[0].axis("off")
    axes[1].imshow(np.asarray(mask_np), cmap="gray")
    axes[1].set_title(title)
    axes[1].axis("off")
    if save_path:
        plt.savefig(save_path)
    plt.close(fig)
    return fig
