"""GroundingDINO's post-processing as the JAX package uses it
(``post_process_grounded_object_detection``, ``processing_grounding_dino.py:192``):
sigmoid, the best score over the text columns (the padded and missing
tokens hold -inf logits, so they score 0), queries above ``threshold``,
cxcywh → xyxy scaled by (W, H, W, H), in query order.
"""

from __future__ import annotations

import torch


def center_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def grounded_boxes(logits: torch.Tensor, pred_boxes: torch.Tensor, threshold: float,
                   image_size: tuple[int, int]) -> torch.Tensor:
    """One image's logits [1, Q, T] and boxes [1, Q, 4] → kept boxes [N, 4]
    (x0, y0, x1, y1) in pixels of an image of ``image_size`` (H, W). The
    text threshold only labels the boxes in ``transformers``; the boxes do
    not depend on it."""
    scores = torch.sigmoid(logits).max(dim=-1)[0]
    H, W = image_size
    scale = torch.tensor([[W, H, W, H]], dtype=torch.int64, device=pred_boxes.device)
    boxes = center_to_corners(pred_boxes) * scale[:, None, :]
    return boxes[0][scores[0] > threshold]
