"""Box ops (counterpart of ``cvpytorch_tpu/ops/boxes.py``).

Boxes are ``(..., 4)`` float tensors; formats: xyxy (corner) and cxcywh
(center).  The arithmetic follows the JAX functions op for op, so f32
results agree bit for bit on the CPU.  ``bbox_iou`` (CIoU) comes with the
training slice.
"""
from __future__ import annotations

import torch


def xyxy_to_cxcywh(boxes):
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def cxcywh_to_xyxy(boxes):
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * \
        (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def box_iou_matrix(a, b, eps: float = 1e-7):
    """Pairwise IoU matrix: a (..., N, 4) × b (..., M, 4) → (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / (union + eps)


def clip_boxes(boxes, height, width):
    """Clip xyxy boxes to image bounds."""
    return torch.stack([
        boxes[..., 0].clamp(0, width),
        boxes[..., 1].clamp(0, height),
        boxes[..., 2].clamp(0, width),
        boxes[..., 3].clamp(0, height),
    ], -1)


def unletterbox_boxes(boxes, pads, scales):
    """Undo letterbox: xyxy boxes in network pixels → original pixels.
    pads (..., 2) = (pad_w, pad_h), scales (..., 2) = (scale_w, scale_h)."""
    pw, ph = pads[..., 0:1], pads[..., 1:2]
    sw, sh = scales[..., 0:1], scales[..., 1:2]
    return torch.cat([
        (boxes[..., 0:1] - pw) / sw,
        (boxes[..., 1:2] - ph) / sh,
        (boxes[..., 2:3] - pw) / sw,
        (boxes[..., 3:4] - ph) / sh,
    ], -1)
