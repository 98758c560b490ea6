"""Box ops (counterpart of ``cvpytorch_tpu/ops/boxes.py``).

Boxes are ``(..., 4)`` float tensors; formats: xyxy (corner) and cxcywh
(center).  The arithmetic follows the JAX functions op for op, so f32
results agree bit for bit on the CPU.
"""
from __future__ import annotations

import math

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


def bbox_iou(box1, box2, fmt: str = "xyxy", iou_type: str = "iou",
             eps: float = 1e-7):
    """Element-wise IoU/GIoU/DIoU/CIoU between aligned boxes.  CIoU's
    ``alpha`` is detached, as JAX's ``stop_gradient`` keeps it out of the
    gradient."""
    if fmt == "cxcywh":
        box1 = cxcywh_to_xyxy(box1)
        box2 = cxcywh_to_xyxy(box2)
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)

    iw = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
    ih = (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    inter = iw * ih
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if iou_type == "iou":
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # convex w
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if iou_type == "giou":
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area

    c2 = cw**2 + ch**2 + eps  # convex diagonal²
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 +
            (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    if iou_type == "diou":
        return iou - rho2 / c2
    if iou_type == "ciou":
        v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + eps)) -
                                torch.atan(w1 / (h1 + eps))) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + v * alpha)
    raise ValueError(iou_type)


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
