"""Task-aligned assigner (counterpart of
``cvpytorch_tpu/models/assigners/tal_assigner.py``), batched over images.

The alignment metric m = s^α · IoU^β (α = 1, β = 6) of a prior and a gt,
s the prior's score for the gt's class, over the priors whose centre lies
strictly inside the gt; each gt takes its ``topk`` priors of largest
metric (every prior at or above the k-th value, so ties all pass) with a
positive metric; a prior taken by several gts keeps the one of highest
IoU.  The soft target of a positive is its metric scaled so that each
gt's largest equals that gt's largest IoU, clipped to [0, 1].
"""
from __future__ import annotations

import torch

from ...ops.boxes import box_iou_matrix


def tal_assign(cls_scores, priors, decoded_boxes, gt_boxes, gt_labels, gt_valid,
               topk: int = 13, alpha: float = 1.0, beta: float = 6.0):
    """cls_scores (B, P, C) probabilities; priors (P, 4) cx, cy, s, s;
    decoded_boxes (B, P, 4) xyxy; gt_boxes (B, M, 4) xyxy; gt_labels
    (B, M); gt_valid (B, M) bool.  Returns ``{'matched_gt': (B, P) int64,
    −1 background, 'matched_iou': (B, P), 'align_metric': (B, P)}``."""
    B, P, C = cls_scores.shape
    M = gt_boxes.shape[1]
    cx, cy = priors[None, :, 0, None], priors[None, :, 1, None]
    g = gt_boxes[:, None]
    inside = (cx > g[..., 0]) & (cx < g[..., 2]) & (cy > g[..., 1]) & (cy < g[..., 3])
    candidate = inside & gt_valid[:, None, :]  # (B, P, M)

    ious = torch.where(candidate, box_iou_matrix(decoded_boxes, gt_boxes), 0.0)
    labels = torch.where(gt_valid, gt_labels, 0).long()
    cls_at_gt = cls_scores.gather(2, labels[:, None, :].expand(B, P, M))
    metric = torch.where(candidate, (cls_at_gt ** alpha) * (ious ** beta), -1.0)

    kth = metric.topk(min(topk, P), dim=1).values[:, -1:, :]
    top = (metric >= kth) & candidate & (metric > 0)

    best_gt = torch.where(top, ious, -1.0).argmax(-1)
    keep = torch.arange(M, device=ious.device) == best_gt[..., None]
    matching = torch.where((top.sum(-1) > 1)[..., None], top & keep, top)

    fg = matching.any(-1)
    first = matching.to(torch.int32).argmax(-1)
    matched_gt = torch.where(fg, first, -1)

    def take(t):
        return torch.where(fg, t.gather(-1, first[..., None])[..., 0], 0.0)

    per_gt_max_m = torch.where(matching, metric, 0.0).amax(1)  # (B, M)
    per_gt_max_iou = torch.where(matching, ious, 0.0).amax(1)
    norm = per_gt_max_iou / per_gt_max_m.clamp(min=1e-9)
    align = take(metric) * take(norm[:, None, :].expand(B, P, M))
    return {"matched_gt": matched_gt, "matched_iou": take(ious),
            "align_metric": align.clamp(0.0, 1.0)}
