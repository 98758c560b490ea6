"""Dynamic Soft Label assigner (counterpart of
``cvpytorch_tpu/models/assigners/dsl_assigner.py``), batched over images.

A masked (B, P, M) cost problem of static shape, as the JAX function
computes it for each image:

* a prior is a candidate row when its centre lies inside any valid gt;
  IoU and cost are taken over those rows against every valid gt;
* cost = the soft-label classification cost + 3·(−log IoU), 1e8 off the
  candidates.  The caller hands in logits, and the cost applies the
  sigmoid *and then* a BCE-with-logits to the probabilities, as the
  reference does (probabilities as logits);
* dynamic_k of a gt = max(⌊Σ of its 13 largest IoUs⌋, 1); the sum runs
  in one fixed order (largest first), so every device truncates the same
  float;
* each gt takes its dynamic_k lowest-cost priors (ranks from a stable
  sort, the order of JAX's ``argsort``);
* a prior taken by several gts goes to the gt of least cost over **all**
  gts, which may be one that did not take it.

The classification cost builds (B, P, M, C) tensors: at NanoDet-Plus-320
and batch 96, (96, 2125, 64, 80) floats, 4.2 GB each in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.boxes import box_iou_matrix

INF = 1e8


def _ranks(x):
    """Rank of each element of (B, P, M) along P, ascending, ties in index
    order."""
    order = torch.argsort(x, dim=1, stable=True)
    idx = torch.arange(x.shape[1], device=x.device).reshape(1, -1, 1).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, idx)


def dsl_assign(pred_logits, priors, decoded_boxes, gt_boxes, gt_labels, gt_valid,
               topk: int = 13, iou_factor: float = 3.0):
    """pred_logits (B, P, C); priors (P, 4) cx, cy, sw, sh; decoded_boxes
    (B, P, 4) xyxy; gt_boxes (B, M, 4) xyxy; gt_labels (B, M); gt_valid
    (B, M) bool.  Returns ``{'matched_gt': (B, P) int64, −1 background,
    'matched_iou': (B, P)}``."""
    B, P, C = pred_logits.shape
    M = gt_boxes.shape[1]
    center = priors[None, :, None, :2]
    lt = center - gt_boxes[:, None, :, :2]
    rb = gt_boxes[:, None, :, 2:] - center
    inside = torch.cat([lt, rb], -1).amin(-1) > 0  # (B, P, M)
    row_valid = (inside & gt_valid[:, None, :]).any(-1)  # (B, P)
    valid = row_valid[..., None] & gt_valid[:, None, :]  # (B, P, M)

    ious = box_iou_matrix(decoded_boxes, gt_boxes) * row_valid[..., None] * gt_valid[:, None, :]
    iou_cost = -torch.log(ious + 1e-7)

    onehot = F.one_hot(torch.where(gt_valid, gt_labels, 0).long(), C).to(ious.dtype)
    soft = onehot[:, None] * ious[..., None]  # (B, P, M, C)
    x = torch.sigmoid(pred_logits)[:, :, None, :]  # probabilities as logits
    bce = x.clamp(min=0) - x * soft + torch.log1p(torch.exp(-x.abs()))
    cls_cost = (bce * (soft - x).abs() ** 2.0).sum(-1)  # (B, P, M)
    cost = torch.where(valid, cls_cost + iou_cost * iou_factor, INF)

    k = min(topk, P)
    top = ious.transpose(1, 2).topk(k, dim=-1).values  # (B, M, k), descending
    total = top[..., 0]
    for j in range(1, k):
        total = total + top[..., j]
    dynamic_ks = total.to(torch.int32).clamp(min=1)

    matching = (_ranks(cost) < dynamic_ks[:, None, :]) & valid
    best_gt = cost.argmin(-1)  # over all gts, first among equals
    keep = F.one_hot(best_gt, M).bool()
    matching = torch.where((matching.sum(-1) > 1)[..., None], keep, matching)

    fg = matching.any(-1)
    first = matching.to(torch.int32).argmax(-1)
    matched_gt = torch.where(fg, first, -1)
    matched_iou = torch.where(fg, ious.gather(-1, first[..., None])[..., 0], 0.0)
    return {"matched_gt": matched_gt, "matched_iou": matched_iou}
