"""ATSS assigner (counterpart of
``cvpytorch_tpu/models/assigners/atss_assigner.py``), batched over images.

Adaptive Training Sample Selection: each gt takes, on every level, the
``topk`` priors whose centres lie closest to its centre; the IoU
threshold of a gt is the mean plus the sample standard deviation (Bessel,
k − 1) of its candidates' IoUs; the positives are the candidates at or
above it (above it with ``strict_thr``) whose centre lies more than
``center_eps`` inside the gt.  A prior positive for several gts keeps the
one of highest IoU among them, or, with ``dedup_unmasked`` (YOLOv6's
warm-up flavour), the highest over every valid gt.

Priors lie on a regular grid, so two priors are often at exactly the same
distance from a gt centre.  The distances are computed in JAX's order of
operations (the root of the summed squares) so that such ties stay exact,
and the per-level ranks come from a stable sort along the priors, the
order of JAX's ``argsort``: of two tied priors the lower index ranks first.
"""
from __future__ import annotations

import torch

from ...ops.boxes import box_iou_matrix
from .dsl_assigner import _ranks


def atss_assign(priors, num_level_priors, cand_boxes, gt_boxes, gt_valid, topk: int = 9,
                center_eps: float = 0.01, strict_thr: bool = False,
                dedup_unmasked: bool = False):
    """priors (P, 4) cx, cy, s, s; ``num_level_priors`` the per-level prior
    counts (summing to P); cand_boxes (P, 4) xyxy, the boxes IoU'd against
    the gts (grid cells around the priors); gt_boxes (B, M, 4) xyxy;
    gt_valid (B, M) bool.  Returns ``{'matched_gt': (B, P) int64, −1
    background, 'matched_iou': (B, P)}``."""
    B, M = gt_valid.shape
    cx, cy = priors[None, :, 0, None], priors[None, :, 1, None]
    gcx = ((gt_boxes[..., 0] + gt_boxes[..., 2]) / 2)[:, None, :]
    gcy = ((gt_boxes[..., 1] + gt_boxes[..., 3]) / 2)[:, None, :]
    dx, dy = cx - gcx, cy - gcy
    dist = torch.sqrt(dx * dx + dy * dy)  # (B, P, M)
    ious = box_iou_matrix(cand_boxes, gt_boxes)  # (B, P, M)

    levels = []
    start = 0
    for n in num_level_priors:
        levels.append(_ranks(dist[:, start:start + n]) < min(topk, n))
        start += n
    candidate = torch.cat(levels, 1) & gt_valid[:, None, :]

    k_cand = candidate.sum(1).to(ious.dtype)  # (B, M)
    mean = torch.where(candidate, ious, 0.0).sum(1) / k_cand.clamp(min=1.0)
    dev = ious - mean[:, None, :]
    var = torch.where(candidate, dev * dev, 0.0).sum(1) / (k_cand - 1.0).clamp(min=1.0)
    thr = (mean + torch.sqrt(var))[:, None, :]

    l = cx - gt_boxes[:, None, :, 0]
    t = cy - gt_boxes[:, None, :, 1]
    r = gt_boxes[:, None, :, 2] - cx
    b = gt_boxes[:, None, :, 3] - cy
    inside = torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) > center_eps
    above = ious > thr if strict_thr else ious >= thr
    pos = candidate & inside & above

    best_gt = torch.where(pos, ious, -1.0).argmax(-1)
    if dedup_unmasked:
        # a prior positive for several gts: the argmax over every valid
        # gt's IoU (invalid gts are zero boxes, never that maximum)
        multi = pos.sum(-1) > 1
        best_gt = torch.where(multi, torch.where(gt_valid[:, None, :], ious, -1.0).argmax(-1),
                              best_gt)
    fg = pos.any(-1)
    matched_gt = torch.where(fg, best_gt, -1)
    matched_iou = torch.where(fg, ious.gather(-1, best_gt[..., None])[..., 0], 0.0)
    return {"matched_gt": matched_gt, "matched_iou": matched_iou}


def grid_cells(priors, scale: float):
    """xyxy squares of side ``scale``·stride centred on the priors (the
    octave cells of the GFL head, YOLOv6's warm-up anchors)."""
    half = 0.5 * scale * priors[:, 2]
    return torch.stack([priors[:, 0] - half, priors[:, 1] - half,
                        priors[:, 0] + half, priors[:, 1] + half], -1)

