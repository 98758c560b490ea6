"""SimOTA assigner (counterpart of
``cvpytorch_tpu/models/assigners/ota_assigner.py``), batched over images.

A masked (B, P, M) cost problem of static shape, as the JAX function
computes it for each image:

* a prior is a candidate row when its centre lies inside any valid gt or
  within ``center_radius``·stride of its centre; IoU, dynamic k and cost
  are taken over those rows against every valid gt;
* cost = a classification cost + 3·(−log IoU) + 1e8 outside the region
  that is both in the box and in the centre window, and 1e8 off the
  candidates;
* dynamic_k of a gt = max(⌊Σ of its ``topk`` largest IoUs⌋, 1), the sum
  taken in one fixed order (largest first) so that every device truncates
  the same float (only the values of the top k enter it, so their order
  among equals does not matter);
* each gt takes its dynamic_k lowest-cost priors: ranks from a stable sort
  along the priors (``dsl_assigner._ranks``), the order of JAX's
  ``argsort``.  With 1e8 added in float32 the costs off the strong region
  round to multiples of 8, so ties are common there and the stable order
  decides them as JAX does;
* a prior taken by several gts keeps the one of least cost among them.

The two cost variants of the JAX function:

* ``soft_label=False`` (YOLOX): BCE of √(cls·obj) against the gt's one-hot
  class;
* ``soft_label=True`` (the mm-style cost of GFLv2 heads): BCE of the class
  probabilities against onehot·IoU, times |onehot·IoU − p|².

JAX builds a (P, M, C) tensor an image for either.  The one-hot target is
0 off the gt's class, so each class term there depends on the prior alone:
the port sums those over the classes once, (B, P), and swaps in the gt
class's own term, a (B, P, M) gather.  The terms are the JAX ones exactly;
only the order of the summation over the classes differs (a float32 ulp
of the sum).  At YOLOX-s's batch 32 the JAX form would be 2.75e9 floats a
tensor.
"""
from __future__ import annotations

import torch

from ...ops.boxes import box_iou_matrix
from .dsl_assigner import _ranks

INF = 1e8


def _gather_classes(x, labels):
    """x (B, P, C), labels (B, M) → (B, P, M): x[b, p, labels[b, m]]."""
    B, P, _ = x.shape
    return x.gather(2, labels[:, None, :].expand(B, P, labels.shape[1]))


def simota_assign(cls_scores, obj_scores, priors, decoded_boxes, gt_boxes, gt_labels,
                  gt_valid, topk: int = 10, center_radius: float = 2.5,
                  soft_label: bool = False):
    """cls_scores (B, P, C) sigmoid probabilities; obj_scores (B, P)
    sigmoid (unused with ``soft_label``); priors (P, 4) cx, cy, stride,
    stride; decoded_boxes (B, P, 4) xyxy; gt_boxes (B, M, 4) xyxy,
    gt_labels (B, M), gt_valid (B, M) bool.  Returns ``{'matched_gt': (B,
    P) int64, −1 background, 'matched_iou': (B, P)}``."""
    B, P, C = cls_scores.shape
    cx, cy = priors[None, :, 0, None], priors[None, :, 1, None]
    gx1, gy1 = gt_boxes[:, None, :, 0], gt_boxes[:, None, :, 1]
    gx2, gy2 = gt_boxes[:, None, :, 2], gt_boxes[:, None, :, 3]
    in_box = (cx > gx1) & (cx < gx2) & (cy > gy1) & (cy < gy2)  # (B, P, M)
    gcx = ((gt_boxes[..., 0] + gt_boxes[..., 2]) / 2)[:, None, :]
    gcy = ((gt_boxes[..., 1] + gt_boxes[..., 3]) / 2)[:, None, :]
    r = center_radius * priors[None, :, 2, None]
    in_center = ((cx - gcx).abs() < r) & ((cy - gcy).abs() < r)
    valid_gt = gt_valid[:, None, :]
    row_valid = ((in_box | in_center) & valid_gt).any(-1)  # (B, P)
    strong = in_box & in_center

    ious = box_iou_matrix(decoded_boxes, gt_boxes) * row_valid[..., None] * valid_gt
    iou_cost = -torch.log(ious + 1e-7)

    labels = torch.where(gt_valid, gt_labels, 0).long()
    if soft_label:
        p = cls_scores.clamp(1e-7, 1 - 1e-7)
        log_p, log1m_p = torch.log(p), torch.log1p(-p)
        off = -log1m_p * p ** 2.0  # the term of a class the gt is not
        soft = ious  # onehot·IoU at the gt's class
        pg = _gather_classes(p, labels)
        at_gt = -(soft * _gather_classes(log_p, labels)
                  + (1 - soft) * _gather_classes(log1m_p, labels)) * (soft - pg).abs() ** 2.0
        cls_cost = off.sum(-1)[..., None] - _gather_classes(off, labels) + at_gt
    else:
        joint = torch.sqrt(cls_scores.clamp(min=1e-8) * obj_scores.clamp(min=1e-8)[..., None])
        off = -torch.log(1 - joint + 1e-8)  # target 0
        at_gt = -torch.log(joint + 1e-8)  # target 1
        cls_cost = (off.sum(-1)[..., None] - _gather_classes(off, labels)
                    + _gather_classes(at_gt, labels))

    cost = cls_cost + 3.0 * iou_cost + INF * (~strong).to(cls_cost.dtype)
    valid = row_valid[..., None] & valid_gt
    cost = torch.where(valid, cost, INF)

    k = min(topk, P)
    top = ious.transpose(1, 2).topk(k, dim=-1).values  # (B, M, k), descending
    total = top[..., 0]
    for j in range(1, k):
        total = total + top[..., j]
    dynamic_ks = total.to(torch.int32).clamp(min=1)

    matching = (_ranks(cost) < dynamic_ks[:, None, :]) & valid
    n_match = matching.sum(-1)
    best_gt = torch.where(matching, cost, INF).argmin(-1)  # first among equals
    keep = torch.nn.functional.one_hot(best_gt, gt_boxes.shape[1]).bool()
    matching = torch.where((n_match > 1)[..., None], matching & keep, matching)

    fg = matching.any(-1)
    first = matching.to(torch.int32).argmax(-1)
    matched_gt = torch.where(fg, first, -1)
    matched_iou = torch.where(fg, ious.gather(-1, first[..., None])[..., 0], 0.0)
    return {"matched_gt": matched_gt, "matched_iou": matched_iou}
