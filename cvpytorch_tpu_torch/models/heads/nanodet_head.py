"""NanoDet-Plus GFL head (counterpart of ``cvpytorch_tpu/models/heads/nanodet_head.py``),
NCHW.

Each level: ``stacked_convs`` depthwise blocks (``convs{i}_{s}_dw``, a
k×k depthwise convolution, BN and activation, then ``convs{i}_{s}_pw``,
1×1) and the 1×1 ``gfl_cls{i}`` emitting C + 4·(reg_max + 1) channels.
Decode: the integral of each ltrb distribution times the stride, around
the centre priors.  NanoDet-Plus's loss: DSL assignment on detached
predictions, then QFL + GIoU + DFL with the sigma-weighted averages of
the JAX loss (sums over the whole batch).

NanoDet v1 (``center_priors_v1``, ``nanodet_v1_loss``): priors at
(i + 0.5)·stride, ATSS assignment on the octave cells (5·stride squares
around them), and the QFL target the aligned IoU of the *decoded
prediction* against its gt, not the assignment's IoU; the same GIoU ×2
and DFL ×0.25 sigma-weighted terms.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.profiler import record_function

from ...registry import HEADS
from ..assigners.atss_assigner import atss_assign, grid_cells
from ..assigners.dsl_assigner import dsl_assign
from ..bricks import ConvBNAct
from ..losses.gfl_loss import (distribution_focal_loss, giou_loss, integral_project,
                               quality_focal_loss)

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


@HEADS.register(name="NanoDetPlusHead")
class NanoDetPlusHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 96, feat_channels: int = 96,
                 stacked_convs: int = 2, kernel_size: int = 5,
                 strides: Sequence[int] = (8, 16, 32, 64), reg_max: int = 7,
                 act: str = "leaky_relu"):
        super().__init__()
        self.n_levels, self.stacked_convs = len(strides), stacked_convs
        no = num_classes + 4 * (reg_max + 1)
        for i in range(self.n_levels):
            cin = in_channels
            for s in range(stacked_convs):
                setattr(self, f"convs{i}_{s}_dw", ConvBNAct(cin, cin, kernel_size, groups=cin,
                                                             act=act, **_BN))
                setattr(self, f"convs{i}_{s}_pw", ConvBNAct(cin, feat_channels, 1, act=act,
                                                             **_BN))
                cin = feat_channels
            setattr(self, f"gfl_cls{i}", nn.Conv2d(cin, no, 1))

    def forward(self, feats):
        """NCHW maps → flat (B, P_total, C + 4·(reg_max + 1)), level by
        level, each in row-major (y, x) order."""
        outs = []
        for i, x in enumerate(feats):
            for s in range(self.stacked_convs):
                x = getattr(self, f"convs{i}_{s}_pw")(getattr(self, f"convs{i}_{s}_dw")(x))
            y = getattr(self, f"gfl_cls{i}")(x)
            outs.append(y.permute(0, 2, 3, 1).flatten(1, 2))
        return torch.cat(outs, 1)


def center_priors(featmap_sizes, strides, device=None, offset: float = 0.0):
    """(P, 4): (x + offset)·s, (y + offset)·s, s, s for every cell of every
    level (offset 0.5: ``center_priors_v1``)."""
    priors = []
    for (h, w), s in zip(featmap_sizes, strides):
        ys, xs = torch.meshgrid(
            (torch.arange(h, dtype=torch.float32, device=device) + offset) * s,
            (torch.arange(w, dtype=torch.float32, device=device) + offset) * s,
            indexing="ij")
        p = torch.stack([xs, ys, torch.full_like(xs, s), torch.full_like(xs, s)], -1)
        priors.append(p.reshape(-1, 4))
    return torch.cat(priors, 0)


def center_priors_v1(featmap_sizes, strides, device=None):
    """NanoDet v1's GFL priors: centres at (i + 0.5)·stride."""
    return center_priors(featmap_sizes, strides, device, offset=0.5)


def decode_nanodet(preds, priors, num_classes, reg_max):
    """preds (B, P, no) → class logits (B, P, C), decoded xyxy boxes
    (B, P, 4) and the distributions (B, P, 4, reg_max + 1)."""
    cls_logits = preds[..., :num_classes]
    reg = preds[..., num_classes:].reshape(*preds.shape[:-1], 4, reg_max + 1)
    dist = integral_project(reg) * priors[None, :, 2, None]
    cx, cy = priors[None, :, 0], priors[None, :, 1]
    boxes = torch.stack([cx - dist[..., 0], cy - dist[..., 1],
                         cx + dist[..., 2], cy + dist[..., 3]], -1)
    return cls_logits, boxes, reg


def nanodet_loss(preds, priors, targets, num_classes, reg_max, topk: int = 13,
                 assign_preds=None):
    """The GFL loss of a padded-target batch (float32).  ``assign_preds``:
    the predictions the assignment is computed from (the aux head's, which
    then drive the matching of both heads); by default ``preds``."""
    cls_logits, decoded, reg = decode_nanodet(preds, priors, num_classes, reg_max)
    a_cls, a_dec = cls_logits, decoded
    if assign_preds is not None:
        a_cls, a_dec, _ = decode_nanodet(assign_preds, priors, num_classes, reg_max)
    with record_function("dsl_assign"):  # a range in step profiles
        assign = dsl_assign(a_cls.detach(), priors, a_dec.detach(), targets["boxes"],
                            targets["labels"], targets["valid"], topk, 3.0)
    return gfl_terms(cls_logits, decoded, reg, priors, targets, assign["matched_gt"],
                     assign["matched_iou"], reg_max)


def _aligned_iou(a, b):
    """IoU of aligned xyxy boxes (..., 4), the union at least 1e-6."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


def gfl_terms(cls_logits, decoded, reg, priors, targets, matched_gt, score, reg_max):
    """QFL against ``score`` (the quality target of each prior; None: the
    detached aligned IoU of each positive's decoded box with its gt), and
    the sigma-weighted GIoU ×2 and DFL ×0.25 of the positives: the terms
    NanoDet v1 and NanoDet-Plus share once the priors are assigned."""
    C = cls_logits.shape[-1]
    pos = matched_gt >= 0
    safe_gt = matched_gt.clamp(min=0)
    gt_boxes = targets["boxes"].gather(1, safe_gt[..., None].expand(-1, -1, 4))
    gt_labels = targets["labels"].gather(1, safe_gt)
    labels = torch.where(pos, gt_labels, C)
    num_pos = pos.sum().float().clamp(min=1.0)
    if score is None:
        score = _aligned_iou(decoded, gt_boxes).detach() * pos

    qfl = quality_focal_loss(cls_logits.reshape(-1, C), labels.reshape(-1), score.reshape(-1))
    loss_qfl = qfl.sum() / num_pos

    weight = torch.sigmoid(cls_logits).amax(-1).detach() * pos
    bbox_avg = weight.sum().clamp(min=1.0)
    l_giou = giou_loss(decoded.reshape(-1, 4), gt_boxes.reshape(-1, 4))
    loss_bbox = (l_giou * weight.reshape(-1) * 2.0).sum() / bbox_avg

    cx, cy, s = priors[None, :, 0], priors[None, :, 1], priors[None, :, 2]
    dist_t = torch.stack([cx - gt_boxes[..., 0], cy - gt_boxes[..., 1],
                          gt_boxes[..., 2] - cx, gt_boxes[..., 3] - cy], -1) / s[..., None]
    dist_t = dist_t.clamp(0, reg_max - 0.1)
    dfl = distribution_focal_loss(reg.reshape(-1, reg_max + 1), dist_t.reshape(-1))
    w4 = weight.reshape(-1).repeat_interleave(4)
    loss_dfl = (dfl * w4 * 0.25).sum() / (4.0 * bbox_avg)

    total = loss_qfl + loss_bbox + loss_dfl
    return total, {"qfl_loss": loss_qfl, "bbox_loss": loss_bbox, "dfl_loss": loss_dfl}


def nanodet_v1_loss(preds, priors, targets, num_classes, reg_max, num_level_priors,
                    octave_base_scale: int = 5, topk: int = 9):
    """NanoDet v1's GFL loss of a padded-target batch (float32): ATSS on
    the octave cells of the (i + 0.5)·stride ``priors`` (``num_level_priors``
    per level), the QFL target the detached aligned IoU of each positive's
    decoded box with its gt."""
    cls_logits, decoded, reg = decode_nanodet(preds, priors, num_classes, reg_max)
    with record_function("atss_assign"):  # a range in step profiles
        matched_gt = atss_assign(priors, num_level_priors, grid_cells(priors, octave_base_scale),
                                 targets["boxes"], targets["valid"], topk)["matched_gt"]
    return gfl_terms(cls_logits, decoded, reg, priors, targets, matched_gt, None, reg_max)
