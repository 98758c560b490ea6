"""GFocalHeadV2 and the GFLv2 loss (counterpart of
``cvpytorch_tpu/models/heads/gflv2_head.py``), NCHW.

Per level: ``stacked_convs`` grouped 3×3 ConvBNAct towers ``cls{i}_{j}``
and ``reg{i}_{j}`` (SiLU, BN torch momentum 0.03, eps 1e-3), ``gfl_cls{i}``
(bias −log 99) and ``gfl_reg{i}`` (4 × (reg_max + 1)) scaled by the scalar
``scale{i}``.  The Distribution-Guided Quality Predictor takes each edge's
top 4 bin probabilities and their mean (``reg_conf{i}_0``, ReLU,
``reg_conf{i}_1``, sigmoid) and scales the class sigmoid by it, so the
head outputs probabilities.  The top 4 come from a stable descending sort
of the 15 bins: equal probabilities keep the lower bin first, as
``jax.lax.top_k``, so a tie's gradient goes where JAX's goes.

Loss (``gflv2_loss``): SimOTA (soft-label costs, objectness 1, top 10,
radius 2.5) on the integral-decoded boxes in the ``simota_assign`` range,
QFL in probability space (``log1p(−p)``, not the logit-space
``gfl_loss.quality_focal_loss``) over num_pos, GIoU × 2 and DFL × 0.25
weighted by the detached best class probability, DFL targets clipped to
reg_max − 0.1.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...ops.boxes import bbox_iou
from ...registry import HEADS
from ..assigners.ota_assigner import simota_assign
from ..bricks import ConvBNAct
from ..losses.gfl_loss import distribution_focal_loss, giou_loss, integral_project
from .nanodet_head import center_priors


class ScaleLayer(nn.Module):
    """x · a learned scalar (``weight``: the JAX leaf ``scale``)."""

    def __init__(self, init: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x):
        return x * self.weight


@HEADS.register(name="GFocalHeadV2")
class GFocalHeadV2(nn.Module):
    def __init__(self, num_classes: int = 80, feat_channels: Sequence[int] = (96, 160, 384),
                 stacked_convs: int = 4, reg_max: int = 14, reg_topk: int = 4,
                 reg_channels: int = 64, add_mean: bool = True, conv_groups: int = 2,
                 strides: Sequence[int] = (8, 16, 32), prior: float = 0.01):
        super().__init__()
        self.num_classes, self.reg_max, self.reg_topk = num_classes, reg_max, reg_topk
        self.stacked_convs, self.add_mean, self.strides = stacked_convs, add_mean, tuple(strides)
        self.n_levels = len(feat_channels)
        total_dim = reg_topk + (1 if add_mean else 0)
        for i, ch in enumerate(feat_channels):
            for j in range(stacked_convs):
                for kind in ("cls", "reg"):
                    setattr(self, f"{kind}{i}_{j}",
                            ConvBNAct(ch, ch, 3, groups=conv_groups, act="silu"))
            cls = nn.Conv2d(ch, num_classes, 3, 1, 1)
            nn.init.constant_(cls.bias, -math.log((1 - prior) / prior))
            setattr(self, f"gfl_cls{i}", cls)
            setattr(self, f"gfl_reg{i}", nn.Conv2d(ch, 4 * (reg_max + 1), 3, 1, 1))
            setattr(self, f"scale{i}", ScaleLayer())
            setattr(self, f"reg_conf{i}_0", nn.Conv2d(4 * total_dim, reg_channels, 1))
            setattr(self, f"reg_conf{i}_1", nn.Conv2d(reg_channels, 1, 1))

    def forward(self, feats):
        """→ (class probabilities (B, P, C), regression logits (B, P, 4,
        reg_max + 1), priors (P, 4)), level by level in row-major order."""
        cls_all, reg_all = [], []
        n = self.reg_max + 1
        for i, x in enumerate(feats):
            c = r = x
            for j in range(self.stacked_convs):
                c = getattr(self, f"cls{i}_{j}")(c)
                r = getattr(self, f"reg{i}_{j}")(r)
            cls_logits = getattr(self, f"gfl_cls{i}")(c)
            reg = getattr(self, f"scale{i}")(getattr(self, f"gfl_reg{i}")(r))
            B, _, H, W = reg.shape
            reg4 = reg.permute(0, 2, 3, 1).reshape(B, H, W, 4, n)
            prob = torch.softmax(reg4, -1)
            topk = prob.sort(dim=-1, descending=True, stable=True).values[..., :self.reg_topk]
            stat = torch.cat([topk, topk.mean(-1, keepdim=True)], -1) if self.add_mean else topk
            stat = stat.reshape(B, H, W, -1).permute(0, 3, 1, 2)
            q = F.relu(getattr(self, f"reg_conf{i}_0")(stat))
            q = torch.sigmoid(getattr(self, f"reg_conf{i}_1")(q))
            cls_prob = torch.sigmoid(cls_logits) * q
            cls_all.append(cls_prob.permute(0, 2, 3, 1).reshape(B, H * W, self.num_classes))
            reg_all.append(reg4.reshape(B, H * W, 4, n))
        priors = center_priors([f.shape[-2:] for f in feats], self.strides, feats[0].device)
        return torch.cat(cls_all, 1), torch.cat(reg_all, 1), priors


def qfl_probability(probs, labels, scores, beta: float = 2.0):
    """QFL on probabilities (N, C); labels (N,), C meaning background;
    scores (N,) the labelled class's soft target.  Returns (N,)."""
    C = probs.shape[-1]
    p = probs.clamp(1e-6, 1 - 1e-6)
    pos = labels < C
    onehot = (torch.where(pos, labels, 0)[:, None] == torch.arange(C, device=labels.device))
    t = (onehot & pos[:, None]).to(p.dtype) * scores[:, None]
    bce = -(t * torch.log(p) + (1 - t) * torch.log1p(-p))
    return (bce * (t - p).abs() ** beta).sum(-1)


def gflv2_decode(cls_probs, reg_logits, priors):
    """→ (B, P, 4) xyxy boxes in network pixels."""
    dist = integral_project(reg_logits) * priors[None, :, 2, None]
    cx, cy = priors[None, :, 0], priors[None, :, 1]
    return torch.stack([cx - dist[..., 0], cy - dist[..., 1],
                        cx + dist[..., 2], cy + dist[..., 3]], -1)


def gflv2_loss(cls_probs, reg_logits, priors, targets, num_classes, reg_max):
    """(total, {qfl_loss, bbox_loss, dfl_loss}) of a padded-target batch."""
    decoded = gflv2_decode(cls_probs, reg_logits, priors)
    B, P, C = cls_probs.shape
    with record_function("simota_assign"), torch.no_grad():
        assign = simota_assign(cls_probs, torch.ones_like(cls_probs[..., 0]), priors, decoded,
                               targets["boxes"], targets["labels"], targets["valid"],
                               topk=10, center_radius=2.5, soft_label=True)
    matched_gt = assign["matched_gt"]
    pos = matched_gt >= 0
    safe = matched_gt.clamp(min=0)
    gt_boxes = targets["boxes"].gather(1, safe[..., None].expand(-1, -1, 4))
    gt_labels = targets["labels"].gather(1, safe)
    labels = torch.where(pos, gt_labels, num_classes)
    num_pos = pos.sum().to(cls_probs.dtype).clamp(min=1.0)

    iou_q = bbox_iou(decoded.detach(), gt_boxes).clamp(min=0)
    loss_qfl = qfl_probability(cls_probs.reshape(-1, C), labels.reshape(-1),
                               (iou_q * pos).reshape(-1)).sum() / num_pos

    weight = cls_probs.detach().max(-1).values * pos
    norm = weight.sum().clamp(min=1.0)
    l_giou = giou_loss(decoded.reshape(-1, 4), gt_boxes.reshape(-1, 4))
    loss_bbox = (l_giou * weight.reshape(-1) * 2.0).sum() / norm

    cx, cy, s = priors[None, :, 0], priors[None, :, 1], priors[None, :, 2]
    dist_t = torch.stack([cx - gt_boxes[..., 0], cy - gt_boxes[..., 1],
                          gt_boxes[..., 2] - cx, gt_boxes[..., 3] - cy], -1) / s[..., None]
    dist_t = dist_t.clamp(0, reg_max - 0.1)
    dfl = distribution_focal_loss(reg_logits.reshape(-1, reg_max + 1), dist_t.reshape(-1))
    w4 = weight.reshape(-1).repeat_interleave(4)
    loss_dfl = (dfl * w4 * 0.25).sum() / (4.0 * norm)
    total = loss_qfl + loss_bbox + loss_dfl
    return total, {"qfl_loss": loss_qfl, "bbox_loss": loss_bbox, "dfl_loss": loss_dfl}
