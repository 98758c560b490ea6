"""Generalized Focal Loss family and the integral projection (counterpart
of ``cvpytorch_tpu/models/losses/gfl_loss.py``): fixed-shape functions of
per-prior tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.boxes import bbox_iou


def _softplus_abs(x):
    return torch.log1p(torch.exp(-x.abs()))


def quality_focal_loss(logits, labels, scores, beta: float = 2.0):
    """QFL: logits (N, C); labels (N,) int, C meaning background; scores
    (N,) the soft quality target of the labelled class.  Returns (N,)."""
    C = logits.shape[-1]
    sig = torch.sigmoid(logits)
    loss = (_softplus_abs(logits) + logits.clamp(min=0)) * sig ** beta
    pos = labels < C
    onehot = F.one_hot(torch.where(pos, labels, 0).long(), C).to(logits.dtype)
    t = onehot * scores[:, None]
    bce = logits.clamp(min=0) - logits * t + _softplus_abs(logits)
    pos_loss = bce * (t - sig).abs() ** beta
    loss = torch.where(pos[:, None] & (onehot > 0), pos_loss, loss)
    return loss.sum(-1)


def distribution_focal_loss(logits, targets):
    """DFL: logits (N, reg_max + 1), targets (N,) in [0, reg_max]: the
    cross-entropy to the two enclosing bins, linearly weighted."""
    tl = torch.floor(targets).to(torch.int64)
    tr = tl + 1
    wl = tr.to(torch.float32) - targets
    wr = targets - tl.to(torch.float32)
    logp = F.log_softmax(logits, -1)
    n = logits.shape[-1]
    tl, tr = tl.clamp(0, n - 1), tr.clamp(0, n - 1)
    return -(logp.gather(-1, tl[:, None])[:, 0] * wl
             + logp.gather(-1, tr[:, None])[:, 0] * wr)


def giou_loss(pred_boxes, target_boxes):
    """1 − GIoU of aligned xyxy boxes."""
    return 1.0 - bbox_iou(pred_boxes, target_boxes, iou_type="giou")


def integral_project(logits):
    """(..., 4, reg_max + 1) distributions → (..., 4) expected distances."""
    bins = torch.arange(logits.shape[-1], dtype=torch.float32, device=logits.device)
    return (torch.softmax(logits, -1) * bins).sum(-1)
