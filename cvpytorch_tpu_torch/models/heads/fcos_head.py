"""FCOS head, targets, loss and decode (counterpart of
``cvpytorch_tpu/models/heads/fcos_head.py``), shared by FCOS and LFD.

Head: cls and reg towers of ``stacked_convs`` 3×3 convs + GroupNorm(32,
eps 1e-5) + ReLU, shared by every level; ``cls_out`` (bias from the prior
probability), ``cnt_out`` (centerness, on the reg tower unless
``cnt_on_reg`` is off) and ``reg_out`` whose output, times the level's
learned ``scale{i}`` (one value), goes through ``exp``.  Each level gives
(cls logits, cnt logits, ltrb) in NHWC order, so their flattening is the
JAX one (row-major (y, x)).

Targets (``gen_fcos_targets``): a location is positive for a gt when it
lies inside the box, the largest of its ltrb distances falls in the
level's range and it lies within 1.5 strides of the gt's centre; of
several such gts it takes the one of least area (``argmin`` over the
areas with 1e9 elsewhere: the first among equals).  Loss: focal
classification (α 0.25, γ 2) over every location, BCE centerness and
GIoU on the positives, each normalised by the image's positives and
averaged over the batch.  Decode: score √(max class prob · centerness).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.boxes import bbox_iou
from ...registry import HEADS

LIMIT_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 999999))
STRIDES = (8, 16, 32, 64, 128)


class Scale(nn.Module):
    """x · a learned scalar (shape (1,), the reference's ``ScaleExp``);
    the Flax ``scale`` leaf carries to ``weight``."""

    def __init__(self, init: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return x * self.weight


@HEADS.register(name="FCOSHead")
class FCOSHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 80, channels: int = 256,
                 stacked_convs: int = 4, prior: float = 0.01, cnt_on_reg: bool = True,
                 num_levels: int = 5):
        super().__init__()
        self.num_classes, self.stacked_convs, self.cnt_on_reg = (num_classes, stacked_convs,
                                                                 cnt_on_reg)
        for tower in ("cls", "reg"):
            for i in range(stacked_convs):
                setattr(self, f"{tower}_conv{i}",
                        nn.Conv2d(in_channels if i == 0 else channels, channels, 3, 1, 1))
                setattr(self, f"{tower}_gn{i}", nn.GroupNorm(32, channels, eps=1e-5))
        self.cls_out = nn.Conv2d(channels, num_classes, 3, 1, 1)
        nn.init.constant_(self.cls_out.bias, -math.log((1 - prior) / prior))
        self.cnt_out = nn.Conv2d(channels, 1, 3, 1, 1)
        self.reg_out = nn.Conv2d(channels, 4, 3, 1, 1)
        for i in range(num_levels):
            setattr(self, f"scale{i}", Scale())

    def _tower(self, name: str, x):
        for i in range(self.stacked_convs):
            x = torch.relu(getattr(self, f"{name}_gn{i}")(getattr(self, f"{name}_conv{i}")(x)))
        return x

    def forward(self, feats):
        """→ per level (cls logits (B, h, w, C), cnt logits (B, h, w, 1),
        ltrb (B, h, w, 4))."""
        outs = []
        for i, x in enumerate(feats):
            c, r = self._tower("cls", x), self._tower("reg", x)
            reg = torch.exp(getattr(self, f"scale{i}")(self.reg_out(r)))
            outs.append(tuple(y.permute(0, 2, 3, 1) for y in (
                self.cls_out(c), self.cnt_out(r if self.cnt_on_reg else c), reg)))
        return outs


def level_coords(h: int, w: int, stride: int, device=None):
    """(h·w, 2) location centres x, y: ``arange·s + s // 2``."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([(xs * stride + stride // 2).reshape(-1),
                        (ys * stride + stride // 2).reshape(-1)], -1)


def gen_fcos_targets(level_shapes, gt_boxes, gt_labels, gt_valid, strides=STRIDES,
                     limit_ranges=LIMIT_RANGES, radius_ratio: float = 1.5):
    """gt_boxes (B, M, 4) xyxy → over all levels: cls targets (B, L) int64
    (−1 background), cnt targets (B, L), ltrb targets (B, L, 4), coords
    (L, 2), strides (L,)."""
    cls_all, cnt_all, reg_all, coords_all, stride_all = [], [], [], [], []
    cxg = ((gt_boxes[..., 0] + gt_boxes[..., 2]) / 2)[:, None, :]
    cyg = ((gt_boxes[..., 1] + gt_boxes[..., 3]) / 2)[:, None, :]
    for (h, w), stride, (lo, hi) in zip(level_shapes, strides, limit_ranges):
        coords = level_coords(h, w, stride, gt_boxes.device).to(gt_boxes.dtype)
        x, y = coords[None, :, 0, None], coords[None, :, 1, None]
        ltrb = torch.stack([x - gt_boxes[:, None, :, 0], y - gt_boxes[:, None, :, 1],
                            gt_boxes[:, None, :, 2] - x, gt_boxes[:, None, :, 3] - y], -1)
        areas = (ltrb[..., 0] + ltrb[..., 2]) * (ltrb[..., 1] + ltrb[..., 3])  # (B, hw, M)
        far = ltrb.amax(-1)
        c_off = torch.maximum((x - cxg).abs(), (y - cyg).abs()).clamp(min=0)
        pos = ((ltrb.amin(-1) > 0) & (far > lo) & (far <= hi) & (c_off < stride * radius_ratio)
               & gt_valid[:, None, :])
        best = torch.where(pos, areas, 1e9).argmin(-1)  # (B, hw), the first among equals
        any_pos = pos.any(-1)
        reg_t = ltrb.gather(2, best[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        cls_t = gt_labels.gather(1, best)
        lr, tb = reg_t[..., 0::2], reg_t[..., 1::2]
        cnt_t = torch.sqrt(((lr.amin(-1) * tb.amin(-1)) / (lr.amax(-1) * tb.amax(-1) + 1e-10))
                           .clamp(min=0))
        cls_all.append(torch.where(any_pos, cls_t.long(), -1))
        cnt_all.append(torch.where(any_pos, cnt_t, -1.0))
        reg_all.append(torch.where(any_pos[..., None], reg_t, -1.0))
        coords_all.append(coords)
        stride_all.append(torch.full((coords.shape[0],), float(stride), dtype=coords.dtype,
                                     device=coords.device))
    return (torch.cat(cls_all, 1), torch.cat(cnt_all, 1), torch.cat(reg_all, 1),
            torch.cat(coords_all, 0), torch.cat(stride_all, 0))


def _flat(outs, num_classes):
    B = outs[0][0].shape[0]
    return (torch.cat([o[0].reshape(B, -1, num_classes) for o in outs], 1),
            torch.cat([o[1].reshape(B, -1) for o in outs], 1),
            torch.cat([o[2].reshape(B, -1, 4) for o in outs], 1))


def _boxes(coords, ltrb):
    x, y = coords[None, :, 0], coords[None, :, 1]
    return torch.stack([x - ltrb[..., 0], y - ltrb[..., 1], x + ltrb[..., 2], y + ltrb[..., 3]],
                       -1)


def _bce_logits(x, t):
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def fcos_loss(outs, gt_boxes, gt_labels, gt_valid, num_classes):
    """Focal classification + BCE centerness + GIoU (float32 or float64)."""
    level_shapes = [o[0].shape[1:3] for o in outs]
    with torch.profiler.record_function("fcos_targets"):  # a range in step profiles
        cls_t, cnt_t, reg_t, coords, _ = gen_fcos_targets(level_shapes, gt_boxes, gt_labels,
                                                          gt_valid)
    cls_logits, cnt_logits, reg_preds = _flat(outs, num_classes)
    pos = cls_t >= 0
    num_pos_i = pos.sum(-1).to(cls_logits.dtype).clamp(min=1.0)  # (B,)

    onehot = (torch.where(pos, cls_t, 0)[..., None]
              == torch.arange(num_classes, device=cls_t.device)).to(cls_logits.dtype)
    onehot = onehot * pos[..., None]
    p = torch.sigmoid(cls_logits)
    alpha, gamma = 0.25, 2.0
    hot = onehot > 0
    pt = torch.where(hot, p, 1 - p)
    alpha_t = torch.where(hot, alpha, 1 - alpha)
    focal = ((alpha_t * (1 - pt) ** gamma * _bce_logits(cls_logits, onehot)).sum((1, 2))
             / num_pos_i).mean()
    cnt_loss = ((_bce_logits(cnt_logits, cnt_t.clamp(min=0)) * pos).sum(-1) / num_pos_i).mean()
    giou = 1.0 - bbox_iou(_boxes(coords, reg_preds), _boxes(coords, reg_t), iou_type="giou")
    reg_loss = ((giou * pos).sum(-1) / num_pos_i).mean()
    total = focal + cnt_loss + reg_loss
    return total, {"cls_loss": focal, "cnt_loss": cnt_loss, "reg_loss": reg_loss}


def decode_fcos(outs, num_classes):
    """→ boxes (B, L, 4) xyxy, scores (B, L), labels (B, L)."""
    coords = torch.cat([level_coords(h, w, s, outs[0][0].device)
                        for (h, w), s in zip((o[0].shape[1:3] for o in outs), STRIDES)], 0)
    cls_logits, cnt_logits, reg_preds = _flat(outs, num_classes)
    cls_p = torch.sigmoid(cls_logits)
    best, labels = cls_p.max(-1)
    scores = torch.sqrt(best * torch.sigmoid(cnt_logits))
    return _boxes(coords.to(reg_preds.dtype), reg_preds), scores, labels
