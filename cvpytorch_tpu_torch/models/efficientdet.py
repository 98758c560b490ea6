"""EfficientDet (counterpart of ``cvpytorch_tpu/models/efficientdet.py``),
NCHW: an EfficientNet backbone, repeated BiFPN cells and the shared
separable-conv heads over 9 anchors a cell, under the forward contract
``model(images, targets, mode)``.

* The compound coefficient is the last character of ``TYPE``
  (``efficientnet_b0`` → D0: 64 channels, 3 BiFPN cells, 3 head layers).
* BiFPN cell: fast-attention fusion relu(w) / (Σ relu(w) + 1e-4) with the
  bare fusion weights ``p6_w1`` … ``p7_w2`` of the cell, swish before each
  separable conv, bilinear upsampling to the finer map's size with
  half-pixel centres (not always ×2: at 96² P5 is 3² and P6 2²), and a
  3×3/2 TF-"same" max-pool that pads with zeros, not −inf, so a negative
  border feature pools to 0.  The first cell down-channels P3–P5 (P4 and
  P5 twice, the second copies feeding the bottom-up pass) and builds P6
  and P7 from P5.
* ``SeparableConvBlock``: depthwise 3×3 without bias, pointwise 1×1 with
  bias, BN torch momentum 0.01, eps 1e-3 (flax 0.99).
* The heads share their separable convs across the five levels and keep
  one BN per level and layer, ``bn{level}_{layer}``.
* Anchors: y1x1y2x2, 3 scales × 3 ratios a cell, centres at stride / 2,
  float64 numpy cast to float32 (49,104 at 512²).
* Loss (``efficientdet_loss``): padded gts get IoU −1; anchors with IoU ≥
  .5 positive, < .4 negative, between ignored; focal loss (α .25, γ 2)
  on probabilities clipped to [1e-4, 1 − 1e-4]; smooth-L1 (β 1/9) on
  (dy, dx, dh, dw), × 50.  The target build runs without gradient in the
  ``effdet_targets`` range and holds one (B, P, M) IoU tensor.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..ops.boxes import unletterbox_boxes
from ..ops.nms import batched_nms
from ..registry import MODELS, NECKS
from .backbones import build_backbone
from .bricks import BatchNorm2d
from .heads.seg_heads import resize_bilinear
from .nanodet_plus import _at_least_f32

_BN = dict(eps=1e-3, momentum=0.01)

# compound-coefficient tables
FPN_FILTERS = (64, 88, 112, 160, 224, 288, 384, 384)
FPN_REPEATS = (3, 4, 5, 6, 7, 7, 8, 8)
BOX_REPEATS = (3, 3, 3, 4, 4, 4, 5, 5)
ANCHOR_SCALES = (4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 5.0)


def _swish(x):
    return x * torch.sigmoid(x)


class SeparableConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm: bool = True):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(in_channels, in_channels, 3, 1, 1, groups=in_channels,
                                        bias=False)
        self.pointwise_conv = nn.Conv2d(in_channels, out_channels, 1)
        if norm:
            self.bn = BatchNorm2d(out_channels, **_BN)

    def forward(self, x):
        x = self.pointwise_conv(self.depthwise_conv(x))
        return self.bn(x) if hasattr(self, "bn") else x


class ConvBN(nn.Module):
    """1×1 conv (bias) + BN: the BiFPN's down-channel block."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)
        self.bn = BatchNorm2d(out_channels, **_BN)

    def forward(self, x):
        return self.bn(self.conv(x))


def maxpool_same(x, k: int = 3, s: int = 2):
    """TF-"same" k×k/s max-pool whose padding is zeros (``F.pad``), not
    −inf: a border window of negative features pools to 0."""
    h, w = x.shape[-2:]
    ev = (math.ceil(h / s) - 1) * s - h + k
    eh = (math.ceil(w / s) - 1) * s - w + k
    x = F.pad(x, (eh // 2, eh - eh // 2, ev // 2, ev - ev // 2))
    return F.max_pool2d(x, k, s)


def _up_bilinear(x, ref):
    return resize_bilinear(x, ref.shape[-2:])


class BiFPNCell(nn.Module):
    """One weighted bidirectional pass; ``in_channels`` are the backbone's
    C3–C5 widths for the first cell (None for the others)."""

    def __init__(self, channels: int, in_channels: Sequence[int] | None = None,
                 epsilon: float = 1e-4):
        super().__init__()
        self.first_time, self.eps = in_channels is not None, epsilon
        if self.first_time:
            c3, c4, c5 = in_channels
            self.p5_to_p6 = ConvBN(c5, channels)
            self.p3_down_channel = ConvBN(c3, channels)
            self.p4_down_channel = ConvBN(c4, channels)
            self.p5_down_channel = ConvBN(c5, channels)
            self.p4_down_channel_2 = ConvBN(c4, channels)
            self.p5_down_channel_2 = ConvBN(c5, channels)
        for name in ("conv6_up", "conv5_up", "conv4_up", "conv3_up", "conv4_down",
                     "conv5_down", "conv6_down", "conv7_down"):
            setattr(self, name, SeparableConvBlock(channels, channels))
        for name, n in (("p6_w1", 2), ("p5_w1", 2), ("p4_w1", 2), ("p3_w1", 2),
                        ("p4_w2", 3), ("p5_w2", 3), ("p6_w2", 3), ("p7_w2", 2)):
            setattr(self, name, nn.Parameter(torch.ones(n)))

    def _fuse(self, name, conv, xs):
        w = F.relu(getattr(self, name))
        w = w / (w.sum() + self.eps)
        return getattr(self, conv)(_swish(sum(wi * x for wi, x in zip(w, xs))))

    def forward(self, feats):
        if self.first_time:
            p3, p4, p5 = feats
            p6_in = maxpool_same(self.p5_to_p6(p5))
            p7_in = maxpool_same(p6_in)
            p3_in = self.p3_down_channel(p3)
            p4_in = self.p4_down_channel(p4)
            p5_in = self.p5_down_channel(p5)
        else:
            p3_in, p4_in, p5_in, p6_in, p7_in = feats
        p6_up = self._fuse("p6_w1", "conv6_up", [p6_in, _up_bilinear(p7_in, p6_in)])
        p5_up = self._fuse("p5_w1", "conv5_up", [p5_in, _up_bilinear(p6_up, p5_in)])
        p4_up = self._fuse("p4_w1", "conv4_up", [p4_in, _up_bilinear(p5_up, p4_in)])
        p3_out = self._fuse("p3_w1", "conv3_up", [p3_in, _up_bilinear(p4_up, p3_in)])
        if self.first_time:
            p4_in = self.p4_down_channel_2(p4)
            p5_in = self.p5_down_channel_2(p5)
        p4_out = self._fuse("p4_w2", "conv4_down", [p4_in, p4_up, maxpool_same(p3_out)])
        p5_out = self._fuse("p5_w2", "conv5_down", [p5_in, p5_up, maxpool_same(p4_out)])
        p6_out = self._fuse("p6_w2", "conv6_down", [p6_in, p6_up, maxpool_same(p5_out)])
        p7_out = self._fuse("p7_w2", "conv7_down", [p7_in, maxpool_same(p6_out)])
        return p3_out, p4_out, p5_out, p6_out, p7_out


@NECKS.register(name="BiFPN")
class BiFPN(nn.Module):
    """``repeats`` cells ``cell{r}``, the first on the backbone's C3–C5
    (``in_channels``); → P3–P7 of ``channels`` each."""

    def __init__(self, in_channels: Sequence[int], channels: int = 64, repeats: int = 3):
        super().__init__()
        self.repeats = repeats
        for r in range(repeats):
            setattr(self, f"cell{r}", BiFPNCell(channels, in_channels if r == 0 else None))

    def forward(self, feats):
        for r in range(self.repeats):
            feats = getattr(self, f"cell{r}")(feats)
        return feats


class Regressor(nn.Module):
    """Shared separable ``conv{i}`` (no BN) with per-level ``bn{level}_{i}``
    and swish, then the shared ``header``; → (B, Σ H·W·A, ``out_dim``),
    level by level in row-major (y, x, anchor) order."""

    def __init__(self, channels: int, num_anchors: int, num_layers: int, out_dim: int = 4,
                 num_levels: int = 5):
        super().__init__()
        self.num_anchors, self.num_layers, self.out_dim = num_anchors, num_layers, out_dim
        self.num_levels = num_levels
        for i in range(num_layers):
            setattr(self, f"conv{i}", SeparableConvBlock(channels, channels, norm=False))
            for lvl in range(num_levels):
                setattr(self, f"bn{lvl}_{i}", BatchNorm2d(channels, **_BN))
        self.header = SeparableConvBlock(channels, num_anchors * out_dim, norm=False)

    def forward(self, feats):
        outs = []
        for lvl, f in enumerate(feats):
            for i in range(self.num_layers):
                f = _swish(getattr(self, f"bn{lvl}_{i}")(getattr(self, f"conv{i}")(f)))
            f = self.header(f)
            outs.append(f.permute(0, 2, 3, 1).reshape(f.shape[0], -1, self.out_dim))
        return torch.cat(outs, 1)


@functools.lru_cache(maxsize=16)
def _anchors_np(image_hw: tuple, pyramid_levels: tuple, anchor_scale: float) -> np.ndarray:
    scales = [2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)]
    ratios = [(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]
    ih, iw = image_hw
    all_boxes = []
    for lvl in pyramid_levels:
        stride = 2 ** lvl
        level = []
        for scale, ratio in itertools.product(scales, ratios):
            base = anchor_scale * stride * scale
            ax2, ay2 = base * ratio[0] / 2.0, base * ratio[1] / 2.0
            xv, yv = np.meshgrid(np.arange(stride / 2, iw, stride),
                                 np.arange(stride / 2, ih, stride))
            xv, yv = xv.reshape(-1), yv.reshape(-1)
            level.append(np.stack([yv - ay2, xv - ax2, yv + ay2, xv + ax2], -1)[:, None, :])
        all_boxes.append(np.concatenate(level, 1).reshape(-1, 4))
    return np.concatenate(all_boxes, 0).astype(np.float32)


def efficientdet_anchors(image_hw, pyramid_levels=(3, 4, 5, 6, 7), anchor_scale: float = 4.0,
                         device=None):
    """(P, 4) float32 y1x1y2x2 anchors: per level, per cell (row-major), the
    3 scales × 3 ratios, computed in float64 numpy (once per size; each
    call gets its own copy)."""
    return torch.tensor(_anchors_np(tuple(int(s) for s in image_hw), tuple(pyramid_levels),
                                    float(anchor_scale)), device=device)


def decode_effdet(anchors, regression):
    """(dy, dx, dh, dw) against y1x1y2x2 anchors → xyxy."""
    ya = (anchors[..., 0] + anchors[..., 2]) / 2
    xa = (anchors[..., 1] + anchors[..., 3]) / 2
    ha = anchors[..., 2] - anchors[..., 0]
    wa = anchors[..., 3] - anchors[..., 1]
    w = torch.exp(regression[..., 3]) * wa
    h = torch.exp(regression[..., 2]) * ha
    yc = regression[..., 0] * ha + ya
    xc = regression[..., 1] * wa + xa
    return torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], -1)


def effdet_targets(anchors, boxes, valid):
    """Per anchor: the best gt's IoU (−1 where the image has no valid gt)
    and its index (the first maximum), from one (B, P, M) IoU tensor
    built in place; anchors y1x1y2x2, gts xyxy."""
    ay1, ax1, ay2, ax2 = (anchors[None, :, i, None] for i in range(4))
    gx1, gy1, gx2, gy2 = (boxes[:, None, :, i] for i in range(4))
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    a_area = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
    inter = torch.minimum(ax2, gx2).sub_(torch.maximum(ax1, gx1)).clamp_(min=0)
    inter.mul_(torch.minimum(ay2, gy2).sub_(torch.maximum(ay1, gy1)).clamp_(min=0))
    ua = (a_area[None, :, None] + area[:, None, :]).sub_(inter).clamp_(min=1e-8)
    iou = inter.div_(ua)
    del ua
    iou.masked_fill_(~valid[:, None, :], -1.0)
    return iou.max(-1)


def efficientdet_loss(classifications, regressions, anchors, targets, alpha: float = 0.25,
                      gamma: float = 2.0):
    """(cls loss, reg loss × 50), each the mean over images of its
    per-image value; classifications (B, P, C) probabilities, regressions
    (B, P, 4), anchors (P, 4) float32 (their sizes and centres are taken
    in float32 whatever the loss's dtype, as in JAX), targets the padded
    gt dict."""
    aw = anchors[:, 3] - anchors[:, 1]
    ah = anchors[:, 2] - anchors[:, 0]
    ax = anchors[:, 1] + 0.5 * aw
    ay = anchors[:, 0] + 0.5 * ah
    C = classifications.shape[-1]
    boxes, labels = targets["boxes"], targets["labels"]
    with record_function("effdet_targets"), torch.no_grad():
        iou_max, arg = effdet_targets(anchors, boxes, targets["valid"])
        pos = iou_max >= 0.5
        known = (pos | (iou_max < 0.4)).to(classifications.dtype)
        num_pos = pos.sum(-1).to(classifications.dtype)
        a_lab = labels.gather(1, arg)
        t = (pos[..., None] & (a_lab[..., None] == torch.arange(C, device=labels.device)))
        t = t.to(classifications.dtype)
        g = boxes.gather(1, arg[..., None].expand(-1, -1, 4))
        gw = (g[..., 2] - g[..., 0]).clamp(min=1.0)
        gh = (g[..., 3] - g[..., 1]).clamp(min=1.0)
        gx = g[..., 0] + 0.5 * (g[..., 2] - g[..., 0])
        gy = g[..., 1] + 0.5 * (g[..., 3] - g[..., 1])
        tr = torch.stack([(gy - ay) / ah, (gx - ax) / aw, torch.log(gh / ah),
                          torch.log(gw / aw)], -1)
    cls_p = classifications.clamp(1e-4, 1.0 - 1e-4)
    one = t == 1.0
    alpha_f = torch.where(one, alpha, 1.0 - alpha)
    focal_w = alpha_f * torch.where(one, 1.0 - cls_p, cls_p) ** gamma
    bce = -(t * torch.log(cls_p) + (1.0 - t) * torch.log(1.0 - cls_p))
    cls_l = (focal_w * bce * known[..., None]).sum((1, 2)) / num_pos.clamp(min=1.0)
    diff = (tr - regressions).abs()
    sl1 = torch.where(diff <= 1.0 / 9.0, 0.5 * 9.0 * diff ** 2, diff - 0.5 / 9.0)
    reg_l = torch.where(num_pos > 0,
                        (sl1 * pos[..., None]).sum((1, 2)) / (num_pos * 4.0).clamp(min=1.0),
                        0.0)
    return cls_l.mean(), reg_l.mean() * 50.0


@MODELS.register(name="EfficientDet")
class EfficientDet(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 score_threshold: float = 0.05, iou_threshold: float = 0.5,
                 max_det: int = 100):
        super().__init__()
        cfg = model_cfg or {}
        self.num_classes = max(len(dictionary), 1)
        self.score_threshold, self.iou_threshold, self.max_det = (score_threshold,
                                                                  iou_threshold, max_det)
        coef = int(str(cfg.get("TYPE") or "efficientdet_d0")[-1])
        self.anchor_scale = ANCHOR_SCALES[coef]
        channels = FPN_FILTERS[coef]
        bb = cfg.get("BACKBONE") or {"name": "EfficientNet", "subtype": f"efficientnet_b{coef}",
                                     "out_stages": (3, 5, 7)}
        self.backbone = build_backbone(bb)
        in_channels = [self.backbone.channels[s - 1] for s in self.backbone.out_stages]
        self.fpn = BiFPN(in_channels, channels, FPN_REPEATS[coef])
        self.regressor = Regressor(channels, 9, BOX_REPEATS[coef], out_dim=4)
        self.classifier = Regressor(channels, 9, BOX_REPEATS[coef], out_dim=self.num_classes)

    def _forward(self, images):
        """NHWC images → (class probabilities (B, P, C), regression (B, P,
        4), anchors (P, 4))."""
        feats = self.fpn(self.backbone(images.permute(0, 3, 1, 2)))
        reg = self.regressor(feats)
        cls = torch.sigmoid(self.classifier(feats))
        anchors = efficientdet_anchors(images.shape[1:3], anchor_scale=self.anchor_scale,
                                       device=images.device)
        return cls, reg, anchors

    def _predict(self, cls, reg, anchors, images, targets=None):
        cls, reg = _at_least_f32(cls), _at_least_f32(reg)
        boxes = decode_effdet(anchors[None], reg)
        h, w = images.shape[1:3]
        hi = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=boxes.dtype, device=boxes.device)
        boxes = torch.minimum(boxes.clamp(min=0), hi)
        scores, labels = cls.max(-1)
        dets = batched_nms(boxes, scores, labels, max_det=self.max_det,
                           iou_threshold=self.iou_threshold,
                           score_threshold=self.score_threshold)
        out_boxes = dets["boxes"]
        if targets is not None and "pads" in targets:
            out_boxes = unletterbox_boxes(out_boxes, targets["pads"][:, None, :],
                                          targets["scales"][:, None, :])
        return {**dets, "boxes": out_boxes}

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        cls, reg, anchors = self._forward(images)
        if mode == "infer":
            return self._predict(cls, reg, anchors, images, targets)
        with torch.autocast(images.device.type, enabled=False):
            c, r = _at_least_f32(cls), _at_least_f32(reg)
            cls_loss, reg_loss = efficientdet_loss(c, r, anchors, targets)
        total = cls_loss + reg_loss
        losses = {"cls_loss": cls_loss, "box_loss": reg_loss, "loss": total}
        if mode == "train":
            return total, losses
        return losses, self._predict(cls, reg, anchors, images, targets)
