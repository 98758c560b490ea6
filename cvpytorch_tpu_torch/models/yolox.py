"""YOLOX and PAI-YOLOX (counterpart of ``cvpytorch_tpu/models/yolox.py``),
NCHW: the Focus-stem CSPDarknet (or PAI's EfficientRep), the YOLOv5 PAFPN
neck, optionally ASFF, the decoupled anchor-free head, and the loss of
objectness BCE over every prior, IoU-soft class BCE and 1 − IoU² on the
SimOTA positives, under the forward contract ``model(images, targets,
mode)``.

Every BN is torch momentum 0.03, eps 1e-3 (flax 0.97).  The priors are the
cells' corners, x·stride, at strides 8, 16, 32; the head predicts the
centre offset in stride units and the log size (clipped to [−10, 8]
before ``exp``).  ``TYPE`` yolox_{n,t,s,m,l,x} picks the depth and width
multipliers of ``backbones/csp_darknet.SIZE_CFG``.

PAI-YOLOX (``use_asff``, or ``pai`` in ``TYPE``; the registry's
``PAIYOLOX``/``PAI_YOLOX`` aliases name this class) swaps in
``yolov6.EfficientRep`` with the serial ReLU SPPF and adds the ASFF pass.
As in JAX, only lowercase ``USE_MODEL`` keys reach the constructor: the
configs' ``NECK: {use_asff: True}`` is not read, their ``TYPE``
``pai_yolox_s`` switches PAI on.  The loss runs in float32 outside
autocast.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn
from torch.profiler import record_function

from ..ops.boxes import bbox_iou, clip_boxes, unletterbox_boxes
from ..ops.nms import batched_nms
from ..registry import MODELS
from .assigners.ota_assigner import simota_assign
from .backbones.csp_darknet import CSPLayer, SIZE_CFG, SPPF
from .bricks import ConvBNAct, make_divisible, make_round
from .heads.nanodet_head import center_priors
from .losses.yolov5_loss import sigmoid_binary_cross_entropy
from .nanodet_plus import _at_least_f32
from .necks.asff import ASFF
from .necks.yolov5_neck import DownsampleFuse, UpsampleFuse
from .yolov6 import EfficientRep

STRIDES = (8, 16, 32)
_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class Focus(nn.Module):
    """Space-to-depth stem: the four pixel phases concatenated along the
    channels in JAX's order (top-left, bottom-left, top-right,
    bottom-right), then ``conv`` (k×k, SiLU)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 act: str = "silu"):
        super().__init__()
        self.conv = ConvBNAct(4 * in_channels, out_channels, kernel_size, act=act)

    def forward(self, x):
        tl, bl = x[..., ::2, ::2], x[..., 1::2, ::2]
        tr, br = x[..., ::2, 1::2], x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], 1))


class YOLOXCSPDarknet(nn.Module):
    """Focus ``stem``, then four stages of a 3×3/2 ``stage{i}_down`` and a
    C3 ``stage{i}_csp`` (no shortcut in stage 4, which puts the SiLU
    ``sppf`` before its C3).  Returns strides 8, 16, 32."""

    def __init__(self, depth_mul: float = 0.33, width_mul: float = 0.5,
                 channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 num_blocks: Sequence[int] = (3, 9, 9, 3)):
        super().__init__()
        chs = [make_divisible(c * width_mul) for c in channels]
        blocks = [make_round(n, depth_mul) for n in num_blocks]
        self.stem = Focus(3, chs[0])
        for i in range(4):
            setattr(self, f"stage{i + 1}_down", ConvBNAct(chs[i], chs[i + 1], 3, 2, act="silu"))
            setattr(self, f"stage{i + 1}_csp", CSPLayer(chs[i + 1], chs[i + 1], n=blocks[i],
                                                        shortcut=i != 3))
        self.sppf = SPPF(chs[4], chs[4], 5)
        self.out_channels = chs[2:]

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"stage{i}_down")(x)
            if i == 4:
                x = self.sppf(x)
            x = getattr(self, f"stage{i}_csp")(x)
            if i >= 2:
                feats.append(x)
        return tuple(feats)


class YOLOXHead(nn.Module):
    """The decoupled head: per level ``stem{i}`` (1×1), two 3×3 ``cls{i}_j``
    and ``reg{i}_j``, ``cls_out{i}`` (C) and ``obj_out{i}`` (1) with bias
    −log 99, ``reg_out{i}`` (4).  → flat (B, P, 4 + 1 + C): reg, obj, cls,
    level by level, each in row-major (y, x) order."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], width_mul: float = 0.5,
                 feat_channels: int = 256):
        super().__init__()
        ch = make_divisible(feat_channels * width_mul)
        self.n_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"stem{i}", ConvBNAct(c, ch, 1, act="silu"))
            for j in range(2):
                setattr(self, f"cls{i}_{j}", ConvBNAct(ch, ch, 3, act="silu"))
                setattr(self, f"reg{i}_{j}", ConvBNAct(ch, ch, 3, act="silu"))
            for name, n, bias in (("cls_out", num_classes, True), ("reg_out", 4, False),
                                  ("obj_out", 1, True)):
                conv = nn.Conv2d(ch, n, 1)
                if bias:
                    nn.init.constant_(conv.bias, _PRIOR_BIAS)
                setattr(self, f"{name}{i}", conv)

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            x = getattr(self, f"stem{i}")(x)
            c = getattr(self, f"cls{i}_1")(getattr(self, f"cls{i}_0")(x))
            r = getattr(self, f"reg{i}_1")(getattr(self, f"reg{i}_0")(x))
            y = torch.cat([getattr(self, f"reg_out{i}")(r), getattr(self, f"obj_out{i}")(r),
                           getattr(self, f"cls_out{i}")(c)], 1)
            outs.append(y.permute(0, 2, 3, 1).flatten(1, 2))
        return torch.cat(outs, 1)


def decode_yolox(preds, priors):
    """xy = (pred + grid)·s, wh = exp(clip(pred, −10, 8))·s → xyxy."""
    s = priors[None, :, 2:3]
    xy = (preds[..., 0:2] + priors[None, :, 0:2] / s) * s
    wh = torch.exp(preds[..., 2:4].clamp(-10, 8)) * priors[None, :, 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], -1)


def yolox_loss(preds, priors, targets, num_classes):
    """The loss of a padded-target batch (float32 or float64)."""
    obj_logits, cls_logits = preds[..., 4], preds[..., 5:]
    boxes = decode_yolox(preds, priors)
    with record_function("simota_assign"), torch.no_grad():  # a range in step profiles
        assign = simota_assign(torch.sigmoid(cls_logits), torch.sigmoid(obj_logits), priors,
                               boxes, targets["boxes"], targets["labels"], targets["valid"])
    matched_gt, matched_iou = assign["matched_gt"], assign["matched_iou"]
    pos = matched_gt >= 0
    num_pos = pos.sum().to(preds.dtype).clamp(min=1.0)
    safe = matched_gt.clamp(min=0)
    gt_boxes = targets["boxes"].gather(1, safe[..., None].expand(-1, -1, 4))
    gt_labels = targets["labels"].gather(1, safe)

    obj_loss = sigmoid_binary_cross_entropy(obj_logits, pos.to(preds.dtype)).sum() / num_pos
    # jax.nn.one_hot: a label outside [0, C) is all zeros
    onehot = (gt_labels[..., None] == torch.arange(num_classes, device=preds.device))
    onehot = onehot.to(preds.dtype) * matched_iou[..., None]
    cls_loss = (sigmoid_binary_cross_entropy(cls_logits, onehot).sum(-1) * pos).sum() / num_pos
    pair_iou = bbox_iou(boxes, gt_boxes, iou_type="iou")
    iou_loss = ((1.0 - pair_iou ** 2) * pos).sum() / num_pos * 5.0
    total = obj_loss + cls_loss + iou_loss
    return total, {"obj_loss": obj_loss, "cls_loss": cls_loss, "iou_loss": iou_loss}


@MODELS.register(name="YOLOX", aliases=("PAIYOLOX", "PAI_YOLOX"))
class YOLOX(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 use_asff: bool = False, conf_threshold: float = 0.01,
                 iou_threshold: float = 0.65, max_det: int = 300):
        super().__init__()
        cfg = model_cfg or {}
        self.num_classes = max(len(dictionary), 1)
        self.conf_threshold, self.iou_threshold, self.max_det = (conf_threshold, iou_threshold,
                                                                 max_det)
        subtype = cfg.get("TYPE") or "yolox_s"
        dm, wm = SIZE_CFG.get(subtype.split("_")[-1], (0.33, 0.5))
        backbone = cfg.get("BACKBONE") or {}
        self.pai = bool(use_asff) or "pai" in subtype.lower()
        if self.pai or "EfficientRep" in str(backbone.get("name") or ""):
            self.backbone = EfficientRep(depth_mul=dm, width_mul=wm, sppf="relu")
        else:
            self.backbone = YOLOXCSPDarknet(depth_mul=dm, width_mul=wm)
        c3, c4, c5 = self.backbone.out_channels
        n = make_round(3, dm)
        w256, w512, w1024 = (make_divisible(c * wm) for c in (256, 512, 1024))
        self.neck_up1 = UpsampleFuse(c5, c4, w512, n)
        self.neck_up2 = UpsampleFuse(w512, c3, w256, n)
        self.neck_down1 = DownsampleFuse(w256, w256, w512, n)
        self.neck_down2 = DownsampleFuse(w512, w512, w1024, n)
        feat_channels = [w256, w512, w1024]
        self.asff = ASFF(feat_channels, w256) if self.pai else None
        self.head = YOLOXHead(self.num_classes,
                              self.asff.out_channels if self.pai else feat_channels, wm)

    def _forward(self, images):
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2))
        p4u, t5 = self.neck_up1(c5, c4)
        p3, t4 = self.neck_up2(p4u, c3)
        p4 = self.neck_down1(p3, t4)
        feats = (p3, p4, self.neck_down2(p4, t5))
        if self.asff is not None:
            feats = self.asff(feats)
        h, w = images.shape[1:3]
        priors = center_priors([(h // s, w // s) for s in STRIDES], STRIDES, images.device)
        return self.head(feats), priors

    def _predict(self, preds, priors, images, targets=None):
        preds = _at_least_f32(preds)
        boxes = decode_yolox(preds, priors)
        scores = torch.sigmoid(preds[..., 5:]) * torch.sigmoid(preds[..., 4:5])
        best, labels = scores.max(-1)
        dets = batched_nms(boxes, best, labels, max_det=self.max_det,
                           iou_threshold=self.iou_threshold, score_threshold=self.conf_threshold)
        h, w = images.shape[1:3]
        out_boxes = clip_boxes(dets["boxes"], h, w)
        if targets is not None and "pads" in targets:
            out_boxes = unletterbox_boxes(out_boxes, targets["pads"][:, None, :],
                                          targets["scales"][:, None, :])
        return {**dets, "boxes": out_boxes}

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        preds, priors = self._forward(images)
        if mode == "infer":
            return self._predict(preds, priors, images, targets)
        t = {k: targets[k] for k in ("boxes", "labels", "valid")}
        with torch.autocast(preds.device.type, enabled=False):
            p = _at_least_f32(preds)
            total, losses = yolox_loss(p, priors.to(p.dtype), t, self.num_classes)
        losses = {**losses, "loss": total}
        if mode == "train":
            return total, losses
        return losses, self._predict(preds, priors, images, targets)
