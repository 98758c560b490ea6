"""YOLOP and FastestDet (counterparts of ``cvpytorch_tpu/models/yolop.py``),
NCHW, under the forward contract ``model(images, targets, mode)``.

YOLOP: the YOLOv5 CSPDarknet, PANet neck and detect layer, plus two
segmentation decoders (drivable area, lane) off P3 that run in every
mode: conv → nearest ×2 → BottleneckCSP → conv → ×2 → conv →
BottleneckCSP → ×2 → conv (2 classes), resized bilinearly to the image
if it is not there yet.  ``YoloBottleneckCSP`` puts BN and LeakyReLU(0.1)
over the concat of two plain 1×1 convs.  The loss is the YOLOv5 loss,
plus a cross-entropy for each of ``drivable``/``lane`` where the targets
carry them (COCO's do not: the decoders then add no loss, but their BN
statistics still move in train mode).  Predictions carry the ``drivable``
and ``lane`` argmax maps (B, H, W).

FastestDet (registered as JAX registers it, under the configs'
``src.models.fastestdet.FastestDet``): a ShuffleNetV2 x0.5; C3 average-
pooled 3×3/2 with the padding counted, C5 repeated ×2, concatenated with
C4; the SPP (1×1, three depthwise-5×5 branches of depth 1/2/3, 1×1, a
residual ReLU) and the head (1×1, then per output a depthwise 5×5 and a
1×1) emit [sigmoid(obj), reg, softmax(cls)] at stride 16: the raw output
holds probabilities.  Its loss assigns each gt to the four cells of its
centre's quadrant (cells at index 0 excluded by the bounds check), keeps
the candidates whose SIoU is above the batch's mean, and applies
BCE-with-logits to the already-sigmoided objectness, on purpose (the JAX
package replicates its reference).  The objectness factor map is set by
candidates whose cells repeat; JAX's CPU scatter keeps the last writer in
candidate order, so the port takes, per cell, the highest candidate
position (``scatter_reduce`` "amax") and gathers its value: deterministic
on the card too.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import clip_boxes, unletterbox_boxes, xyxy_to_cxcywh
from ..ops.nms import batched_nms, yolo_non_max_suppression
from ..registry import MODELS
from .backbones import build_backbone
from .backbones.csp_darknet import YOLOv5CSPDarknet
from .bricks import BatchNorm2d, ConvBNAct
from .detects.yolov5_detect import YOLOv5Detect, decode_yolov5
from .heads.seg_heads import resize_bilinear
from .losses.seg_loss import cross_entropy_2d
from .losses.yolov5_loss import YOLOv5Loss, sigmoid_binary_cross_entropy
from .nanodet_plus import _at_least_f32
from .necks.yolov5_neck import YOLOv5Neck, upsample2x
from .yolov5 import DEFAULT_ANCHORS, STRIDES


class YoloBottleneckCSP(nn.Module):
    """``cv1`` → n bottlenecks (``m{i}_cv1`` 1×1, ``m{i}_cv2`` 3×3) → plain
    ``cv3``; plain ``cv2`` on the input; ``bn`` + LeakyReLU(0.1) over the
    concat; ``cv4``."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5):
        super().__init__()
        c_ = int(out_channels * expansion)
        self.n, self.shortcut = n, shortcut
        self.cv1 = ConvBNAct(in_channels, c_, 1, act="silu")
        for i in range(n):
            setattr(self, f"m{i}_cv1", ConvBNAct(c_, c_, 1, act="silu"))
            setattr(self, f"m{i}_cv2", ConvBNAct(c_, c_, 3, act="silu"))
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv2 = nn.Conv2d(in_channels, c_, 1, bias=False)
        self.bn = BatchNorm2d(2 * c_, eps=1e-3, momentum=0.03)
        self.cv4 = ConvBNAct(2 * c_, out_channels, 1, act="silu")

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            h = getattr(self, f"m{i}_cv2")(getattr(self, f"m{i}_cv1")(y1))
            y1 = y1 + h if self.shortcut else h
        y = torch.cat([self.cv3(y1), self.cv2(x)], 1)
        return self.cv4(F.leaky_relu(self.bn(y), 0.1))


class SegDecoder(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 2):
        super().__init__()
        self.c0 = ConvBNAct(in_channels, 128, 3, act="silu")
        self.csp0 = YoloBottleneckCSP(128, 64, shortcut=False)
        self.c1 = ConvBNAct(64, 32, 3, act="silu")
        self.c2 = ConvBNAct(32, 16, 3, act="silu")
        self.csp1 = YoloBottleneckCSP(16, 8, shortcut=False)
        self.head = ConvBNAct(8, num_classes, 3, act="silu")

    def forward(self, x, out_hw):
        x = self.csp0(upsample2x(self.c0(x)))
        x = self.csp1(self.c2(upsample2x(self.c1(x))))
        x = self.head(upsample2x(x))
        if tuple(x.shape[-2:]) != tuple(out_hw):
            x = resize_bilinear(x, out_hw)
        return x


def _unletterbox(boxes, targets):
    if targets is not None and "pads" in targets:
        return unletterbox_boxes(boxes, targets["pads"][:, None, :], targets["scales"][:, None, :])
    return boxes


@MODELS.register(name="YOLOP")
class YOLOP(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 conf_threshold: float = 0.001, iou_threshold: float = 0.6, max_det: int = 300):
        super().__init__()
        self.num_classes = max(len(dictionary), 1)
        self.conf_threshold, self.iou_threshold, self.max_det = (conf_threshold, iou_threshold,
                                                                 max_det)
        size = ((model_cfg or {}).get("TYPE") or "yolop_s").split("_")[-1]
        self.backbone = YOLOv5CSPDarknet(subtype=f"cspdark_{size}")
        self.neck = YOLOv5Neck(self.backbone.channels, subtype=f"yolov5_{size}")
        self.detect = YOLOv5Detect(self.neck.channels, num_classes=self.num_classes)
        self.da_decoder = SegDecoder(self.neck.channels[0])
        self.ll_decoder = SegDecoder(self.neck.channels[0])
        self.det_loss = YOLOv5Loss(num_classes=self.num_classes, anchors=DEFAULT_ANCHORS,
                                   strides=STRIDES)

    def _forward(self, images):
        """NHWC images → (raw maps, drivable logits, lane logits), the
        logits NCHW at the image's size."""
        feats = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        hw = images.shape[1:3]
        return self.detect(feats), self.da_decoder(feats[0], hw), self.ll_decoder(feats[0], hw)

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        raw, da, ll = self._forward(images)
        if mode == "infer":
            return self._predict(images, raw, da, ll, None)
        h, w = images.shape[1:3]
        with torch.autocast(images.device.type, enabled=False):
            scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=images.device)
            total, det_losses = self.det_loss(
                [_at_least_f32(r) for r in raw],
                {"boxes": xyxy_to_cxcywh(targets["boxes"]) / scale, "labels": targets["labels"],
                 "valid": targets["valid"]})
            losses = dict(det_losses)
            for key, name, logits in (("drivable", "da_loss", da), ("lane", "ll_loss", ll)):
                if key in targets:
                    losses[name] = cross_entropy_2d(_at_least_f32(logits), targets[key].long())
                    total = total + losses[name]
        losses["loss"] = total
        if mode == "train":
            return total, losses
        return losses, self._predict(images, raw, da, ll, targets)

    def _predict(self, images, raw, da, ll, targets):
        decoded = decode_yolov5([_at_least_f32(r) for r in raw], DEFAULT_ANCHORS, STRIDES)
        dets = yolo_non_max_suppression(decoded, self.num_classes,
                                        conf_threshold=self.conf_threshold,
                                        iou_threshold=self.iou_threshold, max_det=self.max_det)
        h, w = images.shape[1:3]
        boxes = _unletterbox(clip_boxes(dets["boxes"], h, w), targets)
        return {**dets, "boxes": boxes, "drivable": da.argmax(1), "lane": ll.argmax(1)}


def siou(pbox, gbox):
    """SIoU of cxcywh grid-unit boxes (…, 4)."""
    eps = 1e-7
    b1x1, b1x2 = pbox[..., 0] - pbox[..., 2] / 2, pbox[..., 0] + pbox[..., 2] / 2
    b1y1, b1y2 = pbox[..., 1] - pbox[..., 3] / 2, pbox[..., 1] + pbox[..., 3] / 2
    b2x1, b2x2 = gbox[..., 0] - gbox[..., 2] / 2, gbox[..., 0] + gbox[..., 2] / 2
    b2y1, b2y2 = gbox[..., 1] - gbox[..., 3] / 2, gbox[..., 1] + gbox[..., 3] / 2
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    s_cw = (b2x1 + b2x2 - b1x1 - b1x2) * 0.5
    s_ch = (b2y1 + b2y2 - b1y1 - b1y2) * 0.5
    sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2) + 1e-12
    sin1 = s_cw.abs() / sigma
    sin2 = s_ch.abs() / sigma
    sin_a = torch.where(sin1 > 2 ** 0.5 / 2, sin2, sin1)
    angle = torch.cos(torch.arcsin(sin_a.clamp(0, 1)) * 2 - math.pi / 2)
    rho_x = (s_cw / cw.clamp(min=eps)) ** 2
    rho_y = (s_ch / ch.clamp(min=eps)) ** 2
    gamma = angle - 2
    dist = 2 - torch.exp(gamma * rho_x) - torch.exp(gamma * rho_y)
    ow = (w1 - w2).abs() / torch.maximum(w1, w2)
    oh = (h1 - h2).abs() / torch.maximum(h1, h2)
    shape = (1 - torch.exp(-ow)) ** 4 + (1 - torch.exp(-oh)) ** 4
    return iou - 0.5 * (dist + shape)


def last_writer_scatter(base, index, values):
    """``base.at[index].set(values)`` along dim 1 where ``index`` repeats,
    each position taking the value of its last candidate (the highest
    position along dim 1), as JAX's CPU scatter does: a deterministic
    "amax" of the candidates' positions, then a gather."""
    B, n = index.shape
    pos = torch.arange(n, device=index.device).expand(B, n)
    last = torch.full_like(base, -1, dtype=torch.int64).scatter_reduce(1, index, pos, "amax")
    return torch.where(last >= 0, values.gather(1, last.clamp(min=0)), base)


@MODELS.register(name="FastestDet")
class FastestDet(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 out_channels: int = 96, stride: int = 16, conf_threshold: float = 0.05,
                 iou_threshold: float = 0.45, max_det: int = 100):
        super().__init__()
        self.num_classes = max(len(dictionary), 1)
        self.stride = stride
        self.conf_threshold, self.iou_threshold, self.max_det = (conf_threshold, iou_threshold,
                                                                 max_det)
        cfg = model_cfg or {}
        bb = cfg.get("BACKBONE") or {"name": "ShuffleNetV2", "subtype": "shufflenetv2_x0.5"}
        self.backbone = build_backbone(bb)
        oc = out_channels
        bn = dict(bn_momentum=0.1, bn_eps=1e-5)
        chs = self.backbone.channels
        c_in = sum(chs[s - 1] for s in self.backbone.out_stages)
        self.spp_in = ConvBNAct(c_in, oc, 1, act="relu", **bn)
        for name in ("s1_0", "s2_0", "s2_1", "s3_0", "s3_1", "s3_2", "obj_dw", "reg_dw",
                     "cls_dw"):
            setattr(self, name, ConvBNAct(oc, oc, 5, groups=oc, act="relu", **bn))
        self.spp_out = ConvBNAct(3 * oc, oc, 1, act=None, **bn)
        self.head_in = ConvBNAct(oc, oc, 1, act="relu", **bn)
        for name, n in (("obj", 1), ("reg", 4), ("cls", self.num_classes)):
            setattr(self, f"{name}_out", ConvBNAct(oc, n, 1, act=None, **bn))

    def _raw(self, images):
        """NHWC images → (B, h, w, 5 + C): sigmoid(obj), reg, softmax(cls)."""
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2))
        p5 = c5.repeat_interleave(2, 2).repeat_interleave(2, 3)
        p3 = F.avg_pool2d(c3, 3, 2, 1, count_include_pad=True)
        x = self.spp_in(torch.cat([p3, c4, p5], 1))
        y1 = self.s1_0(x)
        y2 = self.s2_1(self.s2_0(x))
        y3 = self.s3_2(self.s3_1(self.s3_0(x)))
        f = F.relu(x + self.spp_out(torch.cat([y1, y2, y3], 1)))
        hd = self.head_in(f)
        obj = torch.sigmoid(self.obj_out(self.obj_dw(hd)))
        reg = self.reg_out(self.reg_dw(hd))
        cls = torch.softmax(self.cls_out(self.cls_dw(hd)), 1)
        return torch.cat([obj, reg, cls], 1).permute(0, 2, 3, 1)

    def _decode(self, pred, images):
        """tanh centre, sigmoid size (normalised → image pixels); score =
        obj · best class probability."""
        B, h, w, _ = pred.shape
        ih, iw = images.shape[1:3]
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=pred.device),
                                torch.arange(w, dtype=torch.float32, device=pred.device),
                                indexing="ij")
        cx = (torch.tanh(pred[..., 1]) + gx) / w * iw
        cy = (torch.tanh(pred[..., 2]) + gy) / h * ih
        bw = torch.sigmoid(pred[..., 3]) * iw
        bh = torch.sigmoid(pred[..., 4]) * ih
        boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
        best, labels = pred[..., 5:].max(-1)
        return (boxes.reshape(B, -1, 4), (pred[..., 0] * best).reshape(B, -1),
                labels.reshape(B, -1))

    def _loss(self, pred, targets):
        B, h, w, _ = pred.shape
        P = h * w
        flat = pred.reshape(B, P, -1)
        pobj, preg, pcls = flat[..., 0], flat[..., 1:5], flat[..., 5:]
        gt, gl, gv = targets["boxes"].to(pred.dtype), targets["labels"], targets["valid"]
        ih, iw = h * self.stride, w * self.stride
        # gt boxes are network pixels: normalised by the network input → grid units
        gcx = (gt[..., 0] + gt[..., 2]) / 2 / iw * w
        gcy = (gt[..., 1] + gt[..., 3]) / 2 / ih * h
        gw = (gt[..., 2] - gt[..., 0]) / iw * w
        gh = (gt[..., 3] - gt[..., 1]) / ih * h
        # the four cells of the centre's quadrant, (B, M, 4); index-0 cells
        # fail the bounds check too
        qx = torch.tensor([0, 1, 0, 1], device=pred.device)
        qy = torch.tensor([0, 0, 1, 1], device=pred.device)
        gx = torch.floor(gcx)[..., None] + qx
        gy = torch.floor(gcy)[..., None] + qy
        ok = (gx > 0) & (gx < w) & (gy > 0) & (gy < h) & gv[..., None]
        gxi = gx.clamp(0, w - 1).long()
        gyi = gy.clamp(0, h - 1).long()
        cell = (gyi * w + gxi).reshape(B, -1)
        okf = ok.reshape(B, -1)
        pr = preg.gather(1, cell[..., None].expand(-1, -1, 4))
        pbox = torch.stack([torch.tanh(pr[..., 0]) + gxi.reshape(B, -1),
                            torch.tanh(pr[..., 1]) + gyi.reshape(B, -1),
                            torch.sigmoid(pr[..., 2]) * w, torch.sigmoid(pr[..., 3]) * h], -1)
        gbox = torch.stack([gcx, gcy, gw, gh], -1).repeat_interleave(4, 1)
        iou = siou(pbox, gbox)
        n_ok = okf.sum().clamp(min=1).to(pred.dtype)
        iou_mean = (iou * okf).sum() / n_ok
        keep = okf & (iou > iou_mean)  # above the batch's mean
        n_keep = keep.sum().clamp(min=1).to(pred.dtype)
        iou_loss = ((1.0 - iou) * keep).sum() / n_keep
        pc = pcls.gather(1, cell[..., None].expand(-1, -1, pcls.shape[-1]))
        gl4 = gl.long().repeat_interleave(4, 1)
        logp = torch.log(pc.gather(-1, gl4[..., None])[..., 0].clamp(min=1e-12))
        cls_loss = -(logp * keep).sum() / n_keep
        # objectness: 1 at kept cells; the factor map 0.75, balanced at kept
        # cells; BCE-with-logits over the already-sigmoided map
        tobj = torch.zeros(B, P, dtype=pred.dtype, device=pred.device).scatter_reduce(
            1, cell, keep.to(pred.dtype), "amax")
        n_img = keep.sum(-1).to(torch.float32)
        fval = torch.where(n_img > 0, (1.0 / (n_img / P)) * 0.25, 0.75)
        fmap = last_writer_scatter(torch.full((B, P), 0.75, dtype=pred.dtype, device=pred.device),
                                   cell, torch.where(keep, fval[:, None], 0.75).to(pred.dtype))
        obj_loss = (sigmoid_binary_cross_entropy(pobj, tobj) * fmap).mean()
        total = iou_loss * 8.0 + obj_loss * 16.0 + cls_loss
        return total, {"box_loss": iou_loss, "obj_loss": obj_loss, "cls_loss": cls_loss}

    def _predict(self, pred, images, targets):
        boxes, scores, labels = self._decode(_at_least_f32(pred), images)
        h, w = images.shape[1:3]
        dets = batched_nms(clip_boxes(boxes, h, w), scores, labels, max_det=self.max_det,
                           iou_threshold=self.iou_threshold, score_threshold=self.conf_threshold)
        return {**dets, "boxes": _unletterbox(dets["boxes"], targets)}

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        pred = self._raw(images)
        if mode == "infer":
            return self._predict(pred, images, None)
        with torch.autocast(images.device.type, enabled=False):
            total, losses = self._loss(_at_least_f32(pred), targets)
        losses = {**losses, "loss": total}
        if mode == "train":
            return total, losses
        return losses, self._predict(pred, images, targets)
