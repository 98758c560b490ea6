"""YOLOv7 (counterpart of ``cvpytorch_tpu/models/yolov7.py``), NCHW: a
three-conv stem, then [downsample + E-ELAN] ×4, the SPPCSPC bridge and a
PAN of FeatureFusion blocks, one RepConv a level, and the YOLOv5 detect
layer, decode and NMS, trained with ``losses/yolov7_loss.YOLOv7Loss``,
under the forward contract ``model(images, targets, mode)``.

Every BN is torch momentum 0.03, eps 1e-3 (flax 0.97), the activations
SiLU.  ``TYPE`` yolov7_<size> takes only the width multiplier of
``backbones/csp_darknet.SIZE_CFG`` (l: 1.0, x: 1.25).  The RepConv is the
train form, summed branches (3×3 + BN, 1×1 + BN, and an identity BN
where stride and widths allow).  FeatureFusion applies its ``conv4``
three times, as the reference's forward does.  The loss runs in float32
outside autocast.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import clip_boxes, unletterbox_boxes, xyxy_to_cxcywh
from ..ops.nms import yolo_non_max_suppression
from ..registry import MODELS
from .backbones.csp_darknet import SIZE_CFG
from .bricks import BatchNorm2d, ConvBNAct, make_divisible
from .detects.yolov5_detect import YOLOv5Detect, decode_yolov5
from .losses.yolov7_loss import YOLOv7Loss
from .nanodet_plus import _at_least_f32
from .necks.yolov5_neck import upsample2x

V7_ANCHORS = (
    ((1.5, 2.0), (2.375, 4.5), (5.0, 3.5)),
    ((2.25, 4.6875), (4.75, 3.4375), (4.5, 9.125)),
    ((4.4375, 3.4375), (6.0, 7.59375), (14.34375, 12.53125)),
)
STRIDES = (8.0, 16.0, 32.0)


def _c(i, o, k, s=1):
    return ConvBNAct(i, o, k, s, act="silu")


class EELAN(nn.Module):
    def __init__(self, in_channels: int, mid: int, out: int):
        super().__init__()
        self.conv1, self.conv2 = _c(in_channels, mid, 1), _c(in_channels, mid, 1)
        self.conv3a, self.conv3b = _c(mid, mid, 3), _c(mid, mid, 3)
        self.conv4a, self.conv4b = _c(mid, mid, 3), _c(mid, mid, 3)
        self.conv5 = _c(4 * mid, out, 1)

    def forward(self, x):
        x1, x2 = self.conv1(x), self.conv2(x)
        x3 = self.conv3b(self.conv3a(x2))
        x4 = self.conv4b(self.conv4a(x3))
        return self.conv5(torch.cat([x1, x2, x3, x4], 1))


class DownA(nn.Module):
    """2×2/2 max-pool + 1×1 ``b1`` beside 1×1 ``b2a`` + 3×3/2 ``b2b``,
    concatenated (and, in ``DownB``, the lateral input after them)."""

    def __init__(self, in_channels: int, out_half: int):
        super().__init__()
        self.b1, self.b2a = _c(in_channels, out_half, 1), _c(in_channels, out_half, 1)
        self.b2b = _c(out_half, out_half, 3, 2)

    def forward(self, x, *lateral):
        return torch.cat([self.b1(F.max_pool2d(x, 2, 2)), self.b2b(self.b2a(x)), *lateral], 1)


DownB = DownA


class FeatureFusion(nn.Module):
    """The 6-branch ELAN-W fusion, ``conv4`` shared by three steps."""

    def __init__(self, in_channels: int, out: int):
        super().__init__()
        mid = out // 2
        self.conv1, self.conv2 = _c(in_channels, out, 1), _c(in_channels, out, 1)
        self.conv3, self.conv4 = _c(out, mid, 3), _c(mid, mid, 3)
        self.conv7 = _c(2 * out + 4 * mid, out, 1)

    def forward(self, x):
        x1, x2 = self.conv1(x), self.conv2(x)
        x3 = self.conv3(x2)
        x4 = self.conv4(x3)
        x5 = self.conv4(x4)
        x6 = self.conv4(x5)
        return self.conv7(torch.cat([x1, x2, x3, x4, x5, x6], 1))


class SPPCSPC(nn.Module):
    def __init__(self, in_channels: int, out: int):
        super().__init__()
        self.cv1, self.cv2 = _c(in_channels, out, 1), _c(in_channels, out, 1)
        self.cv3, self.cv4 = _c(out, out, 3), _c(out, out, 1)
        self.cv5, self.cv6 = _c(4 * out, out, 1), _c(out, out, 3)
        self.cv7 = _c(2 * out, out, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pools = [x1] + [F.max_pool2d(x1, k, 1, k // 2) for k in (5, 9, 13)]
        y1 = self.cv6(self.cv5(torch.cat(pools, 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class UpSampling(nn.Module):
    """1×1 ``conv1`` of the deep input, nearest ×2, beside the 1×1 ``conv2``
    of the lateral one."""

    def __init__(self, in_channels: int, lateral_channels: int, out: int):
        super().__init__()
        self.conv1, self.conv2 = _c(in_channels, out, 1), _c(lateral_channels, out, 1)

    def forward(self, x, y):
        return torch.cat([upsample2x(self.conv1(x)), self.conv2(y)], 1)


class YOLOv7Neck(nn.Module):
    """SPPCSPC on C5, then the PAN of FeatureFusion blocks."""

    def __init__(self, in_channels: Sequence[int], spp_out: int, out_channels: Sequence[int]):
        super().__init__()
        c3, c4, c5 = in_channels
        o3, o4, o5 = out_channels
        self.spp = SPPCSPC(c5, spp_out)
        self.up1_1 = UpSampling(spp_out, c4, o4)
        self.featurefusion1_1 = FeatureFusion(2 * o4, o4)
        self.up1_2 = UpSampling(o4, c3, o3)
        self.featurefusion1_2 = FeatureFusion(2 * o3, o3)
        self.down2_1 = DownB(o3, o3)
        self.featurefusion2_1 = FeatureFusion(2 * o3 + o4, o4)
        self.down2_2 = DownB(o4, o4)
        self.featurefusion2_2 = FeatureFusion(2 * o4 + spp_out, o5)

    def forward(self, feats):
        x3, x4, x5 = feats
        x5 = self.spp(x5)
        x4_up = self.featurefusion1_1(self.up1_1(x5, x4))
        x3_up = self.featurefusion1_2(self.up1_2(x4_up, x3))
        x4_down = self.featurefusion2_1(self.down2_1(x3_up, x4_up))
        x5_down = self.featurefusion2_2(self.down2_2(x4_down, x5))
        return x3_up, x4_down, x5_down


class RepConv(nn.Module):
    """Train-form RepVGG-style conv with SiLU: 3×3 + BN ∥ 1×1 + BN (∥ an
    identity BN at stride 1 with equal widths), summed."""

    def __init__(self, in_channels: int, out: int, stride: int = 1):
        super().__init__()
        bn = dict(eps=1e-3, momentum=0.03)
        self.rbr_dense_conv = nn.Conv2d(in_channels, out, 3, stride, 1, bias=False)
        self.rbr_dense_bn = BatchNorm2d(out, **bn)
        self.rbr_1x1_conv = nn.Conv2d(in_channels, out, 1, stride, bias=False)
        self.rbr_1x1_bn = BatchNorm2d(out, **bn)
        self.rbr_identity = (BatchNorm2d(out, **bn) if stride == 1 and in_channels == out
                             else None)

    def forward(self, x):
        out = self.rbr_dense_bn(self.rbr_dense_conv(x)) + self.rbr_1x1_bn(self.rbr_1x1_conv(x))
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return F.silu(out)


class YOLOv7Head(nn.Module):
    """One RepConv ``conv{i}`` a level."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int]):
        super().__init__()
        for i, (c, o) in enumerate(zip(in_channels, out_channels)):
            setattr(self, f"conv{i + 1}", RepConv(c, o))
        self.n = len(out_channels)

    def forward(self, feats):
        return tuple(getattr(self, f"conv{i + 1}")(f) for i, f in enumerate(feats))


@MODELS.register(name="YOLOv7")
class YOLOv7(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 conf_threshold: float = 0.001, iou_threshold: float = 0.6,
                 max_det: int = 300):
        super().__init__()
        cfg = model_cfg or {}
        self.num_classes = max(len(dictionary), 1)
        self.conf_threshold, self.iou_threshold, self.max_det = (conf_threshold, iou_threshold,
                                                                 max_det)
        _, wm = SIZE_CFG.get((cfg.get("TYPE") or "yolov7_l").split("_")[-1], (1.0, 1.0))
        ch = lambda c: make_divisible(c * wm)  # noqa: E731
        self.stem1 = _c(3, ch(32), 3)
        self.stem2 = _c(ch(32), ch(64), 3, 2)
        self.stem3 = _c(ch(64), ch(64), 3)
        self.down1 = _c(ch(64), ch(128), 3, 2)
        self.elan1 = EELAN(ch(128), ch(64), ch(256))  # /4
        self.down2 = DownA(ch(256), ch(128))
        self.elan2 = EELAN(2 * ch(128), ch(128), ch(512))  # /8
        self.down3 = DownA(ch(512), ch(256))
        self.elan3 = EELAN(2 * ch(256), ch(256), ch(1024))  # /16
        self.down4 = DownA(ch(1024), ch(512))
        self.elan4 = EELAN(2 * ch(512), ch(256), ch(1024))  # /32
        necks = (ch(128), ch(256), ch(512))
        self.neck = YOLOv7Neck((ch(512), ch(1024), ch(1024)), ch(512), necks)
        heads = (ch(256), ch(512), ch(1024))
        self.head = YOLOv7Head(necks, heads)
        self.detect = YOLOv5Detect(heads, num_classes=self.num_classes)
        loss = cfg.get("LOSS") or {}
        self.loss = YOLOv7Loss(
            num_classes=self.num_classes, anchors=V7_ANCHORS, strides=STRIDES,
            hyp_box=float(loss.get("hyp_box", 0.05) or 0.05),
            hyp_obj=float(loss.get("hyp_obj", 0.7) or 0.7),
            hyp_cls=float(loss.get("hyp_cls", 0.3) or 0.3))

    def _raw(self, images):
        """NHWC images → list of (B, ny, nx, A, 5 + C) raw maps."""
        x = self.down1(self.stem3(self.stem2(self.stem1(images.permute(0, 3, 1, 2)))))
        x = self.elan1(x)
        c3 = self.elan2(self.down2(x))
        c4 = self.elan3(self.down3(c3))
        c5 = self.elan4(self.down4(c4))
        return self.detect(self.head(self.neck((c3, c4, c5))))

    def _normalized_targets(self, images, targets):
        h, w = images.shape[1:3]
        scale = torch.tensor([w, h, w, h], dtype=targets["boxes"].dtype, device=images.device)
        return {"boxes": xyxy_to_cxcywh(targets["boxes"]) / scale,
                "labels": targets["labels"], "valid": targets["valid"]}

    def _loss(self, images, raw_outs, targets):
        with torch.autocast(images.device.type, enabled=False):
            return self.loss([_at_least_f32(r) for r in raw_outs],
                             self._normalized_targets(images, targets), float(images.shape[1]))

    def _predict(self, images, raw_outs, targets=None):
        decoded = decode_yolov5([_at_least_f32(r) for r in raw_outs], V7_ANCHORS, STRIDES)
        dets = yolo_non_max_suppression(decoded, self.num_classes,
                                        conf_threshold=self.conf_threshold,
                                        iou_threshold=self.iou_threshold, max_det=self.max_det)
        h, w = images.shape[1:3]
        boxes = clip_boxes(dets["boxes"], h, w)
        if targets is not None and "pads" in targets:
            boxes = unletterbox_boxes(boxes, targets["pads"][:, None, :],
                                      targets["scales"][:, None, :])
        return {**dets, "boxes": boxes}

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        raw = self._raw(images)
        if mode == "infer":
            return self._predict(images, raw, targets)
        total, losses = self._loss(images, raw, targets)
        losses = {**losses, "loss": total}
        if mode == "train":
            return total, losses
        return losses, self._predict(images, raw, targets)
