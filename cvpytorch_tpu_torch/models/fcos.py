"""FCOS (counterpart of ``cvpytorch_tpu/models/fcos.py``): a ResNet's C3–C5
(``BACKBONE``, by default ResNet-50 with ``out_stages`` (2, 3, 4)),
``FCOSFPN`` P3–P7 and the FCOS head, loss and √(cls·cnt) decode, then the
class-offset ``batched_nms`` (score 0.05, IoU 0.6, 100 detections), under
the forward contract ``model(images, targets, mode)``.  The loss runs in
float32 outside autocast.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..ops.boxes import clip_boxes, unletterbox_boxes
from ..ops.nms import batched_nms
from ..registry import MODELS
from .backbones import build_backbone
from .heads.fcos_head import FCOSHead, decode_fcos, fcos_loss
from .nanodet_plus import _at_least_f32
from .necks.fcos_fpn import FCOSFPN
from .segmentor import feature_channels

_DEFAULT_BACKBONE = {"name": "ResNet", "subtype": "resnet50", "out_stages": (2, 3, 4)}


class FCOSFamily(nn.Module):
    """The forward contract of the detectors on the FCOS head (FCOS, LFD):
    ``_outs`` gives the head's per-level outputs."""

    score_threshold: float
    iou_threshold: float
    max_det: int

    def _predict(self, outs, images, targets=None):
        outs = [tuple(_at_least_f32(t) for t in o) for o in outs]
        boxes, scores, labels = decode_fcos(outs, self.num_classes)
        dets = batched_nms(boxes, scores, labels, max_det=self.max_det,
                           iou_threshold=self.iou_threshold,
                           score_threshold=self.score_threshold)
        h, w = images.shape[1:3]
        out_boxes = clip_boxes(dets["boxes"], h, w)
        if targets is not None and "pads" in targets:
            out_boxes = unletterbox_boxes(out_boxes, targets["pads"][:, None, :],
                                          targets["scales"][:, None, :])
        return {**dets, "boxes": out_boxes}

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        outs = self._outs(images.permute(0, 3, 1, 2))
        if mode == "infer":
            return self._predict(outs, images, targets)
        with torch.autocast(images.device.type, enabled=False):
            total, losses = fcos_loss([tuple(_at_least_f32(t) for t in o) for o in outs],
                                      targets["boxes"], targets["labels"], targets["valid"],
                                      self.num_classes)
        losses = {**losses, "loss": total}
        if mode == "train":
            return total, losses
        return losses, self._predict(outs, images, targets)


@MODELS.register(name="FCOS")
class FCOS(FCOSFamily):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 score_threshold: float = 0.05, iou_threshold: float = 0.6, max_det: int = 100):
        super().__init__()
        cfg = model_cfg or {}
        self.num_classes = max(len(dictionary), 1)
        self.score_threshold, self.iou_threshold, self.max_det = (score_threshold,
                                                                  iou_threshold, max_det)
        self.backbone = build_backbone(cfg.get("BACKBONE") or _DEFAULT_BACKBONE)
        self.neck = FCOSFPN(feature_channels(self.backbone))
        self.head = FCOSHead(self.neck.out_channels[0], num_classes=self.num_classes)

    def _outs(self, x):
        return self.head(self.neck(self.backbone(x)))
