"""ObjectBox (counterpart of ``cvpytorch_tpu/models/objectbox.py``): the
YOLOv5 CSPDarknet and PANet neck with a one-anchor ``YOLOv5Detect``, the
``ObjectBoxLoss`` (every gt at its centre cell on every level, corner
distances with gain 2^i) and its corner-distance decode before
``yolo_non_max_suppression``.  ``TYPE`` objectbox_{n,s,m,l,x} picks the
size."""
from __future__ import annotations

from typing import Any, Sequence

from torch import nn

from ..ops.boxes import clip_boxes, unletterbox_boxes
from ..ops.nms import yolo_non_max_suppression
from ..registry import MODELS
from .backbones.csp_darknet import YOLOv5CSPDarknet
from .detects.yolov5_detect import YOLOv5Detect
from .losses.objectbox_loss import ObjectBoxLoss, decode_objectbox
from .necks.yolov5_neck import YOLOv5Neck
from .yolov5 import STRIDES, YOLOv5


@MODELS.register(name="ObjectBox")
class ObjectBox(YOLOv5):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 conf_threshold: float = 0.001, iou_threshold: float = 0.6,
                 max_det: int = 300, multi_label: bool = True):
        nn.Module.__init__(self)
        self.num_classes = max(len(dictionary), 1)
        self.conf_threshold, self.iou_threshold = conf_threshold, iou_threshold
        self.max_det, self.multi_label = max_det, multi_label
        size = ((model_cfg or {}).get("TYPE") or "objectbox_s").split("_")[-1]
        self.backbone = YOLOv5CSPDarknet(subtype=f"cspdark_{size}")
        self.neck = YOLOv5Neck(self.backbone.channels, subtype=f"yolov5_{size}")
        self.detect = YOLOv5Detect(self.neck.channels, num_classes=self.num_classes,
                                   num_anchors=1)
        self.loss = ObjectBoxLoss(num_classes=self.num_classes, strides=STRIDES)

    def _predict(self, images, raw_outs, targets=None):
        decoded = decode_objectbox(raw_outs, STRIDES)
        dets = yolo_non_max_suppression(
            decoded, self.num_classes, conf_threshold=self.conf_threshold,
            iou_threshold=self.iou_threshold, max_det=self.max_det,
            multi_label=self.multi_label and self.num_classes > 1)
        h, w = images.shape[1:3]
        boxes = clip_boxes(dets["boxes"], h, w)
        if targets is not None and "pads" in targets:
            boxes = unletterbox_boxes(boxes, targets["pads"][:, None, :],
                                      targets["scales"][:, None, :])
        return {**dets, "boxes": boxes}
