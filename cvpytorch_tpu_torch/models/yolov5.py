"""YOLOv5 (counterpart of ``cvpytorch_tpu/models/yolov5.py``).

CSPDarknet + PANet neck + Detect under the forward contract
``model(images, targets=None, mode)``.  Images enter NHWC (B, H, W, 3) as
in the JAX package; the convolutions run NCHW on the ``channels_last``
view ``images.permute(0, 3, 1, 2)``, which costs no copy.  Predictions are
the JAX dict ``boxes/scores/labels/valid/num`` padded to ``max_det``.

Targets arrive as the padded dict of the detection collate
(``{'boxes': (B,M,4) xyxy network pixels, 'labels', 'valid', 'pads',
'scales', …}``).  ``mode="train"`` returns ``(total, losses)`` and
``mode="val"`` ``(losses, predictions)``.  The loss runs in float32 on the
raw maps cast up (a float64 model's stay float64), outside any autocast
region, so under bf16 autocast only the network runs in bf16.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..ops.boxes import clip_boxes, unletterbox_boxes, xyxy_to_cxcywh
from ..ops.nms import yolo_non_max_suppression
from ..registry import MODELS
from .backbones.csp_darknet import YOLOv5CSPDarknet
from .detects.yolov5_detect import YOLOv5Detect, decode_yolov5
from .losses.yolov5_loss import YOLOv5Loss
from .necks.yolov5_neck import YOLOv5Neck

# anchors in grid units per level
DEFAULT_ANCHORS = (
    ((1.25, 1.625), (2.0, 3.75), (4.125, 2.875)),
    ((1.875, 3.8125), (3.875, 2.8125), (3.6875, 7.4375)),
    ((3.625, 2.8125), (4.875, 6.1875), (11.65625, 10.1875)),
)
STRIDES = (8.0, 16.0, 32.0)


@MODELS.register(name="YOLOv5")
class YOLOv5(nn.Module):
    # its loss takes global normalisers under data parallelism (parallel.dist)
    dp_global_loss = True

    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 conf_threshold: float = 0.001, iou_threshold: float = 0.6,
                 max_det: int = 300, multi_label: bool = True):
        super().__init__()
        self.num_classes = max(len(dictionary), 1)
        self.conf_threshold = conf_threshold
        self.iou_threshold = iou_threshold
        self.max_det = max_det
        self.multi_label = multi_label
        cfg = model_cfg or {}
        subtype = cfg.get("TYPE") or "yolov5_s"
        size = subtype.split("_")[-1]
        size = {"nano": "n", "tiny": "t"}.get(size, size)
        self.backbone = YOLOv5CSPDarknet(subtype=f"cspdark_{size}")
        self.neck = YOLOv5Neck(self.backbone.channels, subtype=f"yolov5_{size}")
        self.detect = YOLOv5Detect(self.neck.channels,
                                   num_classes=self.num_classes)
        loss_cfg = cfg.get("LOSS") or {}
        self.loss = YOLOv5Loss(
            num_classes=self.num_classes,
            anchors=DEFAULT_ANCHORS,
            strides=STRIDES,
            hyp_box=float(loss_cfg.get("hyp_box", 0.05) or 0.05),
            hyp_obj=float(loss_cfg.get("hyp_obj", 1.0) or 1.0),
            hyp_cls=float(loss_cfg.get("hyp_cls", 0.5) or 0.5),
        )

    def _raw(self, images):
        """NHWC images → list of (B, ny, nx, A, 5+C) raw maps."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        return self.detect(self.neck(feats))

    def _normalized_targets(self, images, targets):
        """xyxy pixel GT → normalised cxcywh (what the loss consumes)."""
        h, w = images.shape[1:3]
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=images.device)
        return {
            "boxes": xyxy_to_cxcywh(targets["boxes"]) / scale,
            "labels": targets["labels"],
            "valid": targets["valid"],
        }

    def _loss(self, images, raw_outs, targets):
        with torch.autocast(images.device.type, enabled=False):
            return self.loss([r.to(torch.promote_types(r.dtype, torch.float32))
                              for r in raw_outs], self._normalized_targets(images, targets))

    def _predict(self, images, raw_outs, targets=None):
        decoded = decode_yolov5(raw_outs, DEFAULT_ANCHORS, STRIDES)
        dets = yolo_non_max_suppression(
            decoded, self.num_classes,
            conf_threshold=self.conf_threshold,
            iou_threshold=self.iou_threshold,
            max_det=self.max_det,
            multi_label=self.multi_label and self.num_classes > 1,
        )
        h, w = images.shape[1:3]
        boxes = clip_boxes(dets["boxes"], h, w)
        if targets is not None and "pads" in targets:
            boxes = unletterbox_boxes(
                boxes, targets["pads"][:, None, :], targets["scales"][:, None, :])
        return {**dets, "boxes": boxes}

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        raw_outs = self._raw(images)
        if mode == "train":
            total, losses = self._loss(images, raw_outs, targets)
            return total, {**losses, "loss": total}
        if mode == "val":
            total, losses = self._loss(images, raw_outs, targets)
            preds = self._predict(images, raw_outs, targets)
            return {**losses, "loss": total}, preds
        return self._predict(images, raw_outs, targets)
