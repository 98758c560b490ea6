"""AIRDet (counterpart of ``cvpytorch_tpu/models/airdet.py``): the YOLOv5
CSPDarknet, the GiraffeNeck and the GFocalHeadV2 (GFLv2 with DGQP,
reg_max 14, SimOTA), under the forward contract ``model(images, targets,
mode)``.

``TYPE`` airdet_{nano,tiny,s,m,l,x} picks the width multiple, which picks
the CSPDarknet's size and the neck's widths (192, 320, 768) · w; airdet_s:
(96, 160, 384), the head's ``reg_channels`` 64 and ``conv_groups`` 2.
``GFLv2Detector`` holds what AIRDet and GiraffeDet share: the predict
path (``batched_nms`` on the best class probability, boxes clipped and
un-letterboxed) and the loss, run in float32 outside autocast.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..ops.boxes import clip_boxes, unletterbox_boxes
from ..ops.nms import batched_nms
from ..registry import MODELS
from .backbones.csp_darknet import YOLOv5CSPDarknet
from .heads.gflv2_head import GFocalHeadV2, gflv2_decode, gflv2_loss
from .nanodet_plus import _at_least_f32
from .necks.giraffe_neck import GiraffeNeck

# depth/width multiples
AIRDET_CFG = {"nano": (0.33, 0.25), "tiny": (0.33, 0.375), "s": (0.33, 0.5),
              "m": (0.67, 0.75), "l": (1.0, 1.0), "x": (1.33, 1.25)}


class GFLv2Detector(nn.Module):
    """A backbone, a GiraffeNeck and a GFocalHeadV2; subclasses build them."""

    reg_max = 14

    def __init__(self, dictionary: Sequence[Any], score_threshold: float,
                 iou_threshold: float, max_det: int):
        super().__init__()
        self.num_classes = max(len(dictionary), 1)
        self.score_threshold, self.iou_threshold, self.max_det = (score_threshold,
                                                                  iou_threshold, max_det)

    def _outs(self, images):
        return self.head(self.neck(self.backbone(images.permute(0, 3, 1, 2))))

    def _predict(self, outs, images, targets=None):
        cls_probs, reg_logits, priors = outs
        cls_probs, reg_logits = _at_least_f32(cls_probs), _at_least_f32(reg_logits)
        boxes = gflv2_decode(cls_probs, reg_logits, priors)
        scores, labels = cls_probs.max(-1)
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
        outs = self._outs(images)
        if mode == "infer":
            return self._predict(outs, images, targets)
        cls_probs, reg_logits, priors = outs
        with torch.autocast(images.device.type, enabled=False):
            c, r = _at_least_f32(cls_probs), _at_least_f32(reg_logits)
            t = {k: targets[k] for k in ("boxes", "labels", "valid")}
            total, losses = gflv2_loss(c, r, priors.to(c.dtype), t, self.num_classes,
                                       self.reg_max)
        losses = {**losses, "loss": total}
        if mode == "train":
            return total, losses
        return losses, self._predict(outs, images, targets)


@MODELS.register(name="AIRDet")
class AIRDet(GFLv2Detector):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 score_threshold: float = 0.05, iou_threshold: float = 0.7,
                 max_det: int = 100):
        super().__init__(dictionary, score_threshold, iou_threshold, max_det)
        cfg = model_cfg or {}
        size = (cfg.get("TYPE") or "airdet_s").split("_")[-1]
        _, wm = AIRDET_CFG.get(size, AIRDET_CFG["s"])
        fpn = tuple(max(round(c * wm), 1) for c in (192, 320, 768))
        bb_size = {0.25: "n", 0.375: "t", 0.5: "s", 0.75: "m", 1.0: "l", 1.25: "x"}.get(wm, "s")
        self.backbone = YOLOv5CSPDarknet(subtype=f"cspdark_{bb_size}")
        self.neck = GiraffeNeck(self.backbone.channels, fpn, fpn)
        self.head = GFocalHeadV2(self.num_classes, fpn, reg_max=self.reg_max, reg_channels=64,
                                 conv_groups=2)
