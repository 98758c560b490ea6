"""NanoDet-Plus and NanoDet v1 (counterpart of
``cvpytorch_tpu/models/nanodet_plus.py``): a backbone (ShuffleNetV2 by
default), GhostPAN + the GFL head (QFL, DFL and GIoU on the DSL
assignment) under the forward contract ``model(images, targets, mode)``.

NanoDet v1 (``assigner='atss'``, or ``USE_MODEL.CLASS`` ending in
``.nanodet.NanoDet``): the PAN neck unless the config names one (TAN for
NanoDet-t), 3×3 depthwise head stacks (Plus: 5×5), priors at
(i + 0.5)·stride and the ATSS-assigned GFL loss (``nanodet_v1_loss``);
the v1 configs give ``strides: [8, 16, 32]`` and ``feat_channels``.

Images enter NHWC; the network runs NCHW on the ``channels_last`` view.
The priors come from the pyramid maps' actual sizes (the stride-64 level
is a ceil division: 416/64 → 7).  With ``use_aux_head`` an aux head of
twice the width runs on the same features in train mode; its detached
predictions drive the assignment of both heads and its loss is added
with ``aux_weight``.  The loss runs in float32 on the head outputs cast
up, outside any autocast region.  Prediction: sigmoid scores, the best
class of each prior, class-offset batched NMS (``ops/nms.batched_nms``,
hence the ``nms_keep`` kernel), clipped to the network image and, when
the targets carry the letterbox's ``pads``/``scales``, mapped back to the
original pixels.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..ops.boxes import clip_boxes, unletterbox_boxes
from ..ops.nms import batched_nms
from ..registry import MODELS
from .backbones import build_backbone
from .heads.nanodet_head import (NanoDetPlusHead, center_priors, center_priors_v1,
                                  decode_nanodet, nanodet_loss, nanodet_v1_loss)
from .necks.ghost_pan import GhostPAN
from .necks.pan import PAN
from .necks.tan import TAN
from .segmentor import feature_channels

STRIDES = (8, 16, 32, 64)
_DEFAULT_BACKBONE = {"name": "ShuffleNetV2", "subtype": "shufflenetv2_x1.0",
                     "act": "leaky_relu"}


def _at_least_f32(x):
    """bf16 under autocast → float32; float32 and float64 stay."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@MODELS.register(name="NanoDetPlus", aliases=("NanoDet",))
class NanoDetPlus(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 feat_channels: int = 96, reg_max: int = 7,
                 strides: Sequence[int] = STRIDES, use_aux_head: bool = False,
                 aux_weight: float = 1.0, score_threshold: float = 0.05,
                 iou_threshold: float = 0.6, max_det: int = 100, assigner: str = "dsl",
                 octave_base_scale: int = 5, atss_topk: int = 9):
        super().__init__()
        cfg = model_cfg or {}
        self.v1 = assigner == "atss" or str(cfg.get("CLASS") or "").endswith(".nanodet.NanoDet")
        self.octave_base_scale, self.atss_topk = octave_base_scale, atss_topk
        self.num_classes = max(len(dictionary), 1)
        self.reg_max = reg_max
        self.strides = tuple(strides)
        self.aux_weight = aux_weight
        self.score_threshold, self.iou_threshold = score_threshold, iou_threshold
        self.max_det = max_det
        self.backbone = build_backbone(cfg.get("BACKBONE") or _DEFAULT_BACKBONE)
        neck_cfg = cfg.get("NECK") or {}
        neck_name = neck_cfg.get("name") or ("PAN" if self.v1 else "GhostPAN")
        neck_ch = int(neck_cfg.get("out_channels", feat_channels) or feat_channels)
        in_ch = feature_channels(self.backbone)
        if neck_name == "PAN":
            self.neck = PAN(in_ch, neck_ch)
        elif neck_name == "TAN":
            self.neck = TAN(in_ch, neck_ch,
                            feature_hw=tuple(neck_cfg.get("feature_hw", (20, 20)) or (20, 20)),
                            num_heads=int(neck_cfg.get("num_heads", 8) or 8),
                            num_encoders=int(neck_cfg.get("num_encoders", 1) or 1),
                            mlp_ratio=int(neck_cfg.get("mlp_ratio", 4) or 4),
                            dropout_ratio=float(neck_cfg.get("dropout_ratio", 0.1) or 0.0))
        else:  # any other name is GhostPAN, as in JAX
            self.neck = GhostPAN(in_channels=in_ch, out_channels=neck_ch,
                                 num_extra_levels=len(self.strides) - 3)
        head_cfg = cfg.get("HEAD") or {}
        ksize = 3 if self.v1 else 5
        head = dict(num_classes=self.num_classes, in_channels=neck_ch, strides=self.strides,
                    reg_max=reg_max, kernel_size=int(head_cfg.get("kernel_size", ksize) or ksize))
        self.head = NanoDetPlusHead(feat_channels=feat_channels, **head)
        self.aux_head = (NanoDetPlusHead(feat_channels=feat_channels * 2, **head)
                         if use_aux_head else None)

    def _forward(self, images, train: bool):
        """(head outputs, the aux head's or None, priors)."""
        return self._forward_levels(images, train)[:3]

    def _forward_levels(self, images, train: bool):
        """``_forward``'s three, and the prior count of each level."""
        feats = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        preds = self.head(feats)
        aux_preds = self.aux_head(feats) if self.aux_head is not None and train else None
        # the priors come from the maps' actual sizes
        sizes = [tuple(f.shape[2:]) for f in feats]
        make_priors = center_priors_v1 if self.v1 else center_priors
        priors = make_priors(sizes, self.strides, images.device)
        return preds, aux_preds, priors, tuple(h * w for h, w in sizes)

    def _loss(self, preds, aux_preds, priors, level_priors, targets):
        t = {k: targets[k] for k in ("boxes", "labels", "valid")}

        def loss(p, assign_preds):
            if self.v1:
                return nanodet_v1_loss(p, priors, t, self.num_classes, self.reg_max,
                                       level_priors, self.octave_base_scale, self.atss_topk)
            return nanodet_loss(p, priors, t, self.num_classes, self.reg_max,
                                assign_preds=assign_preds)

        with torch.autocast(preds.device.type, enabled=False):
            preds = _at_least_f32(preds)
            aux_preds = _at_least_f32(aux_preds) if aux_preds is not None else None
            total, losses = loss(preds, aux_preds)
            if aux_preds is not None:
                aux_total, aux_losses = loss(aux_preds, aux_preds)
                total = total + self.aux_weight * aux_total
                losses.update({f"aux_{k}": v for k, v in aux_losses.items()})
        return total, {**losses, "loss": total}

    def _predict(self, preds, priors, images, targets=None):
        cls_logits, boxes, _ = decode_nanodet(_at_least_f32(preds), priors, self.num_classes,
                                              self.reg_max)
        scores = torch.sigmoid(cls_logits)
        dets = batched_nms(boxes, scores.amax(-1), scores.argmax(-1), max_det=self.max_det,
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
        preds, aux_preds, priors, level_priors = self._forward_levels(images,
                                                                      train=mode == "train")
        if mode == "infer":
            return self._predict(preds, priors, images, targets)
        total, losses = self._loss(preds, aux_preds, priors, level_priors, targets)
        if mode == "train":
            return total, losses
        return losses, self._predict(preds, priors, images, targets)
