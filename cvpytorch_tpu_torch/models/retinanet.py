"""RetinaNet (counterpart of ``cvpytorch_tpu/models/retinanet.py``): a
ResNet's C3–C5 (ResNet-50 by default), ``FCOSFPN`` P3–P7, 9 anchors a
cell (3 scales × 3 aspects, sizes 32–512), the 4-conv cls and box towers
(no norm), under the forward contract ``model(images, targets, mode)``.

Loss: each anchor's best gt by IoU (``argmax``, the first among equals;
invalid gts at IoU 0); positive at IoU ≥ 0.5, ignored in (0.4, 0.5);
focal classification (α 0.25, γ 2) off the ignored anchors and smooth-L1
(β 1/9) on the positives' R-CNN deltas (``rcnn.encode_deltas``), both
over the batch's positives.  Predict: ``rcnn.decode_deltas``, boxes
clipped, then the class-offset ``batched_nms`` (score 0.05, IoU 0.5, 100
detections).  The JAX model's infer mode drops its targets; the port
un-letterboxes the served boxes where the targets carry ``pads``, as
every port detector does.  The loss runs in float32 outside autocast.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from ..ops.boxes import box_iou_matrix, clip_boxes, unletterbox_boxes
from ..ops.nms import batched_nms
from ..registry import MODELS
from .backbones import build_backbone
from .losses.yolov5_loss import sigmoid_binary_cross_entropy
from .nanodet_plus import _at_least_f32
from .necks.fcos_fpn import FCOSFPN
from .rcnn import decode_deltas, encode_deltas, smooth_l1
from .segmentor import feature_channels

STRIDES = (8, 16, 32, 64, 128)
SIZES = (32, 64, 128, 256, 512)
SCALES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
ASPECTS = (0.5, 1.0, 2.0)
_DEFAULT_BACKBONE = {"name": "ResNet", "subtype": "resnet50", "out_stages": (2, 3, 4)}


def retina_anchors(level_shapes, device=None, dtype=torch.float32):
    """(Σ h·w·9, 4) xyxy anchors, cell by cell in row-major order, the 9
    of a cell scale-major; the sizes in ``dtype`` (JAX's float64 anchors
    under x64)."""
    out = []
    for (h, w), s, size in zip(level_shapes, STRIDES, SIZES):
        cy, cx = torch.meshgrid((torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s,
                                (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s,
                                indexing="ij")
        centers = torch.stack([cx, cy], -1).reshape(-1, 2)
        whs = torch.tensor([(size * sc * a ** 0.5, size * sc / a ** 0.5)
                            for sc in SCALES for a in ASPECTS], dtype=dtype, device=device)
        c = centers.repeat_interleave(len(whs), 0).to(dtype)
        wh = whs.repeat(centers.shape[0], 1)
        out.append(torch.cat([c - wh / 2, c + wh / 2], -1))
    return torch.cat(out, 0)


class RetinaHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, num_anchors: int = 9,
                 channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        for i in range(4):
            setattr(self, f"cls{i}", nn.Conv2d(in_channels if i == 0 else channels, channels,
                                               3, 1, 1))
            setattr(self, f"reg{i}", nn.Conv2d(in_channels if i == 0 else channels, channels,
                                               3, 1, 1))
        self.cls_out = nn.Conv2d(channels, num_anchors * num_classes, 3, 1, 1)
        nn.init.constant_(self.cls_out.bias, -math.log((1 - 0.01) / 0.01))
        self.reg_out = nn.Conv2d(channels, num_anchors * 4, 3, 1, 1)

    def forward(self, feats):
        """→ class logits (B, A, C), deltas (B, A, 4), A = Σ h·w·9."""
        cls_all, reg_all = [], []
        for f in feats:
            c, r = f, f
            for i in range(4):
                c = torch.relu(getattr(self, f"cls{i}")(c))
                r = torch.relu(getattr(self, f"reg{i}")(r))
            B = f.shape[0]
            cls_all.append(self.cls_out(c).permute(0, 2, 3, 1).reshape(B, -1, self.num_classes))
            reg_all.append(self.reg_out(r).permute(0, 2, 3, 1).reshape(B, -1, 4))
        return torch.cat(cls_all, 1), torch.cat(reg_all, 1)


def retina_loss(cls_logits, reg, anchors, targets, num_classes, pos_iou: float = 0.5,
                neg_iou: float = 0.4):
    gt, gl, gv = targets["boxes"], targets["labels"], targets["valid"]
    ious = torch.where(gv[:, None, :], box_iou_matrix(anchors, gt), 0.0)
    best_iou, best_gt = ious.max(-1)  # the first among equals
    pos = best_iou >= pos_iou
    ignore = (best_iou > neg_iou) & ~pos
    n_pos = pos.sum().to(cls_logits.dtype).clamp(min=1.0)
    labels = gl.gather(1, best_gt)
    # jax.nn.one_hot: a label outside [0, C) is all zeros
    onehot = (labels[..., None] == torch.arange(num_classes, device=labels.device))
    onehot = onehot.to(cls_logits.dtype) * pos[..., None]
    p = torch.sigmoid(cls_logits)
    alpha, gamma = 0.25, 2.0
    hot = onehot > 0
    pt = torch.where(hot, p, 1 - p)
    alpha_t = torch.where(hot, alpha, 1 - alpha)
    focal = alpha_t * (1 - pt) ** gamma * sigmoid_binary_cross_entropy(cls_logits, onehot)
    cls_loss = (focal * (~ignore)[..., None]).sum() / n_pos
    matched = gt.gather(1, best_gt[..., None].expand(-1, -1, 4))
    t_deltas = encode_deltas(matched, anchors[None])
    reg_loss = (smooth_l1(reg - t_deltas).sum(-1) * pos).sum() / n_pos
    return cls_loss + reg_loss, {"cls_loss": cls_loss, "reg_loss": reg_loss}


@MODELS.register(name="RetinaNet")
class RetinaNet(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 pos_iou: float = 0.5, neg_iou: float = 0.4, score_threshold: float = 0.05,
                 iou_threshold: float = 0.5, max_det: int = 100):
        super().__init__()
        cfg = model_cfg or {}
        self.num_classes = max(len(dictionary), 1)
        self.pos_iou, self.neg_iou = pos_iou, neg_iou
        self.score_threshold, self.iou_threshold, self.max_det = (score_threshold,
                                                                  iou_threshold, max_det)
        self.backbone = build_backbone(cfg.get("BACKBONE") or _DEFAULT_BACKBONE)
        self.fpn = FCOSFPN(feature_channels(self.backbone))
        self.head = RetinaHead(self.fpn.out_channels[0], self.num_classes)

    def _forward(self, images):
        feats = self.fpn(self.backbone(images.permute(0, 3, 1, 2)))
        cls_logits, reg = self.head(feats)
        return cls_logits, reg, retina_anchors([f.shape[-2:] for f in feats], images.device,
                                                  torch.promote_types(images.dtype,
                                                                      torch.float32))

    def _predict(self, cls_logits, reg, anchors, images, targets=None):
        cls_logits, reg = _at_least_f32(cls_logits), _at_least_f32(reg)
        boxes = decode_deltas(reg, anchors[None].to(reg.dtype))
        best, labels = torch.sigmoid(cls_logits).max(-1)
        h, w = images.shape[1:3]
        dets = batched_nms(clip_boxes(boxes, h, w), best, labels, max_det=self.max_det,
                           iou_threshold=self.iou_threshold, score_threshold=self.score_threshold)
        out_boxes = dets["boxes"]
        if targets is not None and "pads" in targets:
            out_boxes = unletterbox_boxes(out_boxes, targets["pads"][:, None, :],
                                          targets["scales"][:, None, :])
        return {**dets, "boxes": out_boxes}

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        cls_logits, reg, anchors = self._forward(images)
        if mode == "infer":
            return self._predict(cls_logits, reg, anchors, images, targets)
        t = {k: targets[k] for k in ("boxes", "labels", "valid")}
        with torch.autocast(images.device.type, enabled=False):
            total, losses = retina_loss(_at_least_f32(cls_logits), _at_least_f32(reg), anchors,
                                        t, self.num_classes, self.pos_iou, self.neg_iou)
        losses = {**losses, "loss": total}
        if mode == "train":
            return total, losses
        return losses, self._predict(cls_logits, reg, anchors, images, targets)
