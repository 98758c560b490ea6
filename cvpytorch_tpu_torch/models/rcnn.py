"""Faster R-CNN / Mask R-CNN (counterpart of ``cvpytorch_tpu/models/rcnn.py``),
fixed-shape like the JAX design.

* anchors: 3 aspect ratios × 1 size per FPN level (P2–P5 and the pooled P6);
* the RPN's sampling (256 anchors, ≤ 50 % positive) is a weighted loss:
  every positive counts, negatives are down-weighted to the reference
  ratio in expectation;
* proposals: pre-NMS top-k per image → class-agnostic batched NMS (the
  NMS kernel on CUDA tensors) → a fixed K with a validity mask; they are
  constants for the ROI heads (detached, as torchvision detaches them);
* ROI heads: IoU ≥ 0.5 matching over the padded proposals plus the gt
  boxes, weighted CE and smooth-L1; the mask branch trains on the first
  128 positive slots of each image (a stable top-k of the fg indicator)
  against gt masks cropped to the proposals by ``crop_resize_separable``.

Images enter NHWC; the backbone and heads run NCHW on the
``channels_last`` view.  ROI features are NHWC (N, S, S, C), so the box
head flattens them in the (H, W, C) order of the JAX ``Dense`` and its
``fc1`` kernel needs no permutation.  The heads' logits and deltas are
taken to float32 and every loss runs with autocast off, so under bf16
autocast only the network runs in bf16.

``mode="train"`` returns ``(total, losses)``, ``mode="val"`` ``(losses,
predictions)`` and ``mode="infer"`` the predictions: the dict of
``batched_nms`` with ``masks`` (B, max_det, mask_size, mask_size) pasted
onto each image's canvas.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import box_iou_matrix, clip_boxes, unletterbox_boxes
from ..ops.masks import paste_masks
from ..ops.nms import batched_nms, top_k
from ..ops.roi_align import crop_resize_separable, multiscale_roi_align
from ..registry import MODELS
from .backbones import build_backbone
from .necks.fcos_fpn import FPN

RPN_STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECTS = (0.5, 1.0, 2.0)


def make_anchors(level_shapes, strides=RPN_STRIDES, sizes=ANCHOR_SIZES,
                 aspects=ASPECTS, device=None):
    """(P_total, 4) xyxy anchors over all levels, in (level, y, x, aspect)
    order."""
    all_anchors = []
    for (h, w), s, size in zip(level_shapes, strides, sizes):
        cy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        cx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        centers = torch.stack(torch.broadcast_tensors(cx[None, :], cy[:, None]),
                              -1).reshape(-1, 2)  # (hw, 2) as (x, y)
        whs = torch.tensor([(size * a ** 0.5, size / a ** 0.5) for a in aspects],
                           dtype=torch.float32, device=device)
        c = centers.repeat_interleave(len(aspects), 0)
        wh = whs.repeat(centers.shape[0], 1)
        all_anchors.append(torch.cat([c - wh / 2, c + wh / 2], -1))
    return torch.cat(all_anchors, 0)


def encode_deltas(boxes, anchors):
    """box → (dx, dy, dw, dh) w.r.t. anchors.  Anchor extents are clamped to
    ≥ 1 px: padded proposals are zero-size and would give inf/NaN that the
    masked loss turns into NaN gradients (inf·0)."""
    aw = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1.0)
    ah = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1.0)
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6)
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    bx = boxes[..., 0] + bw / 2
    by = boxes[..., 1] + bh / 2
    return torch.stack([(bx - ax) / aw, (by - ay) / ah,
                        torch.log(bw / aw), torch.log(bh / ah)], -1)


def decode_deltas(deltas, anchors, clip: float = 4.0):
    aw = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1.0)
    ah = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1.0)
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bx = deltas[..., 0] * aw + ax
    by = deltas[..., 1] * ah + ay
    bw = torch.exp(deltas[..., 2].clamp(-clip, clip)) * aw
    bh = torch.exp(deltas[..., 3].clamp(-clip, clip)) * ah
    return torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], -1)


def smooth_l1(x, beta: float = 1.0 / 9):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int = 3, channels: int = 256):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, 1, 1)
        self.obj = nn.Conv2d(channels, num_anchors, 1)
        self.reg = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats):
        """→ objectness (B, P) and deltas (B, P, 4), P in (level, y, x,
        anchor) order."""
        objs, regs = [], []
        for f in feats:
            h = F.relu(self.conv(f))
            B = h.shape[0]
            objs.append(self.obj(h).permute(0, 2, 3, 1).reshape(B, -1))
            regs.append(self.reg(h).permute(0, 2, 3, 1).reshape(B, -1, 4))
        return torch.cat(objs, 1), torch.cat(regs, 1)


class BoxHead(nn.Module):
    def __init__(self, num_classes: int, channels: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = nn.Linear(7 * 7 * 256, channels)
        self.fc2 = nn.Linear(channels, channels)
        self.cls = nn.Linear(channels, num_classes + 1)  # + background
        self.reg = nn.Linear(channels, num_classes * 4)

    def forward(self, roi_feats):
        """roi_feats NHWC (N, 7, 7, C), flattened in (H, W, C) order."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls(x), self.reg(x).reshape(-1, self.num_classes, 4)


class MaskHead(nn.Module):
    def __init__(self, num_classes: int, channels: int = 256):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i}", nn.Conv2d(channels, channels, 3, 1, 1))
        self.deconv = nn.ConvTranspose2d(channels, channels, 2, 2)
        self.mask = nn.Conv2d(channels, num_classes, 1)

    def forward(self, roi_feats):
        """roi_feats NHWC (N, 14, 14, C) → logits (N, classes, 28, 28)."""
        x = roi_feats.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.mask(F.relu(self.deconv(x)))


def _rows(x, idx):
    """x (B, N, ...) gathered along dim 1 by idx (B, K) → (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


@MODELS.register(name="MaskRCNN", aliases=("FasterRCNN",))
class MaskRCNN(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 num_proposals: int = 256, pre_nms_topk: int = 1000,
                 rpn_nms_thresh: float = 0.7, rpn_pos_iou: float = 0.7,
                 rpn_neg_iou: float = 0.3, roi_pos_iou: float = 0.5,
                 with_mask: bool = True, score_threshold: float = 0.05,
                 iou_threshold: float = 0.5, max_det: int = 100,
                 mask_size: int = 112):
        super().__init__()
        self.num_classes = max(len(dictionary), 1)
        self.num_proposals = num_proposals
        self.pre_nms_topk = pre_nms_topk
        self.rpn_nms_thresh = rpn_nms_thresh
        self.rpn_pos_iou = rpn_pos_iou
        self.rpn_neg_iou = rpn_neg_iou
        self.roi_pos_iou = roi_pos_iou
        self.with_mask = with_mask
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.max_det = max_det
        self.mask_size = mask_size  # paste canvas: the dataset's MASK_SIZE
        cfg = model_cfg or {}
        bb = cfg.get("BACKBONE") or {"name": "ResNet", "subtype": "resnet50",
                                     "out_stages": (1, 2, 3, 4)}
        bb = dict(bb.items())
        bb.setdefault("out_stages", (1, 2, 3, 4))
        self.backbone = build_backbone(bb)
        self.fpn = FPN([self.backbone.channels[s - 1] for s in bb["out_stages"]],
                       out_channels=256, num_outs=5)
        self.rpn = RPNHead(num_anchors=len(ASPECTS))
        self.box_head = BoxHead(self.num_classes)
        if with_mask:
            self.mask_head = MaskHead(self.num_classes)

    @staticmethod
    def _roi_align(feats, boxes, output_size):
        """(B, K, 4) boxes → NHWC ROI features (B·K, S, S, C) from P2–P5."""
        B, K, _ = boxes.shape
        idx = torch.arange(B, device=boxes.device).repeat_interleave(K)
        return multiscale_roi_align([f.permute(0, 2, 3, 1) for f in feats[:4]],
                                    RPN_STRIDES[:4], boxes.reshape(B * K, 4), idx,
                                    output_size=output_size)

    # -- RPN ---------------------------------------------------------------
    def _rpn_proposals(self, feats, images):
        obj_logits, reg_deltas = self.rpn(feats)
        obj_logits, reg_deltas = obj_logits.float(), reg_deltas.float()
        anchors = make_anchors([f.shape[-2:] for f in feats], device=images.device)
        scores, boxes = self._rpn_candidates(obj_logits, reg_deltas, anchors,
                                             images.shape[1:3])
        proposals, valid = self._select_proposals(scores, boxes)
        return obj_logits, reg_deltas, anchors, proposals, valid

    @staticmethod
    def _rpn_candidates(obj_logits, reg_deltas, anchors, size):
        """Every anchor's objectness and its decoded box clipped to the
        (h, w) frame.  Proposals are constants for the ROI heads; the NMS
        kernel has no gradient either."""
        boxes = clip_boxes(decode_deltas(reg_deltas, anchors[None]), *size)
        return torch.sigmoid(obj_logits.detach()), boxes.detach()

    def _select_proposals(self, scores, boxes):
        """The pre-NMS top-k of the candidates, suppressed class-agnostically
        through the NMS kernel: (B, num_proposals, 4) boxes and their mask."""
        k = min(self.pre_nms_topk, scores.shape[1])
        top_s, top_i = top_k(scores, k)
        dets = batched_nms(_rows(boxes, top_i), top_s, torch.zeros_like(top_i),
                           max_det=self.num_proposals,
                           iou_threshold=self.rpn_nms_thresh,
                           score_threshold=0.0, max_nms=k, class_aware=False)
        return dets["boxes"], dets["valid"]

    def _rpn_loss(self, obj_logits, reg_deltas, anchors, targets):
        gt, gv = targets["boxes"].float(), targets["valid"]
        ious = box_iou_matrix(anchors, gt)  # (B, P, M)
        ious = torch.where(gv[:, None, :], ious, 0.0)
        best_iou, best_gt = ious.max(-1).values, ious.argmax(-1)
        pos = best_iou >= self.rpn_pos_iou
        # the best anchor of every gt is positive too (torchvision's rule):
        # a scatter-max, so an invalid gt sharing that anchor cannot undo it
        best_anchor = ious.argmax(1)  # (B, M)
        pos = pos | (torch.zeros_like(best_iou).scatter_reduce(
            1, best_anchor, gv.float(), "amax") > 0)
        neg = (best_iou < self.rpn_neg_iou) & ~pos

        n_pos = torch.clamp(pos.sum().float(), min=1.0)
        B = obj_logits.shape[0]
        n_neg = torch.clamp(neg.sum().float(), min=1.0)
        neg_weight = torch.clamp((128.0 * B) / n_neg, max=1.0)
        bce = F.binary_cross_entropy_with_logits(obj_logits, pos.float(),
                                                 reduction="none")
        obj_loss = (bce * (pos + neg * neg_weight)).sum() / (n_pos + neg_weight * n_neg)

        t_deltas = encode_deltas(_rows(gt, best_gt), anchors[None])
        reg_loss = (smooth_l1(reg_deltas - t_deltas).sum(-1) * pos).sum() / n_pos
        return obj_loss, reg_loss

    # -- ROI heads ----------------------------------------------------------
    def _match_proposals(self, proposals, valid, targets):
        gt, gl, gv = targets["boxes"].float(), targets["labels"], targets["valid"]
        ious = torch.where(gv[:, None, :], box_iou_matrix(proposals, gt), 0.0)
        best_iou, best_gt = ious.max(-1).values, ious.argmax(-1)
        fg = (best_iou >= self.roi_pos_iou) & valid
        labels = torch.where(fg, gl.gather(1, best_gt).long(), self.num_classes)
        return fg, labels, _rows(gt, best_gt), best_gt

    def _box_outputs(self, feats, proposals):
        B, K, _ = proposals.shape
        cls, reg = self.box_head(self._roi_align(feats, proposals, 7))
        return (cls.float().reshape(B, K, -1),
                reg.float().reshape(B, K, self.num_classes, 4))

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        feats = self.fpn(self.backbone(images.permute(0, 3, 1, 2)))
        obj_logits, reg_deltas, anchors, proposals, prop_valid = \
            self._rpn_proposals(feats, images)
        if mode == "infer":  # targets: the infer stage's pads/scales, if any
            return self._predict(feats, proposals, prop_valid, images, targets)

        f32 = torch.autocast(images.device.type, enabled=False)
        with f32:
            rpn_obj, rpn_reg = self._rpn_loss(obj_logits, reg_deltas, anchors,
                                              targets)
            # the gt boxes join the proposals (the standard trick for
            # stability); they carry no gradient either
            proposals = torch.cat([proposals, targets["boxes"].float()], 1)
            prop_valid = torch.cat([prop_valid, targets["valid"]], 1)
            fg, labels, matched_boxes, best_gt = self._match_proposals(
                proposals, prop_valid, targets)
        cls_logits, box_reg = self._box_outputs(feats, proposals)

        with f32:
            n_fg = torch.clamp(fg.sum().float(), min=1.0)
            n_valid = torch.clamp(prop_valid.sum().float(), min=1.0)
            ce = F.cross_entropy(cls_logits.transpose(1, 2), labels, reduction="none")
            cls_loss = (ce * prop_valid).sum() / n_valid
            t_deltas = encode_deltas(matched_boxes, proposals)
            safe_lab = labels.clamp(0, self.num_classes - 1)
            reg_sel = box_reg.gather(
                2, safe_lab[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
            box_loss = (smooth_l1(reg_sel - t_deltas).sum(-1) * fg).sum() / n_fg
        losses = {"rpn_obj_loss": rpn_obj, "rpn_reg_loss": rpn_reg,
                  "cls_loss": cls_loss, "box_loss": box_loss}
        total = rpn_obj + rpn_reg + cls_loss + box_loss

        if self.with_mask and "masks" in targets:
            B, K, _ = proposals.shape
            # the first Km positive slots of each image (a stable top-k of
            # the fg indicator: the JAX order among ties)
            Km = min(128, K)
            _, midx = top_k(fg.float(), Km)
            mprop = _rows(proposals, midx)
            mfg, mbest, mlab = _rows(fg, midx), _rows(best_gt, midx), _rows(safe_lab, midx)
            mask_logits = self.mask_head(self._roi_align(feats, mprop, 14))
            gmasks = targets["masks"]  # (B, M, Hm, Wm) float 0/1
            mh = gmasks.shape[-1]
            # the eval paste canvas and the dataset's gt raster must agree,
            # or segm IoU compares different resolutions
            if mh != self.mask_size:
                raise ValueError(
                    f"dataset MASK_SIZE={mh} != model mask_size="
                    f"{self.mask_size}; pass mask_size={mh} to MaskRCNN "
                    "(Trainer threads this automatically)")
            with f32:
                h, w = images.shape[1:3]
                scale = mh / torch.tensor([w, h, w, h], dtype=torch.float32,
                                          device=images.device)
                tgt_crop = crop_resize_separable(
                    _rows(gmasks, mbest).reshape(B * Km, mh, mh),
                    mprop.reshape(B * Km, 4) * scale, output_size=28)
                m_sel = mask_logits.gather(
                    1, mlab.reshape(-1, 1, 1, 1).expand(-1, 1, 28, 28))[:, 0].float()
                mbce = F.binary_cross_entropy_with_logits(
                    m_sel, (tgt_crop > 0.5).float(), reduction="none")
                n_mfg = torch.clamp(mfg.sum().float(), min=1.0)
                mask_loss = (mbce.mean((1, 2)) * mfg.reshape(-1)).sum() / n_mfg
            losses["mask_loss"] = mask_loss
            total = total + mask_loss

        losses["loss"] = total
        if mode == "train":
            return total, losses
        n = self.num_proposals
        return losses, self._predict(feats, proposals[:, :n], prop_valid[:, :n],
                                     images, targets)

    def _predict(self, feats, proposals, prop_valid, images, targets):
        cls_logits, box_reg = self._box_outputs(feats, proposals)
        B, K, _ = proposals.shape
        probs = torch.softmax(cls_logits, -1)[..., :self.num_classes]
        scores = probs.max(-1).values * prop_valid
        labels = probs.argmax(-1)
        deltas = box_reg.gather(2, labels[..., None, None].expand(B, K, 1, 4))[:, :, 0]
        h, w = images.shape[1:3]
        boxes = clip_boxes(decode_deltas(deltas, proposals), h, w)
        dets = batched_nms(boxes, scores, labels, max_det=self.max_det,
                           iou_threshold=self.iou_threshold,
                           score_threshold=self.score_threshold)
        out_boxes = dets["boxes"]
        if targets is not None and "pads" in targets:
            out_boxes = unletterbox_boxes(out_boxes, targets["pads"][:, None, :],
                                          targets["scales"][:, None, :])
        out = {**dets, "boxes": out_boxes}
        if self.with_mask:
            # the mask head on the kept detections, the class's sigmoid,
            # pasted onto a canvas of each image in original pixels
            D = dets["boxes"].shape[1]
            mlog = self.mask_head(self._roi_align(feats, dets["boxes"], 14))
            lab = dets["labels"].reshape(-1).clamp(0, self.num_classes - 1)
            msel = mlog.gather(1, lab.reshape(-1, 1, 1, 1).expand(-1, 1, 28, 28))[:, 0]
            probs = torch.sigmoid(msel.float()).reshape(B, D, 28, 28)
            if targets is not None and "height" in targets:
                hs, ws = targets["height"], targets["width"]
            else:
                hs = torch.full((B,), h, dtype=torch.float32, device=images.device)
                ws = torch.full((B,), w, dtype=torch.float32, device=images.device)
            out["masks"] = paste_masks(probs, out_boxes, hs, ws,
                                       out_size=self.mask_size)
        return out
