"""YOLOv6 (counterpart of ``cvpytorch_tpu/models/yolov6.py``), NCHW:
EfficientRep backbone (RepVGG blocks), RepBiPAN neck, Effidehead, and the
loss of varifocal classification and GIoU boxes on ATSS, then TAL,
assignment, under the forward contract ``model(images, targets, mode)``.

Every BN of the model is torch momentum 0.03, eps 1e-3 (flax 0.97).  The
priors are the cells' centres, (x + 0.5)·stride, at strides 8, 16, 32;
the head predicts ltrb distances in stride units (ReLU'd) and class
logits.  ``TYPE`` yolov6_{n,t,s,m,l} picks the depth and width
multipliers of ``backbones/csp_darknet.SIZE_CFG``.

The ATSS → TAL switch: epochs below ``warmup_epoch`` (4) assign with
ATSS over 5·stride grid cells (``center_eps`` 1e-9, a strict threshold,
multi-gt priors to the highest IoU over every gt) and take IoU(prediction,
gt) as the soft label; later epochs, and targets without an ``epoch``,
assign with TAL.  JAX branches with ``lax.cond`` on a traced epoch; the
port branches in Python on the host integer the trainer puts in the
targets, so no device value is read.  The loss runs in float32 outside
autocast.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..ops.boxes import bbox_iou, clip_boxes, unletterbox_boxes
from ..ops.nms import batched_nms
from ..registry import MODELS
from .assigners.atss_assigner import atss_assign, grid_cells
from .assigners.tal_assigner import tal_assign
from .backbones.csp_darknet import SIZE_CFG
from .backbones.repvgg import RepVGGBlock as _RepVGGBlock
from .bricks import ConvBNAct, make_divisible, make_round
from .heads.nanodet_head import center_priors
from .nanodet_plus import _at_least_f32

_BN = dict(bn_momentum=0.03, bn_eps=1e-3)
STRIDES = (8, 16, 32)


def RepVGGBlock(in_channels, out_channels, stride=1):
    return _RepVGGBlock(in_channels, out_channels, stride, **_BN)


class SimCSPSPPF(nn.Module):
    """The CSP-wrapped SPPF of v6-3.0 (ReLU): ``cv1``→``cv3``→``cv4``, three
    5×5/1 max-pools in series, ``cv5``, ``cv6``, concatenated with ``cv2``
    of the input, ``cv7``."""

    def __init__(self, in_channels: int, out_channels: int, e: float = 0.5):
        super().__init__()
        c_ = int(out_channels * e)
        cba = lambda i, o, k: ConvBNAct(i, o, k, act="relu", **_BN)
        self.cv1, self.cv2, self.cv3 = cba(in_channels, c_, 1), cba(in_channels, c_, 1), cba(c_, c_, 3)
        self.cv4, self.cv5, self.cv6 = cba(c_, c_, 1), cba(4 * c_, c_, 1), cba(c_, c_, 3)
        self.cv7 = cba(2 * c_, out_channels, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = F.max_pool2d(x1, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        z = self.cv6(self.cv5(torch.cat([x1, y1, y2, F.max_pool2d(y2, 5, 1, 2)], 1)))
        return self.cv7(torch.cat([self.cv2(x), z], 1))


class SimSPPF(nn.Module):
    """The serial SPPF with ReLU convolutions (PAI-YOLOX's stage 4):
    ``conv1`` to half the channels, three k×k/1 max-pools, ``conv2``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 5):
        super().__init__()
        c_ = in_channels // 2
        self.k = kernel_size
        self.conv1 = ConvBNAct(in_channels, c_, 1, act="relu", **_BN)
        self.conv2 = ConvBNAct(4 * c_, out_channels, 1, act="relu", **_BN)

    def forward(self, x):
        x = self.conv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        return self.conv2(torch.cat([x, y1, y2, F.max_pool2d(y2, self.k, 1, self.k // 2)], 1))


def add_rep_block(parent: nn.Module, name: str, in_channels: int, out_channels: int, n: int):
    """The reference RepBlock: RepVGG ``{name}_conv1`` (in → out), then
    n − 1 ``{name}_block{j}`` (out → out), attributes of ``parent`` (the
    Flax tree's flat names), listed in ``parent.rep_blocks[name]``."""
    names = [f"{name}_conv1"] + [f"{name}_block{j}" for j in range(max(n - 1, 0))]
    for i, child in enumerate(names):
        setattr(parent, child, RepVGGBlock(in_channels if i == 0 else out_channels, out_channels))
    parent.rep_blocks[name] = names


def run_rep_block(parent: nn.Module, name: str, x):
    for child in parent.rep_blocks[name]:
        x = getattr(parent, child)(x)
    return x


class EfficientRep(nn.Module):
    """v6-3.0's backbone: the ``stem`` RepVGG block (stride 2), then four
    stages of a stride-2 RepVGG ``stage{i}_down`` and a RepBlock, the last
    ending in ``sppf`` (SimCSPSPPF, or with ``sppf='relu'`` the SimSPPF of
    PAI-YOLOX).  Returns the ``out_stages`` (1-based) features;
    ``out_channels`` their widths."""

    def __init__(self, depth_mul: float = 0.33, width_mul: float = 0.5,
                 channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 num_blocks: Sequence[int] = (6, 12, 18, 6),
                 out_stages: Sequence[int] = (2, 3, 4), sppf: str = "simcsp"):
        super().__init__()
        chs = [make_divisible(c * width_mul) for c in channels]
        blocks = [make_round(n, depth_mul) for n in num_blocks]
        self.out_stages, self.rep_blocks = tuple(out_stages), {}
        self.stem = RepVGGBlock(3, chs[0], 2)
        for i in range(4):
            setattr(self, f"stage{i + 1}_down", RepVGGBlock(chs[i], chs[i + 1], 2))
            add_rep_block(self, f"stage{i + 1}", chs[i + 1], chs[i + 1], blocks[i])
        self.sppf = (SimSPPF(chs[4], chs[4]) if sppf == "relu" else SimCSPSPPF(chs[4], chs[4]))
        self.out_channels = [chs[s] for s in self.out_stages]

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for i in range(1, 5):
            x = run_rep_block(self, f"stage{i}", getattr(self, f"stage{i}_down")(x))
            if i == 4:
                x = self.sppf(x)
            if i in self.out_stages:
                feats.append(x)
        return tuple(feats)


class BiFusion(nn.Module):
    """BiC: the top level upsampled by a 2×2/2 transposed convolution
    (``upsample``, with bias), the same level through ``cv1`` (1×1), the
    lower level through ``cv2`` (1×1) and ``downsample`` (3×3/2),
    concatenated, ``cv3`` (1×1)."""

    def __init__(self, top_channels: int, same_channels: int, lower_channels: int,
                 out_channels: int):
        super().__init__()
        self.upsample = nn.ConvTranspose2d(top_channels, out_channels, 2, 2)
        self.cv1 = ConvBNAct(same_channels, out_channels, 1, act="relu", **_BN)
        self.cv2 = ConvBNAct(lower_channels, out_channels, 1, act="relu", **_BN)
        self.downsample = ConvBNAct(out_channels, out_channels, 3, 2, act="relu", **_BN)
        self.cv3 = ConvBNAct(3 * out_channels, out_channels, 1, act="relu", **_BN)

    def forward(self, top, same, lower):
        return self.cv3(torch.cat([self.upsample(top), self.cv1(same),
                                   self.downsample(self.cv2(lower))], 1))


class RepBiPAN(nn.Module):
    """The bi-directional concatenating Rep-PAN on four backbone levels
    (strides 4, 8, 16, 32) → three outputs (8, 16, 32)."""

    def __init__(self, in_channels: Sequence[int], width_mul: float = 0.5,
                 depth_mul: float = 0.33, mid_channels: Sequence[int] = (128, 128, 256),
                 out_channels: Sequence[int] = (128, 256, 512),
                 num_blocks: Sequence[int] = (12, 12, 12, 12)):
        super().__init__()
        c3, c2, c1, c0 = in_channels  # strides 4, 8, 16, 32
        mid = [make_divisible(c * width_mul) for c in mid_channels]
        out = [make_divisible(c * width_mul) for c in out_channels]
        nb = [make_round(n, depth_mul) for n in num_blocks]
        self.rep_blocks = {}
        cba = lambda i, o, k, s=1: ConvBNAct(i, o, k, s, act="relu", **_BN)
        self.reduce_layer0 = cba(c0, mid[2], 1)
        self.bifusion0 = BiFusion(mid[2], c1, c2, mid[2])
        add_rep_block(self, "Rep_p4", mid[2], mid[2], nb[3])
        self.reduce_layer1 = cba(mid[2], mid[1], 1)
        self.bifusion1 = BiFusion(mid[1], c2, c3, mid[1])
        add_rep_block(self, "Rep_p3", mid[1], out[0], nb[2])
        self.downsample2 = cba(out[0], mid[0], 3, 2)
        add_rep_block(self, "Rep_n3", mid[0] + mid[1], out[1], nb[1])
        self.downsample1 = cba(out[1], out[1], 3, 2)
        add_rep_block(self, "Rep_n4", out[1] + mid[2], out[2], nb[0])
        self.out_channels = out

    def forward(self, feats):
        x3, x2, x1, x0 = feats
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = run_rep_block(self, "Rep_p4", self.bifusion0(fpn_out0, x1, x2))
        fpn_out1 = self.reduce_layer1(f_out0)
        pan_out2 = run_rep_block(self, "Rep_p3", self.bifusion1(fpn_out1, x2, x3))
        pan_out1 = run_rep_block(self, "Rep_n3",
                                 torch.cat([self.downsample2(pan_out2), fpn_out1], 1))
        pan_out0 = run_rep_block(self, "Rep_n4",
                                 torch.cat([self.downsample1(pan_out1), fpn_out0], 1))
        return pan_out2, pan_out1, pan_out0


class Effidehead(nn.Module):
    """The decoupled anchor-free head: per level ``stem{i}`` (1×1),
    ``cls_conv{i}`` and ``reg_conv{i}`` (3×3, SiLU), ``cls_out{i}`` (C,
    bias −log 99) and ``reg_out{i}`` (4).  → flat (B, P, 4 + C), level by
    level, each in row-major (y, x) order."""

    def __init__(self, num_classes: int, in_channels: Sequence[int]):
        super().__init__()
        self.n_levels = len(in_channels)
        for i, ch in enumerate(in_channels):
            setattr(self, f"stem{i}", ConvBNAct(ch, ch, 1, act="silu", **_BN))
            setattr(self, f"cls_conv{i}", ConvBNAct(ch, ch, 3, act="silu", **_BN))
            setattr(self, f"reg_conv{i}", ConvBNAct(ch, ch, 3, act="silu", **_BN))
            cls_out = nn.Conv2d(ch, num_classes, 1)
            nn.init.constant_(cls_out.bias, -math.log((1 - 0.01) / 0.01))
            setattr(self, f"cls_out{i}", cls_out)
            setattr(self, f"reg_out{i}", nn.Conv2d(ch, 4, 1))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            x = getattr(self, f"stem{i}")(x)
            cls = getattr(self, f"cls_out{i}")(getattr(self, f"cls_conv{i}")(x))
            reg = getattr(self, f"reg_out{i}")(getattr(self, f"reg_conv{i}")(x))
            outs.append(torch.cat([reg, cls], 1).permute(0, 2, 3, 1).flatten(1, 2))
        return torch.cat(outs, 1)


def decode_yolov6(preds, priors):
    """ltrb distances in stride units, ReLU'd, around the prior centres →
    xyxy boxes."""
    d = F.relu(preds[..., :4]) * priors[None, :, 2:3]
    cx, cy = priors[None, :, 0], priors[None, :, 1]
    return torch.stack([cx - d[..., 0], cy - d[..., 1], cx + d[..., 2], cy + d[..., 3]], -1)


def varifocal_loss(logits, targets, labels_onehot, alpha: float = 0.75, gamma: float = 2.0):
    """α·p^γ on the negatives plus the soft target, times the sigmoid BCE
    (``optax.sigmoid_binary_cross_entropy``, op for op)."""
    p = torch.sigmoid(logits)
    weight = alpha * (p ** gamma) * (1 - labels_onehot) + targets
    bce = -targets * F.logsigmoid(logits) - (1 - targets) * F.logsigmoid(-logits)
    return bce * weight


def yolov6_loss(preds, priors, targets, num_classes, num_level_priors=None, epoch=None,
                warmup_epoch: int = 4):
    """The loss of a padded-target batch (float32).  ``epoch``: the host
    integer of the train epoch, or None; with ``num_level_priors`` given,
    epochs below ``warmup_epoch`` assign with ATSS, the others (and None)
    with TAL."""
    cls_logits = preds[..., 4:]
    boxes = decode_yolov6(preds, priors)
    boxes_d = boxes.detach()
    if epoch is None or num_level_priors is None or int(epoch) >= warmup_epoch:
        with record_function("tal_assign"):  # a range in step profiles
            assign = tal_assign(torch.sigmoid(cls_logits).detach(), priors, boxes_d,
                                targets["boxes"], targets["labels"], targets["valid"])
        matched_gt, align = assign["matched_gt"], assign["align_metric"]
    else:
        with record_function("atss_assign"):
            matched_gt = atss_assign(priors, num_level_priors, grid_cells(priors, 5),
                                     targets["boxes"], targets["valid"], topk=9,
                                     center_eps=1e-9, strict_thr=True,
                                     dedup_unmasked=True)["matched_gt"]
        gt_b = targets["boxes"].gather(1, matched_gt.clamp(min=0)[..., None].expand(-1, -1, 4))
        # the warm-up soft label: IoU(predicted box, its gt)
        align = bbox_iou(boxes_d, gt_b, iou_type="iou") * (matched_gt >= 0)
    pos = matched_gt >= 0
    safe = matched_gt.clamp(min=0)
    gt_boxes = targets["boxes"].gather(1, safe[..., None].expand(-1, -1, 4))
    gt_labels = targets["labels"].gather(1, safe)

    # jax.nn.one_hot: a label outside [0, C) is all zeros
    onehot = (gt_labels[..., None] == torch.arange(num_classes, device=preds.device))
    onehot = onehot.to(preds.dtype) * pos[..., None]
    soft = onehot * align[..., None]
    denom = soft.sum().clamp(min=1.0)
    cls_loss = varifocal_loss(cls_logits, soft, onehot).sum() / denom
    giou = 1.0 - bbox_iou(boxes, gt_boxes, iou_type="giou")
    box_loss = (giou * align * pos).sum() / denom * 2.5
    total = cls_loss + box_loss
    return total, {"cls_loss": cls_loss, "box_loss": box_loss}


# The reference's v6 configs name the generic ``...yolo_detector.YOLODetector``
@MODELS.register(name="YOLOv6", aliases=("YOLODetector",))
class YOLOv6(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 conf_threshold: float = 0.03, iou_threshold: float = 0.65, max_det: int = 300,
                 warmup_epoch: int = 4):
        super().__init__()
        cfg = model_cfg or {}
        self.num_classes = max(len(dictionary), 1)
        self.conf_threshold, self.iou_threshold = conf_threshold, iou_threshold
        self.max_det, self.warmup_epoch = max_det, warmup_epoch
        size = (cfg.get("TYPE") or "yolov6_s").split("_")[-1]
        dm, wm = SIZE_CFG.get(size, (0.33, 0.5))
        self.backbone = EfficientRep(depth_mul=dm, width_mul=wm, out_stages=(1, 2, 3, 4))
        self.neck = RepBiPAN(self.backbone.out_channels, width_mul=wm, depth_mul=dm)
        self.head = Effidehead(self.num_classes, self.neck.out_channels)

    def _forward(self, images):
        preds = self.head(self.neck(self.backbone(images.permute(0, 3, 1, 2))))
        h, w = images.shape[1:3]
        sizes = [(h // s, w // s) for s in STRIDES]
        priors = center_priors(sizes, STRIDES, images.device)
        priors = torch.cat([priors[:, :2] + priors[:, 2:] * 0.5, priors[:, 2:]], 1)
        return preds, priors, tuple(a * b for a, b in sizes)

    def _predict(self, preds, priors, images, targets=None):
        preds = _at_least_f32(preds)
        boxes = decode_yolov6(preds, priors)
        scores = torch.sigmoid(preds[..., 4:])
        dets = batched_nms(boxes, scores.amax(-1), scores.argmax(-1), max_det=self.max_det,
                           iou_threshold=self.iou_threshold,
                           score_threshold=self.conf_threshold)
        h, w = images.shape[1:3]
        out_boxes = clip_boxes(dets["boxes"], h, w)
        if targets is not None and "pads" in targets:
            out_boxes = unletterbox_boxes(out_boxes, targets["pads"][:, None, :],
                                          targets["scales"][:, None, :])
        return {**dets, "boxes": out_boxes}

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        preds, priors, level_priors = self._forward(images)
        if mode == "infer":
            return self._predict(preds, priors, images, targets)
        t = {k: targets[k] for k in ("boxes", "labels", "valid")}
        with torch.autocast(preds.device.type, enabled=False):
            total, losses = yolov6_loss(_at_least_f32(preds), priors, t, self.num_classes,
                                        level_priors, targets.get("epoch"), self.warmup_epoch)
        losses = {**losses, "loss": total}
        if mode == "train":
            return total, losses
        return losses, self._predict(preds, priors, images, targets)
