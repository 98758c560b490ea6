"""STDC (counterpart of ``cvpytorch_tpu/models/light_seg.py``): the
``STDCNet`` backbone (registered in ``BACKBONES``), the ``STDC`` model (in
``MODELS``), its detail-aggregation loss, and ``_seg_out``, the loss and
outputs the other self-contained segmenters share.

``STDCCatBottleneck`` (block_num 4): ``conv0`` 1×1 to ch/2, then 3×3
convs to ch/4, ch/8 and ch/8, concatenated to exactly ch channels.  A
stride-2 block runs ``avd_conv`` (depthwise 3×3/s2) and ``avd_bn`` (BN,
no activation) on ``conv0``'s output and takes as its skip a 3×3/s2/p1
average pool of it that counts the padded zeros (flax's and torch's
default).  BN is torch momentum 0.1, eps 1e-5 (flax 0.9).

``STDC``: the global context ``gc`` is a ConvBNAct over the 1×1 mean of
C5 (in train mode its BN normalises B values a channel: 0 at B = 1);
``p5 + gc``, ``p4``, ``p3`` are fused top-down by bilinear resizes, then
``fuse`` 3×3, a 1×1 ``head`` and a 1×1 ``detail_head``, both resized to
the input.  The loss is the OHEM cross-entropy plus ``detail_weight``
times the detail loss: BCE and dice (smoothing 1) against
``detail_target``, a boundary map of the labels (Laplacian 3×3 at strides
1, 2 and 4, clamped at 0, upsampled by half-pixel nearest, thresholded
at 0.1, fused 0.6/0.3/0.1 and thresholded again) computed in float32 with
autocast off, as JAX computes it on float32 labels (the
``detail_target`` range in step profiles).

JAX's ``STDC`` builds ``STDCNet(subtype=self.subtype)`` with its own
``subtype`` field (default "stdc1"), so the config's ``BACKBONE.subtype``
is never read: ``conf/cityscapes_stdc2.yml`` builds STDCNet-1 in JAX, and
in the port.

Images enter NHWC and run NCHW; under autocast the logits are scored in
float32.  ``logits(images)`` gives the (B, C, H, W) float32 logits that
``mode="infer"`` takes the argmax of.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..config import dictionary_to_names_weights
from ..registry import BACKBONES, MODELS
from .bricks import BatchNorm2d, ConvBNAct
from .heads.seg_heads import resize_bilinear
from .losses.seg_loss import cross_entropy_2d, ohem_cross_entropy_2d

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


def check_mode(mode: str) -> None:
    if mode not in ("train", "val", "infer"):
        raise ValueError(f"unknown mode {mode!r}")


def full_logits(logits, size, resize=resize_bilinear):
    """``logits`` taken to float32 and resized to ``size`` with autocast
    off (bilinear without align corners unless ``resize`` says)."""
    with torch.autocast(logits.device.type, enabled=False):
        return resize(logits.float(), size)


def _seg_out(logits, targets, mode: str, class_weights):
    """The shared tail of the self-contained segmenters: the argmax in
    infer mode, else the class-weighted cross-entropy ``ce_loss``."""
    if mode == "infer":
        return logits.argmax(1)
    with torch.autocast(logits.device.type, enabled=False):
        loss = cross_entropy_2d(logits.float(), targets, class_weights=class_weights)
    losses = {"ce_loss": loss, "loss": loss}
    if mode == "train":
        return loss, losses
    return losses, logits.argmax(1)


class SegModel(nn.Module):
    """Base of the self-contained segmenters: the dictionary's class count
    and weights (a non-persistent buffer), and ``forward`` as the JAX
    forward contract: NHWC images, ``logits`` NCHW at the input size."""

    def __init__(self, dictionary: Sequence[Any] = ()):
        super().__init__()
        names, weights = dictionary_to_names_weights(list(dictionary))
        self.num_classes = len(names)
        self.register_buffer("class_weights", torch.tensor(weights, dtype=torch.float32),
                             persistent=False)

    def logits(self, images):
        raise NotImplementedError

    def forward(self, images, targets=None, mode: str = "infer"):
        check_mode(mode)
        return _seg_out(self.logits(images), targets, mode, self.class_weights)


class STDCCatBottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 blocks: int = 4):
        super().__init__()
        ch = out_channels
        self.stride = stride
        self.blocks = blocks
        self.conv0 = ConvBNAct(in_channels, ch // 2, 1, **_BN)
        if stride == 2:
            self.avd_conv = nn.Conv2d(ch // 2, ch // 2, 3, 2, 1, groups=ch // 2, bias=False)
            self.avd_bn = BatchNorm2d(ch // 2, eps=1e-5, momentum=0.1)
        cin, div = ch // 2, 4
        for i in range(1, blocks):
            c = ch // div if i < blocks - 1 else ch // (div // 2)
            setattr(self, f"conv{i}", ConvBNAct(cin, c, 3, **_BN))
            cin, div = c, div * 2

    def forward(self, x):
        out1 = self.conv0(x)
        if self.stride == 2:
            h = self.avd_bn(self.avd_conv(out1))
            skip = F.avg_pool2d(out1, 3, 2, 1, count_include_pad=True)
        else:
            h = skip = out1
        outs = [skip]
        for i in range(1, self.blocks):
            h = getattr(self, f"conv{i}")(h)
            outs.append(h)
        return torch.cat(outs, 1)


@BACKBONES.register(name="STDCNet")
class STDCNet(nn.Module):
    """``stem1`` 3×3/s2 to 32, ``stem2`` 3×3/s2 to 64, then stages 3-5 of
    (2, 2, 2) ("stdc1") or (4, 5, 3) ("stdc2") blocks ``stage{si}_{j}`` of
    256, 512 and 1024 channels, the first of each stride 2; returns the
    ``out_stages`` features, or with ``classifier`` the ``fc`` logits of
    the last feature's mean."""

    def __init__(self, subtype: str = "stdc1", out_stages: Sequence[int] = (3, 4, 5),
                 classifier: bool = False, num_classes: int = 1000, pretrained: bool = False):
        super().__init__()
        layers = {"stdc1": (2, 2, 2), "stdc2": (4, 5, 3)}[subtype]
        self.out_stages = tuple(out_stages)
        self.classifier = classifier
        self.stem1 = ConvBNAct(3, 32, 3, 2, **_BN)
        self.stem2 = ConvBNAct(32, 64, 3, 2, **_BN)
        self.stages = []
        cin = 64
        for si, (n, ch) in enumerate(zip(layers, (256, 512, 1024)), start=3):
            for j in range(n):
                setattr(self, f"stage{si}_{j}",
                        STDCCatBottleneck(cin, ch, stride=2 if j == 0 else 1))
                cin = ch
            self.stages.append((si, n))
        self.out_channels = [ch for si, ch in zip((3, 4, 5), (256, 512, 1024))
                             if si in self.out_stages]
        if classifier:
            self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.stem2(self.stem1(x))
        feats = []
        for si, n in self.stages:
            for j in range(n):
                x = getattr(self, f"stage{si}_{j}")(x)
            if si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(x.mean((2, 3)))
        return tuple(feats)


_LAPLACIAN = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))


def resize_nearest(x, size):
    """NCHW nearest resize with half-pixel centres, as ``jax.image.resize(
    ..., "nearest")``: output i takes input ⌊(i + ½)·in / out⌋, computed
    in integers (torch's "nearest-exact" rounds the scale first)."""
    for axis, n in zip((-2, -1), size):
        m = x.shape[axis]
        if m != n:
            src = (2 * torch.arange(n, device=x.device) + 1) * m // (2 * n)
            x = x.index_select(axis % x.ndim, src)
    return x


def detail_target(labels, ignore_index: int = 255):
    """(B, H, W) labels → (B, H, W) float32 fused boundary map."""
    with record_function("detail_target"), torch.autocast(labels.device.type, enabled=False):
        m = torch.where(labels == ignore_index, 0, labels).float()[:, None]
        k = torch.tensor(_LAPLACIAN, device=labels.device).reshape(1, 1, 3, 3)
        H, W = labels.shape[1:]

        def boundary(stride):
            edge = torch.clamp(F.conv2d(m, k, stride=stride, padding=1), min=0.0)
            return (resize_nearest(edge, (H, W)) > 0.1).float()

        fused = 0.6 * boundary(1) + 0.3 * boundary(2) + 0.1 * boundary(4)
        return (fused > 0.1).float()[:, 0]


def detail_loss(detail_logits, labels, ignore_index: int = 255):
    """(BCE, dice) of the (B, H, W) ``detail_logits`` against
    ``detail_target``; float32."""
    t = detail_target(labels, ignore_index)
    x = detail_logits.float()
    bce = F.binary_cross_entropy_with_logits(x, t)
    p = torch.sigmoid(x).reshape(t.shape[0], -1)
    tf = t.reshape(t.shape[0], -1)
    inter = (p * tf).sum(1)
    dice = 1.0 - (2.0 * inter + 1.0) / (p.sum(1) + tf.sum(1) + 1.0)
    return bce, dice.mean()


@MODELS.register(name="STDC")
class STDC(SegModel):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None,
                 subtype: str = "stdc1", detail_weight: float = 1.0):
        super().__init__(dictionary)
        self.detail_weight = float(detail_weight)
        self.backbone = STDCNet(subtype=subtype)
        self.gc = ConvBNAct(1024, 128, 1, **_BN)
        self.p5 = ConvBNAct(1024, 128, 1, **_BN)
        self.p4 = ConvBNAct(512, 128, 1, **_BN)
        self.p3 = ConvBNAct(256, 128, 1, **_BN)
        self.fuse = ConvBNAct(128, 128, 3, **_BN)
        self.head = nn.Conv2d(128, self.num_classes, 1)
        self.detail_head = nn.Conv2d(128, 1, 1)

    def _features(self, images):
        c3, c4, c5 = self.backbone(images.permute(0, 3, 1, 2))
        p5 = self.p5(c5) + self.gc(c5.mean((2, 3), keepdim=True))
        p4 = self.p4(c4) + resize_bilinear(p5, c4.shape[-2:])
        p3 = self.p3(c3) + resize_bilinear(p4, c3.shape[-2:])
        return self.fuse(p3)

    def logits(self, images):
        return full_logits(self.head(self._features(images)), images.shape[1:3])

    def forward(self, images, targets=None, mode: str = "infer"):
        check_mode(mode)
        size = images.shape[1:3]
        x = self._features(images)
        logits = full_logits(self.head(x), size)
        if mode == "infer":
            return logits.argmax(1)
        detail_logits = full_logits(self.detail_head(x), size)
        with torch.autocast(images.device.type, enabled=False):
            seg = ohem_cross_entropy_2d(logits, targets, class_weights=self.class_weights)
            bce, dice = detail_loss(detail_logits[:, 0], targets)
            det = bce + dice
            total = seg + self.detail_weight * det
        losses = {"seg_loss": seg, "detail_bce": bce, "detail_dice": dice,
                  "detail_loss": det, "loss": total}
        if mode == "train":
            return total, losses
        return losses, logits.argmax(1)
