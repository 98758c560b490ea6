"""SegNet and ENet (counterpart of ``cvpytorch_tpu/models/segnet_enet.py``),
registered in ``MODELS`` under the JAX names, with real max unpooling on
``ops/pool.py`` (JAX's indices, tie-split pooling gradients and last-writer
unpooling, deterministic on the card).  NCHW inside, NHWC images in; BN
is torch momentum 0.1, eps 1e-5.

``_CBA``: ``conv`` (padding ((k − 1)//2)·dilation per axis), ``bn`` and
ReLU, PReLU ``act`` or nothing.  Its transposed form is flax's
``ConvTranspose`` with padding ((1, 2), (1, 2)), which is torch's
``ConvTranspose2d(3, 2, padding=1, output_padding=1)`` (the weight carry
flips the kernel); ENet's ``final_conv`` is the same.  Both are
``ConvTranspose2x``: the four output phases as forward convolutions,
interleaved, so ENet's forward is deterministic on the card, where
cuDNN's default transposed-convolution algorithm adds with atomics (its
served argmax moved a pixel between two calls on the same images).  ``PReLU`` has one parameter, ``weight`` (Flax
``scale``), initialised to 0.25.

SegNet: a VGG encoder of ``encoder{i}_{j}`` biased 3×3 ``_CBA``s, each
block ending in a 2×2/s2 pool with indices, and the mirrored decoder
``decoder{i}_{j}``, each block starting with the unpool of its encoder's
indices to that encoder's size; a biased 3×3 ``outconv``.  It trains on
``bce_2d`` of logit channel 0 against clip(label, 0, 1), as JAX does,
while its argmax takes all the classes.

ENet: an initial block (``init_conv`` 3×3/s2 beside a 3×3/s2/p1 max pool
of the image, ``init_bn``, ``init_act``), two down bottlenecks (their
pooled residual zero-padded to the block's channels; the pool indices
kept), regular bottlenecks (``c0`` always PReLU; 3×3 dilated, or 5×1 and
1×5 convs), two up bottlenecks (``up_conv`` of the input unpooled with the
matching down block's indices, where ENet's overlapping pools name some
positions twice) and ``final_conv``.  Dropout2d acts in train mode.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pool import max_pool_argmax, max_unpool
from ..registry import MODELS
from .bricks import BatchNorm2d
from .light_seg import SegModel, check_mode
from .losses.seg_loss import bce_2d


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class ConvTranspose2x(nn.ConvTranspose2d):
    """``ConvTranspose2d(cin, cout, 3, 2, padding=1, output_padding=1)``:
    output (2m + a, 2n + b) is a convolution of input rows m (a = 0:
    kernel row 1) or m, m + 1 (a = 1: kernel rows 2, 0), and the same for
    columns, over the input padded by one zero row and column."""

    _TAPS = ((1,), (2, 0))

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__(cin, cout, 3, 2, padding=1, output_padding=1, bias=bias)

    def forward(self, x):
        B, _, H, W = x.shape
        w = self.weight.transpose(0, 1)  # (cout, cin, ky, kx)
        xp = F.pad(x, (0, 1, 0, 1))
        rows = []
        for a, ky in enumerate(self._TAPS):
            cols = [F.conv2d(xp[..., :H + a, :W + b], w[:, :, ky][:, :, :, kx])
                    for b, kx in enumerate(self._TAPS)]
            rows.append(torch.stack(cols, -1))
        y = torch.stack(rows, 3).reshape(B, -1, 2 * H, 2 * W)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


class _CBA(nn.Module):
    def __init__(self, cin: int, out: int, kernel=3, stride: int = 1, dilation: int = 1,
                 act: str | None = "relu", use_bias: bool = False, transpose: bool = False):
        super().__init__()
        k = tuple(kernel) if isinstance(kernel, (tuple, list)) else (kernel, kernel)
        if transpose:
            self.conv = ConvTranspose2x(cin, out, bias=use_bias)
        else:
            pad = tuple((kk - 1) // 2 * dilation for kk in k)
            self.conv = nn.Conv2d(cin, out, k, stride, pad, dilation, bias=use_bias)
        self.bn = BatchNorm2d(out, eps=1e-5, momentum=0.1)
        self.act_kind = act
        if act == "prelu":
            self.act = PReLU()

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act_kind == "relu":
            return F.relu(x)
        if self.act_kind == "prelu":
            return self.act(x)
        return x


# ---------------------------------------------------------------- SegNet --
_SEGNET_ENCODER = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
_SEGNET_DECODER = ((512, 512, 512), (512, 512, 256), (256, 256, 128), (128, 64))  # 5 … 2


@MODELS.register(name="SegNet")
class SegNet(SegModel):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None):
        super().__init__(dictionary)
        cin = 3
        for i, chans in enumerate(_SEGNET_ENCODER, start=1):
            for j, ch in enumerate(chans):
                setattr(self, f"encoder{i}_{j}", _CBA(cin, ch, 3, use_bias=True))
                cin = ch
        for i, chans in enumerate(_SEGNET_DECODER):
            for j, ch in enumerate(chans):
                setattr(self, f"decoder{5 - i}_{j}", _CBA(cin, ch, 3, use_bias=True))
                cin = ch
        self.decoder1_0 = _CBA(cin, 64, 3, use_bias=True)
        self.outconv = nn.Conv2d(64, self.num_classes, 3, padding=1)

    def logits(self, images):
        x = images.permute(0, 3, 1, 2)
        ids, sizes = [], []
        for i, chans in enumerate(_SEGNET_ENCODER, start=1):
            for j in range(len(chans)):
                x = getattr(self, f"encoder{i}_{j}")(x)
            sizes.append(x.shape[-2:])
            x, idx = max_pool_argmax(x, 2, 2, 0)
            ids.append(idx)
        for i, chans in enumerate(_SEGNET_DECODER):
            x = max_unpool(x, ids[4 - i], sizes[4 - i])
            for j in range(len(chans)):
                x = getattr(self, f"decoder{5 - i}_{j}")(x)
        x = self.decoder1_0(max_unpool(x, ids[0], sizes[0]))
        return self.outconv(x).float()

    def forward(self, images, targets=None, mode: str = "infer"):
        check_mode(mode)
        logits = self.logits(images)
        if mode == "infer":
            return logits.argmax(1)
        with torch.autocast(images.device.type, enabled=False):
            loss = bce_2d(logits, targets)
        losses = {"bce_loss": loss, "loss": loss}
        if mode == "train":
            return loss, losses
        return losses, logits.argmax(1)


# ------------------------------------------------------------------ ENet --
class RegularBottleneck(nn.Module):
    def __init__(self, channels: int, dilation: int = 1, asymmetric: bool = False,
                 relu: bool = False, drop: float = 0.01):
        super().__init__()
        mid = channels // 4
        act = "relu" if relu else "prelu"
        self.relu = relu
        self.asymmetric = asymmetric
        self.c0 = _CBA(channels, mid, 1, act="prelu")
        if asymmetric:
            self.c1a = _CBA(mid, mid, (5, 1), act=act)
            self.c1b = _CBA(mid, mid, (1, 5), act=act)
        else:
            self.c1a = _CBA(mid, mid, 3, dilation=dilation, act=act)
        self.c2 = _CBA(mid, channels, 1, act=act)
        self.drop = nn.Dropout2d(drop)
        if not relu:
            self.act = PReLU()

    def forward(self, x):
        h = self.c1a(self.c0(x))
        if self.asymmetric:
            h = self.c1b(h)
        h = self.drop(self.c2(h)) + x
        return F.relu(h) if self.relu else self.act(h)


class DownBottleneck(nn.Module):
    """Returns (out, the pool's indices)."""

    def __init__(self, cin: int, channels: int, relu: bool = False, drop: float = 0.01):
        super().__init__()
        mid = cin // 4
        act = "relu" if relu else "prelu"
        self.relu = relu
        self.channels = channels
        self.c0 = _CBA(cin, mid, 2, stride=2, act=act)
        self.c1a = _CBA(mid, mid, 3, act=act)
        self.c2 = _CBA(mid, channels, 1, act=act)
        self.drop = nn.Dropout2d(drop)
        if not relu:
            self.act = PReLU()

    def forward(self, x):
        h = self.drop(self.c2(self.c1a(self.c0(x))))
        res, idx = max_pool_argmax(x, 3, 2, 1)
        h = h + F.pad(res, (0, 0, 0, 0, 0, self.channels - res.shape[1]))
        return (F.relu(h) if self.relu else self.act(h)), idx


class UpBottleneck(nn.Module):
    """Unpools ``up_conv(x)`` with the indices of the matching down block,
    recorded on a map of ``channels`` channels at twice this size."""

    def __init__(self, cin: int, channels: int, relu: bool = True, drop: float = 0.1):
        super().__init__()
        mid = cin // 4
        act = "relu" if relu else "prelu"
        self.relu = relu
        self.c0 = _CBA(cin, mid, 1, act=act)
        self.c1a = _CBA(mid, mid, 3, act=act, transpose=True)
        self.c2 = _CBA(mid, channels, 1, act=act)
        self.drop = nn.Dropout2d(drop)
        self.up_conv = _CBA(cin, channels, 1, act=None)
        if not relu:
            self.act = PReLU()

    def forward(self, x, indices):
        h = self.drop(self.c2(self.c1a(self.c0(x))))
        res = max_unpool(self.up_conv(x), indices, (x.shape[-2] * 2, x.shape[-1] * 2))
        h = h + res
        return F.relu(h) if self.relu else self.act(h)


# stage 2 and 3's regular bottlenecks: (dilation, asymmetric, drop)
_ENET_PLAN = ((1, False, 0.1), (2, False, 0.1), (1, True, 0.1), (4, False, 0.1),
              (1, False, 0.01), (8, False, 0.1), (1, True, 0.1), (16, False, 0.1))


@MODELS.register(name="ENet")
class ENet(SegModel):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None):
        super().__init__(dictionary)
        self.init_conv = nn.Conv2d(3, 13, 3, 2, 1, bias=False)
        self.init_bn = BatchNorm2d(16, eps=1e-5, momentum=0.1)
        self.init_act = PReLU()
        self.stage1_1 = DownBottleneck(16, 64, drop=0.01)
        for i in range(4):
            setattr(self, f"stage1_2_{i}", RegularBottleneck(64, drop=0.01))
        self.stage2_1 = DownBottleneck(64, 128, drop=0.1)
        for prefix in ("stage2_2", "stage3"):
            for i, (d, asym, p) in enumerate(_ENET_PLAN):
                setattr(self, f"{prefix}_{i}", RegularBottleneck(128, d, asym, drop=p))
        self.stage4_1 = UpBottleneck(128, 64, relu=True, drop=0.1)
        for i in range(2):
            setattr(self, f"stage4_2_{i}", RegularBottleneck(64, relu=True, drop=0.1))
        self.stage5_1 = UpBottleneck(64, 16, relu=True, drop=0.1)
        self.stage5_2 = RegularBottleneck(16, relu=True, drop=0.1)
        self.final_conv = ConvTranspose2x(16, self.num_classes)

    def logits(self, images):
        x = images.permute(0, 3, 1, 2)
        c = self.init_conv(x)
        x = torch.cat([c, max_pool_argmax(x, 3, 2, 1)[0].to(c.dtype)], 1)
        x = self.init_act(self.init_bn(x))
        x, id1 = self.stage1_1(x)
        for i in range(4):
            x = getattr(self, f"stage1_2_{i}")(x)
        x, id2 = self.stage2_1(x)
        for prefix in ("stage2_2", "stage3"):
            for i in range(len(_ENET_PLAN)):
                x = getattr(self, f"{prefix}_{i}")(x)
        x = self.stage4_1(x, id2)
        for i in range(2):
            x = getattr(self, f"stage4_2_{i}")(x)
        x = self.stage5_2(self.stage5_1(x, id1))
        return self.final_conv(x).float()
