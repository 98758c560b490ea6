"""Segmentation heads (counterpart of ``cvpytorch_tpu/models/heads/seg_heads.py``):
``FCNHead``, ``Deeplabv3Head``, ``Deeplabv3PlusHead``, ``PSPHead`` and
``UPerHead``, NCHW.

Each takes ``in_channels``, the channels of the backbone's feature tuple
(torch builds its layers eagerly; Flax infers them), and returns logits at
feature resolution.  Submodules carry the Flax names.  BN is torch
momentum 0.1, eps 1e-5 (the JAX heads' flax momentum 0.9).  Dropout acts
in ``train()`` mode only, as the JAX heads drop only with ``train=True``.

The PSP and UPer pyramid pools are not ``AdaptiveAvgPool2d``: a scale that
divides the map is an exact block mean, any other is ``jax.image.resize``'s
"linear" downsampling, which antialiases (a triangle filter widened by the
scale, weights renormalised at the edges): ``resize_linear``, two matmuls
with JAX's weights.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...registry import HEADS
from ..bricks import ConvBNAct, DepthwiseSeparableConv

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


def resize_bilinear(x, size):
    """NCHW bilinear resize with half-pixel centres, no antialiasing
    (``jax.image.resize(..., "bilinear", antialias=False)``)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


@functools.lru_cache(maxsize=64)
def _linear_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) float64 weights of ``jax.image.resize``'s "linear"
    kernel along one axis (``jax._src.image.scale.compute_weight_mat``): a
    triangle widened by the downscale factor, each column renormalised,
    columns whose sample lies off the input zeroed."""
    scale = n_out / n_in
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(1.0 / scale, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return torch.from_numpy(w)


def resize_linear(x, size):
    """NCHW ``jax.image.resize(..., "linear")``: bilinear with half-pixel
    centres, antialiased when it downsamples, as two matmuls with the JAX
    weights in float32 (float64 for a float64 ``x``: the weights are
    rounded to float32 only for a float32 product), returned in ``x``'s
    dtype.  ``F.interpolate(..., antialias=True)`` computes the same but
    takes no bfloat16 on the CPU, and on the card refuses a large
    downscale (64×128 → 1×1: too much shared memory)."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    wh = _linear_weights(x.shape[-2], size[0]).to(x.device, dtype)
    ww = _linear_weights(x.shape[-1], size[1]).to(x.device, dtype)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.einsum("nchw,hp,wq->ncpq", x.to(dtype), wh, ww)
    return y.to(x.dtype)


def pyramid_pool(x, s: int):
    """The JAX heads' adaptive pool to s×s (see the module docstring)."""
    h, w = x.shape[-2:]
    if h % s or w % s:
        return resize_linear(x, (s, s))
    return F.avg_pool2d(x, (h // s, w // s), (h // s, w // s))


@HEADS.register(name="FCNHead")
class FCNHead(nn.Module):
    """``num_convs`` 3×3 convs on ``feats[in_index]``, with ``is_concat``
    a ``conv_cat`` over [input, convs], then dropout and a 1×1 ``cls``."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 256, num_convs: int = 2, in_index: int = -1,
                 dropout: float = 0.1, is_concat: bool = True, dilation: int = 1):
        super().__init__()
        cin = in_channels[in_index]
        self.in_index = in_index
        self.num_convs = num_convs
        self.is_concat = is_concat
        for i in range(num_convs):
            setattr(self, f"conv{i}", ConvBNAct(cin if i == 0 else channels, channels, 3,
                                                dilation=dilation, **_BN))
        if is_concat:
            self.conv_cat = ConvBNAct(cin + channels, channels, 3, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        inp = feats[self.in_index] if isinstance(feats, (tuple, list)) else feats
        x = inp
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
        if self.is_concat:
            x = self.conv_cat(torch.cat([inp, x], 1))
        return self.cls(self.dropout(x))


class _ASPP(nn.Module):
    """Global-pool ``proj`` branch, then ``aspp{i}`` per dilation (1×1 for
    dilation 1, else 3×3 dilated, depthwise-separable with ``separable``),
    concatenated."""

    def __init__(self, cin: int, channels: int, dilations: Sequence[int], separable: bool):
        super().__init__()
        self.proj = ConvBNAct(cin, channels, 1, **_BN)
        self.n_branches = len(dilations)
        for i, d in enumerate(dilations):
            if d == 1:
                branch = ConvBNAct(cin, channels, 1, **_BN)
            elif separable:
                branch = DepthwiseSeparableConv(cin, channels, 3, dilation=d, **_BN)
            else:
                branch = ConvBNAct(cin, channels, 3, dilation=d, **_BN)
            setattr(self, f"aspp{i}", branch)

    def branches(self, x):
        gp = self.proj(torch.mean(x, dim=(2, 3), keepdim=True))
        outs = [gp.expand(-1, -1, *x.shape[-2:])]
        outs += [getattr(self, f"aspp{i}")(x) for i in range(self.n_branches)]
        return torch.cat(outs, 1)


@HEADS.register(name="Deeplabv3Head")
class Deeplabv3Head(_ASPP):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 256, dilations: Sequence[int] = (1, 12, 24, 36),
                 dropout: float = 0.1, separable: bool = False):
        super().__init__(in_channels[-1], channels, dilations, separable)
        self.reduce = ConvBNAct(channels * (1 + len(dilations)), channels, 3, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        x = self.reduce(self.branches(feats[-1]))
        return self.cls(self.dropout(x))


@HEADS.register(name="Deeplabv3PlusHead")
class Deeplabv3PlusHead(_ASPP):
    """Separable ASPP on the last feature, fused with the first (low-level)
    feature: ``low_proj``, then two separable 3×3 ``fuse`` convs."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 256, low_channels: int = 48,
                 dilations: Sequence[int] = (1, 12, 24, 36), dropout: float = 0.1):
        super().__init__(in_channels[-1], channels, dilations, True)
        self.reduce = ConvBNAct(channels * (1 + len(dilations)), channels, 3, **_BN)
        self.low_proj = ConvBNAct(in_channels[0], low_channels, 1, **_BN)
        self.fuse0 = DepthwiseSeparableConv(channels + low_channels, channels, 3, **_BN)
        self.fuse1 = DepthwiseSeparableConv(channels, channels, 3, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        low, high = feats[0], feats[-1]
        x = self.reduce(self.branches(high))
        low = self.low_proj(low)
        x = torch.cat([resize_bilinear(x, low.shape[-2:]), low], 1)
        x = self.fuse1(self.fuse0(x))
        return self.cls(self.dropout(x))


@HEADS.register(name="PSPHead")
class PSPHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 512, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1):
        super().__init__()
        cin = in_channels[-1]
        self.pool_scales = tuple(pool_scales)
        for i in range(len(self.pool_scales)):
            setattr(self, f"pool{i}", ConvBNAct(cin, channels, 1, **_BN))
        self.bottleneck = ConvBNAct(cin + channels * len(self.pool_scales), channels, 3, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        x = feats[-1]
        size = x.shape[-2:]
        branches = [x] + [resize_bilinear(getattr(self, f"pool{i}")(pyramid_pool(x, s)), size)
                          for i, s in enumerate(self.pool_scales)]
        y = self.bottleneck(torch.cat(branches, 1))
        return self.cls(self.dropout(y))


@HEADS.register(name="UPerHead")
class UPerHead(nn.Module):
    """Pyramid pooling on the last feature, a top-down FPN over the others,
    every level brought to the first's size and fused."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 256, pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1):
        super().__init__()
        c5 = in_channels[-1]
        self.pool_scales = tuple(pool_scales)
        self.n_laterals = len(in_channels) - 1
        for i in range(len(self.pool_scales)):
            setattr(self, f"ppm{i}", ConvBNAct(c5, channels, 1, **_BN))
        self.ppm_bottleneck = ConvBNAct(c5 + channels * len(self.pool_scales), channels, 3,
                                        **_BN)
        for i, c in enumerate(in_channels[:-1]):
            setattr(self, f"lateral{i}", ConvBNAct(c, channels, 1, **_BN))
            setattr(self, f"fpn_conv{i}", ConvBNAct(channels, channels, 3, **_BN))
        self.fuse = ConvBNAct(channels * len(in_channels), channels, 3, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        c5 = feats[-1]
        size = c5.shape[-2:]
        ppm = [c5] + [resize_bilinear(getattr(self, f"ppm{i}")(pyramid_pool(c5, s)), size)
                      for i, s in enumerate(self.pool_scales)]
        top = self.ppm_bottleneck(torch.cat(ppm, 1))
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats[:self.n_laterals])] + [top]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [getattr(self, f"fpn_conv{i}")(l)
                for i, l in enumerate(laterals[:-1])] + [laterals[-1]]
        size = outs[0].shape[-2:]
        y = self.fuse(torch.cat([resize_bilinear(o, size) for o in outs], 1))
        return self.cls(self.dropout(y))
