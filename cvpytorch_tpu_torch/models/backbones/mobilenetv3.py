"""MobileNetV3 small/large (counterpart of
``cvpytorch_tpu/models/backbones/mobilenetv3.py``), NCHW: Howard et al.,
arXiv:1905.02244.

The blocks ``block{i}`` (``expand``, depthwise ``dw``, SE ``se``,
``project``) are grouped into stages 1–5 (small) or 1–6 (large) at the
JAX module's boundaries, and ``out_stages`` picks among them.  BN is torch
momentum 0.1, eps 1e-5; SE squeezes to make_divisible(expand / 4) with a
hard-sigmoid gate.  The classifier is ``head_conv``, global mean, ``fc1``,
hard-swish, dropout, ``fc2``.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct, SqueezeExcite, make_divisible

# (kernel, expand_ch, out_ch, se, act, stride)
_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]
_SMALL_STAGES = ((0,), (1, 2), (3, 4, 5), (6, 7), (8, 9, 10))
_LARGE_STAGES = ((0,), (1, 2), (3, 4, 5), (6, 7, 8, 9), (10, 11), (12, 13, 14))

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


class Bneck(nn.Module):
    def __init__(self, in_ch: int, kernel: int, expand_ch: int, out_ch: int,
                 use_se: bool, act: str, stride: int):
        super().__init__()
        self.expand = (ConvBNAct(in_ch, expand_ch, 1, act=act, **_BN)
                       if expand_ch != in_ch else None)
        self.dw = ConvBNAct(expand_ch, expand_ch, kernel, stride, groups=expand_ch,
                            act=act, **_BN)
        self.se = (SqueezeExcite(expand_ch, gate="hsigmoid",
                                 squeeze_ch=make_divisible(expand_ch // 4))
                   if use_se else None)
        self.project = ConvBNAct(expand_ch, out_ch, 1, act=None, **_BN)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x):
        h = self.expand(x) if self.expand is not None else x
        h = self.dw(h)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)
        return x + h if self.use_res else h


@BACKBONES.register(name="MobileNetV3", aliases=("mobilenet_v3",))
class MobileNetV3(nn.Module):
    def __init__(self, subtype: str = "mobilenet_v3_large", out_stages: Sequence[int] = (3, 4, 5),
                 classifier: bool = False, num_classes: int = 1000, dropout: float = 0.2,
                 pretrained: bool = False, in_channels: int = 3):
        super().__init__()
        small = "small" in subtype
        cfgs = _SMALL if small else _LARGE
        self.stages = _SMALL_STAGES if small else _LARGE_STAGES
        self.out_stages, self.classifier = tuple(out_stages), classifier
        self.stem = ConvBNAct(in_channels, 16, 3, 2, act="hardswish", **_BN)
        cin, self.channels = 16, []
        for blocks in self.stages:
            for i in blocks:
                k, e, c, se, act, s = cfgs[i]
                setattr(self, f"block{i}", Bneck(cin, k, e, c, se, act, s))
                cin = c
            self.channels.append(cin)
        if classifier:
            last_ch = 576 if small else 960
            hidden = 1024 if small else 1280
            self.head_conv = ConvBNAct(cin, last_ch, 1, act="hardswish", **_BN)
            self.fc1 = nn.Linear(last_ch, hidden)
            self.dropout = nn.Dropout(dropout)
            self.fc2 = nn.Linear(hidden, num_classes)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for si, blocks in enumerate(self.stages, start=1):
            for i in blocks:
                x = getattr(self, f"block{i}")(x)
            if si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            x = F.hardswish(self.fc1(self.head_conv(x).mean((2, 3))))
            return self.fc2(self.dropout(x))
        return tuple(feats)
