"""EfficientNet B0–B7 and Lite0 (counterpart of
``cvpytorch_tpu/models/backbones/efficientnet.py``), NCHW.

The ``stem`` (3×3/2, SiLU) and seven stages of ``stage{i}_block{j}``
MBConvs: ``expand`` 1×1 unless the expansion is 1, ``dw`` k×k depthwise
at the stage's stride on its first block, ``se`` squeeze-excitation of
width max(1, block input channels // 4) (not of the expanded width it
gates) with a sigmoid gate on SiLU, ``project`` 1×1 without activation,
and the input added where the stride is 1 and the width stays, after a
``drop`` stochastic depth of rate 0.2 · block index / number of blocks.
BN is torch momentum 0.1, eps 1e-5 (torchvision's; flax momentum 0.9),
not the 1e-3 of EfficientNet-Lite.  ``efficientnet_lite0`` drops the SE,
runs ReLU6 and keeps the first and last stages' depth.  ``classifier``
ends in ``head_conv``, global pooling, dropout and ``fc``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct, DropPath, SqueezeExcite, make_divisible

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)

# (expand, channels, repeats, stride, kernel)
_BASE = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
         (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)]
# width_mult, depth_mult, dropout
_SCALING = {
    "efficientnet_b0": (1.0, 1.0, 0.2),
    "efficientnet_b1": (1.0, 1.1, 0.2),
    "efficientnet_b2": (1.1, 1.2, 0.3),
    "efficientnet_b3": (1.2, 1.4, 0.3),
    "efficientnet_b4": (1.4, 1.8, 0.4),
    "efficientnet_b5": (1.6, 2.2, 0.4),
    "efficientnet_b6": (1.8, 2.6, 0.5),
    "efficientnet_b7": (2.0, 3.1, 0.5),
    "efficientnet_lite0": (1.0, 1.0, 0.2),
}


class MBConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, expand: int, kernel: int,
                 stride: int, se: bool = True, act: str = "silu", drop_rate: float = 0.0):
        super().__init__()
        hidden = in_channels * expand
        if expand != 1:
            self.expand = ConvBNAct(in_channels, hidden, 1, act=act, **_BN)
        self.dw = ConvBNAct(hidden, hidden, kernel, stride, groups=hidden, act=act, **_BN)
        if se:
            self.se = SqueezeExcite(hidden, gate="sigmoid", act="silu",
                                    squeeze_ch=max(1, in_channels // 4))
        self.project = ConvBNAct(hidden, out_channels, 1, act=None, **_BN)
        self.residual = stride == 1 and in_channels == out_channels
        if self.residual:
            self.drop = DropPath(drop_rate)

    def forward(self, x):
        h = self.expand(x) if hasattr(self, "expand") else x
        h = self.dw(h)
        if hasattr(self, "se"):
            h = self.se(h)
        h = self.project(h)
        return x + self.drop(h) if self.residual else h


@BACKBONES.register(name="EfficientNet", aliases=("efficientnet",))
class EfficientNet(nn.Module):
    """NCHW images → the tuple of the ``out_stages`` features (1-based
    stage indices; ``channels[s - 1]`` is stage s's width), or class
    logits with ``classifier``.  ``pretrained`` is accepted for the configs and
    unused."""

    def __init__(self, subtype: str = "efficientnet_b0", out_stages: Sequence[int] = (3, 5, 7),
                 classifier: bool = False, num_classes: int = 1000, pretrained: bool = False):
        super().__init__()
        wm, dm, dropout = _SCALING[subtype]
        lite = "lite" in subtype
        act = "relu6" if lite else "silu"
        self.out_stages, self.classifier = tuple(out_stages), classifier
        ch = make_divisible(32 * wm)
        self.stem = ConvBNAct(3, ch, 3, 2, act=act, **_BN)
        total = sum(math.ceil(r * dm) for _, _, r, _, _ in _BASE)
        self.blocks = []  # (stage, name) in order
        self.channels = []
        bi = 0
        for gi, (e, c, r, s, k) in enumerate(_BASE, start=1):
            out_ch = make_divisible(c * wm)
            reps = r if lite and gi in (1, 7) else math.ceil(r * dm)
            for j in range(reps):
                name = f"stage{gi}_block{j}"
                setattr(self, name, MBConv(ch, out_ch, e, k, s if j == 0 else 1, se=not lite,
                                           act=act, drop_rate=0.2 * bi / max(total, 1)))
                self.blocks.append((gi, name))
                ch = out_ch
                bi += 1
            self.channels.append(ch)
        if classifier:
            head_ch = 1280 if lite else make_divisible(1280 * wm)
            self.head_conv = ConvBNAct(ch, head_ch, 1, act=act, **_BN)
            self.dropout = nn.Dropout(dropout)
            self.fc = nn.Linear(head_ch, num_classes)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for i, (gi, name) in enumerate(self.blocks):
            x = getattr(self, name)(x)
            last = i + 1 == len(self.blocks) or self.blocks[i + 1][0] != gi
            if last and gi in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            x = torch.mean(self.head_conv(x), dim=(2, 3))
            return self.fc(self.dropout(x))
        return tuple(feats)
