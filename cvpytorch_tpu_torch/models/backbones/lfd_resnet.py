"""LFD's ResNet-style backbone (counterpart of
``cvpytorch_tpu/models/backbones/lfd_resnet.py``), NCHW.

A stride-4 stem (3×3/2, 1×1, 3×3/2, 1×1, each conv with a bias, BN and
ReLU), then one stage a pyramid level (strides 8–128), each of light
residual blocks whose first block strides 2: ``FastBlock`` (3×3 → 1×1 →
3×3), ``FasterBlock`` (3×3 → 3×3), ``FastestBlock`` (half-width 3×3 →
3×3); a 3×3 ``down`` branch (no activation) where the stride or width
changes.  BN torch momentum 0.1, eps 1e-5 (flax 0.9).
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)

SUBTYPES = {  # block mode, per-stage block counts, per-stage channels (5 stages)
    "lfd_xs": ("faster", (4, 2, 2, 3, 2), (32, 64, 64, 64, 64)),
    "lfd_s": ("faster", (4, 2, 2, 3, 2), (64, 64, 64, 64, 128)),
    "lfd_m": ("faster", (3, 2, 1, 1, 1), (64, 64, 64, 64, 128)),
    "lfd_l": ("fast", (4, 2, 2, 1, 1), (64, 64, 64, 64, 128)),
}


class _Residual(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.down = (ConvBNAct(in_channels, out_channels, 3, stride, act=None, **_BN)
                     if stride > 1 or in_channels != out_channels else None)

    def forward(self, x):
        identity = x if self.down is None else self.down(x)
        return F.relu(self.body(x) + identity)


class FastBlock(_Residual):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__(in_channels, out_channels, stride)
        self.conv1 = ConvBNAct(in_channels, out_channels, 3, stride, act="relu", **_BN)
        self.conv2 = ConvBNAct(out_channels, out_channels, 1, act="relu", **_BN)
        self.conv3 = ConvBNAct(out_channels, out_channels, 3, act=None, **_BN)

    def body(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class FasterBlock(_Residual):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__(in_channels, out_channels, stride)
        self.conv1 = ConvBNAct(in_channels, out_channels, 3, stride, act="relu", **_BN)
        self.conv2 = ConvBNAct(out_channels, out_channels, 3, act=None, **_BN)

    def body(self, x):
        return self.conv2(self.conv1(x))


class FastestBlock(_Residual):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__(in_channels, out_channels, stride)
        self.conv1 = ConvBNAct(in_channels, out_channels // 2, 3, stride, act="relu", **_BN)
        self.conv2 = ConvBNAct(out_channels // 2, out_channels, 3, act=None, **_BN)

    def body(self, x):
        return self.conv2(self.conv1(x))


_BLOCKS = {"fast": FastBlock, "faster": FasterBlock, "fastest": FastestBlock}


@BACKBONES.register(name="LFDResNet")
class LFDResNet(nn.Module):
    def __init__(self, subtype: str = "lfd_s", out_stages: Sequence[int] = (0, 1, 2, 3, 4)):
        super().__init__()
        mode, block_num, channels = SUBTYPES[subtype]
        block = _BLOCKS[mode]
        self.out_stages = tuple(out_stages)
        c = channels[0]
        for i, (k, s) in enumerate(((3, 2), (1, 1), (3, 2), (1, 1))):
            setattr(self, f"stem{i + 1}", ConvBNAct(3 if i == 0 else c, c, k, s, use_bias=True,
                                                    act="relu", **_BN))
        self.stages = []
        for i, (n, ch) in enumerate(zip(block_num, channels)):
            names = [f"layer{i}_{j}" for j in range(n)]
            for j, name in enumerate(names):
                setattr(self, name, block(c if j == 0 else ch, ch, 2 if j == 0 else 1))
            self.stages.append(names)
            c = ch
        self.out_channels = [channels[i] for i in self.out_stages]

    def forward(self, x):
        for i in range(1, 5):
            x = getattr(self, f"stem{i}")(x)
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_stages:
                outs.append(x)
        return outs
