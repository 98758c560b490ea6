"""RegNet X/Y (counterpart of ``cvpytorch_tpu/models/backbones/regnet.py``),
NCHW: Radosavovic et al., arXiv:2003.13678.

The stage widths, depths and group widths are torchvision's.  A block is
1×1 ``a`` → grouped 3×3 ``b`` (stride on the first block of a stage) →
(Y only) SE ``se`` squeezing to a quarter of the block's input width →
1×1 ``c``, plus the identity or the 1×1 ``proj``, then ReLU.  BN is
torch momentum 0.1, eps 1e-5.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)

# subtype: (depths, widths, group_width, se)
_SPECS = {
    "regnet_x_400mf": ((1, 2, 7, 12), (32, 64, 160, 400), 16, False),
    "regnet_x_800mf": ((1, 3, 7, 5), (64, 128, 288, 672), 16, False),
    "regnet_x_1_6gf": ((2, 4, 10, 2), (72, 168, 408, 912), 24, False),
    "regnet_x_3_2gf": ((2, 6, 15, 2), (96, 192, 432, 1008), 48, False),
    "regnet_x_8gf": ((2, 5, 15, 1), (80, 240, 720, 1920), 120, False),
    "regnet_x_16gf": ((2, 6, 13, 1), (256, 512, 896, 2048), 128, False),
    "regnet_x_32gf": ((2, 7, 13, 1), (336, 672, 1344, 2520), 168, False),
    "regnet_y_400mf": ((1, 3, 6, 6), (48, 104, 208, 440), 8, True),
    "regnet_y_800mf": ((1, 3, 8, 2), (64, 144, 320, 784), 16, True),
    "regnet_y_1_6gf": ((2, 6, 17, 2), (48, 120, 336, 888), 24, True),
    "regnet_y_3_2gf": ((2, 5, 13, 1), (72, 216, 576, 1512), 24, True),
    "regnet_y_8gf": ((2, 4, 10, 1), (224, 448, 896, 2016), 56, True),
    "regnet_y_16gf": ((2, 4, 11, 1), (224, 448, 1232, 3024), 112, True),
    "regnet_y_32gf": ((2, 5, 12, 1), (232, 696, 1392, 3712), 232, True),
}


class _SE(nn.Module):
    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2d(squeeze_channels, channels, 1)

    def forward(self, x):
        s = torch.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class _YBlock(nn.Module):
    def __init__(self, in_channels: int, width: int, stride: int, group_width: int,
                 se_in: int | None):
        super().__init__()
        groups = max(width // group_width, 1)
        self.a = ConvBNAct(in_channels, width, 1, act="relu", **_BN)
        self.b = ConvBNAct(width, width, 3, stride, groups=groups, act="relu", **_BN)
        self.se = _SE(width, se_in) if se_in is not None else None
        self.c = ConvBNAct(width, width, 1, act=None, **_BN)
        self.proj = (ConvBNAct(in_channels, width, 1, stride, act=None, **_BN)
                     if stride != 1 or in_channels != width else None)

    def forward(self, x):
        y = self.b(self.a(x))
        if self.se is not None:
            y = self.se(y)
        y = self.c(y)
        return torch.relu(y + (self.proj(x) if self.proj is not None else x))


@BACKBONES.register(name="RegNet", aliases=("regnet",))
class RegNet(nn.Module):
    def __init__(self, subtype: str = "regnet_y_400mf", out_stages: Sequence[int] = (2, 3, 4),
                 classifier: bool = False, num_classes: int = 1000, output_stride: int = 32,
                 pretrained: bool = False, in_channels: int = 3):
        super().__init__()
        depths, widths, gw, se = _SPECS[subtype]
        self.out_stages, self.classifier = tuple(out_stages), classifier
        self.depths, self.channels = depths, widths
        self.stem = ConvBNAct(in_channels, 32, 3, 2, act="relu", **_BN)
        cin = 32
        for si, (d, w) in enumerate(zip(depths, widths), start=1):
            for bi in range(d):
                # torchvision's Y: the SE squeezes to the block's input width // 4
                se_ch = max(cin // 4, 1) if se else None
                setattr(self, f"stage{si}_block{bi}",
                        _YBlock(cin, w, 2 if bi == 0 else 1, gw, se_ch))
                cin = w
        if classifier:
            self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for si, d in enumerate(self.depths, start=1):
            for bi in range(d):
                x = getattr(self, f"stage{si}_block{bi}")(x)
            if si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(x.mean((2, 3)))
        return tuple(feats)
