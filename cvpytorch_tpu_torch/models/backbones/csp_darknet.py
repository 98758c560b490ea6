"""YOLOv5 CSPDarknet backbone (counterpart of
``cvpytorch_tpu/models/backbones/csp_darknet.py``), NCHW.

6×6/s2/p2 stem, four (3×3/2 conv → C3) stages with depth [3,6,9,3]·depth_mul
and width [64,128,256,512,1024]·width_mul, SPPF on the last stage, BN
momentum 0.03 / eps 1e-3, SiLU.  The JAX package runs the stem as
space-to-depth + 3×3 conv (a TPU matrix-unit workaround); it is the same
function, and ``utils/porting.py`` maps its kernel back to 6×6.

Repeated blocks are plain attributes ``m0``, ``m1``, … so parameter names
join to the JAX tree's paths.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct, make_divisible, make_round

SIZE_CFG = {  # subtype suffix → (depth_mul, width_mul)
    "n": (0.33, 0.25),
    "t": (0.33, 0.375),
    "s": (0.33, 0.5),
    "m": (0.67, 0.75),
    "l": (1.0, 1.0),
    "x": (1.33, 1.25),
}


class DarknetBottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 1.0,
                 act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, 1, act=act)
        self.conv2 = ConvBNAct(hidden, out_channels, 3, act=act)
        self.add = shortcut and in_channels == out_channels

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add else y


class CSPLayer(nn.Module):
    """C3: CSP bottleneck with 3 convs."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, 1, act=act)
        self.conv2 = ConvBNAct(in_channels, hidden, 1, act=act)
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}",
                    DarknetBottleneck(hidden, hidden, shortcut, 1.0, act))
        self.conv3 = ConvBNAct(2 * hidden, out_channels, 1, act=act)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x)
        for i in range(self.n):
            x1 = getattr(self, f"m{i}")(x1)
        return self.conv3(torch.cat([x1, x2], 1))


class SPPF(nn.Module):
    """Serial 5×5 max-pool pyramid; pooling pads with -inf."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, act: str = "silu"):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = ConvBNAct(in_channels, hidden, 1, act=act)
        self.conv2 = ConvBNAct(4 * hidden, out_channels, 1, act=act)
        self.kernel_size = kernel_size

    def forward(self, x):
        x = self.conv1(x)
        k = self.kernel_size
        y1 = F.max_pool2d(x, k, 1, k // 2)
        y2 = F.max_pool2d(y1, k, 1, k // 2)
        y3 = F.max_pool2d(y2, k, 1, k // 2)
        return self.conv2(torch.cat([x, y1, y2, y3], 1))


@BACKBONES.register(name="YOLOv5CSPDarknet", aliases=("cspdarknet",))
class YOLOv5CSPDarknet(nn.Module):
    def __init__(self, subtype: str = "cspdark_s",
                 out_channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 num_blocks: Sequence[int] = (3, 6, 9, 3),
                 out_stages: Sequence[int] = (2, 3, 4), spp_ksize: int = 5,
                 act: str = "silu", depth_mul: float | None = None,
                 width_mul: float | None = None, in_channels: int = 3):
        super().__init__()
        dm, wm = SIZE_CFG[subtype.split("_")[-1]]
        dm = depth_mul if depth_mul is not None else dm
        wm = width_mul if width_mul is not None else wm
        chs = [make_divisible(c * wm) for c in out_channels]
        blocks = [make_round(n, dm) for n in num_blocks]
        self.out_stages = tuple(out_stages)
        self.stem = ConvBNAct(in_channels, chs[0], 6, 2, padding=2, act=act)
        for i in range(4):  # stages 1..4, strides 4/8/16/32
            setattr(self, f"stage{i + 1}_down",
                    ConvBNAct(chs[i], chs[i + 1], 3, 2, act=act))
            setattr(self, f"stage{i + 1}_csp",
                    CSPLayer(chs[i + 1], chs[i + 1], n=blocks[i],
                             shortcut=(i != 3), act=act))
        self.sppf = SPPF(chs[4], chs[4], spp_ksize, act=act)
        self.channels = tuple(chs[s] for s in self.out_stages)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for i in range(4):
            x = getattr(self, f"stage{i + 1}_down")(x)
            x = getattr(self, f"stage{i + 1}_csp")(x)
            if i == 3:
                x = self.sppf(x)
            if (i + 1) in self.out_stages:
                feats.append(x)
        return tuple(feats)
