"""YOLOv5 PANet neck (counterpart of
``cvpytorch_tpu/models/necks/yolov5_neck.py``), NCHW.

Top-down: C5 →(1×1, up×2, concat C4, C3-block)→ P4' →(…, concat C3)→ P3;
bottom-up: P3 →(3×3/2, concat)→ P4 →(…)→ P5.  Channels round with
``max(round(c·wm), 1)``, unlike the backbone's ``make_divisible``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import NECKS
from ..backbones.csp_darknet import CSPLayer, SIZE_CFG
from ..bricks import ConvBNAct, make_round


def upsample2x(x):
    """Nearest-neighbour ×2."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class UpsampleFuse(nn.Module):
    """1×1 reduce → nearest ×2 → concat skip → C3.  Returns (fused, reduced)."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, n_blocks: int = 3):
        super().__init__()
        self.reduce = ConvBNAct(in_channels, out_channels, 1, act="silu")
        self.csp = CSPLayer(out_channels + skip_channels, out_channels,
                            n=n_blocks, shortcut=False)

    def forward(self, x, skip):
        t = self.reduce(x)
        return self.csp(torch.cat([upsample2x(t), skip], 1)), t


class DownsampleFuse(nn.Module):
    """3×3/2 down → concat skip → C3."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, n_blocks: int = 3):
        super().__init__()
        self.down = ConvBNAct(in_channels, in_channels, 3, 2, act="silu")
        self.csp = CSPLayer(in_channels + skip_channels, out_channels,
                            n=n_blocks, shortcut=False)

    def forward(self, x, skip):
        return self.csp(torch.cat([self.down(x), skip], 1))


@NECKS.register(name="YOLOv5Neck")
class YOLOv5Neck(nn.Module):
    """``feat_channels`` are the backbone's (C3, C4, C5) widths."""

    def __init__(self, feat_channels: Sequence[int],
                 subtype: str = "yolov5_s",
                 in_channels: Sequence[int] = (256, 512, 1024),
                 num_blocks: Sequence[int] = (3, 3, 3, 3),
                 depth_mul: float | None = None,
                 width_mul: float | None = None):
        super().__init__()
        dm, wm = SIZE_CFG[subtype.split("_")[-1]]
        dm = depth_mul if depth_mul is not None else dm
        wm = width_mul if width_mul is not None else wm
        chs = [max(round(c * wm), 1) for c in in_channels]
        blocks = [make_round(n, dm) for n in num_blocks]
        c3, c4, c5 = feat_channels
        self.up1 = UpsampleFuse(c5, c4, chs[1], blocks[0])
        self.up2 = UpsampleFuse(chs[1], c3, chs[0], blocks[1])
        self.down1 = DownsampleFuse(chs[0], chs[0], chs[1], blocks[2])
        self.down2 = DownsampleFuse(chs[1], chs[1], chs[2], blocks[3])
        self.channels = tuple(chs)

    def forward(self, feats):
        c3, c4, c5 = feats
        p4_up, t5 = self.up1(c5, c4)
        p3, t4 = self.up2(p4_up, c3)
        p4 = self.down1(p3, t4)
        p5 = self.down2(p4, t5)
        return (p3, p4, p5)
