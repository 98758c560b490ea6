"""GiraffeNeck (counterpart of ``cvpytorch_tpu/models/necks/giraffe_neck.py``),
NCHW: the GFPN with log2-n skips and queen-move cross-scale links, its
nine nodes unrolled:

    inputs:  0 = P3 (/8), 1 = P4 (/16), 2 = P5 (/32)
    node 3 (/32) ← [2, 1]          node 6 (/8)  ← [5, 4]
    node 4 (/16) ← [1, 3, 2, 0]    node 7 (/16) ← [4, 6, 3, 5]
    node 5 (/8)  ← [0, 4, 1]       node 8 (/32) ← [3, 7, 4]
    out 9 (/8) ← [6]   out 10 (/16) ← [7]   out 11 (/32) ← [8]

Each node concatenates its resampled inputs in that order and merges them
with a ``GiraffeCSP`` (C3, n = 2).  Resampling: a 3×3 max-pool of stride
r with padding 1, which pads with −inf, down; nearest repetition up.  BN
torch momentum 0.03, eps 1e-3 (flax 0.97), SiLU.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..bricks import ConvBNAct

# node: (inputs, resample ratios, level of its output channels)
_GRAPH = {"node3": ((2, 1), (1, 2), 2), "node4": ((1, 3, 2, 0), (1, 0.5, 0.5, 2), 1),
          "node5": ((0, 4, 1), (1, 0.5, 0.5), 0), "node6": ((5, 4), (1, 0.5), 0),
          "node7": ((4, 6, 3, 5), (1, 2, 0.5, 2), 1), "node8": ((3, 7, 4), (1, 2, 2), 2)}


def resample(x, ratio):
    """ratio > 1: k3 max-pool of stride ``ratio`` (−inf padding 1);
    ratio < 1: nearest ×(1 / ratio)."""
    if ratio > 1:
        return F.max_pool2d(x, 3, int(ratio), 1)
    if ratio < 1:
        f = int(round(1 / ratio))
        return x.repeat_interleave(f, 2).repeat_interleave(f, 3)
    return x


class GiraffeBottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 expansion: float = 1.0):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, 1, act="silu")
        self.conv2 = ConvBNAct(hidden, out_channels, 3, act="silu")
        self.add = shortcut and in_channels == out_channels

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add else y


class GiraffeCSP(nn.Module):
    """C3 merge: ``conv1`` → ``m{i}`` bottlenecks, ``conv2``, concat, ``conv3``."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 2):
        super().__init__()
        hidden = out_channels // 2
        self.n = n
        self.conv1 = ConvBNAct(in_channels, hidden, 1, act="silu")
        self.conv2 = ConvBNAct(in_channels, hidden, 1, act="silu")
        for i in range(n):
            setattr(self, f"m{i}", GiraffeBottleneck(hidden, hidden))
        self.conv3 = ConvBNAct(2 * hidden, out_channels, 1, act="silu")

    def forward(self, x):
        x1, x2 = self.conv1(x), self.conv2(x)
        for i in range(self.n):
            x1 = getattr(self, f"m{i}")(x1)
        return self.conv3(torch.cat([x1, x2], 1))


@NECKS.register(name="GiraffeNeck")
class GiraffeNeck(nn.Module):
    """``in_channels`` are the backbone's P3–P5 widths; → the three outputs
    (/8, /16, /32) of ``out_channels``."""

    def __init__(self, in_channels: Sequence[int], fpn_channels: Sequence[int] = (96, 160, 384),
                 out_channels: Sequence[int] = (96, 160, 384)):
        super().__init__()
        chs = list(in_channels)
        for name, (inputs, _, level) in _GRAPH.items():
            setattr(self, name, GiraffeCSP(sum(chs[i] for i in inputs), fpn_channels[level]))
            chs.append(fpn_channels[level])
        for i, name in enumerate(("out9", "out10", "out11")):
            setattr(self, name, GiraffeCSP(fpn_channels[i], out_channels[i]))
        self.out_channels = tuple(out_channels)

    def forward(self, feats):
        nodes = list(feats)
        for name, (inputs, ratios, _) in _GRAPH.items():
            cat = torch.cat([resample(nodes[i], r) for i, r in zip(inputs, ratios)], 1)
            nodes.append(getattr(self, name)(cat))
        return [self.out9(nodes[6]), self.out10(nodes[7]), self.out11(nodes[8])]
