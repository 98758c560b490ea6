"""ASFF, adaptively spatial feature fusion (counterpart of
``cvpytorch_tpu/models/necks/asff.py``), NCHW; PAI-YOLOX's pass over the
PAN outputs.

For each target level i, ``asff{i}`` compresses every level to
``channels`` (1×1 ``compress{j}``), resizes it to level i's map, weighs
each by an 8-channel 1×1 ``w{j}``, takes a softmax over the levels of the
``attn`` 1×1 conv on the concatenated weights, sums the levels under it
and ends in the 3×3 ``expand``.  SiLU, BN torch momentum 0.03, eps 1e-3.

The resize is ``jax.image.resize(..., "nearest")``, with half-pixel
centres, both up (p5 → p3, ×4) and down (p3 → p5, ×1/4): the port's
integer-index ``light_seg.resize_nearest``, not ``F.interpolate``'s
"nearest" (which floors the scaled index).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import NECKS
from ..bricks import ConvBNAct
from ..light_seg import resize_nearest

_BN = dict(act="silu", bn_momentum=0.03, bn_eps=1e-3)


class ASFFBlock(nn.Module):
    """Fuses all levels into one target level with learned spatial
    weights."""

    def __init__(self, in_channels: Sequence[int], channels: int):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"compress{i}", ConvBNAct(c, channels, 1, **_BN))
            setattr(self, f"w{i}", ConvBNAct(channels, 8, 1, **_BN))
        self.attn = nn.Conv2d(8 * self.n, self.n, 1)
        self.expand = ConvBNAct(channels, channels, 3, **_BN)

    def forward(self, feats, target_idx: int):
        size = feats[target_idx].shape[-2:]
        resized = [resize_nearest(getattr(self, f"compress{i}")(f), size)
                   for i, f in enumerate(feats)]
        ws = [getattr(self, f"w{i}")(r) for i, r in enumerate(resized)]
        attn = torch.softmax(self.attn(torch.cat(ws, 1)), 1)
        fused = sum(r * attn[:, i:i + 1] for i, r in enumerate(resized))
        return self.expand(fused)


@NECKS.register(name="ASFF")
class ASFF(nn.Module):
    """``in_channels``: the widths of the levels; every output has
    ``channels``."""

    def __init__(self, in_channels: Sequence[int], channels: int = 128):
        super().__init__()
        self.n = len(in_channels)
        for i in range(self.n):
            setattr(self, f"asff{i}", ASFFBlock(in_channels, channels))
        self.out_channels = [channels] * self.n

    def forward(self, feats):
        return tuple(getattr(self, f"asff{i}")(feats, i) for i in range(self.n))
