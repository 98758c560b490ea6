"""GhostPAN neck (counterpart of ``cvpytorch_tpu/models/necks/ghost_pan.py``),
NanoDet-Plus's PAN with GhostNet blocks, NCHW.

1×1 ``reduce{i}`` of each level → top-down (×2 bilinear align-corners
upsample, concat, ``td{i}_b{b}`` GhostBottlenecks) → bottom-up (stride-2
depthwise-separable ``down{i}``, concat, ``bu{i}_b{b}``) → each extra
level is ``extra_in{e}`` of the last lateral plus ``extra_out{e}`` of the
last output, both stride-2 depthwise-separable convolutions (a ceil
division of the map: 13 → 7).  BN is torch momentum 0.1, eps 1e-5.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import NECKS
from ..bricks import ConvBNAct, DepthwiseSeparableConv, upsample2x_bilinear_align

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


class GhostModule(nn.Module):
    """``primary`` convolution to ⌈out/ratio⌉ channels, then the ``cheap``
    depthwise (grouped by those channels) convolution of it; the two
    concatenated and cut to ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 ratio: int = 2, dw_size: int = 3, act: str | None = "leaky_relu"):
        super().__init__()
        self.out_channels = out_channels
        init_ch = -(-out_channels // ratio)
        self.primary = ConvBNAct(in_channels, init_ch, kernel_size, act=act, **_BN)
        self.cheap = ConvBNAct(init_ch, init_ch * (ratio - 1), dw_size, groups=init_ch,
                               act=act, **_BN)

    def forward(self, x):
        y = self.primary(x)
        return torch.cat([y, self.cheap(y)], 1)[:, :self.out_channels]


class GhostBottleneck(nn.Module):
    """Ghost expand, an optional stride-``stride`` depthwise convolution,
    ghost project, always summed with the shortcut: the identity where the
    shapes allow, else ``sc_dw`` + ``sc_pw``."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None,
                 kernel_size: int = 5, stride: int = 1, act: str = "leaky_relu"):
        super().__init__()
        mid = mid_channels or out_channels
        self.ghost1 = GhostModule(in_channels, mid, act=act)
        self.dw = (ConvBNAct(mid, mid, kernel_size, stride, groups=mid, act=None, **_BN)
                   if stride > 1 else None)
        self.ghost2 = GhostModule(mid, out_channels, act=None)
        self.identity = in_channels == out_channels and stride == 1
        if not self.identity:
            self.sc_dw = ConvBNAct(in_channels, in_channels, kernel_size, stride,
                                   groups=in_channels, act=None, **_BN)
            self.sc_pw = ConvBNAct(in_channels, out_channels, 1, act=None, **_BN)

    def forward(self, x):
        y = self.ghost1(x)
        if self.dw is not None:
            y = self.dw(y)
        y = self.ghost2(y)
        return y + (x if self.identity else self.sc_pw(self.sc_dw(x)))


@NECKS.register(name="GhostPAN")
class GhostPAN(nn.Module):
    """A tuple of NCHW feature maps → a tuple of ``len(in_channels) +
    num_extra_levels`` maps of ``out_channels``.  ``use_depthwise`` is
    accepted for the configs (the JAX neck is always depthwise)."""

    def __init__(self, in_channels: Sequence[int] = (116, 232, 464), out_channels: int = 96,
                 kernel_size: int = 5, num_blocks: int = 1, num_extra_levels: int = 1,
                 use_depthwise: bool = True, act: str = "leaky_relu"):
        super().__init__()
        n, c, ks = len(in_channels), out_channels, kernel_size
        self.n, self.num_blocks, self.num_extra_levels = n, num_blocks, num_extra_levels
        for i, cin in enumerate(in_channels):
            setattr(self, f"reduce{i}", ConvBNAct(cin, c, 1, act=act, **_BN))

        def blocks(prefix):
            for b in range(num_blocks):
                setattr(self, f"{prefix}_b{b}", GhostBottleneck(
                    2 * c if b == 0 else c, c, kernel_size=ks, act=act))

        def dwsep(name):
            setattr(self, name, DepthwiseSeparableConv(c, c, ks, 2, act=act, **_BN))

        for i in range(n - 1, 0, -1):
            blocks(f"td{i}")
        for i in range(n - 1):
            dwsep(f"down{i}")
            blocks(f"bu{i}")
        for e in range(num_extra_levels):
            dwsep(f"extra_in{e}")
            dwsep(f"extra_out{e}")

    def _blocks(self, prefix, x):
        for b in range(self.num_blocks):
            x = getattr(self, f"{prefix}_b{b}")(x)
        return x

    def forward(self, feats):
        laterals = [getattr(self, f"reduce{i}")(f) for i, f in enumerate(feats)]
        inner = list(laterals)
        for i in range(self.n - 1, 0, -1):
            up = upsample2x_bilinear_align(inner[i])
            inner[i - 1] = self._blocks(f"td{i}", torch.cat([up, inner[i - 1]], 1))
        outs = [inner[0]]
        for i in range(self.n - 1):
            down = getattr(self, f"down{i}")(outs[-1])
            outs.append(self._blocks(f"bu{i}", torch.cat([down, inner[i + 1]], 1)))
        for e in range(self.num_extra_levels):
            outs.append(getattr(self, f"extra_in{e}")(laterals[-1])
                        + getattr(self, f"extra_out{e}")(outs[-1]))
        return tuple(outs)
