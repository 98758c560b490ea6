"""CustomCspNet (counterpart of
``cvpytorch_tpu/models/backbones/custom_cspnet.py``), NCHW: NanoDet-g's
backbone, after CSPNet (arXiv:1911.11929).

``stage0`` 3×3/2 conv (32), a 3×3/2 max-pool (−inf padding), then CSP
blocks ``stage2`` (32, one residual), ``stage3`` (64, two, stride 2),
``stage4`` (128, two, stride 2), ``stage5`` (256, three, stride 2).  A CSP
block's ``in_conv`` (3×3, its stride), ``res{i}`` tiny residuals (half
the channels through ``in_conv`` and ``mid_conv``, the two concatenated),
``res_out`` (3×3), concatenated with the ``in_conv`` output: twice its
width.  Leaky ReLU (0.1) everywhere; BN torch momentum 0.1, eps 1e-5.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct

_BN = dict(bn_momentum=0.1, bn_eps=1e-5, act="leaky_relu")

# kind, (width, residuals), stride
_PLAN = (("conv", 32, 2), ("pool", None, 2), ("csp", (32, 1), 1), ("csp", (64, 2), 2),
         ("csp", (128, 2), 2), ("csp", (256, 3), 2))


class TinyRes(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        half = channels // 2
        self.in_conv = ConvBNAct(channels, half, 3, **_BN)
        self.mid_conv = ConvBNAct(half, half, 3, **_BN)

    def forward(self, x):
        y = self.in_conv(x)
        return torch.cat([self.mid_conv(y), y], 1)


class CspBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_res: int, stride: int = 1):
        super().__init__()
        self.num_res = num_res
        self.in_conv = ConvBNAct(in_channels, channels, 3, stride, **_BN)
        for i in range(num_res):
            setattr(self, f"res{i}", TinyRes(channels))
        self.res_out = ConvBNAct(channels, channels, 3, **_BN)

    def forward(self, x):
        x = self.in_conv(x)
        y = x
        for i in range(self.num_res):
            y = getattr(self, f"res{i}")(y)
        return torch.cat([self.res_out(y), x], 1)


@BACKBONES.register(name="CustomCspNet", aliases=("custom_cspnet",))
class CustomCspNet(nn.Module):
    """NCHW images → the tuple of the ``out_stages`` features (indices into
    the plan; ``out_channels`` their widths)."""

    def __init__(self, subtype: str = "cspnet", out_stages: Sequence[int] = (3, 4, 5),
                 output_stride: int = 32, pretrained: bool = False):
        super().__init__()
        self.out_stages = tuple(out_stages)
        cin, widths = 3, []
        for i, (kind, arg, s) in enumerate(_PLAN):
            if kind == "conv":
                setattr(self, f"stage{i}", ConvBNAct(cin, arg, 3, s, **_BN))
                cin = arg
            elif kind == "csp":
                setattr(self, f"stage{i}", CspBlock(cin, arg[0], arg[1], s))
                cin = 2 * arg[0]
            widths.append(cin)
        self.out_channels = [widths[i] for i in self.out_stages]

    def forward(self, x):
        feats = []
        for i, (kind, _, s) in enumerate(_PLAN):
            x = F.max_pool2d(x, 3, s, 1) if kind == "pool" else getattr(self, f"stage{i}")(x)
            if i in self.out_stages:
                feats.append(x)
        return tuple(feats)
