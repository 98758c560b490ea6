"""SegFormer's and SFNet's decoders (counterparts of ``SegFormerHead``,
``grid_sample_bilinear``, ``_flow_warp``, ``AlignedModule`` and
``UperNetAlignHead`` in ``cvpytorch_tpu/models/heads/seg_heads_extra.py``),
NCHW, registered under the JAX names and aliases.  Like the heads of
``seg_heads.py`` each takes ``in_channels`` and returns logits at the
first feature's resolution; BN is torch momentum 0.1, eps 1e-5.

* ``SegFormerHead``: a per-level linear projection ``linear{i}`` (the Flax
  Dense, here a 1×1 conv), each level resized bilinearly to level 0, the
  levels concatenated in reversed order, a 1×1 ``fuse`` ConvBNAct,
  dropout and a 1×1 ``cls``.
* ``UperNetAlignHead`` (SFNet): UPerNet whose top-down adds are
  flow-aligned.  ``grid_sample_bilinear`` is not ``F.grid_sample``: it
  clamps the corner indices to the map before it takes the weights
  ``gx − x0``, so off the map it extrapolates where ``padding_mode=
  "border"`` clamps; it is four gathers, as in JAX.  ``_flow_warp``
  normalises the flow by [w, h] (not size − 1) on a ``linspace(-1, 1)``
  grid.  The top-down loop updates ``laterals[i − 1]`` in place from the
  updated ``laterals[i]``.  The PPM pools every bin, those that divide
  the map too, by ``jax.image.resize(..., "linear")``, an antialiased
  bilinear resize, where UPerHead takes a block mean
  (``seg_heads.pyramid_pool``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import HEADS
from ..bricks import ConvBNAct
from .seg_heads import resize_bilinear, resize_linear

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


@HEADS.register(name="SegFormerHead")
class SegFormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 256, dropout: float = 0.1):
        super().__init__()
        self.n_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"linear{i}", nn.Conv2d(c, channels, 1))
        self.fuse = ConvBNAct(channels * len(in_channels), channels, 1, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        size = feats[0].shape[-2:]
        outs = [resize_bilinear(getattr(self, f"linear{i}")(f), size)
                for i, f in enumerate(feats)]
        x = self.fuse(torch.cat(outs[::-1], 1))
        return self.cls(self.dropout(x))


def grid_sample_bilinear(x, grid):
    """Bilinear samples of NCHW ``x`` at ``grid`` (B, h, w, 2), normalised
    [-1, 1] (x, y), align_corners: (B, C, h, w).  See the module docstring
    for where it parts from ``F.grid_sample``."""
    B, C, H, W = x.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(gx), 0, W - 1)
    y0 = torch.clamp(torch.floor(gy), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    flat = x.permute(0, 2, 3, 1).reshape(B, H * W, C)

    def gather(yi, xi):
        idx = (yi * W + xi).long().reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(*yi.shape, C)

    v00, v01 = gather(y0, x0), gather(y0, x1)
    v10, v11 = gather(y1, x0), gather(y1, x1)
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
           v10 * (1 - wx) * wy + v11 * wx * wy)
    return out.permute(0, 3, 1, 2)


def _flow_warp(x, flow, size):
    """NCHW ``x`` warped to ``size`` by the pixel-offset flow (B, h, w, 2)."""
    h, w = size
    ys = torch.linspace(-1.0, 1.0, h, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, device=x.device)
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)  # (h, w, [x, y])
    norm = torch.tensor([w, h], dtype=x.dtype, device=x.device)
    grid = grid[None] + flow / norm
    return grid_sample_bilinear(x, grid.expand(x.shape[0], h, w, 2))


class AlignedModule(nn.Module):
    """Flow-aligned top-down fusion: the flow from [upsampled ``high``,
    ``low``] (both reduced 1×1), then ``high`` itself warped to ``low``'s
    size."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.down_l = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.down_h = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.flow_make = nn.Conv2d(2 * out_channels, 2, 3, padding=1, bias=False)

    def forward(self, low, high):
        size = low.shape[-2:]
        l_ = self.down_l(low)
        h_ = resize_bilinear(self.down_h(high), size)
        flow = self.flow_make(torch.cat([h_, l_], 1))
        return _flow_warp(high, flow.permute(0, 2, 3, 1), size)


@HEADS.register(name="UperNetAlignHead", aliases=("SFNetHead",))
class UperNetAlignHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 128, bins: Sequence[int] = (1, 2, 3, 6),
                 dropout: float = 0.1):
        super().__init__()
        c5 = in_channels[-1]
        self.bins = tuple(bins)
        self.n_levels = len(in_channels)
        for i in range(len(self.bins)):
            setattr(self, f"ppm{i}", ConvBNAct(c5, channels, 1, **_BN))
        self.ppm_bottleneck = ConvBNAct(c5 + channels * len(self.bins), channels, 3, **_BN)
        for i, c in enumerate(in_channels[:-1]):
            setattr(self, f"lateral{i}", ConvBNAct(c, channels, 1, **_BN))
            setattr(self, f"align{i}", AlignedModule(channels, channels // 2))
            setattr(self, f"fpn{i}", ConvBNAct(channels, channels, 3, **_BN))
        self.fpn_bottleneck = ConvBNAct(channels * len(in_channels), channels, 3, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        c5 = feats[-1]
        size = c5.shape[-2:]
        ppm = [c5] + [resize_bilinear(getattr(self, f"ppm{i}")(resize_linear(c5, (s, s))), size)
                      for i, s in enumerate(self.bins)]
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats[:-1])]
        laterals.append(self.ppm_bottleneck(torch.cat(ppm, 1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + getattr(self, f"align{i - 1}")(
                laterals[i - 1], laterals[i])
        outs = [getattr(self, f"fpn{i}")(lat) for i, lat in enumerate(laterals[:-1])]
        outs.append(laterals[-1])
        size = outs[0].shape[-2:]
        x = self.fpn_bottleneck(torch.cat([outs[0]] + [resize_bilinear(o, size)
                                                       for o in outs[1:]], 1))
        return self.cls(self.dropout(x))
