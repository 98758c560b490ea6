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
* ``LightHamHead`` (SegNeXt): every level resized bilinearly to level 0's
  size, concatenated in level order, a 1×1 ``squeeze`` + GroupNorm(32) +
  ReLU, the ``Hamburger`` (1×1 ``ham_in`` with a bias, ReLU, NMF, 1×1
  ``ham_out`` + GroupNorm, ``relu(x + ·)``), a 1×1 ``align`` + GroupNorm
  + ReLU, dropout and ``cls``.  flax's GroupNorm has eps 1e-6.  The NMF
  runs 6 rounds in train mode and 7 in eval, and in float32 with autocast
  off (JAX runs it in the params' dtype, bf16 under AMP).  Its bases are
  JAX's draw ``jax.random.uniform(PRNGKey(0), (B, D, R))``, L2-normalised
  over D: ``prng_uniform`` computes that draw in numpy, bit for bit, once
  for the largest batch seen (a batch's bases are the first rows of a
  larger batch's).
* ``UpConcatHead`` (IncepFormer): levels 1… resized bilinearly to level
  0, concatenated in level order, a 1×1 ``linear_fuse`` ConvBNAct,
  dropout and ``cls``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...registry import HEADS
from ..bricks import ConvBNAct
from .seg_heads import resize_bilinear, resize_linear

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)
GN_EPS = 1e-6  # flax GroupNorm's


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


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (``jax.random``'s) of the uint32
    counter words ``x0``, ``x1`` under the two-word ``key``."""
    ks = [np.uint32(key[0]), np.uint32(key[1])]
    ks.append(ks[0] ^ ks[1] ^ np.uint32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for g in range(5):
        for r in rotations[g % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def prng_uniform(shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(0), shape, dtype)`` in numpy,
    bit for bit, as jax draws with its partitionable threefry: the
    counter of element i is (i >> 32, i & 0xFFFFFFFF); float32 takes the
    bits ``out0 ^ out1``, float64 (JAX with 64-bit floats) ``out0 << 32 |
    out1``, and the float is the mantissa's bits under the exponent of
    1.0, minus 1."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    b0, b1 = _threefry2x32((0, 0), (i >> np.uint64(32)).astype(np.uint32),
                           (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    if np.dtype(dtype) == np.float64:
        bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
        one = (bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
        return (one.view(np.float64) - 1.0).reshape(shape)
    one = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return (one.view(np.float32) - np.float32(1.0)).reshape(shape)


def default_bases(B: int, D: int, R: int, dtype=np.float32) -> np.ndarray:
    """The JAX ``_default_bases``: the PRNGKey(0) draw (B, D, R),
    L2-normalised over D."""
    b = prng_uniform((B, D, R), dtype)
    return b / np.maximum(np.sqrt((b * b).sum(1, keepdims=True)), dtype(1e-12))


def nmf2d(x, bases, steps: int):
    """NMF by multiplicative updates of ``x`` (B, D, N), nonnegative, from
    ``bases`` (B, D, R): the coefficients start as softmax over R of
    xᵀ·bases, then ``steps`` rounds update the coefficients and then the
    bases, then the coefficients once more; returns bases·coefᵀ."""
    xt = x.transpose(1, 2)
    coef = torch.softmax(xt @ bases, -1)

    def update_coef(coef, bases):
        return coef * (xt @ bases) / (coef @ (bases.transpose(1, 2) @ bases) + 1e-6)

    for _ in range(steps):
        coef = update_coef(coef, bases)
        bases = bases * (x @ coef) / (bases @ (coef.transpose(1, 2) @ coef) + 1e-6)
    coef = update_coef(coef, bases)
    return bases @ coef.transpose(1, 2)


class Hamburger(nn.Module):
    TRAIN_STEPS, EVAL_STEPS = 6, 7  # NMF rounds

    def __init__(self, ham_channels: int, nmf_rank: int = 64):
        super().__init__()
        self.nmf_rank = nmf_rank
        self.ham_in = nn.Conv2d(ham_channels, ham_channels, 1)
        self.ham_out = nn.Conv2d(ham_channels, ham_channels, 1, bias=False)
        self.ham_out_gn = nn.GroupNorm(32, ham_channels, eps=GN_EPS)
        self._bases = {}  # (device, dtype) → the bases of the largest batch seen

    def bases(self, B: int, D: int, device, dtype: torch.dtype) -> torch.Tensor:
        key = (str(device), dtype)
        have = self._bases.get(key)
        if have is None or have.shape[0] < B:
            np_dtype = np.float64 if dtype == torch.float64 else np.float32
            have = torch.from_numpy(default_bases(B, D, self.nmf_rank, np_dtype)).to(device)
            self._bases[key] = have
        return have[:B]

    def forward(self, x):
        B, C, H, W = x.shape
        enjoy = F.relu(self.ham_in(x))
        dtype = torch.float64 if enjoy.dtype == torch.float64 else torch.float32
        steps = self.TRAIN_STEPS if self.training else self.EVAL_STEPS
        with record_function("nmf"), torch.autocast(x.device.type, enabled=False):
            enjoy = nmf2d(enjoy.reshape(B, C, H * W).to(dtype),
                          self.bases(B, C, x.device, dtype), steps)
        enjoy = self.ham_out_gn(self.ham_out(enjoy.reshape(B, C, H, W)))
        return F.relu(x + enjoy)


@HEADS.register(name="LightHamHead")
class LightHamHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 256, ham_channels: int = 256, nmf_rank: int = 64,
                 dropout: float = 0.1):
        super().__init__()
        self.squeeze = nn.Conv2d(sum(in_channels), ham_channels, 1, bias=False)
        self.squeeze_gn = nn.GroupNorm(32, ham_channels, eps=GN_EPS)
        self.hamburger = Hamburger(ham_channels, nmf_rank)
        self.align = nn.Conv2d(ham_channels, channels, 1, bias=False)
        self.align_gn = nn.GroupNorm(32, channels, eps=GN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        size = feats[0].shape[-2:]
        x = torch.cat([feats[0]] + [resize_bilinear(f, size) for f in feats[1:]], 1)
        x = self.hamburger(F.relu(self.squeeze_gn(self.squeeze(x))))
        x = F.relu(self.align_gn(self.align(x)))
        return self.cls(self.dropout(x))


@HEADS.register(name="UpConcatHead")
class UpConcatHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 512, dropout: float = 0.1):
        super().__init__()
        self.linear_fuse = ConvBNAct(sum(in_channels), channels, 1, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        size = feats[0].shape[-2:]
        x = torch.cat([feats[0]] + [resize_bilinear(f, size) for f in feats[1:]], 1)
        return self.cls(self.dropout(self.linear_fuse(x)))
