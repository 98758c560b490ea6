"""Shared model building blocks (counterpart of
``cvpytorch_tpu/models/bricks.py``): channel/depth rounding, the
activation table, ``BatchNorm2d``, ``ConvBNAct``,
``DepthwiseSeparableConv``, ``SqueezeExcite`` and ``DropPath``.

``nn.BatchNorm2d`` normalises with the biased batch variance and stores
the unbiased one in ``running_var``, which is what the JAX package's
BatchNorm fork imitates; the YOLO bricks use torch momentum 0.03 and
eps 1e-3 (flax momentum 0.97).  BN momentum is always torch's: flax
momentum m is torch momentum 1 − m.  Under data parallelism
(``parallel.dist``) the bricks' ``BatchNorm2d`` takes its train-mode
moments over the global batch, as the JAX BatchNorm does on a mesh.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist as dp


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    """Channel rounding."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def make_round(x: float, mul: float = 1.0) -> int:
    """Depth rounding."""
    return max(round(x * mul), 1) if x > 1 else int(x)


ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.1),
    "silu": F.silu,
    "swish": F.silu,
    "hardswish": F.hardswish,
    "hsigmoid": F.hardsigmoid,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "mish": F.mish,
    "identity": lambda x: x,
}


def upsample2x_bilinear_align(x):
    """×2 bilinear upsampling with align_corners=True: output i samples
    input position i·(H − 1)/(2H − 1)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def get_activation(name: str | None) -> Callable:
    if name is None:
        return ACTIVATIONS["identity"]
    return ACTIVATIONS[name.lower()]


def bf16_batch_moments(x: torch.Tensor):
    """Per-channel (mean, biased var) of an NCHW map in bfloat16, as XLA
    computes the JAX BatchNorm's moments of a bfloat16 input without the
    float32 promotion: each mean is a float32 sum divided by n in float32
    and rounded to bfloat16, the square x·x is rounded to bfloat16 before
    its mean, and var = max(E[x²] − mean², 0) in bfloat16."""
    xb = x.to(torch.bfloat16)
    dims = [d for d in range(x.dim()) if d != 1]
    mean = torch.mean(xb, dims, dtype=torch.float32).to(torch.bfloat16)
    mean2 = torch.mean(xb * xb, dims, dtype=torch.float32).to(torch.bfloat16)
    return mean, torch.clamp_min(mean2 - mean * mean, 0)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that also trains on one value per channel (the
    global-pool branch of a segmentation head at batch 1), as the JAX
    BatchNorm does: the output is the bias, the running variance decays
    towards 0 (Bessel's factor n / max(n − 1, 1) is 1).  torch's raises
    there.

    ``bf16_stats`` (off by default; ``set_bn_bf16_stats`` sets it on a
    model, the trainer's ``AMP_BN_BF16_STATS``): in train mode under
    autocast the batch moments are taken in bfloat16
    (``bf16_batch_moments``); the normalisation and the running statistics
    stay float32, from those moments.

    With more than one rank on the data axis (``parallel.dist``) train
    mode takes the moments of the global batch over the data group
    (``_global_forward``; the ranks of one model group hold the same
    rows): the mean from the all-reduced sums and count, then the
    all-reduced Σ(x − mean)² (not E[x²] − mean², which cancels in
    float32), both carrying autograd and in float32 at least (float64
    inputs stay float64);
    ``running_var`` gets Bessel's factor n / max(n − 1, 1) of the global
    n, and a global count of one is the one-value case above.
    ``bf16_stats`` is refused there (ROADMAP, Queue 1 item 11c)."""

    bf16_stats = False

    def forward(self, x):
        if self.training and dp.reductions_active():
            return self._global_forward(x)
        if (self.bf16_stats and self.training and x.numel() != x.shape[1]
                and torch.is_autocast_enabled(x.device.type)):
            return self._bf16_stats_forward(x)
        if not (self.training and x.numel() == x.shape[1]):
            return super().forward(x)
        with torch.no_grad():
            self.running_mean.lerp_(x.detach().reshape(-1).to(self.running_mean), self.momentum)
            self.running_var.mul_(1 - self.momentum)
            self.num_batches_tracked += 1
        # x minus its own mean is 0 (with 0 gradient), whatever 1/√(0 + eps)
        # scales it by
        shape = (1, -1, 1, 1)
        return ((x - x.mean((0, 2, 3), keepdim=True)) * self.weight.reshape(shape)
                + self.bias.reshape(shape))

    def _global_forward(self, x):
        if self.bf16_stats:
            raise NotImplementedError(
                "bf16_stats takes per-rank moments: bfloat16 BN moments under data "
                "parallelism are not ported yet (ROADMAP, Queue 1 item 11c)")
        C = x.shape[1]
        dims = [d for d in range(x.dim()) if d != 1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.new_full((1,), x.numel() // C)
        sums = dp.all_reduce_with_grad(torch.cat([xf.sum(dims), count]))
        n = sums[C:].detach()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        d = xf - (sums[:C] / n).reshape(shape)
        var = dp.all_reduce_with_grad((d * d).sum(dims)) / n
        with torch.no_grad():
            self.running_mean.lerp_((sums[:C] / n).detach(), self.momentum)
            self.running_var.lerp_(var.detach() * (n / torch.clamp_min(n - 1, 1)),
                                   self.momentum)
            self.num_batches_tracked += 1
        a = torch.rsqrt(var + self.eps) * self.weight
        return (d * a.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)

    def _bf16_stats_forward(self, x):
        mean, var = (m.float() for m in bf16_batch_moments(x))
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach() * (n / max(n - 1, 1)), self.momentum)
            self.num_batches_tracked += 1
        # one float32 pass: x·a + (bias − mean·a), a = weight / √(var + eps)
        a = torch.rsqrt(var + self.eps) * self.weight
        b = self.bias - mean * a
        shape = (1, -1, 1, 1)
        return torch.addcmul(b.reshape(shape), x, a.reshape(shape)).to(x.dtype)


def set_bn_bf16_stats(model: nn.Module, enabled: bool) -> nn.Module:
    """Sets ``bf16_stats`` on every BN of ``model`` (on this instance only);
    turning it on raises for a BN of another class, which has no such
    switch."""
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            m.bf16_stats = bool(enabled)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm) and enabled:
            raise TypeError(f"{name} is a {type(m).__name__}: bfloat16 BN moments "
                            "need the bricks' BatchNorm2d")
    return model


class ConvBNAct(nn.Module):
    """conv + BN + activation; submodules ``conv`` and ``bn`` carry the
    JAX tree's names.  ``padding`` None → ((k-1)//2)·dilation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, groups: int = 1,
                 dilation: int = 1, use_bias: bool = False,
                 act: str | None = "relu", bn_momentum: float = 0.03,
                 bn_eps: float = 1e-3, padding: int | None = None):
        super().__init__()
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding, dilation, groups, bias=use_bias)
        self.bn = BatchNorm2d(out_channels, eps=bn_eps, momentum=bn_momentum)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class DepthwiseSeparableConv(nn.Module):
    """Depthwise ``ConvBNAct`` ``dw`` (groups = in_channels), then a 1×1
    ``ConvBNAct`` ``pw``, each with the activation.  The Flax depthwise
    kernel (kh, kw, 1, C) carries to torch's (C, 1, kh, kw) by the usual
    HWIO → OIHW transpose."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, act: str | None = "relu",
                 bn_momentum: float = 0.03, bn_eps: float = 1e-3):
        super().__init__()
        bn = dict(act=act, bn_momentum=bn_momentum, bn_eps=bn_eps)
        self.dw = ConvBNAct(in_channels, in_channels, kernel_size, stride,
                            groups=in_channels, dilation=dilation, **bn)
        self.pw = ConvBNAct(in_channels, out_channels, 1, 1, **bn)

    def forward(self, x):
        return self.pw(self.dw(x))


class SqueezeExcite(nn.Module):
    """SE attention: global mean → 1×1 ``fc1`` (``squeeze_ch``, else
    max(C // ``reduce_ratio``, 8)) → ``act`` → 1×1 ``fc2`` (C) → ``gate``,
    which scales the input.  Both convs carry a bias, as the JAX brick's
    ``nn.Conv``s do."""

    def __init__(self, channels: int, reduce_ratio: int = 4, gate: str = "hsigmoid",
                 act: str = "relu", squeeze_ch: int = 0):
        super().__init__()
        sq = squeeze_ch or max(channels // reduce_ratio, 8)
        self.fc1 = nn.Conv2d(channels, sq, 1)
        self.fc2 = nn.Conv2d(sq, channels, 1)
        self.act, self.gate = get_activation(act), get_activation(gate)

    def forward(self, x):
        s = self.act(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * self.gate(self.fc2(s))


class DropPath(nn.Module):
    """Stochastic depth: in ``train()`` mode each sample's branch is kept
    with probability 1 − ``rate`` and scaled by 1 / (1 − rate), else
    zeroed (the JAX ``DropPath``'s ``where(mask, x / keep, 0)``).  The
    mask is drawn from torch's generator of ``x``'s device, as
    ``nn.Dropout`` draws."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.empty(shape, device=x.device).bernoulli_(keep).bool()
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class MultiHeadDense(nn.Linear):
    """``nn.Linear`` standing for one of the ``DenseGeneral`` projections of
    Flax's ``MultiHeadDotProductAttention``: ``split='heads'`` projects
    ``in_features`` to ``heads`` heads of ``out_features // heads`` (the
    query, key and value; Flax kernel (in, H, D), bias (H, D)), and
    ``split='merge'`` projects the heads back (the output; kernel (H, D,
    out), bias (out,)).  The weight carry reshapes those by this rule
    (``utils/porting``)."""

    def __init__(self, in_features: int, out_features: int, heads: int, split: str):
        super().__init__(in_features, out_features)
        if split not in ("heads", "merge"):
            raise ValueError(f"split is 'heads' or 'merge', not {split!r}")
        self.heads, self.split = heads, split

    def flax_shape(self, leaf: str) -> tuple:
        """The Flax shape of the ``kernel`` or ``bias`` this module holds."""
        if self.split == "heads":
            d = self.out_features // self.heads
            return (self.in_features, self.heads, d) if leaf == "kernel" else (self.heads, d)
        d = self.in_features // self.heads
        return (self.heads, d, self.out_features) if leaf == "kernel" else (self.out_features,)
