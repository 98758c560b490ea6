"""ConvNeXt T/S/B/L (counterpart of ``cvpytorch_tpu/models/backbones/convnext.py``),
NCHW: Liu et al., arXiv:2201.03545.

Stages as in the JAX module: stem (4×4/4 conv + LayerNorm) and the
first block stack are stage 1, each later stage is a LayerNorm + 2×2/2
conv and its blocks, and ``out_stages`` picks among stages 1–4.  A block
is a 7×7 depthwise conv, LayerNorm, ``pw1`` (4C), erf GELU, ``pw2``, the
layer scale ``gamma`` and stochastic depth on the residual branch, the
rate rising linearly from 0 to ``drop_path_rate`` over the blocks.
LayerNorms use Flax's eps 1e-6 (torch's default is 1e-5) and run
channels-last, as the Dense layers do; the strided convs pad as Flax's
``SAME`` does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import DropPath

_SPECS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}
LN_EPS = 1e-6  # flax nn.LayerNorm's default


def same_pad(x, kernel: int, stride: int):
    """Flax ``padding='SAME'`` for a k×k, stride-s conv: the total padding
    max((⌈n/s⌉ − 1)·s + k − n, 0), its smaller half first."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def channels_last_norm(norm: nn.LayerNorm, x):
    """LayerNorm over the channels of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_rate: float = 0.0, layer_scale: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale)))
        self.drop = DropPath(drop_rate)

    def forward(self, x):
        h = self.dwconv(x).permute(0, 2, 3, 1)
        h = self.pw2(F.gelu(self.pw1(self.norm(h)))) * self.gamma  # erf GELU, as torch's
        return x + self.drop(h.permute(0, 3, 1, 2))


@BACKBONES.register(name="ConvNeXt", aliases=("convnext",))
class ConvNeXt(nn.Module):
    def __init__(self, subtype: str = "convnext_tiny", out_stages: Sequence[int] = (2, 3, 4),
                 classifier: bool = False, num_classes: int = 1000,
                 drop_path_rate: float = 0.1, pretrained: bool = False, in_channels: int = 3):
        super().__init__()
        depths, dims = _SPECS[subtype]
        self.out_stages, self.classifier = tuple(out_stages), classifier
        self.depths, self.channels = depths, dims
        total, bi, cin = sum(depths), 0, in_channels
        for si, (d, dim) in enumerate(zip(depths, dims), start=1):
            if si == 1:
                self.stem_conv = nn.Conv2d(cin, dim, 4, 4)
                self.stem_norm = nn.LayerNorm(dim, eps=LN_EPS)
            else:
                setattr(self, f"down{si}_norm", nn.LayerNorm(cin, eps=LN_EPS))
                setattr(self, f"down{si}_conv", nn.Conv2d(cin, dim, 2, 2))
            for j in range(d):
                setattr(self, f"stage{si}_block{j}", ConvNeXtBlock(
                    dim, drop_rate=drop_path_rate * bi / max(total - 1, 1)))
                bi += 1
            cin = dim
        if classifier:
            self.head_norm = nn.LayerNorm(cin, eps=LN_EPS)
            self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        feats = []
        for si, d in enumerate(self.depths, start=1):
            if si == 1:
                x = channels_last_norm(self.stem_norm, self.stem_conv(same_pad(x, 4, 4)))
            else:
                x = channels_last_norm(getattr(self, f"down{si}_norm"), x)
                x = getattr(self, f"down{si}_conv")(same_pad(x, 2, 2))
            for j in range(d):
                x = getattr(self, f"stage{si}_block{j}")(x)
            if si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(self.head_norm(x.mean((2, 3))))
        return tuple(feats)
