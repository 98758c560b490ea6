"""SegFormer's Mix Transformer (counterpart of ``MixVisionTransformer`` in
``cvpytorch_tpu/models/backbones/seg_transformers.py``), registered as
``MixVisionTransformer`` and ``mit``, subtypes ``mit_b0`` … ``mit_b5``.

NCHW images in; each stage is an overlapping patch embedding (7×7/4,
then 3×3/2), LayerNorm, ``depth`` blocks of spatial-reduction attention
and Mix-FFN with pre-norm and stochastic depth, and a LayerNorm; the
features of ``out_stages`` come out NCHW (``channels`` lists each
stage's width).  With ``classifier`` a Dense ``fc`` on the mean of the
last stage's tokens.  Submodules carry the Flax names.

What the JAX module does, and this one copies:
* flax ``LayerNorm`` eps 1e-6 (torch's default is 1e-5);
* the Mix-FFN's GELU is the exact erf one (``bricks``' "gelu" is tanh);
* the ``sr`` conv (kernel = stride = the stage's ratio) has flax's
  "SAME" padding: none when the grid divides by the ratio, else
  ⌊p/2⌋ before and the rest after, p = ⌈n/r⌉·r − n;
* the attention logits and softmax are float32 (the JAX einsum's
  ``preferred_element_type``; autocast off around them), scaled by
  1/√head_dim, and the probabilities cast to v's dtype: matmul, softmax,
  matmul, as the JAX module computes them;
* DropPath at rate ``drop_path_rate``·block/(blocks − 1).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...registry import BACKBONES
from ..bricks import DropPath

MIT_SPECS = {  # dims, depths
    "mit_b0": ((32, 64, 160, 256), (2, 2, 2, 2)),
    "mit_b1": ((64, 128, 320, 512), (2, 2, 2, 2)),
    "mit_b2": ((64, 128, 320, 512), (3, 4, 6, 3)),
    "mit_b3": ((64, 128, 320, 512), (3, 4, 18, 3)),
    "mit_b4": ((64, 128, 320, 512), (3, 8, 27, 3)),
    "mit_b5": ((64, 128, 320, 512), (3, 6, 40, 3)),
}
MIT_HEADS = (1, 2, 5, 8)
MIT_SR = (8, 4, 2, 1)
LN_EPS = 1e-6  # flax LayerNorm's


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _tokens(x):
    """NCHW → (B, H·W, C)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def _grid(t, hw):
    """(B, H·W, C) → NCHW."""
    return t.reshape(t.shape[0], *hw, t.shape[-1]).permute(0, 3, 1, 2)


def same_pad(x, r: int):
    """flax "SAME" padding of NCHW ``x`` for a kernel = stride = ``r`` conv."""
    pads = []
    for n in reversed(x.shape[-2:]):
        p = -(-n // r) * r - n
        pads += [p // 2, p - p // 2]
    return F.pad(x, pads) if any(pads) else x


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = _layer_norm(dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, hw):
        B, N, C = x.shape
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(_tokens(self.sr(same_pad(_grid(x, hw), self.sr_ratio))))
        hd = C // self.heads
        q = self.q(x).reshape(B, N, self.heads, hd).transpose(1, 2)
        k = self.k(kv_in).reshape(B, -1, self.heads, hd).transpose(1, 2)
        v = self.v(kv_in).reshape(B, -1, self.heads, hd).transpose(1, 2)
        with record_function("mit_attention"):  # a range in step profiles
            with torch.autocast(x.device.type, enabled=False):
                attn = torch.softmax(q.float() @ k.float().transpose(-2, -1) / math.sqrt(hd), -1)
            out = attn.to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class MixFFN(nn.Module):
    def __init__(self, dim: int, expand: int = 4):
        super().__init__()
        hdim = dim * expand
        self.fc1 = nn.Linear(dim, hdim)
        self.dwconv = nn.Conv2d(hdim, hdim, 3, padding=1, groups=hdim)
        self.fc2 = nn.Linear(hdim, dim)

    def forward(self, x, hw):
        y = _tokens(self.dwconv(_grid(self.fc1(x), hw)))
        return self.fc2(F.gelu(y))


@BACKBONES.register(name="MixVisionTransformer", aliases=("mit",))
class MixVisionTransformer(nn.Module):
    def __init__(self, subtype: str = "mit_b0", out_stages: Sequence[int] = (1, 2, 3, 4),
                 classifier: bool = False, num_classes: int = 1000,
                 drop_path_rate: float = 0.1):
        super().__init__()
        dims, depths = MIT_SPECS[subtype]
        self.out_stages = tuple(out_stages)
        self.classifier = classifier
        self.channels = list(dims)
        self.depths = depths
        total = sum(depths)
        bi = 0
        cin = 3
        for si, dim in enumerate(dims):
            patch, stride = (7, 4) if si == 0 else (3, 2)
            setattr(self, f"patch{si}", nn.Conv2d(cin, dim, patch, stride, patch // 2))
            setattr(self, f"patch_norm{si}", _layer_norm(dim))
            for j in range(depths[si]):
                dp = drop_path_rate * bi / max(total - 1, 1)
                setattr(self, f"ln1_{si}_{j}", _layer_norm(dim))
                setattr(self, f"attn{si}_{j}", EfficientAttention(dim, MIT_HEADS[si], MIT_SR[si]))
                setattr(self, f"dp1_{si}_{j}", DropPath(dp))
                setattr(self, f"ln2_{si}_{j}", _layer_norm(dim))
                setattr(self, f"ffn{si}_{j}", MixFFN(dim))
                setattr(self, f"dp2_{si}_{j}", DropPath(dp))
                bi += 1
            setattr(self, f"out_norm{si}", _layer_norm(dim))
            cin = dim
        if classifier:
            self.fc = nn.Linear(dims[-1], num_classes)

    def forward(self, x):
        feats = []
        t = None
        for si, depth in enumerate(self.depths):
            x = getattr(self, f"patch{si}")(x)
            hw = tuple(x.shape[-2:])
            t = getattr(self, f"patch_norm{si}")(_tokens(x))
            for j in range(depth):
                a = getattr(self, f"attn{si}_{j}")(getattr(self, f"ln1_{si}_{j}")(t), hw)
                t = t + getattr(self, f"dp1_{si}_{j}")(a)
                f = getattr(self, f"ffn{si}_{j}")(getattr(self, f"ln2_{si}_{j}")(t), hw)
                t = t + getattr(self, f"dp2_{si}_{j}")(f)
            t = getattr(self, f"out_norm{si}")(t)
            x = _grid(t, hw)
            if si + 1 in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(t.mean(1))
        return tuple(feats)
