"""Segmentation transformer backbones (counterparts of
``MixVisionTransformer``, ``MSCAN`` and ``IncepTransformer`` in
``cvpytorch_tpu/models/backbones/seg_transformers.py``), registered under
the JAX names and aliases: ``MixVisionTransformer``/``mit`` (``mit_b0`` …
``mit_b5``), ``MSCAN``/``mscan`` (``mscan_t/s/b/l``) and
``IncepTransformer``/``ipt`` (``ipt_t/s/b``).  NCHW images in, the
features of ``out_stages`` (1-based) out NCHW; ``channels`` lists each
stage's width.  Submodules carry the Flax names.

SegFormer's Mix Transformer: each stage is an overlapping patch
embedding (7×7/4, then 3×3/2), LayerNorm, ``depth`` blocks of
spatial-reduction attention and Mix-FFN with pre-norm and stochastic
depth, and a LayerNorm.  With ``classifier`` a Dense ``fc`` on the mean
of the last stage's tokens.  What the JAX module does, and this one
copies:
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

SegNeXt's MSCAN: a stem of two 3×3/2 conv + BN (erf GELU between), then
3×3/2 conv + BN downsamplings, blocks of BN → 1×1 → GELU → multi-scale
strip attention → 1×1, plus the BN output itself (the attention's own
residual), times the layer scale ``ls1``; then BN → 1×1 → depthwise 3×3
→ GELU → 1×1 times ``ls2``; each stage ends in a per-pixel LayerNorm
with eps 1e-5 (``out_ln``, not MiT's 1e-6).  The attention's three strip
branches (1×k then k×1, k = 7, 11, 21, depthwise) each read the 5×5
depthwise conv's output, are summed with it, mixed 1×1 and multiply the
attention's input.  BN is torch momentum 0.1, eps 1e-5.

IncepFormer's IncepTransformer: patch embeddings with BN, blocks of
BN → inception attention and BN → conv MLP (GELU after each of its three
convs), a BN after each stage.  The attention's keys and values come
from three poolings of the map, concatenated: 1×r then r×1 strided
depthwise convs, an r×r strided depthwise conv (both with flax's "SAME"
padding, ⌈H/r⌉·⌈W/r⌉ tokens each), and an r×r average pool ("VALID",
⌊H/r⌋·⌊W/r⌋) followed by a depthwise 3×3, then a LayerNorm (eps 1e-6).
Its scale is 1.0, not 1/√head_dim (the reference passes ``qk_scale=True``
and ``True or hd**-0.5`` is True), so the logits go to the softmax as
they are: a multiply by 1.0 changes no bit, and in eager PyTorch it is a
pass over each logits tensor.  Logits and softmax are float32, as the
JAX einsum's ``preferred_element_type`` makes them: under autocast from
bf16 operands taken to float32, and from float64 operands as their
float64 product rounded to float32 (what XLA computes).  DropPath rates are ``linspace(0, drop_path_rate, blocks)``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ...registry import BACKBONES
from ..bricks import BatchNorm2d, DropPath

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


def same_pad(x, r: int | tuple[int, int]):
    """flax "SAME" padding of NCHW ``x`` for a kernel = stride = ``r`` conv,
    ``r`` one stride or (rh, rw): ⌊p/2⌋ before and the rest after on each
    axis, p = ⌈n/r⌉·r − n."""
    rh, rw = (r, r) if isinstance(r, int) else r
    pads = []
    for n, s in ((x.shape[-1], rw), (x.shape[-2], rh)):
        p = -(-n // s) * s - n
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


# ---------------------------------------------------------------- MSCAN --
MSCAN_SPECS = {  # dims, depths
    "mscan_t": ((32, 64, 160, 256), (3, 3, 5, 2)),
    "mscan_s": ((64, 128, 320, 512), (2, 2, 4, 2)),
    "mscan_b": ((64, 128, 320, 512), (3, 3, 12, 3)),
    "mscan_l": ((64, 128, 320, 512), (3, 5, 27, 3)),
}
MSCAN_MLP = (8, 8, 4, 4)  # per-stage MLP ratios
MSCAN_LN_EPS = 1e-5  # out_ln's, set explicitly in JAX


def _bn(dim: int) -> BatchNorm2d:
    """The JAX ``BatchNorm(momentum=0.9)``: torch momentum 0.1, eps 1e-5."""
    return BatchNorm2d(dim, eps=1e-5, momentum=0.1)


def _depthwise(dim: int, kernel, padding, stride=1) -> nn.Conv2d:
    return nn.Conv2d(dim, dim, kernel, stride, padding, groups=dim)


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of each pixel of an NCHW map."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MSCAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv5 = _depthwise(dim, 5, 2)
        for i, k in enumerate((7, 11, 21)):
            setattr(self, f"h{i}", _depthwise(dim, (1, k), (0, k // 2)))
            setattr(self, f"v{i}", _depthwise(dim, (k, 1), (k // 2, 0)))
        self.mix = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        a = self.conv5(x)
        out = a
        for i in range(3):  # in parallel, each from conv5's output
            out = out + getattr(self, f"v{i}")(getattr(self, f"h{i}")(a))
        return x * self.mix(out)


class MSCANBlock(nn.Module):
    def __init__(self, dim: int, drop_rate: float = 0.0, mlp_ratio: int = 4):
        super().__init__()
        hdim = dim * mlp_ratio
        self.bn1 = _bn(dim)
        self.proj1 = nn.Conv2d(dim, dim, 1)
        self.attn = MSCAttention(dim)
        self.proj2 = nn.Conv2d(dim, dim, 1)
        self.ls1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.dp1 = DropPath(drop_rate)
        self.bn2 = _bn(dim)
        self.ffn1 = nn.Conv2d(dim, hdim, 1)
        self.ffn_dw = _depthwise(hdim, 3, 1)
        self.ffn2 = nn.Conv2d(hdim, dim, 1)
        self.ls2 = nn.Parameter(torch.full((dim,), 1e-2))
        self.dp2 = DropPath(drop_rate)

    def forward(self, x):
        n1 = self.bn1(x)
        h = self.proj2(self.attn(F.gelu(self.proj1(n1)))) + n1
        x = x + self.dp1(h * self.ls1[:, None, None])
        h = self.ffn2(F.gelu(self.ffn_dw(self.ffn1(self.bn2(x)))))
        return x + self.dp2(h * self.ls2[:, None, None])


@BACKBONES.register(name="MSCAN", aliases=("mscan",))
class MSCAN(nn.Module):
    def __init__(self, subtype: str = "mscan_t", out_stages: Sequence[int] = (2, 3, 4),
                 classifier: bool = False, num_classes: int = 1000,
                 drop_path_rate: float = 0.1):
        super().__init__()
        dims, depths = MSCAN_SPECS[subtype]
        self.out_stages = tuple(out_stages)
        self.classifier = classifier
        self.channels = list(dims)
        self.depths = depths
        total = sum(depths)
        bi = 0
        self.stem1 = nn.Conv2d(3, dims[0] // 2, 3, 2, 1)
        self.stem_bn1 = _bn(dims[0] // 2)
        self.stem2 = nn.Conv2d(dims[0] // 2, dims[0], 3, 2, 1)
        self.stem_bn2 = _bn(dims[0])
        for si, dim in enumerate(dims):
            if si:
                setattr(self, f"down{si}", nn.Conv2d(dims[si - 1], dim, 3, 2, 1))
                setattr(self, f"down_bn{si}", _bn(dim))
            for j in range(depths[si]):
                setattr(self, f"stage{si + 1}_block{j}", MSCANBlock(
                    dim, drop_path_rate * bi / max(total - 1, 1), MSCAN_MLP[si]))
                bi += 1
            setattr(self, f"out_ln{si}", ChannelLayerNorm(dim, eps=MSCAN_LN_EPS))
        if classifier:
            self.fc = nn.Linear(dims[-1], num_classes)

    def forward(self, x):
        feats = []
        for si, depth in enumerate(self.depths):
            if si == 0:
                x = self.stem_bn2(self.stem2(F.gelu(self.stem_bn1(self.stem1(x)))))
            else:
                x = getattr(self, f"down_bn{si}")(getattr(self, f"down{si}")(x))
            for j in range(depth):
                x = getattr(self, f"stage{si + 1}_block{j}")(x)
            x = getattr(self, f"out_ln{si}")(x)
            if si + 1 in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(x.mean((2, 3)))
        return tuple(feats)


# ---------------------------------------------------------- IncepFormer --
IPT_SPECS = {  # out channels, depths
    "ipt_t": ((64, 128, 320, 512), (2, 2, 4, 2)),
    "ipt_s": ((64, 128, 320, 512), (3, 4, 12, 2)),
    "ipt_b": ((64, 128, 320, 512), (3, 6, 24, 2)),
}
IPT_HEADS = (2, 4, 8, 16)
IPT_MLP = (8, 8, 4, 4)
IPT_DOWN = (8, 4, 2, 1)


class IncepAttention(nn.Module):
    def __init__(self, dim: int, heads: int, down_ratio: int):
        super().__init__()
        self.heads, self.down_ratio = heads, down_ratio
        r = down_ratio
        self.q = nn.Linear(dim, dim)
        if r > 1:
            self.conv1a = _depthwise(dim, (1, r), 0, (1, r))
            self.conv1b = _depthwise(dim, (r, 1), 0, (r, 1))
            self.conv2 = _depthwise(dim, r, 0, r)
            self.dwconv = _depthwise(dim, 3, 1)
            self.norm = _layer_norm(dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def pooled(self, x):
        """The key/value tokens (B, M, C) of the NCHW map ``x``."""
        r = self.down_ratio
        if r == 1:
            return _tokens(x)
        x1 = self.conv1b(same_pad(self.conv1a(same_pad(x, (1, r))), (r, 1)))
        x2 = self.conv2(same_pad(x, r))
        x3 = self.dwconv(F.avg_pool2d(x, r, r))
        return self.norm(torch.cat([_tokens(x1), _tokens(x2), _tokens(x3)], 1))

    def forward(self, x):
        B, C, H, W = x.shape
        N, hd = H * W, C // self.heads
        q = self.q(_tokens(x)).reshape(B, N, self.heads, hd).transpose(1, 2)
        k, v = self.kv(self.pooled(x)).chunk(2, -1)
        k = k.reshape(B, -1, self.heads, hd).transpose(1, 2)
        v = v.reshape(B, -1, self.heads, hd).transpose(1, 2)
        wide = torch.promote_types(q.dtype, torch.float32)
        with record_function("incepformer_attention"):  # a range in step profiles
            with torch.autocast(x.device.type, enabled=False):
                logits = (q.to(wide) @ k.to(wide).transpose(-2, -1)).float()
                attn = torch.softmax(logits, -1)  # scale 1.0: nothing to multiply
            out = attn.to(v.dtype) @ v
        return _grid(self.proj(out.transpose(1, 2).reshape(B, N, C)), (H, W))


class IncepMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dwconv = _depthwise(hidden, 3, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return F.gelu(self.fc2(F.gelu(self.dwconv(F.gelu(self.fc1(x))))))


class IncepBlock(nn.Module):
    def __init__(self, dim: int, heads: int, down_ratio: int, mlp_ratio: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = _bn(dim)
        self.attn = IncepAttention(dim, heads, down_ratio)
        self.dp1 = DropPath(drop_path)
        self.norm2 = _bn(dim)
        self.mlp = IncepMlp(dim, dim * mlp_ratio)
        self.dp2 = DropPath(drop_path)

    def forward(self, x):
        x = x + self.dp1(self.attn(self.norm1(x)))
        return x + self.dp2(self.mlp(self.norm2(x)))


@BACKBONES.register(name="IncepTransformer", aliases=("ipt",))
class IncepTransformer(nn.Module):
    def __init__(self, subtype: str = "ipt_t", out_stages: Sequence[int] = (1, 2, 3, 4),
                 drop_path_rate: float = 0.1):
        super().__init__()
        chs, depths = IPT_SPECS[subtype]
        self.out_stages = tuple(out_stages)
        self.channels = list(chs)
        self.depths = depths
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cin, cur = 3, 0
        for i, (ch, depth) in enumerate(zip(chs, depths)):
            k, s = (7, 4) if i == 0 else (3, 2)
            setattr(self, f"patch_embed{i + 1}", nn.Conv2d(cin, ch, k, s, k // 2))
            setattr(self, f"embed_norm{i + 1}", _bn(ch))
            for j in range(depth):
                setattr(self, f"block{i + 1}_{j}", IncepBlock(
                    ch, IPT_HEADS[i], IPT_DOWN[i], IPT_MLP[i], float(dpr[cur + j])))
            setattr(self, f"norm{i + 1}", _bn(ch))
            cin, cur = ch, cur + depth

    def forward(self, x):
        outs = []
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"embed_norm{i + 1}")(getattr(self, f"patch_embed{i + 1}")(x))
            for j in range(depth):
                x = getattr(self, f"block{i + 1}_{j}")(x)
            x = getattr(self, f"norm{i + 1}")(x)
            if i + 1 in self.out_stages:
                outs.append(x)
        return tuple(outs)
