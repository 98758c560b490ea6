"""TopFormer and RegSeg, backbones and heads (counterparts of
``cvpytorch_tpu/models/backbones/seg_light.py``), NCHW, registered under
the JAX names and aliases: ``TopFormerBackbone``/``TopFormer_bb``
(``topformer_t/s/b``), ``TopFormerHead``, ``RegSegBackbone``/``RegSeg_bb``
and ``RegSegHead``.  Submodules carry the Flax names; BN is torch
momentum 0.1, eps 1e-5.  Each backbone lists the channels of what it
returns in ``out_channels``.

TopFormer: a token pyramid of MobileNetV2-style inverted residuals (plain
ReLU), the chosen levels block-mean pooled to the last level's
``((H − 1)//2 + 1, (W − 1)//2 + 1)`` and concatenated, 4 transformer
blocks (ReLU6; ``h_sigmoid`` is relu6(x + 3)/6), and a semantic injection
into each chosen level: relu(local) · resize(h_sigmoid(relu(act))) +
resize(relu(global)), each of ``out_ch`` channels.  ``out_stages`` are
0-based positions among the token levels (default (1, 2, 3)).  The
attention's channel c is head·key_dim + k, the logits scaled by
key_dim^-½ before the matmul; under autocast its softmax is float32
(JAX's is in the params' dtype).  The pooling needs sizes the target
divides and raises ``ValueError`` otherwise (JAX asserts), where
``F.adaptive_avg_pool2d`` would average overlapping windows.  The JAX
file's ``_MBBlock`` is called by nothing there and is not ported.

RegSeg (exp48_decoder26): D-blocks of a 1×1 ConvBNAct, grouped dilated
3×3 convs over channel slices (group width 16, BN after the concat), an
SE with ``in_channels // 4`` hidden units (the reference's quirk), a 1×1
ConvBN, and a shortcut that on stride 2 zero-pads odd sizes and averages
2×2 (a padded edge is divided by 4, where ``avg_pool2d(ceil_mode=True)``
divides by the cells in bounds).  ``out_stages`` (1, 2, 3) pick the /4,
/8 and /16 features; the legacy (2, 3, 4) means the same.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES, HEADS
from ..bricks import BatchNorm2d, ConvBNAct
from ..heads.seg_heads import resize_bilinear

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


class Conv2dBN(nn.Module):
    """conv ``c`` (no bias) + BN ``bn``."""

    def __init__(self, in_channels: int, out: int, ks: int = 1, stride: int = 1,
                 pad: int = 0, groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(in_channels, out, ks, stride, pad, groups=groups, bias=False)
        self.bn = BatchNorm2d(out, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return self.bn(self.c(x))


class TFInvRes(nn.Module):
    def __init__(self, inp: int, out: int, ks: int = 3, stride: int = 1, expand: int = 1):
        super().__init__()
        hid = int(round(inp * expand))
        self.residual = stride == 1 and inp == out
        layers = [Conv2dBN(inp, hid)] if expand != 1 else []
        layers += [Conv2dBN(hid, hid, ks, stride, ks // 2, groups=hid), Conv2dBN(hid, out)]
        self.n = len(layers)
        for i, layer in enumerate(layers):
            setattr(self, f"conv{i}", layer)

    def forward(self, x):
        h = x
        for i in range(self.n - 1):
            h = F.relu(getattr(self, f"conv{i}")(h))
        h = getattr(self, f"conv{self.n - 1}")(h)
        return x + h if self.residual else h


def h_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def block_mean(x, th: int, tw: int):
    """Mean of each of the th×tw blocks of the NCHW map ``x``."""
    B, C, H, W = x.shape
    if H % th or W % tw:
        raise ValueError(f"TopFormer pools a {H}x{W} map to {th}x{tw}, which does not divide it")
    return x.reshape(B, C, th, H // th, tw, W // tw).mean((3, 5))


class TFAttention(nn.Module):
    def __init__(self, dim: int, key_dim: int = 16, heads: int = 4, attn_ratio: int = 2):
        super().__init__()
        self.key_dim, self.heads, self.d = key_dim, heads, attn_ratio * key_dim
        nh_kd, dh = key_dim * heads, self.d * heads
        self.to_q = Conv2dBN(dim, nh_kd)
        self.to_k = Conv2dBN(dim, nh_kd)
        self.to_v = Conv2dBN(dim, dh)
        self.proj = Conv2dBN(dh, dim)

    def forward(self, x):
        B, C, H, W = x.shape
        q = self.to_q(x).reshape(B, self.heads, self.key_dim, H * W).transpose(2, 3)
        k = self.to_k(x).reshape(B, self.heads, self.key_dim, H * W)
        v = self.to_v(x).reshape(B, self.heads, self.d, H * W).transpose(2, 3)
        attn = torch.softmax((q * self.key_dim ** -0.5) @ k, -1)
        xx = (attn @ v).transpose(2, 3).reshape(B, self.heads * self.d, H, W)
        return self.proj(F.relu6(xx))


class TFBlock(nn.Module):
    def __init__(self, dim: int, key_dim: int, heads: int, mlp_ratio: int = 2,
                 attn_ratio: int = 2):
        super().__init__()
        hid = dim * mlp_ratio
        self.attn = TFAttention(dim, key_dim, heads, attn_ratio)
        self.fc1 = Conv2dBN(dim, hid)
        self.dwconv = nn.Conv2d(hid, hid, 3, padding=1, groups=hid)
        self.fc2 = Conv2dBN(hid, dim)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.fc2(F.relu6(self.dwconv(self.fc1(x))))


TF_CFGS = {
    # (k, t, c, s) rows; channels; out_channels; token indices; heads
    "topformer_t": ([[3, 1, 16, 1], [3, 4, 16, 2], [3, 3, 16, 1],
                     [5, 3, 32, 2], [5, 3, 32, 1], [3, 3, 64, 2],
                     [3, 3, 64, 1], [5, 6, 96, 2], [5, 6, 96, 1]],
                    (16, 32, 64, 96), 128, (2, 4, 6, 8), 4),
    "topformer_s": ([[3, 1, 16, 1], [3, 4, 24, 2], [3, 3, 24, 1],
                     [5, 3, 48, 2], [5, 3, 48, 1], [3, 3, 96, 2],
                     [3, 3, 96, 1], [5, 6, 128, 2], [5, 6, 128, 1],
                     [3, 6, 128, 1]],
                    (24, 48, 96, 128), 192, (2, 4, 6, 9), 6),
    "topformer_b": ([[3, 1, 16, 1], [3, 4, 32, 2], [3, 3, 32, 1],
                     [5, 3, 64, 2], [5, 3, 64, 1], [3, 3, 128, 2],
                     [3, 3, 128, 1], [5, 6, 160, 2], [5, 6, 160, 1],
                     [3, 6, 160, 1]],
                    (32, 64, 128, 160), 256, (2, 4, 6, 9), 8),
}


@BACKBONES.register(name="TopFormerBackbone", aliases=("TopFormer_bb",))
class TopFormerBackbone(nn.Module):
    def __init__(self, subtype: str = "topformer_t", out_stages: Sequence[int] = (1, 2, 3),
                 classifier: bool = False, num_classes: int = 1000):
        super().__init__()
        cfgs, channels, out_ch, self.token_idx, heads = TF_CFGS[subtype]
        self.channels = list(channels)
        self.positions = [i for i in range(len(channels)) if i in out_stages]
        self.out_channels = [out_ch] * len(self.positions)
        self.classifier = classifier
        self.n_layers = len(cfgs)
        self.stem = Conv2dBN(3, 16, 3, 2, 1)
        cin = 16
        for i, (k, t, c, s) in enumerate(cfgs):
            setattr(self, f"layer{i + 1}", TFInvRes(cin, c, k, s, t))
            cin = c
        embed = sum(channels)
        for bi in range(4):
            setattr(self, f"trans{bi}", TFBlock(embed, 16, heads))
        for i in self.positions:
            for part in ("local", "act", "global"):
                setattr(self, f"sim{i}_{part}", Conv2dBN(channels[i], out_ch))
        if classifier:
            self.fc = nn.Linear(out_ch, num_classes)

    def forward(self, x):
        x = F.relu(self.stem(x))
        tokens = []
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.token_idx:
                tokens.append(x)
        H, W = tokens[-1].shape[-2:]
        agg = torch.cat([block_mean(f, (H - 1) // 2 + 1, (W - 1) // 2 + 1) for f in tokens], 1)
        for bi in range(4):
            agg = getattr(self, f"trans{bi}")(agg)
        parts = torch.split(agg, self.channels, 1)
        outs = []
        for i in self.positions:
            size = tokens[i].shape[-2:]
            local = F.relu(getattr(self, f"sim{i}_local")(tokens[i]))
            act = F.relu(getattr(self, f"sim{i}_act")(parts[i]))
            glob = F.relu(getattr(self, f"sim{i}_global")(parts[i]))
            outs.append(local * resize_bilinear(h_sigmoid(act), size)
                        + resize_bilinear(glob, size))
        if self.classifier:
            return self.fc(outs[-1].mean((2, 3)))
        return tuple(outs)


@HEADS.register(name="TopFormerHead")
class TopFormerHead(nn.Module):
    """The levels (all of ``in_channels[0]`` channels) summed at level 0's
    size, a 1×1 ``fuse`` ConvBNAct, dropout and a 1×1 ``cls``."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 96, dropout: float = 0.1):
        super().__init__()
        self.fuse = ConvBNAct(in_channels[0], channels, 1, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        size = feats[0].shape[-2:]
        acc = feats[0]
        for f in feats[1:]:
            acc = acc + resize_bilinear(f, size)
        return self.cls(self.dropout(self.fuse(acc)))


class DBlock(nn.Module):
    def __init__(self, in_channels: int, out: int, stride: int = 1,
                 dilations: Sequence[int] = (1,), group_width: int = 16):
        super().__init__()
        self.stride = stride
        self.temp = out // len(dilations)
        self.dilations = tuple(dilations)
        self.conv1 = ConvBNAct(in_channels, out, 1, **_BN)
        for i, d in enumerate(self.dilations):
            setattr(self, f"conv2_{i}", nn.Conv2d(
                self.temp, self.temp, 3, stride, d, d, self.temp // group_width, bias=False))
        self.bn2 = BatchNorm2d(self.temp * len(self.dilations), eps=1e-5, momentum=0.1)
        mid = max(in_channels // 4, 1)
        self.se_fc1 = nn.Conv2d(out, mid, 1)
        self.se_fc2 = nn.Conv2d(mid, out, 1)
        self.conv3 = ConvBNAct(out, out, 1, act=None, **_BN)
        self.identity = stride == 1 and in_channels == out
        if not self.identity:
            self.shortcut = ConvBNAct(in_channels, out, 1, act=None, **_BN)

    def forward(self, x):
        h = self.conv1(x)
        t = self.temp
        h = torch.cat([getattr(self, f"conv2_{i}")(h[:, i * t:(i + 1) * t])
                       for i in range(len(self.dilations))], 1)
        h = F.relu(self.bn2(h))
        g = torch.sigmoid(self.se_fc2(F.relu(self.se_fc1(h.mean((2, 3), keepdim=True)))))
        h = self.conv3(h * g)
        if self.identity:
            return F.relu(h + x)
        skip = x
        if self.stride != 1:
            skip = F.avg_pool2d(F.pad(skip, (0, skip.shape[-1] % 2, 0, skip.shape[-2] % 2)), 2, 2)
        return F.relu(h + self.shortcut(skip))


REGSEG_STAGE3 = [[1], [1, 2]] + 4 * [[1, 4]] + 7 * [[1, 14]]  # dilations after stage3_0
REGSEG_CHANNELS = (48, 128, 320)  # of the /4, /8 and /16 features


@BACKBONES.register(name="RegSegBackbone", aliases=("RegSeg_bb",))
class RegSegBackbone(nn.Module):
    def __init__(self, out_stages: Sequence[int] = (1, 2, 3), classifier: bool = False,
                 num_classes: int = 1000):
        super().__init__()
        self.stages = tuple(s - 1 for s in out_stages) if min(out_stages) >= 2 \
            else tuple(out_stages)
        self.out_channels = [c for s, c in enumerate(REGSEG_CHANNELS, 1) if s in self.stages]
        self.classifier = classifier
        self.stem = ConvBNAct(3, 32, 3, 2, **_BN)
        self.stage1 = DBlock(32, 48, stride=2)
        self.stage2_0 = DBlock(48, 128, stride=2)
        self.stage2_1 = DBlock(128, 128)
        self.stage2_2 = DBlock(128, 128)
        self.stage3_0 = DBlock(128, 256, stride=2)
        last = len(REGSEG_STAGE3)
        for i, d in enumerate(REGSEG_STAGE3, 1):
            setattr(self, f"stage3_{i}", DBlock(256, 320 if i == last else 256, dilations=d))
        if classifier:
            self.fc = nn.Linear(320, num_classes)

    def forward(self, x):
        feats = []
        x = self.stage1(self.stem(x))
        if 1 in self.stages:
            feats.append(x)
        x = self.stage2_2(self.stage2_1(self.stage2_0(x)))
        if 2 in self.stages:
            feats.append(x)
        for i in range(len(REGSEG_STAGE3) + 1):
            x = getattr(self, f"stage3_{i}")(x)
        if 3 in self.stages:
            feats.append(x)
        if self.classifier:
            return self.fc(x.mean((2, 3)))
        return tuple(feats)


@HEADS.register(name="RegSegHead")
class RegSegHead(nn.Module):
    """decoder26 on (x4, x8, x16): 1×1 embeds of ``mid_channels`` (8, 128,
    128), y8 + resize(y16) through a 3×3 ``conv8``, [resize(y8), y4]
    through a 3×3 ``conv4``, dropout and a 1×1 ``cls``."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 19,
                 channels: int = 64, mid_channels: Sequence[int] = (8, 128),
                 dropout: float = 0.1):
        super().__init__()
        c4, c8, c16 = in_channels
        m4, m8 = mid_channels
        self.head16 = ConvBNAct(c16, m8, 1, **_BN)
        self.head8 = ConvBNAct(c8, m8, 1, **_BN)
        self.head4 = ConvBNAct(c4, m4, 1, **_BN)
        self.conv8 = ConvBNAct(m8, channels, 3, **_BN)
        self.conv4 = ConvBNAct(channels + m4, channels, 3, **_BN)
        self.dropout = nn.Dropout(dropout)
        self.cls = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        x4, x8, x16 = feats
        y8 = self.head8(x8)
        y8 = self.conv8(y8 + resize_bilinear(self.head16(x16), y8.shape[-2:]))
        y4 = self.head4(x4)
        y4 = self.conv4(torch.cat([resize_bilinear(y8, y4.shape[-2:]), y4], 1))
        return self.cls(self.dropout(y4))
