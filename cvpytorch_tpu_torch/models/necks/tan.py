"""TAN, the Transformer Attention Network neck of NanoDet-t (counterpart
of ``cvpytorch_tpu/models/necks/tan.py``), NCHW.

Three 1×1 ``lateral{i}`` ConvBNActs (leaky ReLU 0.1); levels 0 and 2
resized (bilinear, no antialias) to the middle level's size and
concatenated with it; ``tf_proj`` (1×1, ReLU) to ``out_channels``; the
learned ``pos_embed`` (kept in the Flax layout (1, fh, fw, C), bilinearly
resized when the map is not ``feature_hw``) added; ``num_encoders``
pre-LN encoder layers over the middle level's tokens in row-major (y, x)
order; the result added back to every lateral, resized to its size.

The encoder's attention is Flax's ``nn.MultiHeadDotProductAttention``,
computed in plain ops: ``query``/``key``/``value`` project to H heads of
C/H (``MultiHeadDense``), the query is scaled by 1/√(C/H), the softmax of
the logits weighs the values, ``out`` merges the heads.  In train mode
the attention weights are dropped at ``dropout_ratio`` with one mask of
(tokens, tokens) shared by every image and head (Flax's broadcast
dropout), kept ones scaled by 1/(1 − rate), the mask drawn from torch's
generator of the device, as ``DropPath`` draws.  LayerNorm eps is Flax's
1e-6; the MLP's activation is leaky ReLU (0.1).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...registry import NECKS
from ..bricks import ConvBNAct, MultiHeadDense, get_activation
from .pan import resize_bilinear

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        self.query = MultiHeadDense(dim, dim, num_heads, "heads")
        self.key = MultiHeadDense(dim, dim, num_heads, "heads")
        self.value = MultiHeadDense(dim, dim, num_heads, "heads")
        self.out = MultiHeadDense(dim, dim, num_heads, "merge")

    def forward(self, x):
        b, n, c = x.shape
        heads = lambda t: t.reshape(b, n, self.num_heads, c // self.num_heads)
        q = heads(self.query(x)) / math.sqrt(c // self.num_heads)
        k, v = heads(self.key(x)), heads(self.value(x))
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        if self.training and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            mask = torch.empty((n, n), device=x.device).bernoulli_(keep)
            weights = weights * (mask / keep).to(weights.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(y.reshape(b, n, c))


class TransformerEncoderLayer(nn.Module):
    """Pre-LN: x + attn(norm1(x)), then + fc2(act(fc1(norm2(x))))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dropout_ratio: float = 0.0, mlp_act: str = "gelu"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, num_heads, dropout_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)
        self.act = get_activation(mlp_act)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))


@NECKS.register(name="TAN")
class TAN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 128,
                 feature_hw: Sequence[int] = (20, 20), num_heads: int = 8,
                 num_encoders: int = 1, mlp_ratio: int = 4, dropout_ratio: float = 0.1):
        super().__init__()
        if len(in_channels) != 3:
            raise ValueError("TAN takes exactly 3 input levels")
        self.num_encoders, self.feature_hw = num_encoders, tuple(feature_hw)
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", ConvBNAct(c, out_channels, 1, act="leaky_relu", **_BN))
        self.tf_proj = ConvBNAct(3 * out_channels, out_channels, 1, act="relu", **_BN)
        self.pos_embed = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, *self.feature_hw, out_channels), std=0.02))
        for i in range(num_encoders):
            setattr(self, f"encoder{i}", TransformerEncoderLayer(
                out_channels, num_heads, mlp_ratio, dropout_ratio, mlp_act="leaky_relu"))

    def forward(self, feats):
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        mid_hw = laterals[1].shape[2:]
        x = self.tf_proj(torch.cat([resize_bilinear(laterals[0], mid_hw), laterals[1],
                                    resize_bilinear(laterals[2], mid_hw)], 1))
        b, c, h, w = x.shape
        pos = self.pos_embed
        if self.feature_hw != (h, w):
            pos = resize_bilinear(pos.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
        tokens = (x.permute(0, 2, 3, 1) + pos).reshape(b, h * w, c)
        for i in range(self.num_encoders):
            tokens = getattr(self, f"encoder{i}")(tokens)
        mid = tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return (laterals[0] + resize_bilinear(mid, laterals[0].shape[2:]),
                laterals[1] + mid,
                laterals[2] + resize_bilinear(mid, laterals[2].shape[2:]))
