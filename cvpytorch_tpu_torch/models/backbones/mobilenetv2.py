"""MobileNetV2 (counterpart of ``cvpytorch_tpu/models/backbones/mobilenetv2.py``),
NCHW: Sandler et al., arXiv:1801.04381.

A classifier (``classifier=True``: ``head_conv``, global mean, dropout,
``fc`` → logits) or a feature extractor returning the outputs of the
block groups named by ``out_stages`` (1-based indices into the seven
groups of the paper's table 2).  BN is torch momentum 0.1, eps 1e-5
(flax momentum 0.9).  Blocks are attributes ``stage{g}_block{b}`` with
``expand``/``dw``/``project`` convolutions, the Flax tree's names.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct, make_divisible

# (expansion t, channels c, repeats n, stride s)
_INVERTED_RESIDUAL_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 expand_ratio: int):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        self.use_res = stride == 1 and in_channels == out_channels
        self.expand = (ConvBNAct(in_channels, hidden, 1, act="relu6", **_BN)
                       if expand_ratio != 1 else None)
        self.dw = ConvBNAct(hidden, hidden, 3, stride, groups=hidden, act="relu6", **_BN)
        self.project = ConvBNAct(hidden, out_channels, 1, act=None, **_BN)

    def forward(self, x):
        y = self.expand(x) if self.expand is not None else x
        y = self.project(self.dw(y))
        return x + y if self.use_res else y


@BACKBONES.register(name="MobileNetV2", aliases=("mobilenet_v2",))
class MobileNetV2(nn.Module):
    """NCHW images → the tuple of the ``out_stages`` features, or class
    logits with ``classifier``.  ``pretrained`` is accepted for the
    configs and unused (weights come from checkpoints)."""

    def __init__(self, subtype: str = "mobilenet_v2", width_mult: float = 1.0,
                 out_stages: Sequence[int] = (3, 5, 7), classifier: bool = False,
                 num_classes: int = 1000, dropout: float = 0.2, pretrained: bool = False):
        super().__init__()
        self.out_stages = tuple(out_stages)
        self.classifier = classifier
        cin = make_divisible(32 * width_mult)
        self.stem = ConvBNAct(3, cin, 3, 2, act="relu6", **_BN)
        self.groups = []  # the block names of each group
        self.channels = []  # each group's output channels
        for gi, (t, c, n, s) in enumerate(_INVERTED_RESIDUAL_CFG, start=1):
            out_ch = make_divisible(c * width_mult)
            names = []
            for bi in range(n):
                name = f"stage{gi}_block{bi}"
                setattr(self, name, InvertedResidual(cin, out_ch, s if bi == 0 else 1, t))
                names.append(name)
                cin = out_ch
            self.groups.append(names)
            self.channels.append(out_ch)
        if classifier:
            last_ch = make_divisible(1280 * max(width_mult, 1.0))
            self.head_conv = ConvBNAct(cin, last_ch, 1, act="relu6", **_BN)
            self.dropout = nn.Dropout(dropout)
            self.fc = nn.Linear(last_ch, num_classes)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for gi, names in enumerate(self.groups, start=1):
            for name in names:
                x = getattr(self, name)(x)
            if gi in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            x = self.head_conv(x).mean((2, 3))
            return self.fc(self.dropout(x))
        return tuple(feats)
