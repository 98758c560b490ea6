"""ShuffleNetV2 (counterpart of ``cvpytorch_tpu/models/backbones/shufflenetv2.py``),
NCHW: Ma et al., arXiv:1807.11164; the NanoDet-Plus backbone.

Subtypes x0.5, x1.0, x1.5 and x2.0; ``act`` is ``relu`` or NanoDet's
``leaky_relu`` (slope 0.1).  The stem's 3×3/2 max-pool pads with −inf on
both sides.  A stride-2 unit's two branches both see the whole input; a
stride-1 unit splits the channels in halves and convolves the second;
the depthwise convolutions of either branch have no activation.  Units
are attributes ``stage{s}_unit{u}`` with ``b1_dw``, ``b1_pw``,
``b2_pw1``, ``b2_dw``, ``b2_pw2``, the Flax tree's names.  BN is torch
momentum 0.1, eps 1e-5 (flax momentum 0.9).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct

_STAGE_CH = {
    "shufflenetv2_x0.5": (24, 48, 96, 192, 1024),
    "shufflenetv2_x1.0": (24, 116, 232, 464, 1024),
    "shufflenetv2_x1.5": (24, 176, 352, 704, 1024),
    "shufflenetv2_x2.0": (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)
_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


def channel_shuffle(x, groups: int = 2):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


class ShuffleUnit(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 act: str = "relu"):
        super().__init__()
        branch = out_channels // 2
        self.stride = stride
        if stride > 1:
            self.b1_dw = ConvBNAct(in_channels, in_channels, 3, stride, groups=in_channels,
                                   act=None, **_BN)
            self.b1_pw = ConvBNAct(in_channels, branch, 1, act=act, **_BN)
        b2_in = in_channels if stride > 1 else in_channels // 2
        self.b2_pw1 = ConvBNAct(b2_in, branch, 1, act=act, **_BN)
        self.b2_dw = ConvBNAct(branch, branch, 3, stride, groups=branch, act=None, **_BN)
        self.b2_pw2 = ConvBNAct(branch, branch, 1, act=act, **_BN)

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
        else:
            x1, x2 = self.b1_pw(self.b1_dw(x)), x
        y2 = self.b2_pw2(self.b2_dw(self.b2_pw1(x2)))
        return channel_shuffle(torch.cat([x1, y2], 1))


@BACKBONES.register(name="ShuffleNetV2", aliases=("shufflenetv2",))
class ShuffleNetV2(nn.Module):
    """NCHW images → the tuple of the ``out_stages`` features (stages 2–4;
    ``channels[s - 1]`` is stage s's width), or class logits with
    ``classifier``.  ``pretrained`` is accepted for the configs and
    unused."""

    def __init__(self, subtype: str = "shufflenetv2_x1.0",
                 out_stages: Sequence[int] = (2, 3, 4), classifier: bool = False,
                 num_classes: int = 1000, act: str = "relu",
                 with_last_conv: bool = False, pretrained: bool = False):
        super().__init__()
        chs = _STAGE_CH[subtype]
        self.out_stages = tuple(out_stages)
        self.classifier = classifier
        self.stem = ConvBNAct(3, chs[0], 3, 2, act=act, **_BN)
        self.stages = []  # (stage, unit names)
        cin = chs[0]
        for si, (reps, out_ch) in enumerate(zip(_REPEATS, chs[1:4]), start=2):
            names = []
            for ui in range(reps):
                name = f"stage{si}_unit{ui}"
                setattr(self, name, ShuffleUnit(cin, out_ch, 2 if ui == 0 else 1, act))
                names.append(name)
                cin = out_ch
            self.stages.append((si, names))
        self.channels = list(chs[:4])
        if with_last_conv or classifier:
            self.last_conv = ConvBNAct(cin, chs[4], 1, act=act, **_BN)
            self.channels[3] = cin = chs[4]
        if classifier:
            self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        feats = []
        for si, names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            if si == 4 and hasattr(self, "last_conv"):
                x = self.last_conv(x)
            if si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(x.mean((2, 3)))
        return tuple(feats)
