"""EfficientNet-Lite (counterpart of
``cvpytorch_tpu/models/backbones/efficientnet_lite.py``), NCHW: NanoDet's
variant, MBConv blocks without squeeze-excitation, ReLU6 everywhere.

The ``stem`` (3×3/2, 32 channels, not width-scaled) and seven stages of
``stage{i}_block{b}`` MBConvs (``expand`` 1×1 unless the expansion is 1,
``dw`` k×k depthwise at the stage's stride on its first block,
``project`` 1×1 without activation, the input added where the stride is
1 and the width stays).  Widths are ``_round_filters``' (multiples of 8,
at least 90 % of the scaled width); the first and last stages keep their
depth, the others take ⌈repeats · depth multiplier⌉.  BN is torch
momentum 0.01, eps 1e-3 (flax momentum 0.99).
"""
from __future__ import annotations

import math
from typing import Sequence

from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct

_BN = dict(bn_momentum=0.01, bn_eps=1e-3)

_PARAMS = {  # width multiplier, depth multiplier
    "efficientnet_lite0": (1.0, 1.0),
    "efficientnet_lite1": (1.0, 1.1),
    "efficientnet_lite2": (1.1, 1.2),
    "efficientnet_lite3": (1.2, 1.4),
    "efficientnet_lite4": (1.4, 1.8),
}

# repeats, kernel, stride, expansion, output width
_STAGES = ((1, 3, 1, 1, 16), (2, 3, 2, 6, 24), (2, 5, 2, 6, 40), (3, 3, 2, 6, 80),
           (3, 5, 1, 6, 112), (4, 5, 2, 6, 192), (1, 3, 1, 6, 320))


def _round_filters(filters, mult, divisor=8):
    filters *= mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


class MBConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 expand: int):
        super().__init__()
        mid = in_channels * expand
        self.residual = stride == 1 and in_channels == out_channels
        if expand != 1:
            self.expand = ConvBNAct(in_channels, mid, 1, act="relu6", **_BN)
        self.dw = ConvBNAct(mid, mid, kernel, stride, groups=mid, act="relu6", **_BN)
        self.project = ConvBNAct(mid, out_channels, 1, act=None, **_BN)

    def forward(self, x):
        y = self.expand(x) if hasattr(self, "expand") else x
        y = self.project(self.dw(y))
        return x + y if self.residual else y


@BACKBONES.register(name="EfficientNetLite", aliases=("efficientnet_lite",))
class EfficientNetLite(nn.Module):
    """NCHW images → the tuple of the ``out_stages`` features (stages 0–6;
    ``out_channels`` their widths), or class logits with ``classifier``
    (``head`` 1×1 to 1280, mean, ``fc``)."""

    def __init__(self, subtype: str = "efficientnet_lite0", out_stages: Sequence[int] = (2, 4, 6),
                 classifier: bool = False, num_classes: int = 1000, output_stride: int = 32,
                 pretrained: bool = False):
        super().__init__()
        wm, dm = _PARAMS[subtype]
        self.out_stages, self.classifier = tuple(out_stages), classifier
        self.stem = ConvBNAct(3, 32, 3, 2, act="relu6", **_BN)
        cin, self.stages, widths = 32, [], []
        for i, (rep, k, s, e, cout) in enumerate(_STAGES):
            cout = _round_filters(cout, wm)
            rep = rep if i in (0, len(_STAGES) - 1) else int(math.ceil(rep * dm))
            names = []
            for bi in range(rep):
                setattr(self, f"stage{i}_block{bi}", MBConv(cin, cout, k, s if bi == 0 else 1, e))
                names.append(f"stage{i}_block{bi}")
                cin = cout
            self.stages.append(names)
            widths.append(cout)
        self.out_channels = [widths[i] for i in self.out_stages]
        if classifier:
            self.head = ConvBNAct(cin, 1280, 1, act="relu6", **_BN)
            self.fc = nn.Linear(1280, num_classes)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(self.head(x).mean((2, 3)))
        return tuple(feats)
