"""TinyNet (counterpart of ``cvpytorch_tpu/models/backbones/tinynet.py``):
three stride-2 3×3 ``ConvBNAct`` stages (BN torch momentum 0.2, eps 1e-5)
for smoke tests, a classifier (global mean, ``fc``) or the ``out_stages``
features."""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...registry import BACKBONES
from ..bricks import ConvBNAct


@BACKBONES.register(name="TinyNet")
class TinyNet(nn.Module):
    def __init__(self, subtype: str = "tiny", widths: Sequence[int] = (16, 32, 64),
                 out_stages: Sequence[int] = (1, 2, 3), classifier: bool = False,
                 num_classes: int = 1000, pretrained: bool = False, in_channels: int = 3):
        super().__init__()
        self.out_stages, self.classifier = tuple(out_stages), classifier
        self.channels = tuple(widths)
        cin = in_channels
        for i, ch in enumerate(widths, start=1):
            setattr(self, f"stage{i}", ConvBNAct(cin, ch, 3, 2, act="relu",
                                                 bn_momentum=0.2, bn_eps=1e-5))
            cin = ch
        if classifier:
            self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        feats = []
        for i in range(1, len(self.channels) + 1):
            x = getattr(self, f"stage{i}")(x)
            if i in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(x.mean((2, 3)))
        return tuple(feats)
