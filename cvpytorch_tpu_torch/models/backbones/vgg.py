"""VGG (counterpart of ``cvpytorch_tpu/models/backbones/vgg.py``), NCHW:
Simonyan & Zisserman, arXiv:1409.1556.

vgg11/13/16/19, each with and without ``_bn``.  Group 0 (its convs and
the first 2×2 max pool) is the reference's ``conv1``; groups 1–4 are
captured before their trailing pool, so ``out_stages`` index the widths
(64, 128, 256, 512, 512) and ``(3,)`` is conv4_3 at stride 8 (OpenPose);
the groups after the last captured one are not run.
Convolutions keep their bias in the ``_bn`` variants too.  BN is torch
momentum 0.1, eps 1e-5 (flax momentum 0.9).  Blocks are attributes
``stage{g}_conv{b}`` with ``conv`` (and ``bn``), the Flax tree's names;
``classifier=True`` adds the 7×7 average pool and ``fc1``–``fc3``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import BatchNorm2d

_CFGS = {
    "vgg11": (1, 1, 2, 2, 2),
    "vgg13": (2, 2, 2, 2, 2),
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}
_CHS = (64, 128, 256, 512, 512)


def _adaptive_avg_pool(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Mean over equal (H/th, W/tw) blocks; H and W must divide."""
    B, C, H, W = x.shape
    if H % th or W % tw:
        raise ValueError(f"{H}×{W} does not divide into {th}×{tw} blocks")
    return x.reshape(B, C, th, H // th, tw, W // tw).mean((3, 5))


class _ConvAct(nn.Module):
    """3×3 conv with bias, BN when ``use_bn``, ReLU."""

    def __init__(self, cin: int, cout: int, use_bn: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, 1, 1)
        self.bn = BatchNorm2d(cout, eps=1e-5, momentum=0.1) if use_bn else None

    def forward(self, x):
        x = self.conv(x)
        return F.relu(self.bn(x) if self.bn is not None else x)


@BACKBONES.register(name="VGG", aliases=("vgg",))
class VGG(nn.Module):
    """NCHW images → the tuple of the ``out_stages`` features, or class
    logits with ``classifier``.  ``pretrained`` is accepted for the
    configs and unused."""

    def __init__(self, subtype: str = "vgg16_bn", out_stages: Sequence[int] = (2, 3, 4),
                 classifier: bool = False, num_classes: int = 1000, dropout: float = 0.5,
                 pretrained: bool = False):
        super().__init__()
        reps = _CFGS[subtype.replace("_bn", "")]
        use_bn = subtype.endswith("_bn")
        self.out_stages = tuple(out_stages)
        self.classifier = classifier
        # the captured groups' widths, in the order they are returned
        self.out_channels = [_CHS[si] for si in range(1, 5) if si in self.out_stages]
        self.names = []  # the block names of each group
        cin = 3
        for si, n in enumerate(reps):
            names = []
            for bi in range(n):
                name = f"stage{si}_conv{bi}"
                setattr(self, name, _ConvAct(cin, _CHS[si], use_bn))
                names.append(name)
                cin = _CHS[si]
            self.names.append(names)
        if classifier:
            self.fc1 = nn.Linear(512 * 7 * 7, 4096)
            self.fc2 = nn.Linear(4096, 4096)
            self.fc3 = nn.Linear(4096, num_classes)
            self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        feats = []
        for si, names in enumerate(self.names):
            if not self.classifier and len(feats) == len(self.out_channels):
                break  # the later groups feed nothing (their weights carry all the same)
            for name in names:
                x = getattr(self, name)(x)
            if si in self.out_stages and si > 0 and not self.classifier:
                feats.append(x)  # before the pool
            x = F.max_pool2d(x, 2, 2)
        if self.classifier:
            # flatten in the JAX tree's (h, w, c) order, so that fc1 carries
            x = _adaptive_avg_pool(x, 7, 7).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = self.dropout(F.relu(self.fc1(x)))
            x = self.dropout(F.relu(self.fc2(x)))
            return self.fc3(x)
        return tuple(feats)
