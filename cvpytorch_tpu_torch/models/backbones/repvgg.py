"""RepVGG (counterpart of ``cvpytorch_tpu/models/backbones/repvgg.py``),
NCHW: Ding et al., arXiv:2101.03697; NanoDet's RepVGG-A0 backbone, and
the block of YOLOv6's EfficientRep and RepBiPAN.

``RepVGGBlock`` in train form sums three branches, ``conv3``/``bn3``
(3×3), ``conv1``/``bn1`` (1×1, same stride) and, where the stride is 1
and the channels stay, ``bnid`` (BN of the input), then ReLU.  With
``deploy`` it is one 3×3 convolution with bias, ``reparam``, then ReLU;
``fuse_repvgg_kernel`` folds a trained block's three branches and their
BN statistics into that kernel and bias (eval mode: fused equals
unfused).  BN defaults to torch momentum 0.1, eps 1e-5; YOLOv6 passes
0.03 and 1e-3.

``RepVGG`` stages: the stem (min(64, width of stage 1), stride 2) and
four stages whose first block halves the map; the gN variants group the
convolutions of the layers in ``_G_LAYERS``.  As in the JAX module (and
the reference it follows), stage 4 is always 512 wide.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import BatchNorm2d

_G_LAYERS = (2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26)

_SPECS = {  # blocks per stage, width multipliers, groups of the _G_LAYERS
    "repvgg_a0": ((2, 4, 14, 1), (0.75, 0.75, 0.75, 2.5), 1),
    "repvgg_a1": ((2, 4, 14, 1), (1.0, 1.0, 1.0, 2.5), 1),
    "repvgg_a2": ((2, 4, 14, 1), (1.5, 1.5, 1.5, 2.75), 1),
    "repvgg_b0": ((4, 6, 16, 1), (1.0, 1.0, 1.0, 2.5), 1),
    "repvgg_b1": ((4, 6, 16, 1), (2.0, 2.0, 2.0, 4.0), 1),
    "repvgg_b1g2": ((4, 6, 16, 1), (2.0, 2.0, 2.0, 4.0), 2),
    "repvgg_b1g4": ((4, 6, 16, 1), (2.0, 2.0, 2.0, 4.0), 4),
    "repvgg_b2": ((4, 6, 16, 1), (2.5, 2.5, 2.5, 5.0), 1),
    "repvgg_b2g2": ((4, 6, 16, 1), (2.5, 2.5, 2.5, 5.0), 2),
    "repvgg_b2g4": ((4, 6, 16, 1), (2.5, 2.5, 2.5, 5.0), 4),
    "repvgg_b3": ((4, 6, 16, 1), (3.0, 3.0, 3.0, 5.0), 1),
    "repvgg_b3g2": ((4, 6, 16, 1), (3.0, 3.0, 3.0, 5.0), 2),
    "repvgg_b3g4": ((4, 6, 16, 1), (3.0, 3.0, 3.0, 5.0), 4),
}
_BASE = (64, 128, 256, 512)


class RepVGGBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 deploy: bool = False, groups: int = 1, bn_momentum: float = 0.1,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.reparam = nn.Conv2d(in_channels, out_channels, 3, stride, 1, groups=groups)
            return
        self.conv3 = nn.Conv2d(in_channels, out_channels, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn3 = BatchNorm2d(out_channels, eps=bn_eps, momentum=bn_momentum)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1, stride, 0, groups=groups,
                               bias=False)
        self.bn1 = BatchNorm2d(out_channels, eps=bn_eps, momentum=bn_momentum)
        if stride == 1 and in_channels == out_channels:
            self.bnid = BatchNorm2d(in_channels, eps=bn_eps, momentum=bn_momentum)

    def forward(self, x):
        if self.deploy:
            return F.relu(self.reparam(x))
        out = self.bn3(self.conv3(x)) + self.bn1(self.conv1(x))
        if hasattr(self, "bnid"):
            out = out + self.bnid(x)
        return F.relu(out)


@torch.no_grad()
def fuse_repvgg_kernel(block: RepVGGBlock):
    """(weight (O, I/g, 3, 3), bias (O,)) of the one 3×3 convolution that
    computes the train-form ``block`` in eval mode: each branch's kernel
    scaled by its BN's γ/√(var + eps), the 1×1 kernel and the identity
    (1 at the centre of each channel's own input) padded to 3×3, the
    biases β − mean·γ/√(var + eps) summed."""
    def fold(kernel, bn):
        std = torch.sqrt(bn.running_var + bn.eps)
        return kernel * (bn.weight / std)[:, None, None, None], bn.bias - bn.running_mean * bn.weight / std

    k3, b3 = fold(block.conv3.weight, block.bn3)
    k1, b1 = fold(F.pad(block.conv1.weight, (1, 1, 1, 1)), block.bn1)
    weight, bias = k3 + k1, b3 + b1
    if hasattr(block, "bnid"):
        out_ch, in_per_group = k3.shape[:2]
        kid = torch.zeros_like(k3)
        kid[torch.arange(out_ch), torch.arange(out_ch) % in_per_group, 1, 1] = 1.0
        kid, bid = fold(kid, block.bnid)
        weight, bias = weight + kid, bias + bid
    return weight, bias


@BACKBONES.register(name="RepVGG", aliases=("repvgg",))
class RepVGG(nn.Module):
    """NCHW images → the tuple of the ``out_stages`` features (1-based
    stages; ``out_channels`` their widths), or class logits with
    ``classifier``.  ``pretrained`` is accepted for the configs and
    unused."""

    def __init__(self, subtype: str = "RepVGG-A0", out_stages: Sequence[int] = (2, 3, 4),
                 classifier: bool = False, num_classes: int = 1000, deploy: bool = False,
                 pretrained: bool = False):
        super().__init__()
        blocks, widths, g = _SPECS[subtype.lower().replace("-", "_")]
        chs = [int(b * w) for b, w in zip(_BASE, widths)]
        chs[3] = 512
        self.out_stages, self.classifier = tuple(out_stages), classifier
        self.stem = RepVGGBlock(3, min(64, chs[0]), 2, deploy)
        cin, layer_idx, self.stages = min(64, chs[0]), 1, []
        for si, (n, ch) in enumerate(zip(blocks, chs), start=1):
            names = []
            for j in range(n):
                groups = g if (g > 1 and layer_idx in _G_LAYERS) else 1
                setattr(self, f"stage{si}_block{j}",
                        RepVGGBlock(cin, ch, 2 if j == 0 else 1, deploy, groups=groups))
                names.append(f"stage{si}_block{j}")
                cin, layer_idx = ch, layer_idx + 1
            self.stages.append(names)
        self.out_channels = [chs[s - 1] for s in self.out_stages]
        if classifier:
            self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.stem(x)
        feats = []
        for si, names in enumerate(self.stages, start=1):
            for name in names:
                x = getattr(self, name)(x)
            if si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(x.mean((2, 3)))
        return tuple(feats)
