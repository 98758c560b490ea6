"""ResNet family (counterpart of ``cvpytorch_tpu/models/backbones/resnet.py``),
NCHW.

resnet18/34/50/101/152 and the ResNeXt/wide variants (their subtype
names set the groups and base width); ``output_stride`` 16 or 8 trades
the stride of the last stages for dilation; a ``v1c``/``v1d`` suffix
selects the deep stem (three 3×3 convs); ``classifier`` ends in global
pooling and ``fc``.  BN is torch momentum 0.1, eps 1e-5 (flax momentum
0.9).  The stem's 3×3/2 max-pool pads with −inf, as ``nn.max_pool``
does.

Blocks are attributes ``layer{stage}_block{i}`` and their layers carry the
Flax names (``conv1``, ``bn1``, …, ``ds_conv``, ``ds_bn``), so parameter
names join to the JAX tree's paths.  ``rfp_in_channels`` ({stage: width})
adds the DetectoRS hook the RFP neck (``necks/rfp.py``) drives: a 1×1
``rfp_conv{stage}`` (kernel and bias zero at init, so the recursion starts
as the identity) of the fed feature, added after each fed stage's first
block when ``forward`` is given ``rfp_feats`` ({stage: NCHW feature}).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import BatchNorm2d

_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3)),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3)),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3)),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3)),
}


def _bn(channels: int) -> nn.BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _conv(cin, cout, k, stride=1, dilation=1, groups=1):
    pad = dilation if k == 3 else (k - 1) // 2
    return nn.Conv2d(cin, cout, k, stride, pad, dilation, groups, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, **_):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = _bn(planes)
        if downsample:
            self.ds_conv = _conv(inplanes, planes, 1, stride)
            self.ds_bn = _bn(planes)
        self.downsample = downsample

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * 4
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, width, 3, stride, dilation, groups)
        self.bn2 = _bn(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = _bn(out_ch)
        if downsample:
            self.ds_conv = _conv(inplanes, out_ch, 1, stride)
            self.ds_bn = _bn(out_ch)
        self.downsample = downsample

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(y + identity)


@BACKBONES.register(name="ResNet", aliases=("resnet",))
class ResNet(nn.Module):
    """NCHW images → the tuple of the ``out_stages`` features (1-based
    stage indices), or class logits with ``classifier``."""

    def __init__(self, subtype: str = "resnet50",
                 out_stages: Sequence[int] = (2, 3, 4),
                 classifier: bool = False, num_classes: int = 1000,
                 output_stride: int = 32, rfp_in_channels: dict | None = None):
        super().__init__()
        self.out_stages = tuple(out_stages)
        self.classifier = classifier
        self.deep_stem = subtype.endswith(("v1c", "v1d"))
        base = subtype[:-3] if self.deep_stem else subtype
        block_type, layers = _SPECS[base]
        groups, base_width = 1, 64
        if "resnext50" in subtype:
            groups, base_width = 32, 4
        elif "resnext101" in subtype:
            groups, base_width = 32, 8
        elif "wide_" in subtype:
            base_width = 128
        block = BasicBlock if block_type == "basic" else Bottleneck

        strides = [1, 2, 2, 2]
        dilations = [1, 1, 1, 1]
        if output_stride == 16:
            strides[3], dilations[3] = 1, 2
        elif output_stride == 8:
            strides[2], dilations[2] = 1, 2
            strides[3], dilations[3] = 1, 4

        if self.deep_stem:
            cin = 3
            for i, (ch, s) in enumerate(((32, 2), (32, 1), (64, 1))):
                setattr(self, f"stem_conv{i}", _conv(cin, ch, 3, s))
                setattr(self, f"stem_bn{i}", _bn(ch))
                cin = ch
        else:
            self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.stem_bn = _bn(64)

        self.blocks = []  # (stage, name) in order
        self.channels = []  # of each stage's output
        inplanes, planes = 64, 64
        for si, (n_blocks, stride, dilation) in enumerate(
                zip(layers, strides, dilations), start=1):
            for bi in range(n_blocks):
                first = bi == 0
                out_ch = planes * block.expansion
                need_ds = first and (stride != 1 or inplanes != out_ch)
                name = f"layer{si}_block{bi}"
                setattr(self, name, block(
                    inplanes, planes, stride if first else 1, dilation,
                    downsample=need_ds, groups=groups, base_width=base_width))
                self.blocks.append((si, name))
                inplanes = out_ch
            self.channels.append(inplanes)
            planes *= 2
        if classifier:
            self.fc = nn.Linear(inplanes, num_classes)
        for si, cin in (rfp_in_channels or {}).items():
            conv = nn.Conv2d(cin, self.channels[si - 1], 1)
            nn.init.zeros_(conv.weight)
            nn.init.zeros_(conv.bias)
            setattr(self, f"rfp_conv{si}", conv)

    def forward(self, x, rfp_feats=None):
        if self.deep_stem:
            for i in range(3):
                x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        else:
            x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i, (si, name) in enumerate(self.blocks):
            x = getattr(self, name)(x)
            if rfp_feats is not None and si in rfp_feats and name.endswith("_block0"):
                x = x + getattr(self, f"rfp_conv{si}")(rfp_feats[si])
            last_of_stage = i + 1 == len(self.blocks) or self.blocks[i + 1][0] != si
            if last_of_stage and si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(torch.mean(x, dim=(2, 3)))
        return tuple(feats)
