"""SqueezeNet 1.1, DenseNet and ViT (counterpart of
``cvpytorch_tpu/models/backbones/misc_backbones.py``), NCHW.

* SqueezeNet 1.1: a 3×3/2 unpadded stem + ReLU, then three layers, each a
  3×3/2 max pool in ceil mode (a padding column on the right and bottom,
  as the JAX module emulates it) and its Fire modules; the classifier is
  dropout, the 1×1 ``cls_conv``, ReLU and a global mean.
* DenseNet 121/161/169/201: a 7×7/2 stem and 3×3/2 max pool, dense
  blocks of BN-ReLU-1×1-BN-ReLU-3×3 layers, each stage's features taken
  after its transition (BN, ReLU, 1×1 halving the channels, 2×2 average
  pool); the last stage has no transition.  BN is torch momentum 0.1,
  eps 1e-5.  The classifier adds ``final_bn``, ReLU, a global mean and ``fc``.
* ViT: the JAX module's pre-LN encoder (LayerNorm eps 1e-6, Flax's;
  tanh GELU, Flax's default) with a class token and a learned position
  embedding.  The position embedding's length depends on the image size,
  which Flax reads off the input and the port takes as ``img_size``
  (default 224).  Classifier-first as in JAX: ``fc`` on the class token,
  or the patch tokens ``(B, N, C)`` as the one feature.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..bricks import BatchNorm2d, ConvBNAct, get_activation
from .convnext import same_pad


class Fire(nn.Module):
    def __init__(self, in_ch: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze, 1)
        self.e1 = nn.Conv2d(squeeze, expand, 1)
        self.e3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.e1(s)), torch.relu(self.e3(s))], 1)


def ceil_pool(x):
    """3×3/2 max pool over the map padded with -inf by one column and row
    at the end: ceil mode, exact for every size."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)


@BACKBONES.register(name="SqueezeNet", aliases=("squeezenet",))
class SqueezeNet(nn.Module):
    PLAN = ((16, 64, 2), (32, 128, 2), (48, 192, 2))

    def __init__(self, subtype: str = "squeezenet1_1", out_stages: Sequence[int] = (1, 2, 3),
                 classifier: bool = False, num_classes: int = 1000, pretrained: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.out_stages, self.classifier = tuple(out_stages), classifier
        self.stem = nn.Conv2d(in_channels, 64, 3, 2)
        cin, self.layers, self.channels = 64, [], []
        for si, (sq, ex, n) in enumerate(self.PLAN, start=1):
            names = [(f"layer{si}_fire{j}", sq, ex) for j in range(n)]
            if si == 3:
                names += [(f"layer3_fire{j + 2}", 64, 256) for j in range(2)]
            for name, s, e in names:
                setattr(self, name, Fire(cin, s, e))
                cin = 2 * e
            self.layers.append([name for name, _, _ in names])
            self.channels.append(cin)
        if classifier:
            self.dropout = nn.Dropout(0.5)
            self.cls_conv = nn.Conv2d(cin, num_classes, 1)

    def forward(self, x):
        x = torch.relu(self.stem(x))
        feats = []
        for si, names in enumerate(self.layers, start=1):
            x = ceil_pool(x)
            for name in names:
                x = getattr(self, name)(x)
            if si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return torch.relu(self.cls_conv(self.dropout(x))).mean((2, 3))
        return tuple(feats)


def _bn(channels: int):
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int):
        super().__init__()
        self.bn1 = _bn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
        self.bn2 = _bn(4 * growth)
        self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x):
        h = self.conv1(torch.relu(self.bn1(x)))
        h = self.conv2(torch.relu(self.bn2(h)))
        return torch.cat([x, h], 1)


@BACKBONES.register(name="DenseNet", aliases=("densenet",))
class DenseNet(nn.Module):
    CFGS = {"densenet121": (32, 64, (6, 12, 24, 16)),
            "densenet161": (48, 96, (6, 12, 36, 24)),
            "densenet169": (32, 64, (6, 12, 32, 32)),
            "densenet201": (32, 64, (6, 12, 48, 32))}

    def __init__(self, subtype: str = "densenet121", out_stages: Sequence[int] = (2, 3, 4),
                 classifier: bool = False, num_classes: int = 1000, pretrained: bool = False,
                 in_channels: int = 3):
        super().__init__()
        growth, stem_ch, self.reps = self.CFGS[subtype]
        self.out_stages, self.classifier = tuple(out_stages), classifier
        self.stem = ConvBNAct(in_channels, stem_ch, 7, 2, padding=3, act="relu",
                              bn_momentum=0.1, bn_eps=1e-5)
        cin, self.channels = stem_ch, []
        for si, n in enumerate(self.reps, start=1):
            for j in range(n):
                setattr(self, f"dense{si}_{j}", DenseLayer(cin, growth))
                cin += growth
            if si < len(self.reps):
                setattr(self, f"trans{si}_bn", _bn(cin))
                setattr(self, f"trans{si}_conv", nn.Conv2d(cin, cin // 2, 1, bias=False))
                cin //= 2
            self.channels.append(cin)
        if classifier:
            self.final_bn = _bn(cin)
            self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, padding=1)
        feats = []
        for si, n in enumerate(self.reps, start=1):
            for j in range(n):
                x = getattr(self, f"dense{si}_{j}")(x)
            if si < len(self.reps):
                x = torch.relu(getattr(self, f"trans{si}_bn")(x))
                x = F.avg_pool2d(getattr(self, f"trans{si}_conv")(x), 2, 2)
            if si in self.out_stages and not self.classifier:
                feats.append(x)
        if self.classifier:
            return self.fc(torch.relu(self.final_bn(x)).mean((2, 3)))
        return tuple(feats)


@BACKBONES.register(name="ViT", aliases=("VisionTransformer", "vit"))
class ViT(nn.Module):
    DIMS = {"vit_t_16": (192, 12, 3, 16), "vit_s_16": (384, 12, 6, 16),
            "vit_b_16": (768, 12, 12, 16), "vit_l_16": (1024, 24, 16, 16),
            "vit_b_32": (768, 12, 12, 32), "vit_l_32": (1024, 24, 16, 32)}

    def __init__(self, subtype: str = "vit_b_16", classifier: bool = True,
                 num_classes: int = 1000, out_stages: Sequence[int] = (),
                 dropout: float = 0.0, pretrained: bool = False, img_size: int = 224,
                 in_channels: int = 3):
        super().__init__()
        from ..necks.tan import MultiHeadAttention  # the necks import the backbones

        dim, self.depth, heads, self.patch = self.DIMS[subtype]
        self.classifier, self.channels = classifier, (dim,)
        self.patch_embed = nn.Conv2d(in_channels, dim, self.patch, self.patch)
        n = (-(-img_size // self.patch)) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.randn(1, n + 1, dim) * 0.02)
        self.dropout = nn.Dropout(dropout)
        for i in range(self.depth):
            setattr(self, f"ln1_{i}", nn.LayerNorm(dim, eps=1e-6))
            setattr(self, f"attn_{i}", MultiHeadAttention(dim, heads))
            setattr(self, f"ln2_{i}", nn.LayerNorm(dim, eps=1e-6))
            setattr(self, f"mlp1_{i}", nn.Linear(dim, 4 * dim))
            setattr(self, f"mlp2_{i}", nn.Linear(4 * dim, dim))
        self.final_ln = nn.LayerNorm(dim, eps=1e-6)
        self.act = get_activation("gelu")
        if classifier:
            self.fc = nn.Linear(dim, num_classes)

    def forward(self, x):
        x = self.patch_embed(same_pad(x, self.patch, self.patch))
        x = x.flatten(2).transpose(1, 2)  # (B, N, C), row-major patches
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype), x], 1)
        x = self.dropout(x + self.pos_embed)
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x))
            h = getattr(self, f"mlp1_{i}")(getattr(self, f"ln2_{i}")(x))
            x = x + getattr(self, f"mlp2_{i}")(self.act(h))
        x = self.final_ln(x)
        if self.classifier:
            return self.fc(x[:, 0])
        return (x[:, 1:],)
