"""LSPNet and SGCPNet (counterpart of ``cvpytorch_tpu/models/light_seg3.py``),
registered in ``MODELS`` under the JAX names, and ``resize_align_corners``,
which ``light_seg2`` uses too.  NCHW inside, NHWC images in; BN is torch
momentum 0.1, eps 1e-5 (flax 0.9) unless stated.

LSPNet (``TYPE: lspnet_s|m|l``): two ``_LSPBaseNet`` paths, ``high_net``
and ``low_net``, of ConvBNAct 3×3 stages ``stage{si}_{i}`` (depths 1, 3,
3, 10, 10; strides 2, 2, 2, 2, 1), fed the input resized with align
corners to ``int(H·r)`` for the type's two resolutions (0.75 and 0.25 for
"s"); after stages 2 and 3 each path adds the other resized to its size;
the concatenation goes through a biased 1×1 ``classifier`` and is resized
to the input bilinearly without align corners.

SGCPNet: a MobileNetV3-style backbone (``stem_conv``/``stem_bn``,
hard-swish, then ``stage{s}_{b}`` inverted residuals of ``_SGCP_STAGES``:
a shortcut whenever the stride is 1, through ``sc_conv``/``sc_bn`` where
the channels change; the SE on the block's output channels, its BN'd 1×1s
ending in a hard sigmoid) giving /8, /16 and /32 features, and a
two-pass weighted-fusion head: 1×1 ``shrink*``, P6/P7 by 3×3/s2/p1 max
pools (−inf padding), fast-attention sums ``relu(w)/(Σ + 1e-4)`` of the
top-level parameters ``p*_w*`` followed by swish, depthwise-separable
``conv*`` modules without activation, the head's BN at torch momentum
0.01 (flax 0.99) and eps 1e-3, levels brought together by half-pixel
nearest resizes (``resize_nearest``), a biased 1×1 ``classifier`` at P3
and a bilinear resize to the input.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import MODELS
from .bricks import BatchNorm2d, ConvBNAct
from .light_seg import SegModel, full_logits, resize_nearest

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


def resize_align_corners(x, size):
    """NCHW bilinear resize with align corners: output i samples input
    i·(in − 1)/max(out − 1, 1) (JAX's separable gather and lerp, equal up
    to rounding); unchanged where the size is."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class _LSPBaseNet(nn.Module):
    def __init__(self, channels: Sequence[int] = (8, 24, 48, 96, 96),
                 depths: Sequence[int] = (1, 3, 3, 10, 10),
                 strides: Sequence[int] = (2, 2, 2, 2, 1)):
        super().__init__()
        self.depths = tuple(depths)
        cin = 3
        for si, (c, d, st) in enumerate(zip(channels, depths, strides)):
            for i in range(d):
                setattr(self, f"stage{si}_{i}",
                        ConvBNAct(cin, c, 3, st if i == 0 else 1, **_BN))
                cin = c

    def stage(self, idx: int, x):
        for i in range(self.depths[idx]):
            x = getattr(self, f"stage{idx}_{i}")(x)
        return x


@MODELS.register(name="LSPNet")
class LSPNet(SegModel):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None,
                 resolutions: Sequence[float] = (0.75, 0.25),
                 channels: Sequence[int] = (8, 24, 48, 96, 96),
                 depths: Sequence[int] = (1, 3, 3, 10, 10)):
        super().__init__(dictionary)
        cfg = model_cfg or {}
        t = str(cfg.get("TYPE") or "lspnet_s").split("_")[-1]
        self.resolutions = {"s": (0.75, 0.25), "m": (1.0, 0.25),
                            "l": (1.0, 0.25)}.get(t, tuple(resolutions))
        chs = {"l": (8, 24, 64, 160, 160)}.get(t, tuple(channels))
        self.high_net = _LSPBaseNet(chs, depths)
        self.low_net = _LSPBaseNet(chs, depths)
        self.classifier = nn.Conv2d(2 * chs[-1], self.num_classes, 1)

    @staticmethod
    def _bi(xh, xl):
        return (xh + resize_align_corners(xl, xh.shape[-2:]),
                xl + resize_align_corners(xh, xl.shape[-2:]))

    def logits(self, images):
        x = images.permute(0, 3, 1, 2)
        H, W = x.shape[-2:]
        (r1, r2) = self.resolutions
        xh = resize_align_corners(x, (int(H * r1), int(W * r1)))
        xl = resize_align_corners(x, (int(H * r2), int(W * r2)))
        for i in range(5):
            if i in (3, 4):
                xh, xl = self._bi(xh, xl)
            xh, xl = self.high_net.stage(i, xh), self.low_net.stage(i, xl)
        return full_logits(
            self.classifier(torch.cat([xh, resize_align_corners(xl, xh.shape[-2:])], 1)), (H, W))


def _hswish(x):
    return x * torch.clamp((x + 3.0) / 6.0, 0.0, 1.0)


def _hsigmoid(x):
    return torch.clamp((x + 3.0) / 6.0, 0.0, 1.0)


def _bn(c: int, momentum: float = 0.1, eps: float = 1e-5):
    return BatchNorm2d(c, eps=eps, momentum=momentum)


class _SGCPSe(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // 4, 1, bias=False)
        self.bn1 = _bn(c // 4)
        self.fc2 = nn.Conv2d(c // 4, c, 1, bias=False)
        self.bn2 = _bn(c)

    def forward(self, x):
        g = F.relu(self.bn1(self.fc1(x.mean((2, 3), keepdim=True))))
        return x * _hsigmoid(self.bn2(self.fc2(g)))


class _SGCPBlock(nn.Module):
    def __init__(self, cin: int, k: int, expand: int, out: int, act: str, se: bool,
                 stride: int):
        super().__init__()
        self.act = F.relu if act == "relu" else _hswish
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, expand, 1, bias=False)
        self.bn1 = _bn(expand)
        self.conv2 = nn.Conv2d(expand, expand, k, stride, k // 2, groups=expand, bias=False)
        self.bn2 = _bn(expand)
        self.conv3 = nn.Conv2d(expand, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.se = _SGCPSe(out) if se else None
        if stride == 1 and cin != out:
            self.sc_conv = nn.Conv2d(cin, out, 1, bias=False)
            self.sc_bn = _bn(out)

    def forward(self, x):
        h = self.act(self.bn1(self.conv1(x)))
        h = self.act(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.se is not None:
            h = self.se(h)
        if self.stride == 1:
            h = h + (self.sc_bn(self.sc_conv(x)) if hasattr(self, "sc_conv") else x)
        return h


# (k, expand, out, act, se, stride) rows per stage
_SGCP_STAGES = (
    ((3, 16, 16, "relu", True, 2),),
    ((3, 72, 24, "relu", False, 2), (3, 88, 24, "relu", False, 1)),
    ((5, 96, 40, "hswish", True, 2), (5, 240, 40, "hswish", True, 1),
     (5, 240, 40, "hswish", True, 1), (5, 120, 48, "hswish", True, 1),
     (5, 144, 48, "hswish", True, 1)),
    ((5, 288, 96, "hswish", True, 2), (5, 576, 96, "hswish", True, 1),
     (5, 576, 96, "hswish", True, 1)),
)

_HEAD_BN = dict(momentum=0.01, eps=1e-3)  # flax momentum 0.99


def _max_pool(x):
    return F.max_pool2d(x, 3, 2, 1)


# fusion weights: name → number of inputs
_WEIGHTS = {"p6_w1": 2, "p5_w1": 2, "p4_w1": 2, "p3_w1": 2, "p4_w2": 3, "p5_w2": 3,
            "p6_w2": 3, "p7_w2": 2, "p6_w1_2": 2, "p5_w1_2": 2, "p4_w1_2": 2, "p3_w1_2": 2}
_CONVBN = ("p5_to_p6", "p3_dc", "p4_dc", "p5_dc", "p4_dc2", "p5_dc2")
_DWMOD = ("conv6_up", "conv5_up", "conv4_up", "conv3_up", "conv4_down", "conv5_down",
          "conv6_down", "conv7_down", "conv6_up2", "conv5_up2", "conv4_up2", "conv3_up2")


@MODELS.register(name="SGCPNet")
class SGCPNet(SegModel):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None,
                 shrink_channels: Sequence[int] = (40, 112, 320), mid_channels: int = 64):
        super().__init__(dictionary)
        self.stem_conv = nn.Conv2d(3, 16, 3, 2, 1, bias=False)
        self.stem_bn = _bn(16)
        cin = 16
        for si, rows in enumerate(_SGCP_STAGES):
            for bi, row in enumerate(rows):
                setattr(self, f"stage{si + 1}_{bi}", _SGCPBlock(cin, *row))
                cin = row[2]
        sc, mid = tuple(shrink_channels), mid_channels
        for i, (name, c) in enumerate(zip(("shrink3", "shrink4", "shrink5"), (24, 48, 96))):
            setattr(self, name, nn.Conv2d(c, sc[i], 1))
        for name in _CONVBN:
            c = {"p3": sc[0], "p4": sc[1], "p5": sc[2]}[name[:2]]
            setattr(self, f"{name}_conv", nn.Conv2d(c, mid, 1))
            setattr(self, f"{name}_bn", _bn(mid, **_HEAD_BN))
        for name in _DWMOD:
            setattr(self, f"{name}_dw", nn.Conv2d(mid, mid, 3, 1, 1, groups=mid, bias=False))
            setattr(self, f"{name}_dwbn", _bn(mid, **_HEAD_BN))
            setattr(self, f"{name}_pw", nn.Conv2d(mid, mid, 1, bias=False))
            setattr(self, f"{name}_pwbn", _bn(mid, **_HEAD_BN))
        for name, n in _WEIGHTS.items():
            setattr(self, name, nn.Parameter(torch.ones(n)))
        self.classifier = nn.Conv2d(mid, self.num_classes, 1)

    def _convbn(self, name, x):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    def _dwmod(self, name, x):
        x = getattr(self, f"{name}_dwbn")(getattr(self, f"{name}_dw")(x))
        return getattr(self, f"{name}_pwbn")(getattr(self, f"{name}_pw")(x))

    def _wsum(self, name, parts):
        w = F.relu(getattr(self, name))
        w = w / (w.sum() + 1e-4)
        s = sum(w[i] * p for i, p in enumerate(parts))
        return s * torch.sigmoid(s)

    def _fuse(self, conv, weights, x, *others):
        """``conv`` of the weighted sum of ``x`` and ``others`` resized to it."""
        return self._dwmod(conv, self._wsum(weights, [x] + [resize_nearest(o, x.shape[-2:])
                                                            for o in others]))

    def logits(self, images):
        x = _hswish(self.stem_bn(self.stem_conv(images.permute(0, 3, 1, 2))))
        feats = []
        for si, rows in enumerate(_SGCP_STAGES):
            for bi in range(len(rows)):
                x = getattr(self, f"stage{si + 1}_{bi}")(x)
            if si >= 1:
                feats.append(x)
        p3, p4, p5 = self.shrink3(feats[0]), self.shrink4(feats[1]), self.shrink5(feats[2])

        p6_in = _max_pool(self._convbn("p5_to_p6", p5))
        p7_in = _max_pool(p6_in)
        p3_in, p4_in, p5_in = (self._convbn(n, p) for n, p in
                               (("p3_dc", p3), ("p4_dc", p4), ("p5_dc", p5)))
        p6_up = self._fuse("conv6_up", "p6_w1", p6_in, p7_in)
        p5_up = self._fuse("conv5_up", "p5_w1", p5_in, p6_up)
        p4_up = self._fuse("conv4_up", "p4_w1", p4_in, p5_up)
        p3_out = self._fuse("conv3_up", "p3_w1", p3_in, p4_up)

        p4_in, p5_in = self._convbn("p4_dc2", p4), self._convbn("p5_dc2", p5)
        p4_out = self._fuse("conv4_down", "p4_w2", p4_in, p4_up, _max_pool(p3_out))
        p5_out = self._fuse("conv5_down", "p5_w2", p5_in, p5_up, _max_pool(p4_out))
        p6_out = self._fuse("conv6_down", "p6_w2", p6_in, p6_up, _max_pool(p5_out))
        p7_out = self._fuse("conv7_down", "p7_w2", p7_in, _max_pool(p6_out))

        p6_up = self._fuse("conv6_up2", "p6_w1_2", p6_out, p7_out)
        p5_up = self._fuse("conv5_up2", "p5_w1_2", p5_out, p6_up)
        p4_up = self._fuse("conv4_up2", "p4_w1_2", p4_out, p5_up)
        p3_fin = self._fuse("conv3_up2", "p3_w1_2", p3_out, p4_up)
        return full_logits(self.classifier(p3_fin), images.shape[1:3])
