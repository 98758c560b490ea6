"""ICNet, PP-LiteSeg and LEDNet (counterpart of
``cvpytorch_tpu/models/light_seg2.py``), registered in ``MODELS`` under
the JAX names.  NCHW inside, NHWC images in; BN is torch momentum 0.1
(flax 0.9), eps 1e-5, and 1e-3 in LEDNet.

ICNet: ``sub1_*`` three 3×3/s2 convs on the full input; one ``backbone``
(default ResNet-50, ``out_stages`` (2, 4)) called twice, on the input
resized bilinearly to a half (its layer2 is kept) and then to a quarter
(its layer4), so its BN statistics update twice a step in that order;
layer4 plus the align-corners resizes of its pyramid pools 1, 2, 3 and 6
(``seg_heads.pyramid_pool``: a block mean, or JAX's antialiased linear
resize where the bin does not divide the map); cascade fusions ``cff_24``
and ``cff_12`` (``low`` resized with align corners to ``high``'s size,
a dilation-2 ``low`` and a dilation-1 ``high`` 3×3 ConvBNAct, relu of
the sum, and a 1×1 ``low_cls`` on ``low`` for the auxiliary loss); a ×2
resize, ``conv_cls`` and a resize to the input.  Loss: CE + 0.4 × the
two auxiliary CEs at the input size.

PP-LiteSeg: a ``backbone`` (default STDCNet-1); the SPPM, pools 1, 2 and
4 of C5 through 1×1 ``sppm{i}`` resized back with align corners, summed,
then ``sppm_out``; three ``UAFM``s from C5 down to C3 (``proj`` 3×3 of
the low feature, the high one resized with align corners, attention from
the channel means and maxima of both through ``sa1``/``sa2`` and a
sigmoid, low·a + high·(1 − a), then ``sa_out`` and ``out``), each with a
``cls{idx}_conv`` + ``cls{idx}_out`` head resized to the input.  Training
sums the three CEs; inference takes the first head, on C5 (the reference's
``outputs[0]``).

LEDNet: ``down*`` blocks (a biased 3×3/s2 conv to ``ch − cin`` channels
beside a 2×2 max pool, BN, ReLU), SS-nbt blocks (split in halves; left
3×1 → 1×3 → BN → 3×1(d) → 1×3(d) → BN, right the mirror; each branch
dropped by its own channel mask in train mode; relu(x + cat), then the
channel shuffle of NHWC (2, C/2) swapped), and the APN decoder (a global
branch ``b1``, ``mid``, a 1-channel 7/5/3 pyramid fused by align-corners
resizes; logits = y · mid + b1, resized with align corners).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import MODELS
from .backbones import build_backbone
from .bricks import BatchNorm2d, ConvBNAct
from .heads.seg_heads import pyramid_pool, resize_bilinear
from .light_seg import SegModel, check_mode, full_logits
from .light_seg3 import resize_align_corners
from .losses.seg_loss import cross_entropy_2d
from .segmentor import feature_channels

_BN = dict(bn_momentum=0.1, bn_eps=1e-5)


def _backbone(model_cfg, default):
    cfg = (model_cfg.get("BACKBONE") if model_cfg else None) or default
    return build_backbone(cfg)


class CascadeFusion(nn.Module):
    def __init__(self, low_channels: int, high_channels: int, out: int, num_classes: int):
        super().__init__()
        self.low = ConvBNAct(low_channels, out, 3, dilation=2, **_BN)
        self.high = ConvBNAct(high_channels, out, 3, **_BN)
        self.low_cls = nn.Conv2d(out, num_classes, 1, bias=False)

    def forward(self, low, high):
        low = self.low(resize_align_corners(low, high.shape[-2:]))
        return F.relu(low + self.high(high)), self.low_cls(low)


@MODELS.register(name="ICNet")
class ICNet(SegModel):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None):
        super().__init__(dictionary)
        self.backbone = _backbone(model_cfg, {"name": "ResNet", "subtype": "resnet50",
                                              "out_stages": (2, 4)})
        c2, c4 = feature_channels(self.backbone)
        cin = 3
        for i, ch in enumerate((32, 32, 64)):
            setattr(self, f"sub1_{i}", ConvBNAct(cin, ch, 3, 2, **_BN))
            cin = ch
        self.cff_24 = CascadeFusion(c4, c2, 128, self.num_classes)
        self.cff_12 = CascadeFusion(128, 64, 128, self.num_classes)
        self.conv_cls = nn.Conv2d(128, self.num_classes, 1, bias=False)

    def _heads(self, images):
        x = images.permute(0, 3, 1, 2)
        H, W = x.shape[-2:]
        b1 = x
        for i in range(3):
            b1 = getattr(self, f"sub1_{i}")(b1)
        x_sub2 = self.backbone(resize_bilinear(x, (H // 2, W // 2)))[0]
        x_sub4 = self.backbone(resize_bilinear(x, (H // 4, W // 4)))[1]
        size = x_sub4.shape[-2:]
        feat = x_sub4
        for b in (1, 2, 3, 6):
            feat = feat + resize_align_corners(pyramid_pool(x_sub4, b), size)
        f24, aux24 = self.cff_24(feat, x_sub2)
        f12, aux12 = self.cff_12(f24, b1)
        up2 = resize_bilinear(f12, (f12.shape[-2] * 2, f12.shape[-1] * 2))
        return full_logits(self.conv_cls(up2), (H, W)), (aux24, aux12)

    def logits(self, images):
        return self._heads(images)[0]

    def forward(self, images, targets=None, mode: str = "infer"):
        check_mode(mode)
        logits, auxes = self._heads(images)
        if mode == "infer":
            return logits.argmax(1)
        size = images.shape[1:3]
        with torch.autocast(images.device.type, enabled=False):
            main = cross_entropy_2d(logits, targets, class_weights=self.class_weights)
            aux = sum(cross_entropy_2d(full_logits(a, size), targets,
                                       class_weights=self.class_weights)
                      for a in auxes)
            total = main + 0.4 * aux
        losses = {"ce_loss": main, "aux_loss": aux, "loss": total}
        if mode == "train":
            return total, losses
        return losses, logits.argmax(1)


class UAFM(nn.Module):
    def __init__(self, low_channels: int, mid: int, out: int):
        super().__init__()
        self.proj = ConvBNAct(low_channels, mid, 3, **_BN)
        self.sa1 = ConvBNAct(4, 2, 3, **_BN)
        self.sa2 = ConvBNAct(2, 1, 3, act=None, **_BN)
        self.sa_out = ConvBNAct(mid, mid, 3, **_BN)
        self.out = ConvBNAct(mid, out, 3, **_BN)

    def forward(self, low, high):
        low = self.proj(low)
        high = resize_align_corners(high, low.shape[-2:])
        # amax, not max(dim): a tie's gradient splits as in JAX
        stats = torch.cat([low.mean(1, keepdim=True), low.amax(1, keepdim=True),
                           high.mean(1, keepdim=True), high.amax(1, keepdim=True)], 1)
        a = torch.sigmoid(self.sa2(self.sa1(stats)))
        return self.out(self.sa_out(low * a + high * (1.0 - a)))


@MODELS.register(name="PPLiteSeg")
class PPLiteSeg(SegModel):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None,
                 out_channels: Sequence[int] = (32, 64, 128), sppm_channel: int = 128,
                 sizes: Sequence[int] = (1, 2, 4)):
        super().__init__(dictionary)
        self.backbone = _backbone(model_cfg, {"name": "STDCNet", "subtype": "stdc1"})
        feats = feature_channels(self.backbone)
        oc = tuple(out_channels)
        self.sizes = tuple(sizes)
        for i in range(len(self.sizes)):
            setattr(self, f"sppm{i}", ConvBNAct(feats[-1], sppm_channel, 1, **_BN))
        self.sppm_out = ConvBNAct(sppm_channel, sppm_channel, 3, **_BN)
        mids = (oc[1], oc[2], oc[2])
        for idx in (2, 1, 0):
            setattr(self, f"uafm{idx}", UAFM(feats[idx], mids[idx], oc[idx]))
            setattr(self, f"cls{idx}_conv", ConvBNAct(oc[idx], oc[1], 3, **_BN))
            setattr(self, f"cls{idx}_out", nn.Conv2d(oc[1], self.num_classes, 1, bias=False))

    def all_logits(self, images):
        """The three heads' logits at the input size, coarsest first."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        c5 = feats[-1]
        acc = 0
        for i, b in enumerate(self.sizes):
            acc = acc + resize_align_corners(getattr(self, f"sppm{i}")(pyramid_pool(c5, b)),
                                             c5.shape[-2:])
        high = self.sppm_out(acc)
        out = []
        for idx, low in zip((2, 1, 0), reversed(feats)):
            high = getattr(self, f"uafm{idx}")(low, high)
            y = getattr(self, f"cls{idx}_out")(getattr(self, f"cls{idx}_conv")(high))
            out.append(full_logits(y, images.shape[1:3]))
        return out

    def logits(self, images):
        return self.all_logits(images)[0]

    def forward(self, images, targets=None, mode: str = "infer"):
        check_mode(mode)
        logits_list = self.all_logits(images)
        main = logits_list[0]
        if mode == "infer":
            return main.argmax(1)
        with torch.autocast(images.device.type, enabled=False):
            ces = [cross_entropy_2d(lg, targets, class_weights=self.class_weights)
                   for lg in logits_list]
        losses = {f"ce_loss{i + 1}": c for i, c in enumerate(ces)}
        losses["loss"] = total = sum(ces)
        if mode == "train":
            return total, losses
        return losses, main.argmax(1)


def _bn3(c: int):
    return BatchNorm2d(c, eps=1e-3, momentum=0.1)


def channel_shuffle(y):
    """NHWC ``reshape(n, h, w, 2, C/2).swapaxes(3, 4)``: output channel
    2k + g is input channel g·C/2 + k."""
    n, c, h, w = y.shape
    return y.reshape(n, 2, c // 2, h, w).transpose(1, 2).reshape(n, c, h, w)


class SSnbt(nn.Module):
    def __init__(self, channels: int, dilation: int = 1, dropprob: float = 0.0):
        super().__init__()
        ch, d = channels // 2, dilation

        def conv(k, dd):
            pad = (dd * (k[0] - 1) // 2, dd * (k[1] - 1) // 2)
            return nn.Conv2d(ch, ch, k, padding=pad, dilation=dd)

        self.l1, self.l2 = conv((3, 1), 1), conv((1, 3), 1)
        self.l3, self.l4 = conv((3, 1), d), conv((1, 3), d)
        self.r1, self.r2 = conv((1, 3), 1), conv((3, 1), 1)
        self.r3, self.r4 = conv((1, 3), d), conv((3, 1), d)
        self.l_bn1, self.l_bn2, self.r_bn1, self.r_bn2 = (_bn3(ch) for _ in range(4))
        self.drop = nn.Dropout2d(dropprob)  # one mask a branch

    def forward(self, x):
        x1, x2 = x.chunk(2, 1)
        a = F.relu(self.l1(x1))
        a = F.relu(self.l_bn1(self.l2(a)))
        a = F.relu(self.l3(a))
        a = self.l_bn2(self.l4(a))
        b = F.relu(self.r1(x2))
        b = F.relu(self.r_bn1(self.r2(b)))
        b = F.relu(self.r3(b))
        b = self.r_bn2(self.r4(b))
        y = F.relu(x + torch.cat([self.drop(a), self.drop(b)], 1))
        return channel_shuffle(y)


# the APN decoder's ConvBNReLUs ``{name}_conv`` + ``{name}_bn``: name →
# (input, output, kernel, stride), "C" standing for the classes
_APN = {"b1": (128, "C", 1, 1), "mid": (128, "C", 1, 1), "down_1": (128, 1, 7, 2),
        "down_2": (1, 1, 5, 2), "down_3a": (1, 1, 3, 2), "down_3b": (1, 1, 3, 1),
        "conv2": (1, 1, 5, 1), "conv1": (1, 1, 7, 1)}
# the encoder: (channels, [(dilation, drop probability) of each SS-nbt])
_LED_STAGES = ((32, [(1, 0.03)] * 3), (64, [(1, 0.03)] * 2),
               (128, [(d, 0.3) for d in (1, 2, 5, 9, 2, 5, 9, 17)]))


@MODELS.register(name="LEDNet")
class LEDNet(SegModel):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None):
        super().__init__(dictionary)
        self.stages = []  # (down block name, [SS-nbt names])
        cin = 3
        for stage, (ch, blocks) in enumerate(_LED_STAGES, start=1):
            # ``down{stage}``: a biased 3×3/s2 conv beside a 2×2 max pool
            setattr(self, f"down{stage}_conv", nn.Conv2d(cin, ch - cin, 3, 2, 1))
            setattr(self, f"down{stage}_bn", _bn3(ch))
            for i, (d, p) in enumerate(blocks):
                setattr(self, f"s{stage}_{i}", SSnbt(ch, d, p))
            self.stages.append((f"down{stage}", [f"s{stage}_{i}" for i in range(len(blocks))]))
            cin = ch
        for name, (cin, ch, k, st) in _APN.items():
            setattr(self, f"{name}_conv", nn.Conv2d(cin, self.num_classes if ch == "C" else ch,
                                                    k, st, k // 2))
            setattr(self, f"{name}_bn", _bn3(self.num_classes if ch == "C" else ch))

    def _cbr(self, name, x):
        return F.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x)))

    def logits(self, images):
        x = images.permute(0, 3, 1, 2)
        for down, blocks in self.stages:
            x = torch.cat([getattr(self, f"{down}_conv")(x), F.max_pool2d(x, 2, 2)], 1)
            x = F.relu(getattr(self, f"{down}_bn")(x))
            for name in blocks:
                x = getattr(self, name)(x)
        h, w = x.shape[-2:]
        b1 = resize_align_corners(self._cbr("b1", x.mean((2, 3), keepdim=True)), (h, w))
        mid = self._cbr("mid", x)
        x1 = self._cbr("down_1", x)
        x2 = self._cbr("down_2", x1)
        x3 = self._cbr("down_3b", self._cbr("down_3a", x2))
        x3 = resize_align_corners(x3, (h // 4, w // 4))
        y = resize_align_corners(self._cbr("conv2", x2) + x3, (h // 2, w // 2))
        y = resize_align_corners(y + self._cbr("conv1", x1), (h, w))
        return full_logits(y * mid + b1, images.shape[1:3], resize_align_corners)
