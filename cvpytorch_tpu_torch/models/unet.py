"""UNet semantic segmentation (counterpart of ``cvpytorch_tpu/models/unet.py``).

A ``DoubleConv`` stem, ``depth`` conv-then-pool stages of
``base_channels``·2^min(i, depth − 1) channels, ``depth`` up stages (×2
bilinear upsampling with align_corners=True, concatenated after the skip,
then a ``DoubleConv``) and a 1×1 ``outconv``.  ``DoubleConv`` is twice a
3×3 conv with a bias, BN (torch momentum 0.1, eps 1e-5: the JAX flax
momentum 0.9) and ReLU.  The loss is the class-weighted 2-D cross-entropy
plus ``LOSS.EXTRA`` (a name of ``seg_loss``) when the config gives one.

Images enter NHWC and run NCHW on the ``channels_last`` view; under
autocast the logits are scored in float32.  ``mode="train"`` returns
``(total, {'ce_loss'[, 'extra_loss'], 'loss'})``, ``mode="val"`` the
losses and the argmax, ``mode="infer"`` the (B, H, W) argmax.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import dictionary_to_names_weights
from ..registry import MODELS
from .bricks import BatchNorm2d, upsample2x_bilinear_align
from .losses.seg_loss import build_seg_loss, cross_entropy_2d


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        for i in range(2):
            setattr(self, f"conv{i}", nn.Conv2d(in_channels if i == 0 else out_channels,
                                                out_channels, 3, padding=1))
            setattr(self, f"bn{i}", BatchNorm2d(out_channels, eps=1e-5, momentum=0.1))

    def forward(self, x):
        for i in range(2):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


@MODELS.register(name="UNet")
class UNet(nn.Module):
    # its seg losses take global normalisers under data parallelism
    dp_global_loss = True

    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None,
                 base_channels: int = 64, depth: int = 4):
        super().__init__()
        names, weights = dictionary_to_names_weights(list(dictionary))
        self.num_classes = len(names)
        self.register_buffer("class_weights", torch.tensor(weights, dtype=torch.float32),
                             persistent=False)
        b, d = base_channels, depth
        self.depth = d
        self.conv = DoubleConv(3, b)
        skips = [b]
        for i in range(1, d + 1):
            setattr(self, f"down{i}", DoubleConv(skips[-1], b * 2 ** min(i, d - 1)))
            skips.append(b * 2 ** min(i, d - 1))
        x_ch = skips.pop()
        for i in range(d):
            out = b * 2 ** max(d - 2 - i, 0)
            setattr(self, f"up{i + 1}", DoubleConv(skips.pop() + x_ch, out))
            x_ch = out
        self.outconv = nn.Conv2d(x_ch, self.num_classes, 1)
        loss_cfg = (model_cfg.get("LOSS") if model_cfg else None) or {}
        extra = loss_cfg.get("EXTRA") if hasattr(loss_cfg, "get") else None
        self._extra_loss = build_seg_loss(extra) if extra else None

    def forward_logits(self, x):
        skips = [self.conv(x)]
        for i in range(1, self.depth + 1):
            skips.append(F.max_pool2d(getattr(self, f"down{i}")(skips[-1]), 2, 2))
        xx = skips.pop()
        for i in range(1, self.depth + 1):
            xx = getattr(self, f"up{i}")(
                torch.cat([skips.pop(), upsample2x_bilinear_align(xx)], 1))
        return self.outconv(xx)

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        logits = self.forward_logits(images.permute(0, 3, 1, 2))
        if mode == "infer":
            return logits.argmax(1)
        with torch.autocast(images.device.type, enabled=False):
            logits = logits.float()
            ce = cross_entropy_2d(logits, targets, class_weights=self.class_weights)
            losses = {"ce_loss": ce}
            total = ce
            if self._extra_loss is not None:
                extra = self._extra_loss(logits, targets)
                losses["extra_loss"] = extra
                total = total + extra
            losses["loss"] = total
        if mode == "train":
            return total, losses
        return losses, logits.argmax(1)
