"""FPN and FCOSFPN (counterparts of ``cvpytorch_tpu/models/necks/fcos_fpn.py``),
NCHW.

``FPN``: 1×1 laterals on each input, top-down sums with nearest upsampling, 3×3
output convs, then ``num_outs - len(feats)`` extra levels by 2×2/2
max-pooling with no padding (P6 of a 25² P5 is 12²).  256 channels, no
norm.  ``jax.image.resize(..., "nearest")`` samples the source pixel under
each output pixel's centre, which is ``mode="nearest-exact"``; torch's
``"nearest"`` floors the scaled index instead and differs wherever the
ratio is not an integer.

``FCOSFPN`` (FCOS, RetinaNet): 1×1 laterals on C3–C5 with top-down sums,
3×3 ``smooth`` convs, then P6 by a 3×3/2 conv of P5 (of C5 with
``use_p5=False``) and P7 by a 3×3/2 conv of ReLU(P6); 256 channels, no
norm.  Its nearest resizes take the integer source indices of
``light_seg.resize_nearest`` (the same half-pixel rule).
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..light_seg import resize_nearest


def _upsample_to(x, ref):
    return F.interpolate(x, size=ref.shape[-2:], mode="nearest-exact")


@NECKS.register(name="FPN")
class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, out_channels, 1))
            setattr(self, f"fpn{i}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))

    def forward(self, feats):
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_to(laterals[i],
                                                             laterals[i - 1])
        outs = [getattr(self, f"fpn{i}")(x) for i, x in enumerate(laterals)]
        x = outs[-1]
        for _ in range(self.num_outs - len(outs)):
            x = F.max_pool2d(x, 2, 2)
            outs.append(x)
        return tuple(outs)


@NECKS.register(name="FCOSFPN")
class FCOSFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 use_p5: bool = True):
        super().__init__()
        self.use_p5 = use_p5
        for i, c in zip((3, 4, 5), in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, out_channels, 1))
            setattr(self, f"smooth{i}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))
        self.p6 = nn.Conv2d(out_channels if use_p5 else in_channels[2], out_channels, 3, 2, 1)
        self.p7 = nn.Conv2d(out_channels, out_channels, 3, 2, 1)
        self.out_channels = [out_channels] * 5

    def forward(self, feats):
        c3, c4, c5 = feats
        p5 = self.lateral5(c5)
        p4 = self.lateral4(c4) + resize_nearest(p5, c4.shape[-2:])
        p3 = self.lateral3(c3) + resize_nearest(p4, c3.shape[-2:])
        p3, p4, p5 = self.smooth3(p3), self.smooth4(p4), self.smooth5(p5)
        p6 = self.p6(p5 if self.use_p5 else c5)
        return (p3, p4, p5, p6, self.p7(F.relu(p6)))
