"""FPN (counterpart of ``FPN`` in ``cvpytorch_tpu/models/necks/fcos_fpn.py``),
NCHW.

1×1 laterals on each input, top-down sums with nearest upsampling, 3×3
output convs, then ``num_outs - len(feats)`` extra levels by 2×2/2
max-pooling with no padding (P6 of a 25² P5 is 12²).  256 channels, no
norm.  ``jax.image.resize(..., "nearest")`` samples the source pixel under
each output pixel's centre, which is ``mode="nearest-exact"``; torch's
``"nearest"`` floors the scaled index instead and differs wherever the
ratio is not an integer.  ``FCOSFPN`` comes with FCOS.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...registry import NECKS


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
