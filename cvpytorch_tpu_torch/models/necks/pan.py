"""PAN neck (counterpart of ``cvpytorch_tpu/models/necks/pan.py``),
NanoDet v1's, NCHW.

Bias-free 1×1 ``lateral{i}`` convolutions (no BN, no activation), a
top-down pass adding each level's bilinear resize to the level below,
then a bottom-up pass adding each level's bilinear *downsampling* to the
level above.  Both resizes are ``F.interpolate(..., 'bilinear',
align_corners=False)``, which never antialiases: JAX's
``jax.image.resize(..., 'bilinear', antialias=False)``, also where a
level does not halve evenly (5 → 3).
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...registry import NECKS


def resize_bilinear(x, hw):
    """NCHW bilinear resize to ``hw``, half-pixel centres, no antialias."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


@NECKS.register(name="PAN", aliases=("FPN_PAN",))
class PAN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 96):
        super().__init__()
        self.n_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, out_channels, 1, bias=False))

    def forward(self, feats):
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        n = len(laterals)
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(laterals[i],
                                                                laterals[i - 1].shape[2:])
        for i in range(n - 1):
            laterals[i + 1] = laterals[i + 1] + resize_bilinear(laterals[i],
                                                                laterals[i + 1].shape[2:])
        return tuple(laterals)
