"""RFP, the Recursive Feature Pyramid of DetectoRS (counterpart of
``cvpytorch_tpu/models/necks/rfp.py``), NCHW.

``forward((image, C3, C4, C5))``: the ``fpn`` (``fcos_fpn.FPN``) on C3–C5;
then for each further step, the pyramid fed back into a second backbone
(``{Class}_{step − 1}``, Flax's automatic name, built with ResNet's
``rfp_in_channels`` hook): stage 2 takes the raw P3, stages 3 and 4 take P4
and P5 through the one shared ``rfp_aspp``; the same FPN runs on its
features and a per-pixel sigmoid gate ``rfp_weight{step}_{level}`` (1×1,
zero at init) fuses the new pyramid with the old.  At init the hook convs
are zero, so the second backbone runs as it would unfed, and the gates
are ½: given the first backbone's weights, the output is the plain FPN's.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..backbones import build_backbone
from .fcos_fpn import FPN


class ASPP(nn.Module):
    """Three dilated branches on x and a 1×1 branch on its global mean,
    each ReLU'd, concatenated."""

    def __init__(self, in_channels: int, out_channels: int = 64,
                 dilations: Sequence[int] = (1, 3, 6, 1)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            k = 3 if d > 1 else 1
            setattr(self, f"aspp{i}", nn.Conv2d(in_channels, out_channels, k, 1,
                                                d if d > 1 else 0, d))

    def forward(self, x):
        gap = x.mean((2, 3), keepdim=True)
        outs = [F.relu(getattr(self, f"aspp{i}")(gap if i == self.n - 1 else x))
                for i in range(self.n)]
        outs[-1] = outs[-1].expand_as(outs[-2])
        return torch.cat(outs, 1)


@NECKS.register(name="RFP")
class RFP(nn.Module):
    def __init__(self, in_channels: Sequence[int], rfp_steps: int = 2, rfp_backbone: Any = None,
                 aspp_out_channels: int = 64, aspp_dilations: Sequence[int] = (1, 3, 6, 1),
                 out_channels: int = 256, num_outs: int = 5,
                 rfp_stages: Sequence[int] = (2, 3, 4)):
        super().__init__()
        self.rfp_steps, self.rfp_stages, self.num_outs = rfp_steps, tuple(rfp_stages), num_outs
        self.fpn = FPN(in_channels, out_channels, num_outs)
        self.rfp_aspp = ASPP(out_channels, aspp_out_channels, aspp_dilations)
        cfg = dict(rfp_backbone or {"name": "ResNet", "subtype": "resnet50"})
        cfg["rfp_in_channels"] = {s: out_channels if i == 0 else aspp_out_channels * len(
            aspp_dilations) for i, s in enumerate(self.rfp_stages)}
        self.backbones = []
        for step in range(1, rfp_steps):
            bb = build_backbone(cfg)
            name = f"{type(bb).__name__}_{step - 1}"
            setattr(self, name, bb)
            self.backbones.append(name)
            for level in range(num_outs):
                gate = nn.Conv2d(out_channels, 1, 1)
                nn.init.zeros_(gate.weight)
                nn.init.zeros_(gate.bias)
                setattr(self, f"rfp_weight{step}_{level}", gate)

    def forward(self, feats):
        img, *cs = feats
        out = list(self.fpn(tuple(cs)))
        for step, name in enumerate(self.backbones, start=1):
            rfp_feats = [out[0]] + [self.rfp_aspp(out[i])
                                    for i in range(1, len(self.rfp_stages))]
            cs2 = getattr(self, name)(img, rfp_feats=dict(zip(self.rfp_stages, rfp_feats)))
            out2 = self.fpn(tuple(cs2))
            fused = []
            for level, (o_new, o_old) in enumerate(zip(out2, out)):
                w = torch.sigmoid(getattr(self, f"rfp_weight{step}_{level}")(o_new))
                fused.append(w * o_new + (1.0 - w) * o_old)
            out = fused
        return tuple(out)
