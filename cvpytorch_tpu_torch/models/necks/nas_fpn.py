"""NAS-FPN (counterpart of ``cvpytorch_tpu/models/necks/nas_fpn.py``), NCHW:
1×1 laterals on the inputs, stride-2 3×3 ``extra{i}`` levels up to P7, then
``stack_times`` stacks of the seven merging cells

    gp(P6,P4)@4 → sum(·,P4)@4 → sum(·,P3)@3* → sum(P3*,·)@4* →
    sum(gp(4*,3*)@5, P5)@5* → sum(gp(5*,4'),P7)@7* → gp(7*,5*)@6*

where ``gp(a, b) = b + sigmoid(mean(b))·a`` gates with the global mean of
its second input.  Each cell resizes both inputs to its level, merges,
then ReLU → 3×3 conv (no bias) → BN (torch momentum 0.1, eps 1e-5).
Resizing down max-pools with a matching stride (no padding), then, if the
size is still off, and resizing up, takes ``jax.image.resize``'s nearest
with half-pixel centres (``light_seg.resize_nearest``, not
``F.interpolate(mode="nearest")``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..bricks import BatchNorm2d
from ..light_seg import resize_nearest

# (name, op, inputs as stage-local names, output level 0–4 = P3–P7)
_CELLS = (("gp_64_4", "gp", ("p6", "p4"), 1), ("sum_44_4", "sum", ("p4_1", "p4"), 1),
          ("sum_43_3", "sum", ("p4_2", "p3"), 0), ("sum_34_4", "sum", ("p3_o", "p4_2"), 1),
          ("gp_43_5", "gp", ("p4_o", "p3_o"), 2), ("sum_55_5", "sum", ("p5_t", "p5"), 2),
          ("gp_54_7", "gp", ("p5_o", "p4_2"), 4), ("sum_77_7", "sum", ("p7_t", "p7"), 4),
          ("gp_75_6", "gp", ("p7_o", "p5_o"), 3))
_OUTPUTS = {"gp_64_4": "p4_1", "sum_44_4": "p4_2", "sum_43_3": "p3_o", "sum_34_4": "p4_o",
            "gp_43_5": "p5_t", "sum_55_5": "p5_o", "gp_54_7": "p7_t", "sum_77_7": "p7_o",
            "gp_75_6": "p6_o"}


def to_size(x, hw):
    h, w = x.shape[-2:]
    th, tw = hw
    if (h, w) == (th, tw):
        return x
    if th <= h:
        sh, sw = max(h // th, 1), max(w // tw, 1)
        x = F.max_pool2d(x, (sh, sw), (sh, sw))
    return x if tuple(x.shape[-2:]) == (th, tw) else resize_nearest(x, (th, tw))


class MergeCell(nn.Module):
    def __init__(self, channels: int, op: str = "sum"):
        super().__init__()
        self.op = op
        self.conv = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn = BatchNorm2d(channels, eps=1e-5, momentum=0.1)

    def forward(self, x1, x2, hw):
        x1, x2 = to_size(x1, hw), to_size(x2, hw)
        if self.op == "gp":
            y = x2 + torch.sigmoid(x2.mean((2, 3), keepdim=True)) * x1
        else:
            y = x1 + x2
        return self.bn(self.conv(F.relu(y)))


@NECKS.register(name="NASFPN", aliases=("NAS_FPN",))
class NASFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 stack_times: int = 3, num_outs: int = 5):
        super().__init__()
        if num_outs != 5:
            raise ValueError("NAS-FPN is defined over 5 levels (P3-P7)")
        self.n_in, self.num_outs, self.stack_times = len(in_channels), num_outs, stack_times
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, out_channels, 1))
        for i in range(self.n_in, num_outs):
            setattr(self, f"extra{i}", nn.Conv2d(out_channels, out_channels, 3, 2, 1))
        for s in range(stack_times):
            for name, op, _, _ in _CELLS:
                setattr(self, f"s{s}_{name}", MergeCell(out_channels, op))

    def forward(self, feats):
        levels = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.n_in, self.num_outs):
            levels.append(getattr(self, f"extra{i}")(levels[-1]))
        for s in range(self.stack_times):
            hw = [p.shape[-2:] for p in levels]
            env = dict(zip(("p3", "p4", "p5", "p6", "p7"), levels))
            for name, _, (a, b), level in _CELLS:
                env[_OUTPUTS[name]] = getattr(self, f"s{s}_{name}")(env[a], env[b], hw[level])
            levels = [env[k] for k in ("p3_o", "p4_o", "p5_o", "p6_o", "p7_o")]
        return tuple(levels)
