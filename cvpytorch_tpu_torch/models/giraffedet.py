"""GiraffeDet (counterpart of ``cvpytorch_tpu/models/giraffedet.py``): a
shallow space-to-depth backbone, the GiraffeNeck and a GFocalHeadV2 with
2 stacked, ungrouped convs (``giraffedet_s``: width 48, neck widths (96,
192, 384)).  The predict path and the loss are AIRDet's
(``airdet.GFLv2Detector``).

``space_to_depth`` orders the new channels (dy, dx, c), as JAX's NHWC
reshape and transpose do; ``F.pixel_unshuffle`` would order them (c, dy,
dx) and scramble the 1×1 ``fuse`` conv's inputs against carried weights.
"""
from __future__ import annotations

from typing import Any, Sequence

from torch import nn

from ..registry import MODELS
from .airdet import GFLv2Detector
from .bricks import ConvBNAct
from .heads.gflv2_head import GFocalHeadV2
from .necks.giraffe_neck import GiraffeNeck


def space_to_depth(x, block: int = 2):
    """(B, C, H, W) → (B, C·b², H/b, W/b), channel (dy·b + dx)·C + c."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, c * block * block, h // block, w // block)


class S2DBlock(nn.Module):
    """Space-to-depth, 1×1 ``fuse``, 3×3 ``conv``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.fuse = ConvBNAct(4 * in_channels, out_channels, 1, act="silu")
        self.conv = ConvBNAct(out_channels, out_channels, 3, act="silu")

    def forward(self, x):
        return self.conv(self.fuse(space_to_depth(x)))


class S2DChainBackbone(nn.Module):
    """``stem1`` (3×3/2), ``stem2``, four S2D blocks; → /8, /16, /32."""

    def __init__(self, width: int = 64):
        super().__init__()
        w = width
        self.stem1 = ConvBNAct(3, w, 3, 2, act="silu")
        self.stem2 = ConvBNAct(w, w, 3, 1, act="silu")
        self.s2d1 = S2DBlock(w, w * 2)
        self.s2d2 = S2DBlock(w * 2, w * 4)
        self.s2d3 = S2DBlock(w * 4, w * 8)
        self.s2d4 = S2DBlock(w * 8, w * 8)
        self.channels = (w * 4, w * 8, w * 8)

    def forward(self, x):
        c2 = self.s2d1(self.stem2(self.stem1(x)))
        c3 = self.s2d2(c2)
        c4 = self.s2d3(c3)
        return [c3, c4, self.s2d4(c4)]


@MODELS.register(name="GiraffeDet")
class GiraffeDet(GFLv2Detector):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 score_threshold: float = 0.05, iou_threshold: float = 0.6,
                 max_det: int = 100):
        super().__init__(dictionary, score_threshold, iou_threshold, max_det)
        cfg = model_cfg or {}
        size = (cfg.get("TYPE") or "giraffedet_s").split("_")[-1]
        width = {"s": 48, "m": 64, "l": 96}.get(size, 48)
        fpn = (width * 2, width * 4, width * 8)
        self.backbone = S2DChainBackbone(width)
        self.neck = GiraffeNeck(self.backbone.channels, fpn, fpn)
        self.head = GFocalHeadV2(self.num_classes, fpn, reg_max=self.reg_max, conv_groups=1,
                                 stacked_convs=2)
