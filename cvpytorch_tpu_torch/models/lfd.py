"""LFD, the light and fast detector (counterpart of
``cvpytorch_tpu/models/lfd.py``): ``LFDResNet`` (``BACKBONE.subtype``,
lfd_s by default: as in JAX, ``TYPE`` is not read), ``LFDNeck`` (a 1×1
conv + BN + ReLU a level to ``NECK.out_channels``, 128, no top-down path)
and the FCOS head (2 stacked convs of the neck's width), loss and decode
at strides 8–128, under the forward contract ``model(images, targets,
mode)``.
"""
from __future__ import annotations

from typing import Any, Sequence

from torch import nn

from ..registry import MODELS, NECKS
from .backbones.lfd_resnet import LFDResNet
from .bricks import ConvBNAct
from .fcos import FCOSFamily
from .heads.fcos_head import FCOSHead


@NECKS.register(name="LFDNeck")
class LFDNeck(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 128):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"neck{i}", ConvBNAct(c, out_channels, 1, use_bias=True, act="relu",
                                                bn_momentum=0.1, bn_eps=1e-5))

    def forward(self, feats):
        return [getattr(self, f"neck{i}")(x) for i, x in enumerate(feats)]


@MODELS.register(name="LFD")
class LFD(FCOSFamily):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 score_threshold: float = 0.05, iou_threshold: float = 0.6, max_det: int = 100):
        super().__init__()
        cfg = model_cfg or {}
        self.num_classes = max(len(dictionary), 1)
        self.score_threshold, self.iou_threshold, self.max_det = (score_threshold,
                                                                  iou_threshold, max_det)
        backbone, neck, head = (cfg.get(k) or {} for k in ("BACKBONE", "NECK", "HEAD"))
        out_ch = int(neck.get("out_channels", 128) or 128)
        self.backbone = LFDResNet(subtype=backbone.get("subtype", "lfd_s") or "lfd_s")
        self.neck = LFDNeck(self.backbone.out_channels, out_ch)
        self.head = FCOSHead(out_ch, num_classes=self.num_classes, channels=out_ch,
                             stacked_convs=2, prior=float(head.get("prior", 0.01) or 0.01),
                             cnt_on_reg=bool(head.get("cnt_on_reg", True)))

    def _outs(self, x):
        return self.head(self.neck(self.backbone(x)))
