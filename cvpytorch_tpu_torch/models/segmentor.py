"""Encoder-decoder segmentor (counterpart of
``cvpytorch_tpu/models/segmentor.py``): a backbone, a head and an optional
auxiliary head built from the config, the head's logits resized
bilinearly to the input size, and a loss with the dictionary's class
weights.

Images enter NHWC; the backbone and heads run NCHW on the
``channels_last`` view.  Under autocast the logits are taken to float32
and resized and scored with autocast off.  ``mode="train"`` returns
``(total, {'seg_loss'[, 'aux_loss']})`` (the auxiliary head, weighted by
``AUX_WEIGHT``, default 0.4, runs in train mode only), ``mode="val"``
``({'seg_loss'}, argmax)`` and ``mode="infer"`` the (B, H, W) argmax;
``logits(images)`` the float32 logits that argmax takes.
"""
from __future__ import annotations

import inspect
from typing import Any, Sequence

import torch
from torch import nn

from ..config import dictionary_to_names_weights
from ..registry import BACKBONES, HEADS, MODELS
from .backbones import build_backbone
from .heads.seg_heads import resize_bilinear
from .losses.seg_loss import build_seg_loss

_DEFAULT_BACKBONE = {"name": "ResNet", "subtype": "resnet50", "output_stride": 8,
                     "out_stages": (1, 4)}


def _not_ported(kind: str, name: str) -> KeyError:
    return KeyError(f"{kind} {name!r} is not one the segmentor can use: "
                    "no such head, or a backbone without per-stage channels")


def feature_channels(backbone: nn.Module) -> list[int]:
    """Channels of each feature the backbone returns: its ``out_channels``
    where it declares them (TopFormer's 0-based positions, each of
    ``out_ch`` channels; RegSeg's renumbered stages), else its 1-based
    ``out_stages`` of its per-stage ``channels``."""
    if hasattr(backbone, "out_channels"):
        return list(backbone.out_channels)
    if not (hasattr(backbone, "channels") and hasattr(backbone, "out_stages")):
        raise _not_ported("segmentation backbone", type(backbone).__name__)
    return [backbone.channels[s - 1] for s in backbone.out_stages]


def build_head(cfg, num_classes: int, in_channels: Sequence[int]) -> nn.Module:
    """The HEAD / AUX_HEAD block: keys the head's constructor does not
    take are dropped, as the JAX factory drops what its dataclass lacks;
    ``in_channels`` is passed where the head takes it (a detection head
    such as ``GFocalHeadV2`` declares its widths itself)."""
    kwargs = dict(cfg.items() if hasattr(cfg, "items") else cfg)
    name = kwargs.pop("name")
    if name not in HEADS:
        raise _not_ported("segmentation head", name)
    cls = HEADS.get(name)
    params = inspect.signature(cls).parameters
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in kwargs.items() if k in params}
    if "in_channels" in params:
        kwargs["in_channels"] = tuple(in_channels)
    return cls(num_classes=num_classes, **kwargs)


@MODELS.register(name="EncoderDecoder", aliases=(
    "SegNeXt", "PSPNet", "Deeplabv3", "Deeplabv3Plus", "SegFormer",
    "UPerNet", "SFNet", "TopFormer", "RegSeg"))
class EncoderDecoder(nn.Module):
    # its seg losses take global normalisers under data parallelism
    dp_global_loss = True

    def __init__(self, dictionary: Sequence[Any] = (), model_cfg=None):
        super().__init__()
        names, weights = dictionary_to_names_weights(list(dictionary))
        self.num_classes = len(names)
        self.register_buffer("class_weights", torch.tensor(weights, dtype=torch.float32),
                             persistent=False)
        cfg = model_cfg or {}
        backbone_cfg = cfg.get("BACKBONE") or _DEFAULT_BACKBONE
        if backbone_cfg["name"] not in BACKBONES:
            raise _not_ported("backbone", backbone_cfg["name"])
        self.backbone = build_backbone(backbone_cfg)
        channels = feature_channels(self.backbone)
        self.head = build_head(cfg.get("HEAD") or {"name": "FCNHead"},
                               self.num_classes, channels)
        aux_cfg = cfg.get("AUX_HEAD")
        self.aux_head = build_head(aux_cfg, self.num_classes, channels) if aux_cfg else None
        self.aux_weight = float(cfg.get("AUX_WEIGHT") or 0.4)
        loss_cfg = cfg.get("LOSS") or {}
        self._loss_fn = build_seg_loss(
            loss_cfg.get("name", "CrossEntropyLoss2d") or "CrossEntropyLoss2d",
            **{k.lower(): v for k, v in loss_cfg.items() if k != "name"})

    @staticmethod
    def _logits(head, feats, size):
        out = head(feats)
        with torch.autocast(out.device.type, enabled=False):
            return resize_bilinear(out.float(), size)

    def logits(self, images):
        """The (B, C, H, W) float32 logits ``mode="infer"`` takes the argmax of."""
        return self._logits(self.head, self.backbone(images.permute(0, 3, 1, 2)),
                            images.shape[1:3])

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        size = images.shape[1:3]
        feats = self.backbone(images.permute(0, 3, 1, 2))
        logits = self._logits(self.head, feats, size)
        if mode == "infer":
            return logits.argmax(1)
        aux_logits = (self._logits(self.aux_head, feats, size)
                      if self.aux_head is not None and mode == "train" else None)
        with torch.autocast(images.device.type, enabled=False):
            main = self._loss_fn(logits, targets, class_weights=self.class_weights)
            losses = {"seg_loss": main}
            total = main
            if aux_logits is not None:
                aux = self._loss_fn(aux_logits, targets, class_weights=self.class_weights)
                losses["aux_loss"] = aux
                total = total + self.aux_weight * aux
        if mode == "train":
            return total, losses
        return losses, logits.argmax(1)
