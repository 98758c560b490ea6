"""Classification model (counterpart of ``cvpytorch_tpu/models/classification.py``):
a backbone built from ``BACKBONE`` with ``classifier=True`` (default
ResNet-18) emits the logits, and the loss is the cross-entropy with the
dictionary's class weights and ``label_smoothing``.

Images enter NHWC; the backbone runs NCHW on the ``channels_last`` view.
Under autocast the loss takes the logits in float32 with autocast off.
``mode="train"`` returns ``(loss, {'ce_loss'})``, ``mode="val"``
``({'ce_loss'}, argmax)`` and ``mode="infer"`` the (B,) argmax.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..config import dictionary_to_names_weights
from ..registry import MODELS
from .backbones import build_backbone
from .losses.cls_loss import cross_entropy_loss


@MODELS.register(name="Classification", aliases=("ClsModel",))
class Classification(nn.Module):
    def __init__(self, dictionary: Sequence[Any] = (), model_cfg: Any = None,
                 label_smoothing: float = 0.0):
        super().__init__()
        names, weights = dictionary_to_names_weights(list(dictionary))
        self.num_classes = len(names)
        self.label_smoothing = float(label_smoothing)
        self.register_buffer("class_weights", torch.tensor(weights, dtype=torch.float32),
                             persistent=False)
        cfg = dict((model_cfg or {}).get("BACKBONE") or
                   {"name": "ResNet", "subtype": "resnet18"})
        cfg.setdefault("classifier", True)
        cfg["num_classes"] = self.num_classes
        self.backbone = build_backbone(cfg)

    def forward(self, images, targets=None, mode: str = "infer"):
        if mode not in ("train", "val", "infer"):
            raise ValueError(f"unknown mode {mode!r}")
        logits = self.backbone(images.permute(0, 3, 1, 2))
        if mode == "infer":
            return logits.argmax(-1)
        with torch.autocast(images.device.type, enabled=False):
            loss = cross_entropy_loss(logits.float(), targets, self.class_weights,
                                      self.label_smoothing)
        if mode == "train":
            return loss, {"ce_loss": loss}
        return {"ce_loss": loss}, logits.argmax(-1)
