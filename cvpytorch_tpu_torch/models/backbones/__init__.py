"""Backbone factory (counterpart of ``cvpytorch_tpu/models/backbones/__init__.py``):
the registry resolves the YAML ``BACKBONE.name``."""
from __future__ import annotations

import inspect

from ...registry import BACKBONES

from . import (  # noqa: F401  (registers)
    convnext, csp_darknet, custom_cspnet, efficientnet, efficientnet_lite, lfd_resnet,
    misc_backbones, mobilenetv2, mobilenetv3, regnet, repvgg, resnet, seg_light,
    seg_transformers, shufflenetv2, tinynet, vgg)


def build_backbone(cfg):
    """cfg: ``{'name': 'ResNet', 'subtype': 'resnet50', ...}``, the schema
    of the YAML BACKBONE blocks; keys the constructor does not take are
    dropped, as the JAX factory drops the fields its module lacks."""
    kwargs = dict(cfg.items() if hasattr(cfg, "items") else cfg)
    cls = BACKBONES.get(kwargs.pop("name"))
    params = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in params})
