"""Evaluator factory (counterpart of ``cvpytorch_tpu/evaluator/__init__.py``):
selects by ``cfg.EVALUATOR.NAME``.  The port has the COCO protocol
for boxes and masks, the VOC protocol for boxes, the segmentation
confusion matrix and the classification accuracies."""
from __future__ import annotations

from ..registry import EVALUATORS
from . import classification, coco, segmentation, voc  # noqa: F401  (registers)


def build_evaluator(cfg, dataset=None):
    ev_cfg = cfg.EVALUATOR or {}
    name = ev_cfg.get("NAME", "classification")
    kwargs = {}
    if ev_cfg.get("EVAL_TYPE"):
        kwargs["eval_type"] = ev_cfg.get("EVAL_TYPE")
    if ev_cfg.get("IOU_TYPES"):
        kwargs["iou_types"] = tuple(ev_cfg.get("IOU_TYPES"))
    if name not in EVALUATORS:
        raise KeyError(f"evaluator {name!r} is not ported yet (ROADMAP, "
                       "Queue 1); the port has classification, coco_detection, "
                       "voc_detection and segmentation")
    return EVALUATORS.get(name)(dataset=dataset, **kwargs)
