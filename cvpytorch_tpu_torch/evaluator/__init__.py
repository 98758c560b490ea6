"""Evaluator factory (counterpart of ``cvpytorch_tpu/evaluator/__init__.py``):
selects by ``cfg.EVALUATOR.NAME``: the COCO protocol for boxes, masks
and keypoints (``coco_keypoints`` is ``coco_detection`` with bbox and
OKS keypoints unless ``IOU_TYPES`` says otherwise), the VOC protocol for
boxes, the segmentation confusion matrix, the classification accuracies
and the single-instance keypoint PCK/OKS (``keypoint``)."""
from __future__ import annotations

from ..registry import EVALUATORS
from . import classification, coco, keypoint, segmentation, voc  # noqa: F401  (registers)


def build_evaluator(cfg, dataset=None):
    ev_cfg = cfg.EVALUATOR or {}
    name = ev_cfg.get("NAME", "classification")
    kwargs = {}
    if ev_cfg.get("EVAL_TYPE"):
        kwargs["eval_type"] = ev_cfg.get("EVAL_TYPE")
    if ev_cfg.get("IOU_TYPES"):
        kwargs["iou_types"] = tuple(ev_cfg.get("IOU_TYPES"))
    if name == "coco_keypoints":
        name = "coco_detection"
        kwargs.setdefault("iou_types", ("bbox", "keypoints"))
    if name not in EVALUATORS:
        raise KeyError(f"no evaluator {name!r}: the port has classification, "
                       "coco_detection (coco), coco_keypoints, voc_detection, "
                       "segmentation and keypoint, as the JAX package has")
    return EVALUATORS.get(name)(dataset=dataset, **kwargs)
