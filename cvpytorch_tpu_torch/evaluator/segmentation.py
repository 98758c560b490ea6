"""Segmentation evaluator (counterpart of
``cvpytorch_tpu/evaluator/segmentation.py``): a confusion matrix
accumulated on the host with ``np.bincount`` over the valid pixels (label
255 and labels ≥ ``num_classes`` are ignored), and from it PA, mPA, mIoU,
FWIoU and each class's IoU.  ``state_dict`` / ``merge_state_dicts`` carry
the matrix between processes."""
from __future__ import annotations

import numpy as np

from ..registry import EVALUATORS
from .base import BaseEvaluator


@EVALUATORS.register(name="segmentation")
class SegmentationEvaluator(BaseEvaluator):
    def __init__(self, dataset=None, num_classes: int | None = None,
                 eval_type: str = "mIoU", ignore_index: int = 255, **_):
        super().__init__(dataset)
        self.num_classes = num_classes or getattr(dataset, "num_classes", None)
        if not self.num_classes:
            raise ValueError("the segmentation evaluator needs num_classes "
                             "(or a dataset with a dictionary)")
        self.eval_type = eval_type
        self.ignore_index = ignore_index
        self.id2name = getattr(dataset, "id2name", {})
        self.reset()

    def reset(self):
        n = self.num_classes
        self.confusion = np.zeros((n, n), dtype=np.int64)

    def update(self, targets, preds, indices=None):  # sums: order-free
        t = np.asarray(targets).reshape(-1)
        p = np.asarray(preds).reshape(-1)
        valid = (t != self.ignore_index) & (t < self.num_classes)
        idx = t[valid].astype(np.int64) * self.num_classes + p[valid].astype(np.int64)
        self.confusion += np.bincount(
            idx, minlength=self.num_classes**2).reshape(self.num_classes, self.num_classes)

    def state_dict(self):
        return {"confusion": self.confusion}

    def merge_state_dicts(self, states):
        self.confusion = np.sum([s["confusion"] for s in states], axis=0)

    def evaluate(self) -> dict:
        c = self.confusion.astype(np.float64)
        diag = np.diag(c)
        gt_total = c.sum(1)
        pred_total = c.sum(0)
        with np.errstate(divide="ignore", invalid="ignore"):
            pa = diag.sum() / max(c.sum(), 1)
            class_pa = np.where(gt_total > 0, diag / np.maximum(gt_total, 1), np.nan)
            union = gt_total + pred_total - diag
            iou = np.where(union > 0, diag / np.maximum(union, 1), np.nan)
            freq = gt_total / max(c.sum(), 1)
            fwiou = np.nansum(freq * np.nan_to_num(iou))
        out = {
            "PA": float(pa),
            "mPA": float(np.nanmean(class_pa)) if np.any(gt_total > 0) else 0.0,
            "mIoU": float(np.nanmean(iou)) if np.any(union > 0) else 0.0,
            "FWIoU": float(fwiou),
        }
        for i in range(self.num_classes):
            name = self.id2name.get(i, str(i))
            out[f"IoU_{name}"] = float(iou[i]) if union[i] > 0 else float("nan")
        out["performance"] = out.get(self.eval_type, out["mIoU"])
        return out
