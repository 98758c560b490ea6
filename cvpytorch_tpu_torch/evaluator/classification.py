"""Classification evaluator (counterpart of
``cvpytorch_tpu/evaluator/classification.py``): per-class counts of
correct and total predictions, from which ``Acc``, ``mAcc`` (the mean
over the classes present) and each class's ``Acc_<name>``; 'performance'
is the ``eval_type`` metric.  ``state_dict`` / ``merge_state_dicts``
carry the counts between processes."""
from __future__ import annotations

import numpy as np

from ..registry import EVALUATORS
from .base import BaseEvaluator


@EVALUATORS.register(name="classification")
class ClassificationEvaluator(BaseEvaluator):
    def __init__(self, dataset=None, num_classes: int | None = None,
                 eval_type: str = "mAcc", **_):
        super().__init__(dataset)
        self.num_classes = num_classes or getattr(dataset, "num_classes", None)
        if not self.num_classes:
            raise ValueError("the classification evaluator needs num_classes "
                             "(or a dataset with a dictionary)")
        self.eval_type = eval_type
        self.id2name = getattr(dataset, "id2name", {})
        self.reset()

    def reset(self):
        self.correct = np.zeros(self.num_classes, dtype=np.int64)
        self.total = np.zeros(self.num_classes, dtype=np.int64)

    def update(self, targets, preds, indices=None):  # sums: order-free
        t = np.asarray(targets).reshape(-1).astype(np.int64)
        p = np.asarray(preds).reshape(-1).astype(np.int64)
        seen = (t >= 0) & (t < self.num_classes)
        t, p = t[seen], p[seen]
        self.total += np.bincount(t, minlength=self.num_classes)
        self.correct += np.bincount(t[p == t], minlength=self.num_classes)

    def state_dict(self):
        return {"correct": self.correct, "total": self.total}

    def merge_state_dicts(self, states):
        self.correct = np.sum([s["correct"] for s in states], axis=0)
        self.total = np.sum([s["total"] for s in states], axis=0)

    def evaluate(self) -> dict:
        present = self.total > 0
        per_class = np.where(present, self.correct / np.maximum(self.total, 1), np.nan)
        m_acc = float(np.nanmean(per_class)) if present.any() else 0.0
        out = {"Acc": float(self.correct.sum() / max(self.total.sum(), 1)), "mAcc": m_acc}
        for c in range(self.num_classes):
            out[f"Acc_{self.id2name.get(c, str(c))}"] = (float(per_class[c]) if present[c]
                                                         else float("nan"))
        out["performance"] = out.get(self.eval_type, m_acc)
        return out
