"""Evaluator contract (counterpart of ``cvpytorch_tpu/evaluator/base.py``):
``update(targets, preds)`` / ``evaluate() → {metric: float, 'performance':
float}`` / ``reset()``.  'performance' drives best checkpoints and early
stopping."""
from __future__ import annotations


class BaseEvaluator:
    def __init__(self, dataset=None, **kwargs):
        self.dataset = dataset

    def update(self, targets, preds):
        raise NotImplementedError

    def evaluate(self) -> dict:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError
