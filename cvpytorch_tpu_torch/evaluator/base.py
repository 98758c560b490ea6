"""Evaluator contract (counterpart of ``cvpytorch_tpu/evaluator/base.py``):
``update(targets, preds, indices=None)`` / ``evaluate() → {metric: float,
'performance': float}`` / ``reset()``.  'performance' drives best
checkpoints and early stopping.

Data parallelism: each rank scores its rows of the val set; before
``evaluate()`` the trainer gathers every rank's ``state_dict()`` and calls
``merge_state_dicts`` (self's included), so that every rank evaluates the
whole set.  ``indices`` are the batch's images' positions in the val
set's single-process order: an evaluator whose metrics depend on the order
of its records (the AP sorts rank score ties by it) keeps them and the
merge restores that order; without them the merge concatenates the
states in their order, as the JAX merge does."""
from __future__ import annotations


class BaseEvaluator:
    def __init__(self, dataset=None, **kwargs):
        self.dataset = dataset

    def update(self, targets, preds, indices=None):
        raise NotImplementedError

    def evaluate(self) -> dict:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def state_dict(self):
        """Picklable local accumulation (for the cross-rank gather)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support a cross-rank merge")

    def merge_state_dicts(self, states):
        """Replaces the local accumulation with the merge of every rank's
        ``state_dict()``, in the single-process order."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support a cross-rank merge")
