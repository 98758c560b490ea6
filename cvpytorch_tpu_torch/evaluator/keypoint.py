"""Keypoint evaluator: PCK and OKS-AP (counterpart of
``cvpytorch_tpu/evaluator/keypoint.py``, numpy).

``update(targets, preds)`` takes single-instance targets
``{'keypoints': (B, K, 2), 'valid': (B, K)[, 'bbox_size': (B,)]}`` and
decoded ``preds`` (B, K, 3) (x, y, confidence) in the same pixels.  The
detection collate's (B, M, K, 3) keypoints and OpenPose's prediction dict
are refused with the cause named (the JAX evaluator fails on both too:
numpy broadcasting and indexing).
"""
from __future__ import annotations

import numpy as np

from ..registry import EVALUATORS
from .base import BaseEvaluator

# COCO per-keypoint OKS sigmas
COCO_SIGMAS = np.array([
    .026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
    .107, .107, .087, .087, .089, .089])


@EVALUATORS.register(name="keypoint")
class KeypointEvaluator(BaseEvaluator):
    def __init__(self, dataset=None, num_keypoints: int = 17, eval_type: str = "PCK",
                 pck_threshold: float = 0.2, **_):
        super().__init__(dataset)
        self.num_keypoints = num_keypoints
        self.eval_type = eval_type
        self.pck_threshold = pck_threshold
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0
        self._oks: list[float] = []

    def update(self, targets, preds, indices=None):  # sums: order-free
        if isinstance(preds, dict):
            raise ValueError("the keypoint evaluator takes decoded (B, K, 3) keypoints, not a "
                             f"dict of {sorted(preds)} (a bottom-up model: use coco_keypoints)")
        gt = np.asarray(targets["keypoints"])
        p = np.asarray(preds)[..., :2]
        if gt.shape != p.shape:
            raise ValueError(f"the keypoint evaluator takes single-instance (B, K, 2) "
                             f"keypoints of the predictions' {p.shape[:2]}, not {gt.shape} "
                             "(the detection collate's (B, M, K, 3) persons: use coco_keypoints)")
        valid = np.asarray(targets["valid"]).astype(bool)
        size = np.asarray(targets.get("bbox_size", np.full(len(gt), 1.0)))
        dist = np.linalg.norm(p - gt, axis=-1)  # (B, K)
        thr = self.pck_threshold * np.maximum(size, 1e-6)[:, None]
        self._correct += int((dist[valid] < np.broadcast_to(thr, dist.shape)[valid]).sum())
        self._total += int(valid.sum())
        k = min(self.num_keypoints, len(COCO_SIGMAS))
        var = (2 * COCO_SIGMAS[:k]) ** 2
        for b in range(len(gt)):
            v = valid[b][:k]
            if not v.any():
                continue
            e = dist[b][:k] ** 2 / (2 * np.maximum(size[b], 1e-6) ** 2 * var)
            self._oks.append(float(np.exp(-e)[v].mean()))

    def state_dict(self):
        return {"correct": self._correct, "total": self._total, "oks": self._oks}

    def merge_state_dicts(self, states):
        self._correct = sum(s["correct"] for s in states)
        self._total = sum(s["total"] for s in states)
        self._oks = [o for s in states for o in s["oks"]]

    def evaluate(self) -> dict:
        pck = self._correct / max(self._total, 1)
        oks = np.asarray(self._oks)
        out = {"PCK": float(pck)}
        if len(oks):
            thrs = np.arange(0.5, 1.0, 0.05)  # AP over OKS thresholds .5:.95
            out["OKS_AP"] = float(np.mean([(oks > t).mean() for t in thrs]))
        out["performance"] = out.get(self.eval_type, out["PCK"])
        return out
