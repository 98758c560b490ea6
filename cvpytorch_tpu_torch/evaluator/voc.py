"""VOC-protocol detection evaluator (counterpart of
``cvpytorch_tpu/evaluator/voc.py``), registered as ``voc_detection``.

Per class, over the whole set: each image's detections of the class in
score order are matched greedily to its gt at one IoU threshold (the
best-IoU gt; a gt already used makes the detection a false positive),
then all detections are ranked by score and AP is the area under the
all-point interpolated precision/recall curve.  A class without gt is
left out of mAP; a class with gt and no detections counts AP 0.  The gt
arrives in network pixels and is un-letterboxed by ``pads``/``scales``;
the predictions are already in the original image's pixels.  Sorts use
numpy's default kind, as the JAX evaluator does, so score ties rank the
same: the ranking depends on the order of the images' records, which
``merge_state_dicts`` puts back in the single-process order by the
images' positions (``update``'s ``indices``); without them it
concatenates the states in their order, as the JAX merge does."""
from __future__ import annotations

import numpy as np

from ..registry import EVALUATORS
from .base import BaseEvaluator
from .coco import _box_iou


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP: the precision envelope integrated over
    the recall steps."""
    mrec = np.concatenate([[0], recall, [1]])
    mpre = np.concatenate([[0], precision, [0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


@EVALUATORS.register(name="voc_detection")
class VOCEvaluator(BaseEvaluator):
    def __init__(self, dataset=None, num_classes: int | None = None,
                 eval_type: str = "mAP", iou_threshold: float = 0.5, **_):
        super().__init__(dataset)
        self.num_classes = num_classes or getattr(dataset, "num_classes", None)
        if not self.num_classes:
            raise ValueError("voc_detection needs num_classes or a dataset with a dictionary")
        self.eval_type = eval_type
        self.iou_threshold = iou_threshold
        self.id2name = getattr(dataset, "id2name", {})
        self.reset()

    def reset(self):
        self._dets, self._gts, self._pos = [], [], []

    def update(self, targets, preds, indices=None):
        t_boxes = np.asarray(targets["boxes"])
        t_labels = np.asarray(targets["labels"])
        t_valid = np.asarray(targets["valid"])
        B = len(t_boxes)
        pads = np.asarray(targets.get("pads", np.zeros((B, 2))))
        scales = np.asarray(targets.get("scales", np.ones((B, 2))))
        p_boxes, p_scores, p_labels, p_valid = (
            np.asarray(preds[k]) for k in ("boxes", "scores", "labels", "valid"))
        self._pos.extend([None] * B if indices is None else (int(i) for i in indices))
        for i in range(B):
            gv = t_valid[i]
            gb = t_boxes[i][gv].copy()
            if len(gb):
                gb[:, [0, 2]] = (gb[:, [0, 2]] - pads[i, 0]) / scales[i, 0]
                gb[:, [1, 3]] = (gb[:, [1, 3]] - pads[i, 1]) / scales[i, 1]
            self._gts.append((gb, t_labels[i][gv]))
            pv = p_valid[i]
            self._dets.append((p_boxes[i][pv], p_scores[i][pv], p_labels[i][pv]))

    def state_dict(self):
        return {"dets": self._dets, "gts": self._gts, "pos": self._pos}

    def merge_state_dicts(self, states):
        records = [r for s in states for r in zip(s["pos"], s["dets"], s["gts"])]
        if all(r[0] is not None for r in records):
            records.sort(key=lambda r: r[0])
        self._pos = [r[0] for r in records]
        self._dets = [r[1] for r in records]
        self._gts = [r[2] for r in records]

    def _match_class(self, c: int) -> tuple[list, list, int]:
        """Scores and 0/1 matches of class ``c``'s detections, and its gt count."""
        scores, matches, n_gt = [], [], 0
        for (db, ds, dl), (gb, gl) in zip(self._dets, self._gts):
            g = gb[gl == c]
            n_gt += len(g)
            sel = dl == c
            order = np.argsort(-ds[sel])
            d, s = db[sel][order], ds[sel][order]
            used = np.zeros(len(g), bool)
            for k in range(len(d)):
                scores.append(s[k])
                if len(g) == 0:
                    matches.append(0)
                    continue
                ious = _box_iou(d[k:k + 1], g, np.zeros(len(g), bool))[0]
                best = int(np.argmax(ious))
                hit = ious[best] >= self.iou_threshold and not used[best]
                used[best] |= hit
                matches.append(int(hit))
        return scores, matches, n_gt

    def evaluate(self) -> dict:
        aps = {}
        for c in range(self.num_classes):
            scores, matches, n_gt = self._match_class(c)
            if n_gt == 0:
                continue
            if not scores:
                aps[c] = 0.0
                continue
            m = np.asarray(matches)[np.argsort(-np.asarray(scores))]
            tp = np.cumsum(m)
            fp = np.cumsum(1 - m)
            aps[c] = average_precision(tp / n_gt, tp / np.maximum(tp + fp, 1e-9))
        m_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        out = {"mAP": m_ap}
        for c, v in aps.items():
            out[f"AP_{self.id2name.get(c, c)}"] = v
        out["performance"] = m_ap
        return out
