"""The port's ``voc_detection`` evaluator against the JAX package's on
seeded detections: score ties, a class without gt (left out), a class
with gt and no detections (AP 0), a detection on an already used gt (a
false positive), gt un-letterboxed by ``pads``/``scales``, and the split
and merge of the evaluator's state.  Every metric equal (exact: the same
numpy arithmetic, ties ranked by the same default sort)."""
import numpy as np
import pytest

from cvpytorch_tpu.evaluator.voc import VOCEvaluator as JaxVOCEvaluator
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.evaluator import build_evaluator
from cvpytorch_tpu_torch.evaluator.voc import VOCEvaluator, average_precision

NUM_CLASSES = 6  # class 4: gt, no detections; class 5: detections, no gt


class _Dataset:
    num_classes = NUM_CLASSES
    id2name = {i: f"cls{i}" for i in range(NUM_CLASSES)}


def batches(seed=0, n_batches=3, B=4, M=8, K=12):
    """Letterboxed targets (network pixels) and predictions (original
    pixels): each detection a jittered gt of its class, a duplicate of one
    (the used-gt false positive) or a random box, scores in 0.1 steps so
    that many tie."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        scales = rng.uniform(0.5, 1.5, (B, 1)).repeat(2, 1)
        pads = np.stack([rng.uniform(0, 40, B), np.zeros(B)], 1)
        gt = np.zeros((B, M, 4), np.float32)
        labels = rng.randint(0, 5, (B, M)).astype(np.int32)
        valid = np.zeros((B, M), bool)
        boxes = np.zeros((B, K, 4), np.float32)
        dl = np.zeros((B, K), np.int32)
        pv = np.zeros((B, K), bool)
        for b in range(B):
            n = rng.randint(1, M + 1)
            valid[b, :n] = True
            xy = rng.uniform(0, 300, (M, 2))
            wh = rng.uniform(10, 120, (M, 2))
            orig = np.concatenate([xy, xy + wh], 1)
            gt[b] = np.concatenate([orig[:, :2] * scales[b] + pads[b],
                                    orig[:, 2:] * scales[b] + pads[b]], 1)
            k = rng.randint(0, K + 1)
            pv[b, :k] = True
            for j in range(k):
                g = rng.randint(n)
                kind = rng.rand()
                if kind < 0.6:
                    boxes[b, j] = orig[g] + rng.normal(0, 4, 4)
                    dl[b, j] = labels[b, g] if rng.rand() < 0.9 else 5
                elif kind < 0.8 and j:
                    boxes[b, j] = boxes[b, j - 1]
                    dl[b, j] = dl[b, j - 1]
                else:
                    boxes[b, j] = np.concatenate([xy[0], xy[0] + wh[0]]) + rng.uniform(-50, 50)
                    dl[b, j] = rng.randint(0, 4)
            dl[b][dl[b] == 4] = 3  # no detections of class 4
        scores = (rng.randint(1, 10, (B, K)) / 10).astype(np.float32)
        targets = {"boxes": gt, "labels": labels, "valid": valid, "pads": pads,
                   "scales": scales}
        preds = {"boxes": boxes, "scores": scores, "labels": dl, "valid": pv}
        out.append((targets, preds))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voc_evaluator_equals_jax(seed):
    port = VOCEvaluator(dataset=_Dataset())
    ref = JaxVOCEvaluator(dataset=_Dataset())
    for targets, preds in batches(seed):
        port.update(targets, preds)
        ref.update(targets, preds)
    got, want = port.evaluate(), ref.evaluate()
    assert got == want
    assert "AP_cls4" in got and got["AP_cls4"] == 0.0
    assert "AP_cls5" not in got
    assert 0 < got["mAP"] < 1 and got["performance"] == got["mAP"]


def test_used_gt_is_a_false_positive_and_letterbox_is_undone():
    """One gt (letterboxed by pad 10, scale 2) and two identical detections
    on it in original pixels: the second is a false positive, so AP is
    the precision-1 step at recall 1 = 1.0; without un-letterboxing the
    detections would miss."""
    targets = {"boxes": np.array([[[30, 20, 90, 80]]], np.float32),
               "labels": np.zeros((1, 1), np.int32), "valid": np.ones((1, 1), bool),
               "pads": np.array([[10.0, 0.0]]), "scales": np.array([[2.0, 2.0]])}
    preds = {"boxes": np.array([[[10, 10, 40, 40], [10, 10, 40, 40]]], np.float32),
             "scores": np.array([[0.9, 0.8]], np.float32),
             "labels": np.zeros((1, 2), np.int32), "valid": np.ones((1, 2), bool)}
    for cls in (VOCEvaluator, JaxVOCEvaluator):
        ev = cls(num_classes=1)
        ev.update(targets, preds)
        assert ev.evaluate()["mAP"] == 1.0
        scores, matches, n_gt = VOCEvaluator._match_class(ev, 0)
        assert matches == [1, 0] and n_gt == 1


def test_state_dicts_merge_to_the_whole():
    data = batches(3, n_batches=4)
    whole, parts = VOCEvaluator(dataset=_Dataset()), []
    for i, (t, p) in enumerate(data):
        whole.update(t, p)
        if i % 2 == 0:
            parts.append(VOCEvaluator(dataset=_Dataset()))
        parts[-1].update(t, p)
    merged = VOCEvaluator(dataset=_Dataset())
    merged.merge_state_dicts([e.state_dict() for e in parts])
    assert merged.evaluate() == whole.evaluate()


def test_all_point_interpolation():
    """Precision made monotone from the right, summed over recall steps."""
    recall = np.array([0.25, 0.25, 0.5, 0.75])
    precision = np.array([1.0, 0.5, 0.67, 0.75])
    assert average_precision(recall, precision) == pytest.approx(0.25 + 0.25 * 0.75 + 0.25 * 0.75)


def test_registered_as_voc_detection():
    cfg = CommonConfiguration({"EVALUATOR": {"NAME": "voc_detection", "EVAL_TYPE": "mAP"}})
    ev = build_evaluator(cfg, _Dataset())
    assert isinstance(ev, VOCEvaluator) and ev.num_classes == NUM_CLASSES
