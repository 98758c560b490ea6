"""The port's COCO box evaluator against the JAX package's on the same
padded targets and predictions: the same metrics, exactly."""
import numpy as np
import pytest

from cvpytorch_tpu.evaluator.coco import CocoEvaluator as JaxCocoEvaluator
from cvpytorch_tpu_torch.evaluator import build_evaluator
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.evaluator.coco import CocoEvaluator
from cvpytorch_tpu_torch.evaluator.segmentation import SegmentationEvaluator
from cvpytorch_tpu_torch.evaluator.voc import VOCEvaluator


def batch(seed, B=4, M=6, K=12, C=3):
    """GT in network pixels with letterbox pads/scales and a crowd box;
    predictions near the GT (some exact, some off, some false)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (B, M, 2))
    wh = rng.uniform(8, 120, (B, M, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    valid = rng.rand(B, M) < 0.8
    crowd = np.zeros((B, M), bool)
    crowd[0, 0] = True
    pads = rng.uniform(0, 20, (B, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 2, (B, 2)).astype(np.float32)
    orig = (gt - np.concatenate([pads, pads], -1)[:, None]) / \
        np.concatenate([scales, scales], -1)[:, None]
    src = rng.randint(0, M, (B, K))
    boxes = np.take_along_axis(orig, src[..., None], 1) + rng.randn(B, K, 4) * \
        rng.choice([0.0, 2.0, 30.0], (B, K, 1))
    preds = {"boxes": boxes.astype(np.float32),
             "scores": rng.rand(B, K).astype(np.float32),
             "labels": np.where(rng.rand(B, K) < 0.8,
                                np.take_along_axis(labels, src, 1),
                                rng.randint(0, C, (B, K))).astype(np.int32),
             "valid": rng.rand(B, K) < 0.9}
    targets = {"boxes": gt, "labels": labels, "valid": valid, "crowd": crowd,
               "pads": pads, "scales": scales}
    return targets, preds


class DS:
    num_classes = 3
    id2name = {0: "a", 1: "b", 2: "c"}


@pytest.mark.parametrize("eval_type", ["mAP", "AP50"])
def test_coco_box_metrics_equal_jax(eval_type):
    want_ev = JaxCocoEvaluator(dataset=DS(), eval_type=eval_type)
    got_ev = CocoEvaluator(dataset=DS(), eval_type=eval_type)
    for seed in range(3):
        targets, preds = batch(seed)
        want_ev.update(targets, preds)
        got_ev.update(targets, preds)
    want, got = want_ev.evaluate(), got_ev.evaluate()
    assert got == want
    assert 0 < got["mAP"] < 1 and got["performance"] == want[eval_type]


def test_build_evaluator_names():
    cfg = CommonConfiguration({"EVALUATOR": {"NAME": "coco_detection", "EVAL_TYPE": "mAP"}})
    assert isinstance(build_evaluator(cfg, DS()), CocoEvaluator)
    seg = build_evaluator(CommonConfiguration(
        {"EVALUATOR": {"NAME": "segmentation", "EVAL_TYPE": "mIoU"}}), DS())
    assert isinstance(seg, SegmentationEvaluator) and seg.num_classes == 3
    voc = build_evaluator(CommonConfiguration({"EVALUATOR": {"NAME": "voc_detection"}}), DS())
    assert isinstance(voc, VOCEvaluator) and voc.num_classes == 3
    from cvpytorch_tpu_torch.evaluator.keypoint import KeypointEvaluator

    kpt = build_evaluator(CommonConfiguration({"EVALUATOR": {"NAME": "keypoint",
                                                             "EVAL_TYPE": "OKS"}}), DS())
    assert isinstance(kpt, KeypointEvaluator) and kpt.eval_type == "OKS"
    oks = build_evaluator(CommonConfiguration({"EVALUATOR": {"NAME": "coco_keypoints"}}), DS())
    assert isinstance(oks, CocoEvaluator) and oks.iou_types == ("bbox", "keypoints")
    with pytest.raises(KeyError, match="no evaluator 'pck_top_down'"):
        build_evaluator(CommonConfiguration({"EVALUATOR": {"NAME": "pck_top_down"}}), DS())
