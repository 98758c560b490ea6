"""The port's keypoint data path against the JAX package on the CPU:
``CocoKeypoint`` item by item on a ``person_keypoints`` directory, the
seven keypoint transforms and the configs' pipelines under one ``random``
seed, the detection collate's keypoints and areas, and the evaluators
(COCO OKS keypoints with OpenPose's bottom-up bridge, and PCK/OKS).

Tolerances: images, targets, collated batches and every evaluator stat
equal (``imgproc`` is OpenCV 5.0.0's arithmetic, the target arithmetic
the JAX transforms' float32; ``CropWithFactor`` is also held to
``cv2.resize(img, None, fx=s, fy=s)`` on sizes where its source step 1/s
differs from the ratio of the sizes).
"""
import copy
import json
import os
import random

import cv2
import numpy as np
import pytest

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets import coco as jax_coco
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms import keypoint_transforms as jkt
from cvpytorch_tpu.data.transforms.det_transforms import make_det_collate as jax_det_collate
from cvpytorch_tpu.evaluator import build_evaluator as jax_build_evaluator
from cvpytorch_tpu.evaluator import coco as jax_coco_eval
from cvpytorch_tpu.evaluator.keypoint import KeypointEvaluator as JaxKeypointEvaluator
from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
from cvpytorch_tpu_torch.data.datasets import coco
from cvpytorch_tpu_torch.data.transforms import build_transforms
from cvpytorch_tpu_torch.data.transforms import imgproc
from cvpytorch_tpu_torch.data.transforms import keypoint_transforms as tkt
from cvpytorch_tpu_torch.data.transforms.det_transforms import make_det_collate
from cvpytorch_tpu_torch.evaluator import build_evaluator
from cvpytorch_tpu_torch.evaluator import coco as coco_eval
from cvpytorch_tpu_torch.evaluator.keypoint import KeypointEvaluator
from tests.test_torch_det_host_aug import assert_sample_equal, run_both
from tests.test_torch_jpeg import scene
from tests.test_torch_paf import skeleton

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERSON = [{"id": 1, "name": "person"}]


def person_keypoints(rng, w, h, n):
    """``n`` skeletons in a (h, w) frame: jittered, scaled, some joints
    unlabelled (v = 0) or occluded (v = 1), some off the frame."""
    kps, boxes = [], []
    for _ in range(n):
        k = skeleton(rng.uniform(0.2, 0.8) * w, rng.uniform(0.3, 0.6) * h,
                     rng.uniform(0.15, 0.45) * h / 100)
        k[:, :2] += rng.uniform(-3, 3, (17, 2))
        k[:, 2] = rng.choice([0, 1, 2], 17, p=[0.1, 0.2, 0.7])
        lab = k[k[:, 2] > 0]
        x1, y1 = lab[:, :2].min(0) - 4
        x2, y2 = lab[:, :2].max(0) + 4
        kps.append(k)
        boxes.append([float(x1), float(y1), float(x2 - x1), float(y2 - y1)])
    return kps, boxes


def write_person_keypoints(root, n_images=6, seed=0, sizes=((96, 128), (120, 90), (100, 100))):
    """``root/images/*.jpg`` and ``root/person_keypoints.json``: skeletons
    with areas, one annotation without ``area`` (the box-area fallback),
    one without ``keypoints`` (zeros), a crowd person and an image with
    no annotation."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(n_images):
        h, w = sizes[i % len(sizes)]
        name = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), scene(h, w, seed * 100 + i),
                    [cv2.IMWRITE_JPEG_QUALITY, 92])
        images.append({"id": 10 + i, "file_name": name, "height": h, "width": w})
        if i == 1:
            continue
        kps, boxes = person_keypoints(rng, w, h, rng.randint(1, 4))
        for j, (k, b) in enumerate(zip(kps, boxes)):
            a = {"id": len(anns) + 1, "image_id": 10 + i, "category_id": 1, "bbox": b,
                 "iscrowd": int(i == 4 and j == 0), "num_keypoints": int((k[:, 2] > 0).sum()),
                 "keypoints": k.reshape(-1).round(2).tolist(),
                 "area": round(b[2] * b[3] * 0.6, 2)}
            if i == 2 and j == 0:
                del a["area"]
            if i == 3 and j == 0:
                del a["keypoints"]
            anns.append(a)
    ann_file = os.path.join(root, "person_keypoints.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": PERSON}, f)
    return img_dir, ann_file


def keypoint_dictionary():
    return load_dictionary(os.path.join(ROOT, "conf", "dicts", "coco_dict.yml"),
                           "KEYPOINT_CLASSES")[1]


def dataset_pair(root, stage, transforms=None):
    img_dir, ann_file = write_person_keypoints(root)
    cfg = {"IMG_DIR": img_dir, "ANN_FILE": ann_file}
    dictionary = keypoint_dictionary()
    got = coco.CocoKeypoint(CommonConfiguration(cfg), dictionary, stage=stage,
                            transform=build_transforms("KEYPOINT_CLASSES", transforms, stage)
                            if transforms else None)
    want = jax_coco.CocoKeypoint(JaxConfig(cfg), dictionary, stage=stage,
                                 transform=jax_build_transforms("KEYPOINT_CLASSES", transforms,
                                                                stage)
                                 if transforms else None)
    return got, want


def test_keypoint_dictionary_falls_back_as_jax():
    """``coco_dict.yml`` holds only DET_CLASSES: both read it for
    KEYPOINT_CLASSES."""
    from cvpytorch_tpu.config import load_dictionary as jax_load_dictionary

    got = keypoint_dictionary()
    assert got == jax_load_dictionary(os.path.join(ROOT, "conf", "dicts", "coco_dict.yml"),
                                      "KEYPOINT_CLASSES")[1]
    assert list(got[0]) == ["person"]


@pytest.mark.parametrize("stage", ["train", "val", "infer"])
def test_coco_keypoint_samples_equal_jax(tmp_path, stage):
    got, want = dataset_pair(tmp_path, stage)
    assert len(got) == len(want) == (5 if stage == "train" else 6)
    for i in range(len(want)):
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g["image"], w["image"])
        if w["target"] is None:
            assert g["target"] is None
            continue
        assert set(g["target"]) == set(w["target"]) >= {"keypoints", "areas"}
        for k, v in w["target"].items():
            np.testing.assert_array_equal(g["target"][k], v, err_msg=k)
            assert np.asarray(g["target"][k]).dtype == np.asarray(v).dtype, k


def kp_sample(rng, h=120, w=160, n=3):
    kps, boxes = person_keypoints(rng, w, h, n)
    b = np.asarray(boxes, np.float32)
    b[:, 2:] += b[:, :2]
    return {"image": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "target": {"boxes": b, "labels": np.zeros(n, np.int32),
                       "keypoints": np.stack(kps).astype(np.float32),
                       "areas": rng.uniform(100, 900, n).astype(np.float32)}}


TRANSFORMS = {
    "flip_coco_pairs": ("RandomHorizontalFlip", {"p": 1.0}),
    "flip_no_pairs": ("RandomHorizontalFlip", {"p": 1.0, "flip_pairs": None}),
    "vflip": ("RandomVerticalFlip", {"p": 1.0}),
    "resize_letterbox": ("Resize", {"size": [96, 96], "keep_ratio": True}),
    "resize_no_scaleup": ("Resize", {"size": [256, 320], "keep_ratio": True, "scaleup": False}),
    "resize_stretch": ("Resize", {"size": [72, 100], "keep_ratio": False}),
    "random_resized_crop": ("RandomResizedCrop", {"size": [96, 96], "scale": [0.3, 1.1],
                                                  "ratio": [0.8, 1.25]}),
    "crop_with_factor": ("CropWithFactor", {"size": 103, "factor": 32}),
    "crop_with_factor_half": ("CropWithFactor", {"size": 60, "factor": 16}),
}


@pytest.mark.parametrize("case", list(TRANSFORMS))
def test_keypoint_transform_equals_jax(case):
    name, kw = TRANSFORMS[case]
    rng = np.random.RandomState(len(case))
    for seed in range(4):
        sample = kp_sample(rng)
        got, want = run_both(lambda: getattr(tkt, name)(**kw), lambda: getattr(jkt, name)(**kw),
                             sample, seed)
        assert_sample_equal(got, want)


def test_crop_with_factor_floor_raises_as_jax():
    """``is_ceil=False`` floors the canvas below the resized image: both
    packages fail to copy it in (unless the sides are multiples of the
    factor)."""
    sample = kp_sample(np.random.RandomState(0))
    for cls in (tkt.CropWithFactor, jkt.CropWithFactor):
        with pytest.raises(ValueError, match="could not broadcast"):
            cls(size=60, factor=16, is_ceil=False)(copy.deepcopy(sample))


@pytest.mark.parametrize("size,hw", [(368, (427, 640)), (100, (200, 300)), (103, (91, 150))])
def test_crop_with_factor_resize_equals_cv2(size, hw):
    """fx = fy = s: OpenCV steps the source by 1/s (and an exact half is
    its 2×2 area mean)."""
    img = np.random.RandomState(size).randint(0, 256, hw + (3,)).astype(np.uint8)
    s = size / min(hw)
    want = cv2.resize(img, None, fx=s, fy=s)
    np.testing.assert_array_equal(imgproc.resize_linear(img, None, fxy=s), want)
    if want.shape[:2] != tuple(int(round(n * s)) for n in hw):
        pytest.fail("OpenCV's size rule")
    if size == 368:  # the step differs from the ratio of the sizes here
        assert not np.array_equal(imgproc.resize_linear(img, want.shape[:2]), want)


def test_infer_stage_letterbox_keys():
    """Without a target (the infer stage) the letterbox's pads and scales
    ride on the sample, as the detection ``Resize`` puts them."""
    sample = {"image": np.zeros((60, 80, 3), np.uint8), "target": None}
    out = tkt.Resize([96, 96])(sample)
    assert out["image"].shape == (96, 96, 3) and out["target"] is None
    np.testing.assert_array_equal(out["pads"], [0, 12])
    np.testing.assert_array_equal(out["scales"], np.float32([1.2, 1.2]))


@pytest.mark.parametrize("stage", ["TRAIN", "VAL"])
@pytest.mark.parametrize("config", ["coco_openpose", "coco_litepose"])
def test_config_pipelines_equal_jax(tmp_path, config, stage):
    """The configs' pipelines on the dataset's items, then the collate."""
    import yaml

    with open(os.path.join(ROOT, "conf", f"{config}.yml")) as f:
        transforms = yaml.safe_load(f)["DATASET"][stage]["TRANSFORMS"]
    got_ds, want_ds = dataset_pair(tmp_path, stage.lower(), transforms)
    got_items, want_items = [], []
    for i in range(len(want_ds)):
        random.seed(i)
        np.random.seed(i)
        want_items.append(want_ds[i])
        random.seed(i)
        np.random.seed(i)
        got_items.append(got_ds[i])
        assert_sample_equal(got_items[-1], want_items[-1])
    got = make_det_collate(8)(got_items)
    want = jax_det_collate(8)(copy.deepcopy(want_items))
    assert set(got["target"]) == set(want["target"]) >= {"keypoints", "areas"}
    for k, v in want["target"].items():
        np.testing.assert_array_equal(got["target"][k], v, err_msg=k)
    np.testing.assert_array_equal(got["image"], want["image"])


# -- evaluators -------------------------------------------------------------------------------
def eval_batch(seed, B=3, M=4, D=6):
    """Padded GT (letterboxed) and predictions around them: keypoints,
    boxes, areas, a crowd, a GT with no labelled keypoint."""
    rng = np.random.RandomState(seed)
    kp = np.zeros((B, M, 17, 3), np.float32)
    boxes = np.zeros((B, M, 4), np.float32)
    valid = rng.rand(B, M) < 0.8
    valid[:, 0] = True
    for b in range(B):
        ks, bx = person_keypoints(rng, 320, 240, M)
        kp[b] = np.stack(ks)
        bx = np.asarray(bx, np.float32)
        boxes[b] = np.concatenate([bx[:, :2], bx[:, :2] + bx[:, 2:]], 1)
    kp[0, 1, :, 2] = 0
    targets = {"boxes": boxes * 0.8 + 4, "labels": np.zeros((B, M), np.int32), "valid": valid,
               "keypoints": np.concatenate([kp[..., :2] * 0.8 + 4, kp[..., 2:]], -1),
               "areas": rng.uniform(200, 9000, (B, M)).astype(np.float32),
               "crowd": rng.rand(B, M) < 0.1,
               "pads": np.full((B, 2), 4.0, np.float32),
               "scales": np.full((B, 2), 0.8, np.float32)}
    src = rng.randint(0, M, (B, D))
    pk = kp[np.arange(B)[:, None], src].copy()
    pk[..., :2] += rng.randn(B, D, 17, 2).astype(np.float32) * rng.uniform(1, 12, (B, D, 1, 1))
    pk[..., 2] = 2.0
    preds = {"keypoints": pk, "boxes": boxes[np.arange(B)[:, None], src] + rng.randn(B, D, 4),
             "scores": rng.rand(B, D).astype(np.float32), "labels": np.zeros((B, D), np.int32),
             "valid": rng.rand(B, D) < 0.9}
    return targets, preds


def test_oks_iou_matches_jax():
    targets, preds = eval_batch(0)
    gk, pk = targets["keypoints"][0], preds["keypoints"][0]
    crowd = np.zeros(len(gk), bool)
    for areas in (targets["areas"][0], np.full(len(gk), 50.0)):
        got = coco_eval._oks_iou(pk, gk, targets["boxes"][0], areas, crowd)
        want = jax_coco_eval._oks_iou(pk, gk, targets["boxes"][0], areas, crowd)
        np.testing.assert_array_equal(got, want)
        assert (got[:, 1] > 0).any()  # the GT without labelled keypoints


@pytest.mark.parametrize("iou_types", [("bbox", "keypoints"), ("keypoints",)])
def test_coco_keypoint_stats_equal_jax(iou_types):
    cfg = {"EVALUATOR": {"NAME": "coco_keypoints", "EVAL_TYPE": "keypoints_mAP"}}
    if iou_types != ("bbox", "keypoints"):
        cfg["EVALUATOR"]["IOU_TYPES"] = list(iou_types)
    dataset = type("D", (), {"num_classes": 1, "id2name": {0: "person"}})()
    got = build_evaluator(CommonConfiguration(cfg), dataset)
    want = jax_build_evaluator(JaxConfig(cfg), dataset)
    assert got.iou_types == want.iou_types == iou_types
    for seed in range(3):
        t, p = eval_batch(seed)
        got.update(t, p)
        want.update(copy.deepcopy(t), copy.deepcopy(p))
    g, w = got.evaluate(), want.evaluate()
    assert g == w
    assert "keypoints_Recall_20" in g and "keypoints_AP_small" not in g
    assert 0 < g["keypoints_mAP"] < 1 and g["performance"] == g["keypoints_mAP"]


def test_bottom_up_bridge_stats_equal_jax():
    """OpenPose's val predictions (peaks, scores, ``conns``) go through the
    host assembly inside both evaluators."""
    import jax.numpy as jnp
    from cvpytorch_tpu.ops import paf as J

    rng = np.random.RandomState(3)
    kp = np.stack([np.stack(person_keypoints(rng, 184, 184, 3)[0]) for _ in range(2)])
    kp[..., 2] = np.maximum(kp[..., 2], 1)
    hm, pafs = J.render_openpose_targets(jnp.asarray(kp), jnp.ones((2, 3)), (184, 184))
    xy, score, valid = J.find_peaks(hm[..., :18])
    conns = J.greedy_limb_match(*J.score_limb_pairs(xy, valid, pafs))
    preds = {"peaks_xy": np.asarray(xy), "peaks_score": np.asarray(score),
             "conns": np.asarray(conns), "stride": np.full(2, 8, np.int32)}
    boxes = np.concatenate([kp[..., :2].min(2), kp[..., :2].max(2)], -1)
    targets = {"boxes": boxes, "labels": np.zeros((2, 3), np.int32), "valid": np.ones((2, 3), bool),
               "keypoints": kp, "areas": np.full((2, 3), 3000.0, np.float32)}
    got = coco_eval.CocoEvaluator(num_classes=1, iou_types=("bbox", "keypoints"))
    want = jax_coco_eval.CocoEvaluator(num_classes=1, iou_types=("bbox", "keypoints"))
    got.update(targets, preds)
    want.update(targets, preds)
    g, w = got.evaluate(), want.evaluate()
    assert g == w and g["keypoints_mAP"] > 0.5


def test_pck_oks_evaluator_equals_jax():
    rng = np.random.RandomState(1)
    got, want = KeypointEvaluator(eval_type="OKS_AP"), JaxKeypointEvaluator(eval_type="OKS_AP")
    for _ in range(3):
        t = {"keypoints": rng.uniform(0, 64, (4, 17, 2)), "valid": rng.rand(4, 17) < 0.8,
             "bbox_size": rng.uniform(10, 60, 4)}
        p = np.concatenate([t["keypoints"] + rng.randn(4, 17, 2) * 3, rng.rand(4, 17, 1)], -1)
        got.update(t, p)
        want.update(t, p)
    assert got.evaluate() == want.evaluate()
    assert got.state_dict() == want.state_dict()


def test_keypoint_evaluator_raises_where_jax_raises():
    """The configs' ``keypoint`` evaluator on the models' val outputs:
    LitePose's (B, 17, 3) against the collated (B, M, 17, 3) keypoints,
    and OpenPose's prediction dict."""
    t = {"keypoints": np.zeros((2, 4, 17, 3), np.float32), "valid": np.ones((2, 4), bool)}
    lite = np.zeros((2, 17, 3), np.float32)
    openpose = {"heatmaps": np.zeros((2, 8, 8, 19)), "conns": np.zeros((2, 19, 20, 3))}
    with pytest.raises(ValueError):
        JaxKeypointEvaluator().update(t, lite)
    with pytest.raises(ValueError, match=r"single-instance .*\(2, 4, 17, 3\)"):
        KeypointEvaluator().update(t, lite)
    with pytest.raises(IndexError):
        JaxKeypointEvaluator().update(t, openpose)
    with pytest.raises(ValueError, match="not a dict"):
        KeypointEvaluator().update(t, openpose)
