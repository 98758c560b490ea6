"""The port's COCO data path against the JAX package's, on a tiny COCO
directory of JPEG files written here with OpenCV:

* ``CocoDetection`` / ``CocoSegmentation``: the same items, images,
  boxes, labels and masks (polygons with points on and past the border,
  compressed and uncompressed RLE), the same mosaic groups under the same
  ``random`` seed, and the same samples through ``conf/coco_yolov5_s.yml``'s
  TRAIN (mosaic) and VAL pipelines with ``random`` and ``np.random``
  seeded; ``CACHE``;
* ``imgproc.fill_poly`` against ``cv2.fillPoly`` on seeded random
  polygons (inside, on the border as COCO's are, outside, degenerate,
  self-touching);
* the host C RLE codec and COCO matchers against the JAX package's C and
  its numpy ``rle_py``, and against the port's plain Python matcher;
* the ``CocoEvaluator``'s 12 bbox and 12 segm metrics (masks of 256²,
  through the RLE codec) against the JAX evaluator's;
* one ``Trainer`` step of ``conf/coco_yolov5_s.yml`` on the directory,
  cut to 64²: its batch equals the JAX pipeline's, its loss is finite.
"""
import copy
import json
import os
import random

import cv2
import numpy as np
import pytest
import yaml

from cvpytorch_tpu import native as jax_native
from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets import coco as jax_coco
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms import det_transforms as jdt
from cvpytorch_tpu.evaluator.coco import CocoEvaluator as JaxCocoEvaluator
from cvpytorch_tpu.native import rle_py
from cvpytorch_tpu_torch import native
from cvpytorch_tpu_torch import trainer as trainer_mod
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.data.datasets import coco
from cvpytorch_tpu_torch.data.transforms import build_transforms
from cvpytorch_tpu_torch.data.transforms.det_transforms import make_det_collate
from cvpytorch_tpu_torch.data.transforms.imgproc import fill_poly
from cvpytorch_tpu_torch.evaluator import coco as coco_eval
from cvpytorch_tpu_torch.evaluator.coco import CocoEvaluator
from tests.test_torch_jpeg import scene
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "conf", "coco_yolov5_s.yml")
DICTIONARY = [{"person": 1.0}, {"car": 1.0}, {"dog": 1.0}]
CATEGORIES = [{"id": 18, "name": "dog"}, {"id": 1, "name": "person"}, {"id": 3, "name": "car"},
              {"id": 5, "name": "zebra"}]  # zebra is not in the dictionary


def polygon(rng, x, y, w, h, W, H):
    """A star-ish polygon around the box, some points pushed to or past
    the image border as COCO's annotations have them."""
    k = rng.randint(3, 9)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rng.uniform(0.3, 0.6, k)
    px = x + w / 2 + r * w * np.cos(ang)
    py = y + h / 2 + r * h * np.sin(ang)
    if rng.rand() < 0.4:
        px[rng.randint(k)] = W  # on the right border: int() gives x == W
    return np.stack([np.clip(px, 0, W), np.clip(py, 0, H)], 1).reshape(-1).round(2).tolist()


def write_coco(root, n_images: int, seed: int = 0, sizes=((43, 64), (64, 48), (48, 48))) -> tuple:
    """``root/images/*.jpg`` and ``root/instances.json``: boxes, polygon
    and RLE segmentations, a crowd RLE, a degenerate box, an image with no
    annotation and a category outside the dictionary."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(n_images):
        h, w = sizes[i % len(sizes)]
        name = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), scene(h, w, seed * 1000 + i),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        images.append({"id": 100 + i, "file_name": name, "height": h, "width": w})
        if i == 1:
            continue  # no annotation: dropped at the train stage
        for _ in range(rng.randint(1, 5)):
            bw, bh = rng.uniform(4, w * 0.7), rng.uniform(4, h * 0.7)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            cat = CATEGORIES[rng.randint(len(CATEGORIES))]["id"]
            segm = [polygon(rng, x, y, bw, bh, w, h) for _ in range(rng.randint(1, 3))]
            anns.append({"id": len(anns) + 1, "image_id": 100 + i, "category_id": cat,
                         "bbox": [round(x, 2), round(y, 2), round(bw, 2), round(bh, 2)],
                         "area": bw * bh, "iscrowd": 0, "segmentation": segm})
        m = np.zeros((h, w), np.uint8)
        m[h // 4:h // 2, w // 4:w // 2] = 1
        counts = jax_native.rle_from_mask(m)
        box = [w / 4, h / 4, w / 4, h / 4]
        rle = {"size": [h, w], "counts": jax_native.rle_encode_string(counts)}
        anns.append({"id": len(anns) + 1, "image_id": 100 + i, "category_id": 1, "bbox": box,
                     "area": float(m.sum()), "iscrowd": 1, "segmentation": rle})
        if i % 3 == 0:  # a non-crowd instance given as RLE: compressed, then uncompressed
            plain = i % 2 == 0
            anns.append({"id": len(anns) + 1, "image_id": 100 + i, "category_id": 3,
                         "bbox": box, "area": float(m.sum()), "iscrowd": 0,
                         "segmentation": {"size": [h, w], "counts": counts.tolist() if plain
                                          else jax_native.rle_encode_string(counts)}})
        anns.append({"id": len(anns) + 1, "image_id": 100 + i, "category_id": 3,
                     "bbox": [1.0, 1.0, 0.5, 3.0], "area": 1.5, "iscrowd": 0,
                     "segmentation": [[1, 1, 1.5, 1, 1.5, 4]]})  # degenerate: dropped
    ann_file = os.path.join(root, "instances.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": CATEGORIES}, f)
    return img_dir, ann_file


def datasets(root, cls: str, stage: str, n_images=9, transforms=None, **extra):
    img_dir, ann_file = write_coco(root, n_images)
    cfg = {"IMG_DIR": img_dir, "ANN_FILE": ann_file, **extra}
    got = getattr(coco, cls)(CommonConfiguration(cfg), DICTIONARY, stage=stage,
                             transform=build_transforms("DET_CLASSES", transforms, stage)
                             if transforms else None)
    want = getattr(jax_coco, cls)(JaxConfig(cfg), DICTIONARY, stage=stage,
                                  transform=jax_build_transforms("DET_CLASSES", transforms, stage)
                                  if transforms else None)
    return got, want


def assert_sample_equal(got, want):
    np.testing.assert_array_equal(got["image"], want["image"])
    if want["target"] is None:
        assert got["target"] is None
        return
    assert set(got["target"]) == set(want["target"])
    for k, v in want["target"].items():
        np.testing.assert_array_equal(got["target"][k], v, err_msg=k)


@pytest.mark.parametrize("cls", ["CocoDetection", "CocoSegmentation"])
@pytest.mark.parametrize("stage", ["train", "val", "infer"])
def test_coco_samples_equal_jax(tmp_path, cls, stage):
    got, want = datasets(tmp_path, cls, stage, MASK_SIZE=28)
    assert len(got) == len(want) == (8 if stage == "train" else 9)
    assert got.catid2label == want.catid2label == {18: 2, 1: 0, 3: 1}
    for i in range(len(got)):
        assert_sample_equal(got[i], want[i])
    if cls == "CocoSegmentation" and stage != "infer":
        masks = [got[i]["target"]["masks"] for i in range(len(got))]
        assert all(m.shape[1:] == (28, 28) for m in masks) and sum(m.sum() for m in masks) > 0


def test_mosaic_groups_equal_jax(tmp_path):
    got, want = datasets(tmp_path, "CocoDetection", "train", LOAD_NUM=4, MOSAIC_PROB=0.5)
    for seed in range(6):
        random.seed(seed)
        g = [got[i] for i in range(len(got))]
        random.seed(seed)
        w = [want[i] for i in range(len(want))]
        for a, b in zip(g, w):
            assert isinstance(a, list) == isinstance(b, list)
            for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
                assert_sample_equal(x, y)
    assert any(isinstance(s, list) for s in g) and not all(isinstance(s, list) for s in g)


def flagship_transforms(stage: str) -> dict:
    with open(FLAGSHIP) as f:
        data = yaml.safe_load(f)["DATASET"]
    t = copy.deepcopy(data[stage.upper()]["TRANSFORMS"])
    if stage == "train":
        t["RandomAffineWithMosaic"]["size"] = [64, 64]
    else:
        t["Resize"]["size"] = [64, 64]
    return t


@pytest.mark.parametrize("stage", ["train", "val"])
def test_flagship_pipelines_on_coco_equal_jax(tmp_path, stage):
    extra = {"LOAD_NUM": 4, "MOSAIC_PROB": 1.0} if stage == "train" else {}
    got, want = datasets(tmp_path, "CocoDetection", stage, transforms=flagship_transforms(stage),
                         **extra)
    collates = (make_det_collate(128), jdt.make_det_collate(128))
    batches = []
    for ds, collate in zip((got, want), collates):
        random.seed(3)
        np.random.seed(3)
        batches.append(collate([ds[i] for i in range(len(ds))]))
    g, w = batches
    np.testing.assert_array_equal(g["image"], w["image"])
    for key in ("boxes", "labels", "valid", "pads", "scales", "height", "width"):
        np.testing.assert_array_equal(g["target"][key], w["target"][key], err_msg=key)
    assert g["target"]["valid"].sum() >= 4


def test_cache_decodes_once_and_equals_the_files(tmp_path):
    got, want = datasets(tmp_path, "CocoDetection", "val", CACHE=True)
    cached = [f for f in os.listdir(tmp_path) if f.endswith(".cache.npy")]
    assert len(cached) == 1
    again = coco.CocoDetection(got.data_cfg, DICTIONARY, stage="val")
    for i in range(len(got)):
        np.testing.assert_array_equal(again[i]["image"], want[i]["image"])
        np.testing.assert_array_equal(got._cache[i], cv2.imread(got._paths()[i]))


# ---- fill_poly ----

def random_polygon(rng, mode, H, W):
    k = rng.randint(1, 11)
    if mode == "inside":
        return rng.uniform(0, [W, H], (k, 2))
    if mode == "coco":  # float points in [0, W] x [0, H]: the border itself is outside
        return np.clip(rng.uniform(0, [W + 0.999, H + 0.999], (k, 2)), 0, [W, H])
    if mode == "outside":
        return rng.uniform(-60, [W + 60, H + 60], (k, 2))
    if mode == "concave":
        ang = np.sort(rng.uniform(0, 2 * np.pi, k + 2))
        r = rng.uniform(1, max(H, W), k + 2)
        return np.stack([W / 2 + r * np.cos(ang), H / 2 + r * np.sin(ang)], 1)
    if mode == "degenerate":  # repeated points, 1- and 2-point polygons, collinear runs
        base = rng.randint(0, [W + 1, H + 1], (max(k // 3, 1), 2))
        return base[rng.randint(0, len(base), rng.choice([1, 2, k]))]
    a, c, b = rng.randint(-2, [W + 3, H + 3], (3, 2))  # self-touching bow tie
    return np.array([a, c, b, [a[0], b[1]], c, [b[0], a[1]]])


@pytest.mark.parametrize("mode", ["inside", "coco", "outside", "concave", "degenerate", "bowtie"])
def test_fill_poly_equals_cv2(mode):
    rng = np.random.RandomState(["inside", "coco", "outside", "concave", "degenerate",
                                 "bowtie"].index(mode))
    for _ in range(300):
        H, W = rng.randint(1, 50, 2)
        pts = random_polygon(rng, mode, H, W).astype(np.int32)
        want = np.zeros((H, W), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = fill_poly(np.zeros((H, W), np.uint8), pts, 1)
        assert np.array_equal(got, want), (H, W, pts.tolist())


# ---- RLE codec and matchers ----

def random_mask(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(rng.randint(0, 4)):
        y, x = rng.randint(0, h), rng.randint(0, w)
        m[y:y + rng.randint(1, h + 1), x:x + rng.randint(1, w + 1)] = 1
    return m


def test_rle_codec_equals_jax_c_and_numpy():
    rng = np.random.RandomState(0)
    for _ in range(60):
        h, w = rng.randint(1, 50, 2)
        m = random_mask(rng, h, w)
        counts = native.rle_from_mask(m)
        np.testing.assert_array_equal(counts, jax_native.rle_from_mask(m))
        np.testing.assert_array_equal(counts, rle_py.from_mask_flat(m.T.reshape(-1)))
        s = native.rle_encode_string(counts)
        assert s == jax_native.rle_encode_string(counts) == rle_py.encode_string(counts)
        np.testing.assert_array_equal(native.rle_decode_string(s), counts)
        np.testing.assert_array_equal(native.rle_decode_string(s), rle_py.decode_string(s.encode()))
        np.testing.assert_array_equal(native.rle_to_mask(counts, h, w), m)
        assert native.rle_area(counts) == jax_native.rle_area(counts) == int(m.sum())
    with pytest.raises(ValueError):
        native.rle_decode_string("0P")  # a continued varint that ends the string


def test_rle_iou_and_matchers_equal_jax():
    rng = np.random.RandomState(1)
    ranges = [coco_eval.AREA_RNG[a] for a in coco_eval.AREA_KEYS]
    for _ in range(40):
        h, w = rng.randint(1, 40, 2)
        D, G = rng.randint(0, 7, 2)
        dt = [native.rle_from_mask(random_mask(rng, h, w)) for _ in range(D)]
        gt = [native.rle_from_mask(random_mask(rng, h, w)) for _ in range(G)]
        crowd = rng.rand(G) < 0.3
        ious = native.rle_iou(dt, gt, crowd)
        np.testing.assert_array_equal(ious, jax_native.rle_iou(dt, gt, crowd))
        np.testing.assert_allclose(ious, rle_py.iou(dt, gt, crowd.astype(np.uint8)), rtol=1e-12)
        base = crowd | (rng.rand(G) < 0.2)
        ga, da = rng.uniform(0, 12000, G), rng.uniform(0, 12000, D)
        got = native.coco_match_areas(ious, coco_eval.IOU_THRS, base, crowd, ga, da, ranges)
        want = jax_native.coco_match_areas(ious, coco_eval.IOU_THRS, base, crowd, ga, da, ranges)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g, wv)
        for i, rng_a in enumerate(ranges):
            dtm, dtig, npig = coco_eval._evaluate_img(ious, base.copy(), crowd, ga, da, rng_a)
            np.testing.assert_array_equal(got[0][i], dtm)
            np.testing.assert_array_equal(got[1][i], dtig)
            assert got[2][i] == npig
        if D and G:
            ig = base | (ga < 1000)
            order = np.argsort(ig, kind="stable")
            for g, wv in zip(native.coco_match(ious, coco_eval.IOU_THRS, ig, crowd, order),
                             jax_native.coco_match(ious, coco_eval.IOU_THRS, ig, crowd, order)):
                np.testing.assert_array_equal(g, wv)


def test_segm_evaluator_at_256_equals_jax():
    """12 bbox + 12 segm metrics over padded batches with 256² masks (the
    RLE path on both sides), and the RLE IoU equal to the dense one."""
    rng = np.random.RandomState(4)
    C, S = 3, 256

    class DS:
        num_classes = C

    got_ev = CocoEvaluator(dataset=DS(), iou_types=("bbox", "segm"))
    want_ev = JaxCocoEvaluator(dataset=DS(), iou_types=("bbox", "segm"))
    for _ in range(2):
        B, M, K = 2, 5, 10
        xy = rng.uniform(0, 160, (B, M, 2))
        gt = np.concatenate([xy, xy + rng.uniform(8, 90, (B, M, 2))], -1).astype(np.float32)
        gmask = np.zeros((B, M, S, S), np.float32)
        for b in range(B):
            for m in range(M):
                x0, y0, x1, y1 = gt[b, m].astype(int)
                gmask[b, m, y0:y1, x0:x1] = 1
        t = {"boxes": gt, "labels": rng.randint(0, C, (B, M)).astype(np.int32),
             "valid": rng.rand(B, M) < 0.9, "masks": gmask, "crowd": rng.rand(B, M) < 0.15,
             "pads": np.zeros((B, 2), np.float32), "scales": np.ones((B, 2), np.float32)}
        src = rng.randint(0, M, (B, K))
        db = np.take_along_axis(gt, src[..., None], 1) + rng.randn(B, K, 4).astype(np.float32) * 3
        dmask = np.take_along_axis(gmask, src[..., None, None], 1).copy()
        dmask = np.where(rng.rand(*dmask.shape) < 0.05, 1 - dmask, dmask)
        p = {"boxes": db, "scores": rng.rand(B, K).astype(np.float32),
             "labels": np.take_along_axis(t["labels"], src, 1), "valid": rng.rand(B, K) < 0.9,
             "masks": dmask}
        got_ev.update(t, p)
        want_ev.update(t, p)
        crowd = t["crowd"][0]
        np.testing.assert_array_equal(coco_eval._mask_iou(dmask[0], gmask[0], crowd),
                                      coco_eval._mask_iou_dense(dmask[0], gmask[0], crowd))
    got, want = got_ev.evaluate(), want_ev.evaluate()
    keys = [f"{t}_{m}" for t in ("bbox", "segm") for m in (
        "mAP", "AP_50", "AP_75", "AP_small", "AP_medium", "AP_large",
        "Recall_1", "Recall_10", "Recall_100", "Recall_small", "Recall_medium", "Recall_large")]
    assert set(keys) <= set(got) and set(got) == set(want)
    assert got == want
    assert 0 < got["segm_mAP"] < 1


# ---- one trainer step ----

def flagship_on(tmp_path, img_dir, ann_file) -> str:
    with open(FLAGSHIP) as f:
        cfg = yaml.safe_load(f)
    data = cfg["DATASET"]
    data["DICTIONARY"] = os.path.join(ROOT, data["DICTIONARY"])
    for stage in ("TRAIN", "VAL"):
        data[stage].update(IMG_DIR=img_dir, ANN_FILE=ann_file, BATCH_SIZE=2, NUM_WORKER=2)
    data["TRAIN"]["TRANSFORMS"]["RandomAffineWithMosaic"]["size"] = [64, 64]
    data["VAL"]["TRANSFORMS"]["Resize"]["size"] = [64, 64]
    cfg.update(N_MAX_EPOCHS=1, TENSORBOARD=False, CHECKPOINT_DIR=str(tmp_path / "ckpts"),
               N_ITERS_TO_DISPLAY_STATUS=1)
    cfg["EVALUATOR"]["EVAL_INTERVALS"] = 1
    path = tmp_path / "coco_yolov5_s_files.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_trainer_step_on_coco_files(tmp_path, monkeypatch):
    img_dir, ann_file = write_coco(tmp_path / "coco", 3, seed=2)
    setting = flagship_on(tmp_path, img_dir, ann_file)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(setting), device="cpu")
    assert type(trainer.datasets["train"]).__name__ == "CocoDetection" and len(
        trainer.datasets["train"]) == 2
    with open(setting) as f:
        train = json.load(f)["DATASET"]["TRAIN"]
    jax_ds = jax_coco.CocoDetection(
        JaxConfig(train), trainer.dictionary,
        jax_build_transforms("DET_CLASSES", train["TRANSFORMS"], "train"))
    batches = []
    for ds, collate in ((trainer.datasets["train"], make_det_collate(128)),
                        (jax_ds, jdt.make_det_collate(128))):
        random.seed(5)
        np.random.seed(5)
        batches.append(collate([ds[0], ds[1]]))
    got, want = batches
    np.testing.assert_array_equal(got["image"], want["image"])
    for key in ("boxes", "labels", "valid", "pads", "scales"):
        np.testing.assert_array_equal(got["target"][key], want["target"][key], err_msg=key)

    losses = []
    make_step = trainer_mod.make_train_step

    def recording(**kw):
        step = make_step(**kw)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    monkeypatch.setattr(trainer_mod, "make_train_step", recording)
    state = trainer.run()
    assert state.step == 1 and len(losses) == 1 and np.isfinite(losses).all()
