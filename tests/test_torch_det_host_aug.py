"""The port's detection host augmentation against OpenCV and the JAX
package on the CPU.

``imgproc``'s warps, area resize, blurs and colour conversions against
the installed OpenCV 5.0.0 (equal, or within a stated share of ±1), then
every detection transform built on them against the JAX transform under
the same ``random`` and ``np.random`` seeds: images, boxes, labels, pads
and scales equal.  Mosaic-4 and mosaic-9, ``MixUp``'s carried sample,
and ``conf/coco_yolov5_s.yml``'s train pipeline as written on LOAD_NUM = 4
groups of 427×640 frames.

Run as a script (``python -m tests.test_torch_det_host_aug``) it prints
the one-thread host ms of the flagship's mosaic + affine per item, the
port's against OpenCV's on the same item.
"""
import copy
import os
import random
import time

import cv2
import numpy as np
import pytest

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets.synthetic import SyntheticDetection as JaxSyntheticDetection
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms import det_transforms as jdt
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.data.datasets.synthetic import SyntheticDetection
from cvpytorch_tpu_torch.data.transforms import build_transforms
from cvpytorch_tpu_torch.data.transforms import det_transforms as tdt
from cvpytorch_tpu_torch.data.transforms import imgproc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DICTIONARY = [{f"c{i}": 1.0} for i in range(4)]
FLAGSHIP = os.path.join(ROOT, "conf", "coco_yolov5_s.yml")


def image(rng, h, w, c=3):
    shape = (h, w, c) if c > 1 else (h, w)
    return rng.randint(0, 256, shape).astype(np.uint8)


# -- imgproc against OpenCV ------------------------------------------------------------
def _rotation(rng, h, w):
    return cv2.getRotationMatrix2D((w / 2, h / 2), rng.uniform(-180, 180), rng.uniform(0.6, 1.4))


def _shear(rng, h, w):
    m = _rotation(rng, h, w)
    m[0, 1] += rng.uniform(-0.4, 0.4)
    m[1, 0] += rng.uniform(-0.3, 0.3)
    return m


def _scale(lo, hi):
    def make(rng, h, w):
        s = rng.uniform(lo, hi)
        return np.array([[s, 0, rng.uniform(-40, 40)], [0, s, rng.uniform(-40, 40)]])
    return make


# (matrix maker, channels, interpolation); the destination is another
# non-square size, so each row has a vector body and a scalar tail
WARP_CASES = {
    "rotate_c3": (_rotation, 3, "linear"),
    "rotate_c1": (_rotation, 1, "linear"),
    "shear_c3": (_shear, 3, "linear"),
    "scale_up_c3": (_scale(1.2, 2.5), 3, "linear"),
    "scale_down_c1": (_scale(0.3, 0.9), 1, "linear"),
    "nearest_rotate_c1": (_rotation, 1, "nearest"),
    "nearest_shear_c3": (_shear, 3, "nearest"),
    "nearest_scale_c1": (_scale(0.5, 2.0), 1, "nearest"),
}


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_affine_equals_cv2(case):
    make, c, interp = WARP_CASES[case]
    flag = cv2.INTER_LINEAR if interp == "linear" else cv2.INTER_NEAREST
    rng = np.random.RandomState(sorted(WARP_CASES).index(case))
    for _ in range(4):
        h, w = rng.randint(24, 200, 2)
        img = image(rng, h, w, c)
        m = make(rng, h, w)
        dsize = (int(rng.randint(24, 200)), int(rng.randint(24, 200)))
        border = tuple(int(v) for v in rng.randint(0, 256, 3))
        want = cv2.warpAffine(img, m, dsize, flags=flag, borderValue=border)
        got = imgproc.warp_affine(img, m, dsize, border, interp)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_warp_perspective_equals_cv2(channels):
    rng = np.random.RandomState(channels)
    for _ in range(4):
        h, w = rng.randint(24, 200, 2)
        img = image(rng, h, w, channels)
        m = np.eye(3)
        m[:2] = _rotation(rng, h, w)
        m[2, :2] = rng.uniform(-2e-3, 2e-3, 2)
        dsize = (int(rng.randint(24, 200)), int(rng.randint(24, 200)))
        want = cv2.warpPerspective(img, m, dsize, borderValue=(114, 114, 114))
        np.testing.assert_array_equal(imgproc.warp_perspective(img, m, dsize, (114,) * 3), want)


@pytest.mark.parametrize("seed", range(3))
def test_separable_path_equals_the_general_one(seed):
    """A map with no rotation or shear (the default configs') takes the
    separable gather; the general path over the full grid gives the same
    pixels, and so does OpenCV."""
    rng = np.random.RandomState(seed)
    img = image(rng, 150, 230)
    m = _scale(0.5, 1.5)(rng, 150, 230)
    dsize = (211, 133)
    inv = imgproc._invert_affine(m)
    assert inv[1] == 0 and inv[3] == 0
    x = np.arange(dsize[0], dtype=np.float32)[None, :]
    y = np.arange(dsize[1], dtype=np.float32)[:, None]
    body = dsize[0] - dsize[0] % imgproc._WARP_BLOCK
    general = imgproc._sample(img, imgproc._coords(inv[0:3], x, y, body),
                              imgproc._coords(inv[3:6], x, y, body), (114,) * 3, "linear")
    got = imgproc.warp_affine(img, m, dsize, (114,) * 3)
    np.testing.assert_array_equal(got, general)
    np.testing.assert_array_equal(got, cv2.warpAffine(img, m, dsize, borderValue=(114,) * 3))


def test_rotation_matrix_equals_cv2():
    rng = np.random.RandomState(0)
    for _ in range(200):
        center = tuple(rng.uniform(0, 900, 2)) if rng.rand() < 0.5 else (0, 0)
        angle, scale = rng.uniform(-360, 360), rng.uniform(0.1, 3)
        np.testing.assert_array_equal(imgproc.rotation_matrix_2d(center, angle, scale),
                                      cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("factor", [0.3, 0.5, 0.62, 1 / 3, 0.9])
def test_resize_area_equals_cv2(factor):
    rng = np.random.RandomState(int(factor * 100))
    for c in (1, 3):
        h, w = rng.randint(30, 300, 2)
        img = image(rng, h, w, c)
        size = (max(1, int(h * factor)), max(1, int(w * factor)))
        want = cv2.resize(img, size[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(imgproc.resize_area(img, size), want)


FILTERS = {
    "gaussian3": (lambda i: imgproc.gaussian_blur(i, 3), lambda i: cv2.GaussianBlur(i, (3, 3), 0)),
    "gaussian5": (lambda i: imgproc.gaussian_blur(i, 5), lambda i: cv2.GaussianBlur(i, (5, 5), 0)),
    "gaussian7": (lambda i: imgproc.gaussian_blur(i, 7), lambda i: cv2.GaussianBlur(i, (7, 7), 0)),
    "median3": (lambda i: imgproc.median_blur(i, 3), lambda i: cv2.medianBlur(i, 3)),
    "median5": (lambda i: imgproc.median_blur(i, 5), lambda i: cv2.medianBlur(i, 5)),
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_blurs_equal_cv2(name):
    port, ref = FILTERS[name]
    rng = np.random.RandomState(len(name))
    for c in (1, 3):
        for h, w in ((37, 61), (120, 97)):
            img = image(rng, h, w, c)
            np.testing.assert_array_equal(port(img), ref(img))


def test_gray_equals_cv2_on_every_colour():
    cube = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([(cube >> 16) & 255, (cube >> 8) & 255, cube & 255], -1)
    bgr = bgr.astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(imgproc.bgr_to_gray(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("kind", ["noise", "smooth", "constant"])
def test_equalize_hist_equals_cv2(kind):
    rng = np.random.RandomState(3)
    img = image(rng, 90, 131, 1)
    if kind == "smooth":
        img = cv2.GaussianBlur(img // 3 + 40, (7, 7), 0)
    elif kind == "constant":
        img[:] = 77
    np.testing.assert_array_equal(imgproc.equalize_hist(img), cv2.equalizeHist(img))


@pytest.mark.parametrize("grid", [(8, 8), (3, 5)])
def test_clahe_equals_cv2(grid):
    """Sides that divide by the tiles and sides that do not (OpenCV pads
    both then)."""
    rng = np.random.RandomState(grid[1])
    for h, w in ((64, 80), (70, 64), (101, 157)):
        img = cv2.GaussianBlur(image(rng, h, w, 1) // 2, (5, 5), 0)
        clip = rng.uniform(1, 4)
        want = cv2.createCLAHE(clipLimit=clip, tileGridSize=grid).apply(img)
        np.testing.assert_array_equal(imgproc.clahe(img, clip, grid), want)


def test_lab_conversions_within_the_measured_share():
    """On 2^20 random triples (seeded): BGR2Lab off by 1 on at most 1e-4
    of values (over all 2^24 colours: 3.3e-5, never more than 1); Lab2BGR
    off on at most 2.5 % (all 2^24: 1.9 %), by at most 2 (2 on 32 of all
    2^24 triples)."""
    rng = np.random.RandomState(0)
    v = rng.randint(0, 256, (1024, 1024, 3)).astype(np.uint8)
    d = np.abs(imgproc.bgr_to_lab(v).astype(int) - cv2.cvtColor(v, cv2.COLOR_BGR2LAB))
    assert d.max() <= 1 and (d != 0).mean() <= 1e-4
    d = np.abs(imgproc.lab_to_bgr(v).astype(int) - cv2.cvtColor(v, cv2.COLOR_LAB2BGR))
    assert d.max() <= 2 and (d != 0).mean() <= 0.025


# -- transforms against the JAX package -----------------------------------------------
def det_sample(rng, h=427, w=640, n=5):
    xy = rng.uniform(0, [w - 60, h - 60], (n, 2))
    wh = rng.uniform(8, 60, (n, 2))
    return {"image": image(rng, h, w),
            "target": {"boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                       "labels": rng.randint(0, 4, n).astype(np.int64)}}


def run_both(make_port, make_jax, sample, seed):
    """Both transforms under one seed of ``random`` and ``np.random``: the
    outputs, and both streams left at the same place."""
    random.seed(seed)
    np.random.seed(seed)
    want = make_jax()(copy.deepcopy(sample))
    after = random.random(), np.random.rand()
    random.seed(seed)
    np.random.seed(seed)
    got = make_port()(copy.deepcopy(sample))
    assert (random.random(), np.random.rand()) == after
    return got, want


def assert_sample_equal(got, want):
    assert got["image"].dtype == want["image"].dtype
    np.testing.assert_array_equal(got["image"], want["image"])
    tw, tg = want.get("target"), got.get("target")
    assert (tg is None) == (tw is None)
    for key in (tw or {}):
        assert np.asarray(tg[key]).dtype == np.asarray(tw[key]).dtype, key
        np.testing.assert_array_equal(tg[key], tw[key], err_msg=key)


AFFINE_CASES = {
    "nanodet_v1": {"p": 0.5, "translate": 0.2, "scale": [0.8, 1.2]},
    "scalar_scale": {"p": 1.0, "translate": 0.1, "scale": 0.5},
    "rotate_shear": {"p": 1.0, "degrees": 10.0, "shear": 5.0, "scale": [0.5, 1.5]},
    "perspective": {"p": 1.0, "degrees": 5.0, "perspective": 0.0005},
    "identity": {"p": 1.0, "translate": 0.0, "scale": 0.0},
}


@pytest.mark.parametrize("case", list(AFFINE_CASES))
def test_random_affine_equals_jax(case):
    kw = AFFINE_CASES[case]
    rng = np.random.RandomState(len(case))
    for seed in range(4):
        sample = det_sample(rng)
        got, want = run_both(lambda: tdt.RandomAffine(**kw), lambda: jdt.RandomAffine(**kw),
                             sample, seed)
        assert_sample_equal(got, want)


MOSAIC_KW = {"p": 1.0, "size": [160, 160], "degrees": [0.0, 0.0], "translate": 0.1,
             "scale": [0.5, 1.5], "shear": [0.0, 0.0], "perspective": [0.0, 0.0],
             "fill": [114, 114, 114]}
# tiles smaller and larger than the mosaic's 160² cell: mosaic-9 scales
# them up bilinear and down by area
TILE_SHAPES = [(107, 160), (200, 130), (427, 640), (90, 70), (160, 160),
               (250, 333), (64, 200), (171, 120), (300, 300)]


@pytest.mark.parametrize("load_num", [4, 9])
@pytest.mark.parametrize("rotate", [False, True])
def test_mosaic_equals_jax(load_num, rotate):
    """The config's keywords (``perspective`` is dropped, as in the JAX
    transform); with ``rotate``, degrees and shear too (the general warp)."""
    kw = dict(MOSAIC_KW, **({"degrees": 10.0, "shear": 3.0} if rotate else {}))
    rng = np.random.RandomState(load_num + rotate)
    for seed in range(3):
        group = [det_sample(rng, h, w) for h, w in TILE_SHAPES[:load_num]]
        group[1]["target"] = {"boxes": np.zeros((0, 4), np.float32),
                              "labels": np.zeros((0,), np.int64)}
        got, want = run_both(lambda: tdt.RandomAffineWithMosaic(**kw),
                             lambda: jdt.RandomAffineWithMosaic(**kw), group, seed)
        assert got["image"].shape == (160, 160, 3)
        assert_sample_equal(got, want)


# every JAX transform that draws or computes, forced on (p = 1)
FORCED = {
    "GaussianBlur": {"p": 1.0},
    "MedianBlur": {"p": 1.0},
    "RandomGrayscale": {"p": 1.0},
    "RandomGamma": {"p": 1.0},
    "EqualizeHist": {"p": 1.0},
    "RandomFog": {"p": 1.0},
    "Cutout": {"p": 1.0},
}


@pytest.mark.parametrize("name", list(FORCED))
def test_forced_transform_equals_jax(name):
    rng = np.random.RandomState(len(name))
    for seed in range(3):
        sample = det_sample(rng, 97, 131)
        got, want = run_both(lambda: tdt.DET_TRANSFORMS[name](**FORCED[name]),
                             lambda: jdt.DET_TRANSFORMS[name](**FORCED[name]), sample, seed)
        assert_sample_equal(got, want)


def test_clahe_transform_within_the_measured_share():
    """The Lab round trip (``imgproc.lab_to_bgr``) differs from OpenCV's;
    the L channel's CLAHE is exact.  Measured on these inputs: 1.9–2.4 %
    of values off, by at most 1."""
    rng = np.random.RandomState(5)
    for seed in range(3):
        sample = det_sample(rng, 97, 131)
        sample["image"] = cv2.GaussianBlur(sample["image"], (9, 9), 0)
        got, want = run_both(lambda: tdt.CLAHE(p=1.0), lambda: jdt.CLAHE(p=1.0), sample, seed)
        d = np.abs(got["image"].astype(int) - want["image"])
        assert d.max() <= 1 and (d != 0).mean() <= 0.03


def test_mixup_carries_the_previous_sample_as_jax():
    """A stream of single samples through one transform on each side: each
    call blends with the sample the call before kept."""
    rng = np.random.RandomState(8)
    port, ref = tdt.MixUp(p=0.7), jdt.MixUp(p=0.7)
    blended = 0
    for seed in range(8):
        sample = det_sample(rng, 64, 80, n=2)
        random.seed(seed)
        np.random.seed(seed)
        want = ref(copy.deepcopy(sample))
        random.seed(seed)
        np.random.seed(seed)
        got = port(copy.deepcopy(sample))
        assert_sample_equal(got, want)
        blended += len(got["target"]["boxes"]) > 2
    assert blended >= 2
    random.seed(0)
    group = [det_sample(rng, 64, 80, n=2) for _ in range(2)]
    got, want = run_both(lambda: tdt.MixUp(p=1.0), lambda: jdt.MixUp(p=1.0), group, 1)
    assert_sample_equal(got, want)


@pytest.mark.parametrize("stage", ["TRAIN", "VAL"])
def test_flagship_pipeline_equals_jax(stage):
    """``conf/coco_yolov5_s.yml``'s pipelines as written on 427×640 frames
    (train: LOAD_NUM = 4 groups through mosaic + affine, flip, ColorHSV,
    the rare blurs and grayscale, ToCXCYWH, ToTensor, Normalize), over 6
    items: float images, boxes, labels, pads and scales equal."""
    cfg = CommonConfiguration.from_file(FLAGSHIP)
    tcfg = cfg.DATASET.get(stage).TRANSFORMS.data
    data = {"SIZE": [427, 640], "LENGTH": 6, "SEED": 11, "MAX_BOXES": 64,
            "LOAD_NUM": cfg.DATASET.TRAIN.LOAD_NUM}
    port = SyntheticDetection(CommonConfiguration(data), DICTIONARY,
                              build_transforms("DET_CLASSES", tcfg, stage.lower()),
                              stage=stage.lower())
    ref = JaxSyntheticDetection(JaxConfig(data), DICTIONARY,
                                jax_build_transforms("DET_CLASSES", tcfg, stage.lower()),
                                stage=stage.lower())
    for i in range(6):
        random.seed(40 + i)
        np.random.seed(40 + i)
        want = ref[i]
        random.seed(40 + i)
        np.random.seed(40 + i)
        got = port[i]
        assert got["image"].shape == (640, 640, 3) and got["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])
        for key in ("boxes", "labels", "pads", "scales"):
            np.testing.assert_array_equal(got["target"][key], want["target"][key])


def _time_ms(fn, n):
    fn()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n * 1e3


def main():
    """One-thread host ms per item of the flagship's mosaic + affine on
    LOAD_NUM = 4 groups of 427×640 frames, the port's and OpenCV's (the
    JAX transform) on the same groups and seeds."""
    cv2.setNumThreads(1)
    kw = dict(MOSAIC_KW, size=[640, 640])
    rng = np.random.RandomState(0)
    groups = [[det_sample(rng) for _ in range(4)] for _ in range(8)]
    for name, transform in (("port", tdt.RandomAffineWithMosaic(**kw)),
                            ("cv2", jdt.RandomAffineWithMosaic(**kw))):
        state = iter(range(10 ** 6))

        def one():
            random.seed(next(state))
            transform(copy.deepcopy(groups[random.randrange(8)]))

        print(f"mosaic+affine 640 {name}: {_time_ms(one, 40):.2f} ms/item (one thread)")


if __name__ == "__main__":
    main()
