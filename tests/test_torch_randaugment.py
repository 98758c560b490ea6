"""The port's segmentation ``RandAugment`` (numpy) against the JAX
transform (PIL 12) on the CPU, bit for bit: every operation alone, on the
image (bilinear warps, the colour fill) and, for the warps, on the mask
(nearest, the ignore fill), over magnitudes, both signs, images of odd
sizes and images of few grey levels; then the whole transform under
``random`` seeds, every option."""
import copy
import random

import numpy as np
import pytest
from PIL import Image

from cvpytorch_tpu.data.transforms import seg_transforms as jax_seg
from cvpytorch_tpu_torch.data.transforms import seg_transforms as seg

MAGNITUDES = (0.0, 0.25, 0.6, 1.0)


def images(n=6, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = rng.randint(9, 61, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if i % 2:  # few levels: histograms with gaps, flat channels
            img = (img // 64 * 50 + 20).astype(np.uint8)
            img[..., 2] = 77
        out.append((img, rng.randint(0, 19, (h, w)).astype(np.uint8)))
    return out


def jax_op(op, pil, v, fill, resample):
    jax_seg._WARP["fillcolor"] = fill
    jax_seg._WARP["resample"] = resample
    return np.asarray(jax_seg._op_functions()[op](pil, v))


@pytest.mark.parametrize("op", sorted(jax_seg._OP_RANGES))
def test_each_operation_equals_pil(op):
    lo, hi, signed = jax_seg._OP_RANGES[op]
    for img, mask in images():
        for m in MAGNITUDES:
            v = m * (hi - lo) + lo
            for vv in ((v, -v) if signed else (v,)):
                want = jax_op(op, Image.fromarray(img), vv, (3, 4, 5), Image.BILINEAR)
                got = seg.PIL_OPS[op](img, vv, (3, 4, 5), True)
                np.testing.assert_array_equal(got, want, err_msg=f"{op} {vv} {img.shape}")
                if op in jax_seg._AFFINE_OPS:
                    want = jax_op(op, Image.fromarray(mask), vv, 255, Image.NEAREST)
                    got = seg.PIL_OPS[op](mask, vv, 255, False)
                    np.testing.assert_array_equal(got, want, err_msg=f"{op} mask {vv}")


@pytest.mark.parametrize("kwargs", [
    {}, {"ops": "full", "n_ops": 3, "magnitude": 0.9},
    {"ops": "full", "p": 0.5, "n_ops": 4, "magnitude": 0.3, "fill": [9, 8, 7],
     "ignore_value": 250},
    {"ops": ["rotate", "shear_x", "trans_y", "invert", "posterize", "solarize"],
     "n_ops": 2, "magnitude": 0.55, "fill": 40}])
def test_transform_equals_jax_under_seeds(kwargs):
    for seed, (img, mask) in enumerate(images(8, seed=1)):
        sample = {"image": img, "target": mask}
        random.seed(seed)
        want = jax_seg.RandAugment(**kwargs)(copy.deepcopy(sample))
        random.seed(seed)
        got = seg.RandAugment(**kwargs)(copy.deepcopy(sample))
        assert set(got) == set(want) == {"image", "target"}
        for k in ("image", "target"):
            assert got[k].dtype == want[k].dtype == np.uint8
            np.testing.assert_array_equal(got[k], want[k])


def test_warps_follow_pil_fixed_point_and_scaling_paths():
    """Rotations and shears of the mask take PIL's 16.16 fixed-point path,
    translations its scaling path; a direct double-precision nearest
    sampler disagrees with PIL on some pixels, the port's does not."""
    rng = np.random.RandomState(2)
    moved = 0
    for _ in range(40):
        h, w = rng.randint(20, 90, 2)
        mask = rng.randint(0, 19, (h, w)).astype(np.uint8)
        angle = rng.uniform(-30, 30)
        want = np.asarray(Image.fromarray(mask).rotate(angle, resample=Image.NEAREST,
                                                       fillcolor=255))
        got = seg.rotate(mask, angle, 255, False)
        np.testing.assert_array_equal(got, want)
        a = seg.rotation_affine(angle % 360.0, w, h)
        ys, xs = np.mgrid[0:h, 0:w] + 0.5
        xi = np.floor(a[0] * xs + a[1] * ys + a[2]).astype(int)
        yi = np.floor(a[3] * xs + a[4] * ys + a[5]).astype(int)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        direct = np.where(ok, mask[yi.clip(0, h - 1), xi.clip(0, w - 1)], 255)
        moved += int((direct != want).sum())
    assert moved > 0
