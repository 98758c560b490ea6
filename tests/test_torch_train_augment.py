"""The port's device augmentation and train-side data path against the JAX
package on the CPU.

Each augment function gets the draws that ``jax.random`` made for the JAX
function (a ``torch.Generator`` cannot reproduce them), reconstructed from
the same key splits as ``cvpytorch_tpu/ops/augment.py`` makes them.  Then
the collates, ``LOAD_NUM`` groups, the host flip, the loader's order and
the device prefetcher (on the CPU).
"""
import copy
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cvpytorch_tpu.data.datasets  # noqa: F401  (registers the JAX datasets)
from cvpytorch_tpu.data import loader as jax_loader
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms import det_transforms as jdt
from cvpytorch_tpu.ops import augment as jaug
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.data import loader
from cvpytorch_tpu_torch.data.datasets.synthetic import SyntheticDetection
from cvpytorch_tpu_torch.data.transforms import build_transforms
from cvpytorch_tpu_torch.data.transforms import det_transforms as tdt
from cvpytorch_tpu_torch.ops import augment as taug

B, S, OUT, M = 2, 32, 64, 5
# Image tolerances in levels of 0-255 (the target is under half a level).
# Measured max |diff| on these inputs: the warp and the HSV jitter given
# the same inputs 0; the whole chain 0.0030 (over seeds 0-5: the affine's
# 3×3 product and its inverse round differently, which moves the tent
# weights); the boxes 0 px.
LEVELS = 1e-3
CHAIN_LEVELS = 1e-2


def tiles(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 4, S, S, 3)).astype(np.uint8)
    xy = rng.uniform(0, S - 12, (B, 4, M, 2))
    wh = rng.uniform(3, 12, (B, 4, M, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.rand(B, 4, M) < 0.8
    return images, boxes, valid


def jax_draws(key):
    """The draws of ``jaug.fused_det_augment(…, key, OUT)``, as numpy."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    centers = jax.vmap(lambda k: jax.random.uniform(
        k, (2,), minval=S * 0.5, maxval=S * 1.5))(jax.random.split(k1, B))
    affine = jaug.random_affine_matrices(k2, B, OUT, OUT, translate=0.1,
                                         scale=(0.5, 1.5))
    gains = jax.random.uniform(k3, (B, 3), minval=-1.0, maxval=1.0) * \
        jnp.array(taug.HSV_GAINS) + 1.0
    flip = jax.random.bernoulli(k4, 0.5, (B,))
    return {"centers": centers, "affine": affine, "gains": gains, "flip": flip}


def as_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_augment_with_jax_draws_matches_jax(seed):
    """The whole chain: images within a hundredth of a level, boxes within
    1e-4 px, ``keep`` exactly (no box of these draws sits at a
    box-candidate threshold)."""
    images, boxes, valid = tiles(seed)
    key = jax.random.PRNGKey(seed)
    want = jaug.fused_det_augment(jnp.asarray(images), jnp.asarray(boxes),
                                  jnp.asarray(valid), key, OUT)
    got = taug.apply_aug(torch.from_numpy(images), torch.from_numpy(boxes),
                         torch.from_numpy(valid), as_torch(jax_draws(key)), OUT)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=CHAIN_LEVELS / 255, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=0)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < got[2].numel()


def test_mosaic_placement_and_boxes_are_exact():
    images, boxes, valid = tiles(3)
    key = jax.random.PRNGKey(3)
    k1 = jax.random.split(key, 4)[0]
    canvas, mboxes, mvalid = jaug.mosaic4(jnp.asarray(images), jnp.asarray(boxes),
                                          jnp.asarray(valid), k1, OUT)
    centers = torch.from_numpy(np.asarray(jax_draws(key)["centers"]))
    got = taug.mosaic4(torch.from_numpy(images), torch.from_numpy(boxes),
                       torch.from_numpy(valid), centers)
    assert np.array_equal(got[0].numpy(), np.asarray(canvas))
    assert np.array_equal(got[1].numpy(), np.asarray(mboxes))
    assert np.array_equal(got[2].numpy(), np.asarray(mvalid))


def test_affine_pieces_match_jax():
    """Matrices from the same draws (with rotation and shear too) within
    1e-6 relative; their inverses, the warp (within a thousandth of a
    level), the box transform (1e-4 px) and the candidate mask (exact)."""
    key = jax.random.PRNGKey(5)
    deg, shear, tr, sc = 10.0, 5.0, 0.1, (0.5, 1.5)
    want = np.asarray(jaug.random_affine_matrices(key, B, 48, 64, deg, tr, sc, shear))
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = lambda k, lo, hi: np.asarray(jax.random.uniform(k, (B,), minval=lo, maxval=hi))
    draws = [u(k1, -deg, deg) * np.pi / 180, u(k2, *sc),
             np.tan(u(k3, -shear, shear) * np.pi / 180),
             np.tan(u(k4, -shear, shear) * np.pi / 180),
             u(k5, 0.5 - tr, 0.5 + tr) * 64,
             u(jax.random.fold_in(k5, 1), 0.5 - tr, 0.5 + tr) * 48]
    got = taug.affine_matrices(*(torch.from_numpy(np.float32(d)) for d in draws), 48, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)

    ms = np.asarray(jax_draws(key)["affine"])
    inv_j = np.asarray(jax.vmap(jaug.invert_affine)(jnp.asarray(ms)))
    inv_t = taug.invert_affine(torch.from_numpy(ms))
    np.testing.assert_allclose(inv_t.numpy(), inv_j, rtol=1e-6, atol=1e-6)

    canvas = np.random.RandomState(6).uniform(0, 255, (B, 2 * S, 2 * S, 3)).astype(np.float32)
    wj = np.asarray(jaug.affine_warp_separable(jnp.asarray(canvas), jnp.asarray(inv_j), (OUT, OUT)))
    wt = taug.affine_warp_separable(torch.from_numpy(canvas), torch.from_numpy(inv_j), (OUT, OUT))
    np.testing.assert_allclose(wt.numpy(), wj, atol=LEVELS, rtol=0)

    boxes = tiles(6)[1].reshape(B, -1, 4) * 2
    bj = np.asarray(jax.vmap(jaug.transform_boxes)(jnp.asarray(boxes), jnp.asarray(ms)))
    bt = taug.transform_boxes(torch.from_numpy(boxes), torch.from_numpy(ms))
    np.testing.assert_allclose(bt.numpy(), bj, atol=1e-4, rtol=0)
    kj = np.asarray(jax.vmap(jaug.box_candidates_mask)(jnp.asarray(boxes), jnp.asarray(bj)))
    kt = taug.box_candidates_mask(torch.from_numpy(boxes), torch.from_numpy(bj))
    assert np.array_equal(kt.numpy(), kj)


def test_hsv_flip_and_normalize_match_jax():
    key = jax.random.PRNGKey(7)
    draws = jax_draws(key)
    k3, k4 = jax.random.split(key, 4)[2:]
    img = np.random.RandomState(7).uniform(0, 255, (B, 16, 24, 3)).astype(np.float32)
    img[0, :4] = 128.0  # grey: delta 0
    img[1, :4, :, 0] = img[1, :4, :, 1]  # ties of the max
    hj = np.asarray(jaug.hsv_jitter(jnp.asarray(img), k3))
    ht = taug.hsv_jitter(torch.from_numpy(img), torch.from_numpy(np.asarray(draws["gains"])))
    np.testing.assert_allclose(ht.numpy(), hj, atol=LEVELS, rtol=0)

    boxes = np.random.RandomState(8).uniform(0, 24, (B, 3, 4)).astype(np.float32)
    fj = jaug.random_hflip(jnp.asarray(img), jnp.asarray(boxes), k4, 0.5)
    ft = taug.random_hflip(torch.from_numpy(img), torch.from_numpy(boxes),
                           torch.from_numpy(np.asarray(draws["flip"])))
    for g, w in zip(ft, fj):
        assert np.array_equal(g.numpy(), np.asarray(w))

    mean, std = (0.1, 0.2, 0.3), (0.5, 0.6, 0.7)
    nj = np.asarray(jaug.normalize(jnp.asarray(img), mean, std))
    nt = taug.normalize(torch.from_numpy(img), mean, std)
    np.testing.assert_allclose(nt.numpy(), nj, rtol=1e-6, atol=1e-7)


def test_fused_augment_draws_on_the_generator():
    """The port's own draws: shapes, ranges, and the same generator seed
    gives the same batch."""
    images, boxes, valid = (torch.from_numpy(a) for a in tiles(9))
    outs = [taug.fused_det_augment(images, boxes, valid,
                                   taug.step_generator(1029 + 7919, 5, "cpu"), OUT)
            for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    img, bx, keep = outs[0]
    assert img.shape == (B, OUT, OUT, 3) and img.dtype == torch.float32
    assert bx.shape == (B, 4 * M, 4) and keep.shape == (B, 4 * M)
    assert float(img.min()) >= 0 and float(img.max()) <= 1
    assert float(bx.min()) >= 0 and float(bx.max()) <= OUT


def samples(n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = i + 1
        xy = rng.uniform(0, 40, (k, 2))
        out.append({"image": rng.randint(0, 256, (48, 64, 3)).astype(np.uint8),
                    "target": {"boxes": np.concatenate([xy, xy + 8], 1).astype(np.float32),
                               "labels": np.arange(k, dtype=np.int32),
                               "pads": np.array([1.0, 2.0], np.float32),
                               "scales": np.array([0.5, 0.5], np.float32)}})
    return out


def test_det_collate_matches_jax():
    want = jdt.make_det_collate(4)(samples())
    got = tdt.make_det_collate(4)(samples())
    assert set(got) == set(want) and set(got["target"]) == set(want["target"])
    assert np.array_equal(got["image"], want["image"])
    assert np.array_equal(got["image_id"], want["image_id"])
    for k, v in want["target"].items():
        assert np.array_equal(got["target"][k], v), k


def test_device_aug_collate_matches_jax():
    """Tiles within one level (the port letterboxes without OpenCV), boxes,
    labels and validity equal."""
    groups = [samples(4, seed=s) for s in range(2)]
    want = jdt.make_device_aug_collate(2, 32)(groups)
    got = tdt.make_device_aug_collate(2, 32)([samples(4, seed=s) for s in range(2)])
    assert got["image"].shape == want["image"].shape == (2, 4, 32, 32, 3)
    assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= 1
    for k, v in want["target"].items():
        assert np.array_equal(got["target"][k], v), k


def test_load_num_groups_match_jax():
    """A train item is the indexed sample and three drawn with Python's
    ``random``: the same groups as the JAX dataset's under the same seed."""
    from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
    from cvpytorch_tpu.data.datasets.synthetic import SyntheticDetection as JaxSynthetic

    cfg = {"LENGTH": 8, "SIZE": [48, 64], "SEED": 2, "LOAD_NUM": 4}
    classes = ({"a": 1.0}, {"b": 1.0})
    port = SyntheticDetection(CommonConfiguration(cfg), classes)
    jaxd = JaxSynthetic(JaxConfig(cfg), classes)
    for i in range(3):
        random.seed(10 + i)
        want = jaxd[i]
        random.seed(10 + i)
        got = port[i]
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert np.array_equal(g["image"], w["image"])
            for k in ("boxes", "labels"):
                assert np.array_equal(g["target"][k], w["target"][k])
    val = SyntheticDetection(CommonConfiguration(cfg), classes, stage="val")
    assert isinstance(val[0], dict)  # LOAD_NUM is a train-stage setting


def test_host_flip_matches_jax():
    for seed in range(4):
        random.seed(seed)
        want = jdt.RandomHorizontalFlip(0.5)(samples(1, seed)[0])
        random.seed(seed)
        got = tdt.RandomHorizontalFlip(0.5)(samples(1, seed)[0])
        assert np.array_equal(got["image"], want["image"])
        assert np.array_equal(got["target"]["boxes"], want["target"]["boxes"])


# keywords for each JAX DET_TRANSFORMS name: a draw where the transform
# has one (p = 1), small mosaic tiles
DET_KWARGS = {
    "Resize": {"size": [48, 64]},
    "RandomAffineWithMosaic": {"size": [32, 32], "degrees": 5.0, "shear": 2.0},
    "Normalize": {"mean": [0.5, 0.4, 0.3], "std": [0.2, 0.3, 0.4]},
    **{name: {"p": 1.0} for name in (
        "RandomHorizontalFlip", "ColorHSV", "RandomAffine", "GaussianBlur", "MedianBlur",
        "RandomGrayscale", "RandomGamma", "EqualizeHist", "CLAHE", "RandomFog",
        "Cutout", "MixUp")},
}


@pytest.mark.parametrize("name", sorted(jdt.DET_TRANSFORMS))
def test_opencv_transforms_raise_naming_the_roadmap(name):
    """No JAX detection transform is refused any more: each name builds
    from a config in the port and, under one seed of ``random`` and of
    ``np.random``, equals the JAX transform (the CLAHE's Lab round trip
    to ±1, as ``tests/test_torch_det_host_aug.py`` measures it)."""
    kwargs = DET_KWARGS.get(name, {})
    group = samples(4, seed=len(name))
    sample = group if name == "RandomAffineWithMosaic" else group[0]
    if name == "Normalize":
        sample["image"] = sample["image"].astype(np.float32) / 255
    if name == "MixUp":  # a LOAD_NUM = 2 group
        sample = group[:2]
    outputs = []
    for build in (lambda: jax_build_transforms("DET_CLASSES", {name: kwargs}),
                  lambda: build_transforms("DET_CLASSES", {name: kwargs})):
        random.seed(3)
        np.random.seed(3)
        outputs.append(build()(copy.deepcopy(sample)))
    want, got = outputs
    d = np.abs(got["image"].astype(np.float64) - want["image"])
    assert d.max() <= (1 if name == "CLAHE" else 0)
    for key in want["target"]:
        np.testing.assert_array_equal(got["target"][key], want["target"][key], err_msg=key)


class Numbers:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((1,), i, np.int64)}


@pytest.mark.parametrize("n,bs,drop_last", [(10, 3, False), (10, 3, True), (9, 3, True)])
def test_loader_order_matches_jax(n, bs, drop_last):
    """Shuffled order and length per (seed, epoch, drop_last)."""
    for seed in (0, 1029):
        j = jax_loader.DataLoader(Numbers(n), batch_size=bs, shuffle=True,
                                  num_workers=2, drop_last=drop_last, seed=seed)
        t = loader.DataLoader(Numbers(n), batch_size=bs, shuffle=True,
                              num_workers=2, drop_last=drop_last, seed=seed)
        for epoch in (0, 1, 5):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            want = [b["image"].tolist() for b in j]
            got = [b["image"].tolist() for b in t]
            assert got == want and len(t) == len(j) == len(want)


def test_device_prefetcher_on_the_cpu():
    """Order and end; numpy arrays become tensors and numpy scalars Python
    numbers; an exception in the producer reaches the consumer."""
    batches = [{"image": np.full((2, 3), i, np.uint8),
                "target": {"boxes": np.zeros((2, 4), np.float32), "aug_step": np.int32(i)}}
               for i in range(5)]
    got = list(loader.DevicePrefetcher(iter(batches), "cpu"))
    assert [int(b["image"][0, 0]) for b in got] == list(range(5))
    assert isinstance(got[0]["image"], torch.Tensor) and got[0]["image"].dtype == torch.uint8
    assert got[3]["target"]["aug_step"] == 3 and isinstance(got[3]["target"]["aug_step"], int)

    def failing():
        yield batches[0]
        raise RuntimeError("producer broke")

    feed = loader.DevicePrefetcher(failing(), "cpu")
    assert int(next(feed)["image"][0, 0]) == 0
    with pytest.raises(RuntimeError, match="producer broke"):
        next(feed)

    gate = threading.Event()

    def slow():
        for b in batches:
            gate.wait(5)
            yield b

    feed = loader.DevicePrefetcher(slow(), "cpu")
    gate.set()
    feed.close()
    assert not feed._thread.is_alive()
