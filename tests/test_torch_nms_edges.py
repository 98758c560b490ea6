"""Edges of the port's greedy NMS on the CPU, against the JAX package.

The card holds the CUDA kernel bit for bit against ``nms_keep_plain``
(``chip_smoke.py``) at ragged K, at every threshold the detectors use and
on constructed near-threshold pairs.  These tests hold that plain version
to JAX ``nms_keep_mask`` and to the Pallas kernel in interpret mode on the
same inputs (``cvpytorch_tpu_torch.ops.nms_cases``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.ops import nms as jnms
from cvpytorch_tpu.ops.pallas.nms_kernel import pallas_nms_keep
from cvpytorch_tpu_torch.ops import nms_kernel
from cvpytorch_tpu_torch.ops.nms_cases import (
    NANODET_CASE, THRESHOLDS, iou_f32, nanodet_inputs, near_threshold_pairs, nms_inputs)
from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep_plain


def jax_keeps(boxes, thr):
    """Keep masks of one image's score-sorted boxes (K, 4) from the XLA path
    and from the Pallas kernel in interpret mode."""
    K = len(boxes)
    scores = np.arange(K, 0, -1).astype(np.float32)  # distinct: order = identity
    keep, order = jnms.nms_keep_mask(jnp.asarray(boxes), jnp.asarray(scores), thr)
    assert np.array_equal(np.asarray(order), np.arange(K))
    pallas = pallas_nms_keep(jnp.asarray(boxes), thr, interpret=True)
    return np.asarray(keep), np.asarray(pallas)


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("K", [1, 63, 64, 65])
def test_plain_matches_jax_at_ragged_k(K, thr):
    """Tail tiles and tail bits of the kernel's 64-box words, 80 classes."""
    boxes = nms_inputs(1, K, seed=K, n_classes=80)
    got = nms_keep_plain(torch.from_numpy(boxes), thr)[0].numpy()
    xla, pallas = jax_keeps(boxes[0], thr)
    assert np.array_equal(got, xla)
    assert np.array_equal(got, pallas)
    if K >= 2:
        assert got[1] == (thr >= 0.6)  # IoU(box 0, box 1) == f32(0.6)


def test_plain_matches_jax_on_the_nanodet_input():
    """NanoDet-Plus-320's (96, 1024) NMS input (80 classes, 320² canvas, thr
    0.6): the plain version over the whole batch, and JAX ``nms_keep_mask``
    (XLA; the Pallas kernel in interpret mode takes minutes at K = 1024)
    on four of its images, equal."""
    boxes = nanodet_inputs(seed=11)
    assert boxes.shape == (NANODET_CASE["B"], NANODET_CASE["K"], 4)
    thr = NANODET_CASE["thr"]
    got = nms_keep_plain(torch.from_numpy(boxes), thr).numpy()
    scores = np.arange(NANODET_CASE["K"], 0, -1).astype(np.float32)
    for i in (0, 1, 47, 95):
        keep, _ = jnms.nms_keep_mask(jnp.asarray(boxes[i]), jnp.asarray(scores), thr)
        assert np.array_equal(got[i], np.asarray(keep))
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_plain_matches_jax_on_near_threshold_pairs(thr):
    """IoU at thr, one f32 ulp either side, inter == 0, NaN and inf: the
    plain version, JAX ``nms_keep_mask`` and numpy's f32 division agree.

    The Pallas kernel in interpret mode is held to them only on the pairs
    without overlap or with non-finite coordinates: it pads K to 128, and
    XLA's CPU code for that 128-wide IoU matrix rounds some pairs one ulp
    above thr to thr or below (``box_iou_matrix`` jitted at K = 128 does
    the same), so it is no reference at the last ulp."""
    pairs, counts = near_threshold_pairs(thr)
    assert min(counts.values()) > 0
    got = nms_keep_plain(torch.from_numpy(pairs), thr).numpy()
    iou = iou_f32(pairs[:, 0], pairs[:, 1])
    want = ~(iou > np.float32(thr))
    assert got[:, 0].all()
    assert np.array_equal(got[:, 1], want)
    t = np.float32(thr)
    assert want[iou == t].all()  # IoU == thr is kept (strict)
    assert not want[iou == np.nextafter(t, np.float32(np.inf))].any()
    n_exact = len(pairs) - counts["no_overlap"] - counts["non_finite"]
    for k, (pair, keep) in enumerate(zip(pairs, got)):
        xla, pallas = jax_keeps(pair, thr)
        assert np.array_equal(keep, xla)
        if k >= n_exact:
            assert np.array_equal(keep, pallas)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_division_band_decides_like_f32_division(thr):
    """The proof that the mask kernel's division-free test relies on.

    The kernel computes q = RN(inter * r) with r = rcp.approx(d), which is
    within 1 ulp of 1/d.  It sets the bit when q > hi, clears it when
    q < lo, and divides (IEEE) when lo <= q <= hi or q is NaN.  Whatever r
    is among RN(1/d) and its two f32 neighbours (1.5 ulp of 1/d either
    way), a decision made outside the band must equal
    ``f32(inter) / f32(d) > thr``: over a million random pairs and over
    pairs built at inter = RN(m d) and up to 8 ulps either side, m being
    thr and the midpoint between thr and the next f32 (where rounding
    flips).  Analytically: q is within 2^-22 of inter / d relative, and
    the band is 2^-16 wide, so a decision outside it cannot flip."""
    rng = np.random.RandomState(int(thr * 100))
    f = np.float32
    t = f(thr)
    lo, hi = (f(v) for v in nms_kernel.division_band(thr))
    assert lo < t < hi
    n = 1_000_000
    d = f(10.0) ** rng.uniform(-7, 8, n).astype(np.float32)
    inter = (d * rng.uniform(0, 1.2, n).astype(np.float32)).astype(np.float32)
    mid = np.float64(t) + (np.float64(np.nextafter(t, f(np.inf))) - np.float64(t)) / 2
    built = []
    for m in (np.float64(t), mid):
        d0 = f(10.0) ** rng.uniform(-7, 8, 20_000).astype(np.float32)
        base = (m * d0.astype(np.float64)).astype(np.float32).view(np.int32)
        for k in range(-8, 9):
            built.append((d0, (base + k).view(np.float32)))
    d = np.concatenate([d] + [b[0] for b in built])
    inter = np.concatenate([inter] + [b[1] for b in built])
    with np.errstate(all="ignore"):
        exact = inter / d > t
        r0 = f(1) / d
        n_band = 0
        for r in (np.nextafter(r0, f(0)), r0, np.nextafter(r0, f(np.inf))):
            q = inter * r
            assert exact[q > hi].all()
            assert not exact[q < lo].any()
            n_band = max(n_band, int(((q >= lo) & (q <= hi))[:n].sum()))
    assert exact[n:].any() and not exact[n:].all()  # both sides were built
    assert n_band < n * 1e-3  # random pairs almost never divide


@pytest.mark.parametrize("thr", [0.0, -0.5, 1e-40, float("nan"), 2.0 ** 101])
def test_division_band_is_everything_for_odd_thresholds(thr):
    assert nms_kernel.division_band(thr) == (-np.inf, np.inf)


def test_library_path_hashes_every_source(tmp_path, monkeypatch):
    """A change to any source under csrc/, not only the compiled .cu,
    names a new library, so a stale one is never loaded."""
    (tmp_path / "nms_kernel.cu").write_text("// kernel\n")
    (tmp_path / "tiles.cuh").write_text("// header\n")
    monkeypatch.setattr(nms_kernel, "CSRC", tmp_path)
    first = nms_kernel.library_path()
    (tmp_path / "tiles.cuh").write_text("// header, changed\n")
    second = nms_kernel.library_path()
    (tmp_path / "nms_kernel.cu").write_text("// kernel, changed\n")
    assert len({first, second, nms_kernel.library_path()}) == 3


@pytest.mark.parametrize("K,words", [(1, 64), (64, 64), (65, 3 * 64), (1000, 136 * 64),
                                     (1024, 136 * 64)])
def test_mask_scratch_is_the_packed_upper_triangle(K, words):
    """One 64-word tile per pair r <= c of the ceil(K / 64) tiles."""
    assert nms_kernel.mask_words(3, K) == 3 * words
