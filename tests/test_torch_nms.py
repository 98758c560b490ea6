"""The port's NMS (``cvpytorch_tpu_torch/ops/nms*.py``) against the JAX
package on the CPU.

Keep masks must be bit-exact against JAX ``nms_keep_mask`` (the XLA path)
and against the Pallas kernel in interpret mode; ``batched_nms`` and
``yolo_non_max_suppression`` must give identical outputs when fed the same
inputs.  On the CPU the port's ``nms_keep`` runs its plain version, whose
arithmetic the CUDA kernel repeats (the card's comparison is in
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.ops import nms as jnms
from cvpytorch_tpu.ops.pallas.nms_kernel import pallas_nms_keep
from cvpytorch_tpu_torch.ops import nms as tnms
from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain


def random_boxes(rng, n, span=100.0, size=30.0):
    centers = rng.rand(n, 2) * span
    wh = rng.rand(n, 2) * size + 5
    return np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)


def clustered_boxes(rng, n, n_labels=3):
    """Clustered boxes in a 640 canvas with class offsets label*4096, the
    kind of input batched_nms gives the kernel."""
    centers = rng.rand(max(n // 16, 1), 2) * 600 + 20
    c = centers[rng.randint(0, len(centers), n)] + rng.randn(n, 2) * 4
    wh = rng.rand(n, 2) * 50 + 10
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    labels = rng.randint(0, n_labels, n).astype(np.float32)
    return (boxes + (labels * 4096.0)[:, None]).astype(np.float32)


def jax_keep(boxes, scores, thr):
    keep, order = jnms.nms_keep_mask(jnp.asarray(boxes), jnp.asarray(scores), thr)
    return np.asarray(keep), np.asarray(order)


def port_keep(boxes, scores, thr):
    keep, order = tnms.nms_keep_mask(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), thr)
    return keep.numpy(), order.numpy()


def assert_keep_matches_jax(boxes, scores, thr, pallas=True):
    jk, jo = jax_keep(boxes, scores, thr)
    tk, to = port_keep(boxes, scores, thr)
    assert np.array_equal(to, jo)
    assert np.array_equal(tk, jk)
    if pallas:
        pk = np.asarray(pallas_nms_keep(jnp.asarray(boxes[jo]), thr,
                                        interpret=True))
        assert np.array_equal(tk, pk)
    return tk


@pytest.mark.parametrize("seed", [0, 1])
def test_keep_mask_50_boxes(seed):
    """The tests/test_pallas_nms.py case: 50 random boxes, thr 0.5."""
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, 50)
    scores = np.sort(rng.rand(50).astype(np.float32))[::-1].copy()
    keep = assert_keep_matches_jax(boxes, scores, 0.5)
    assert 0 < keep.sum() < 50


def test_keep_mask_identical_boxes():
    boxes = np.array([[0.0, 0, 10, 10]] * 3 + [[50, 50, 60, 60]], np.float32)
    keep = nms_keep(torch.from_numpy(boxes)[None], 0.5)[0]
    assert keep.tolist() == [True, False, False, True]
    assert_keep_matches_jax(boxes, np.ones(4, np.float32), 0.5)


def test_keep_mask_score_ties():
    """Scores with many exact ties: both sides order equal scores by index."""
    rng = np.random.RandomState(3)
    boxes = random_boxes(rng, 64, span=60.0)
    scores = np.round(rng.rand(64), 1).astype(np.float32)
    assert_keep_matches_jax(boxes, scores, 0.45)


def test_keep_mask_k1000():
    """K = 1000 is not a multiple of 64 (the kernel's word) nor of 128."""
    rng = np.random.RandomState(4)
    boxes = clustered_boxes(rng, 1000)
    scores = np.round(rng.rand(1000), 2).astype(np.float32)
    keep = assert_keep_matches_jax(boxes, scores, 0.6)
    assert 0 < keep.sum() < 1000


def test_keep_mask_batch_differs_per_image():
    rng = np.random.RandomState(5)
    boxes = np.stack([clustered_boxes(rng, 200) for _ in range(3)])
    scores = rng.rand(3, 200).astype(np.float32)
    order = np.argsort(-scores, 1, kind="stable")
    sorted_boxes = np.take_along_axis(boxes, order[..., None], 1)
    got = nms_keep(torch.from_numpy(sorted_boxes), 0.6).numpy()
    for b in range(3):
        jk, jo = jax_keep(boxes[b], scores[b], 0.6)
        assert np.array_equal(jo, order[b])
        assert np.array_equal(got[b], jk)
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("thr", [0.5, 0.6])
def test_iou_equal_to_threshold_is_kept(thr):
    """inter / (union + 1e-7) == f32(thr) exactly: the comparison is
    strict, so the second box survives."""
    h = 10.0 * thr  # area 100·thr inside a 10×10 box: IoU = thr
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, h]], np.float32)
    iou = (100 * thr) / (np.float32(100) + np.float32(1e-7))
    assert np.float32(iou) == np.float32(thr)
    keep = assert_keep_matches_jax(boxes, np.array([0.9, 0.8], np.float32), thr)
    assert keep.tolist() == [True, True]
    # a little more overlap suppresses
    boxes[1, 3] = h + 0.01
    keep = assert_keep_matches_jax(boxes, np.array([0.9, 0.8], np.float32), thr)
    assert keep.tolist() == [True, False]


def test_plain_version_matches_wrapper_on_cpu():
    rng = np.random.RandomState(6)
    boxes = torch.from_numpy(np.stack([clustered_boxes(rng, 300) for _ in range(2)]))
    before = nms_keep.launches
    assert torch.equal(nms_keep(boxes, 0.6), nms_keep_plain(boxes, 0.6))
    assert nms_keep.launches == before  # the CPU path launches no kernel


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="K <= 1024"):
        nms_keep(torch.zeros(1, 1025, 4), 0.5)
    with pytest.raises(ValueError, match=r"\(B, K, 4\)"):
        nms_keep(torch.zeros(10, 4), 0.5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        nms_keep(torch.zeros(1, 8, 4, device="meta"), 0.5)


def test_top_k_orders_ties_like_jax():
    rng = np.random.RandomState(7)
    pool = np.array([-1.0, -0.0, 0.0, 0.25, 0.5, 1e-30, -2.0, 3.0], np.float32)
    for _ in range(5):
        x = rng.choice(pool, size=(3, 200)).astype(np.float32)
        x = np.where(rng.rand(3, 200) < 0.3,
                     rng.randn(3, 200).astype(np.float32), x).astype(np.float32)
        for k in (1, 37, 200):
            v, i = tnms.top_k(torch.from_numpy(x), k)
            jv, ji = jax.lax.top_k(jnp.asarray(x), k)
            assert np.array_equal(i.numpy(), np.asarray(ji))
            assert np.array_equal(v.numpy(), np.asarray(jv))


def decoded_predictions(seed, B=2, N=300, C=3, tie_decimals=None):
    """(B, N, 5+C) decoded YOLO predictions: cxcywh in a 64² canvas, obj
    and class probabilities; rounding makes exact score ties."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, N, 2) * 64
    wh = rng.rand(B, N, 2) * 24 + 2
    probs = rng.rand(B, N, 1 + C)
    if tie_decimals is not None:
        probs = np.round(probs, tie_decimals)
    return np.concatenate([xy, wh, probs], -1).astype(np.float32)


def assert_dets_equal(jd, td):
    for key in ("boxes", "scores", "labels", "valid", "num"):
        assert np.array_equal(np.asarray(jd[key]), td[key].numpy()), key


@pytest.mark.parametrize("seed,ties", [(0, None), (1, 1)])
def test_yolo_nms_multi_label_matches_jax(seed, ties):
    pred = decoded_predictions(seed, tie_decimals=ties)
    jd = jnms.yolo_non_max_suppression(jnp.asarray(pred), 3, multi_label=True)
    td = tnms.yolo_non_max_suppression(torch.from_numpy(pred), 3,
                                       multi_label=True)
    assert_dets_equal(jd, td)
    assert 0 < int(td["num"][0]) <= 300


def test_yolo_nms_single_label_matches_jax():
    pred = decoded_predictions(2, tie_decimals=2)
    jd = jnms.yolo_non_max_suppression(jnp.asarray(pred), 3, conf_threshold=0.1,
                                       max_nms=128)
    td = tnms.yolo_non_max_suppression(torch.from_numpy(pred), 3,
                                       conf_threshold=0.1, max_nms=128)
    assert_dets_equal(jd, td)


def test_batched_nms_pads_to_max_det_like_jax():
    """N = 100 < max_det: the candidate set is padded with -1 scores."""
    rng = np.random.RandomState(8)
    boxes = np.stack([random_boxes(rng, 100, span=64.0) for _ in range(2)])
    scores = np.round(rng.rand(2, 100), 2).astype(np.float32)
    labels = rng.randint(0, 3, (2, 100)).astype(np.int32)
    jd = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(labels), iou_threshold=0.5,
                          score_threshold=0.2)
    td = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(labels).long(), iou_threshold=0.5,
                          score_threshold=0.2)
    assert_dets_equal(jd, td)
    assert td["boxes"].shape == (2, 300, 4)
