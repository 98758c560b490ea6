"""Inputs and a numpy reference for checking the greedy NMS kernel.

``chip_smoke.py`` holds the CUDA kernel against ``nms_keep_plain`` on the
card with these inputs, and the CPU tests hold ``nms_keep_plain`` against
the JAX package on the same ones.  numpy only: nothing here needs a card.
"""
from __future__ import annotations

import numpy as np

# every iou_threshold of the detectors: YOLOP, RetinaNet and the R-CNN
# head, YOLOv5, YOLOv6 and YOLOX, the RPN and AIRDet
THRESHOLDS = (0.45, 0.5, 0.6, 0.65, 0.7)


# NanoDet-Plus-320's val and serving input: batch 96, its 2125 priors cut
# to max_nms 1024, 80 COCO classes, boxes in a 320² canvas, iou_threshold 0.6
NANODET_CASE = {"B": 96, "K": 1024, "n_classes": 80, "canvas": 320, "thr": 0.6}


def nms_inputs(B: int, K: int, seed: int, n_classes: int = 3,
               dense: bool = False, canvas: int = 640) -> np.ndarray:
    """(B, K, 4) f32 boxes as ``batched_nms`` hands them to ``nms_keep``:
    clustered boxes in a ``canvas``² image (K/16 clusters, or with
    ``dense`` 4 tight ones, where most boxes of a class overlap; sides of
    10–60 pixels at 640, scaled with the canvas), score order with ties
    (scores rounded to 2 decimals, stable sort), class offsets label*4096,
    and boxes 0 and 1 of every image at IoU exactly equal to 0.6 (kept at
    0.6)."""
    rng = np.random.RandomState(seed)
    n_clusters = 4 if dense else max(K // 16, 1)
    s = canvas / 640
    centers = rng.rand(B, n_clusters, 2) * (canvas - 40) + 20
    which = rng.randint(0, n_clusters, (B, K))
    c = (np.take_along_axis(centers, which[..., None], 1)
         + rng.randn(B, K, 2) * (1 if dense else 4))
    wh = rng.rand(B, K, 2) * (50 * s) + 10 * s
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = np.round(rng.rand(B, K), 2).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    labels = rng.randint(0, n_classes, (B, K)).astype(np.float32)
    if K >= 2:  # IoU(box0, box1) = 60 / (100 + 1e-7) == f32(0.6)
        boxes[:, 0] = [100, 100, 110, 110]
        boxes[:, 1] = [100, 100, 110, 106]
        labels[:, :2] = 0
    return (boxes + (labels * 4096.0)[..., None]).astype(np.float32)


def nanodet_inputs(seed: int) -> np.ndarray:
    """``nms_inputs`` at ``NANODET_CASE``'s shape, classes and canvas."""
    c = NANODET_CASE
    return nms_inputs(c["B"], c["K"], seed, n_classes=c["n_classes"], canvas=c["canvas"])


def iou_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of box pairs a, b (..., 4) in numpy f32, in the kernel's order:
    IEEE f32 steps, NaN-propagating max and min, a correctly rounded
    division."""
    f0 = np.float32(0)
    with np.errstate(all="ignore"):
        w = np.maximum(np.minimum(a[..., 2], b[..., 2])
                       - np.maximum(a[..., 0], b[..., 0]), f0)
        h = np.maximum(np.minimum(a[..., 3], b[..., 3])
                       - np.maximum(a[..., 1], b[..., 1]), f0)
        inter = w * h
        area_a = (np.maximum(a[..., 2] - a[..., 0], f0)
                  * np.maximum(a[..., 3] - a[..., 1], f0))
        area_b = (np.maximum(b[..., 2] - b[..., 0], f0)
                  * np.maximum(b[..., 3] - b[..., 1], f0))
        return inter / ((area_a + area_b - inter) + np.float32(1e-7))


def near_threshold_pairs(thr: float) -> tuple[np.ndarray, dict]:
    """(n, 2, 4) f32 images of two boxes each, box 0 ranked first: pairs
    whose f32 IoU is thr, one ulp above or one ulp below (found by walking
    one coordinate over 4096 f32 steps in three families: a box inside
    another, two 10x10 boxes side by side, two 300x300 boxes at the class
    offset 79*4096), then pairs with no overlap (inter == 0: apart,
    touching, a box of zero area) and with NaN or infinite coordinates.
    Returns the pairs and the count of each kind."""
    f = np.float32
    t = f(thr)
    up, down = np.nextafter(t, f(np.inf)), np.nextafter(t, f(-np.inf))

    def walk(center: float, below: int = 2048, above: int = 2048) -> np.ndarray:
        bits = np.array([center], np.float32).view(np.int32)
        return (bits + np.arange(-below, above, dtype=np.int32)).view(np.float32)

    o = f(79 * 4096)
    families = []
    # each family walks one coordinate x over 4096 f32 steps and a height
    # y over 64 steps just below the side: b inside a (IoU ~ x y / 100),
    # side by side (IoU ~ s / (20 - s), s = 10 - x) and, at the offset,
    # side by side with 300-pixel boxes
    for x0, side, a, b in (
            (10 * thr, 10, [0, 0, 10, 10], lambda x, y: [0 * x, 0 * x, y, x]),
            (10 - 20 * thr / (1 + thr), 10, [0, 0, 10, 10],
             lambda x, y: [x, 0 * x, x + f(10), y]),
            (300 - 600 * thr / (1 + thr), 300, [o, 0, o + 300, 300],
             lambda x, y: [o + x, 0 * x, o + x + f(300), y])):
        x, y = (v.ravel() for v in np.meshgrid(walk(x0), walk(side, 63, 1)))
        families.append((np.broadcast_to(f(a), (len(x), 4)), np.stack(b(x, y), -1)))
    picked, counts = [], {}
    for a, b in families:
        iou = iou_f32(a, b)
        for name, v in (("at_thr", t), ("ulp_above", up), ("ulp_below", down)):
            hit = np.flatnonzero(iou == v)[:4]
            counts[name] = counts.get(name, 0) + len(hit)
            picked += [np.stack([a[k], b[k]]) for k in hit]
    if not all(counts[k] for k in ("at_thr", "ulp_above", "ulp_below")):
        raise AssertionError(f"near-threshold pairs at {thr} not found: {counts}")
    nan, inf = np.nan, np.inf
    zero = [[[0, 0, 10, 10], [20, 20, 30, 30]],   # apart
            [[0, 0, 10, 10], [10, 0, 20, 10]],    # touching
            [[0, 0, 10, 10], [5, 5, 5, 5]],       # zero area inside
            [[0, 0, 0, 0], [0, 0, 0, 0]]]         # two empty boxes
    odd = [[[nan, 0, 10, 10], [0, 0, 10, 10]],
           [[0, 0, 10, 10], [0, nan, 10, 10]],
           [[0, 0, inf, 10], [0, 0, 10, 10]],
           [[-inf, -inf, inf, inf], [0, 0, 10, 10]],
           [[-inf, -inf, inf, inf], [-inf, -inf, inf, inf]]]
    counts["no_overlap"], counts["non_finite"] = len(zero), len(odd)
    pairs = np.concatenate([np.stack(picked), f(zero), f(odd)]).astype(np.float32)
    return pairs, counts
