"""OpenPose part-affinity-field targets and bottom-up decoding
(counterpart of ``cvpytorch_tpu/ops/paf.py``), plain PyTorch on padded
fixed-shape tensors; the instance assembly is host numpy, a copy of the
JAX package's.

Maps are NHWC as in the JAX package: heatmaps (B, gy, gx, 19) (18 joints
and the background), PAFs (B, gy, gx, 38) in channel order [x0, y0, x1,
y1, …].

* ``render_openpose_targets`` — the training targets from the collated
  (B, M, 17, 3) COCO keypoints: gaussians accumulated over persons and
  clipped at 1 (``expo <= 4.6052``), a limb's unit vector on the grid
  cells inside its rounded box (``jnp.round``: half to even, as
  ``torch.round``) within ``limb_width`` of its line, averaged over the
  persons that cover a cell.  (B, M, L, gy, gx) intermediates: at 368²,
  bs32 and 64 boxes 75.8 M elements each.
* ``find_peaks`` — 3×3 local maxima (strict before, ``>=`` after) above
  the threshold, the top ``max_peaks`` by ``ops.nms.top_k`` (lower index
  first among equal values, as ``jax.lax.top_k``), refined by a parabola
  on the log intensity.
* ``score_limb_pairs`` — each candidate pair's PAF line integral at 10
  samples ``i · (1 / 9)`` (the values ``jnp.linspace(0, 1, 10)`` gives,
  which ``torch.linspace`` does not: it counts from both ends), each
  sample point ``a + t·v`` rounded once, as XLA's fused multiply-add.
* ``greedy_limb_match`` — each (image, limb) problem's pairs by a stable
  descending order of their scores, taken greedily while both ends are
  free: one vectorised step over all (B, L) problems for each order
  position, up to the last finite score of any problem (the JAX loop runs
  all P² positions; the later ones take nothing).  Its time is the
  ``limb_match`` range.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .nms import top_k

# the 18-joint OpenPose order
OPENPOSE_KEYPOINTS = (
    "nose", "neck", "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle", "right_eye",
    "left_eye", "right_ear", "left_ear")

# limb connections on that order
LIMB_IDS = (
    (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (1, 2), (2, 3),
    (3, 4), (2, 14), (1, 5), (5, 6), (6, 7), (5, 15), (1, 0), (0, 14),
    (0, 15), (14, 16), (15, 17))

# COCO17 index for each OpenPose18 joint (17 = the synthesized neck)
COCO_ORDER = (0, 17, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3)

NUM_JOINTS = 18
NUM_LIMBS = len(LIMB_IDS)   # 19


def _coco_inverse() -> np.ndarray:
    inv = np.empty(17, np.int64)
    for p, c in enumerate(COCO_ORDER):
        if c < 17:
            inv[c] = p
    return inv


def add_neck(kpts17: torch.Tensor) -> torch.Tensor:
    """(..., 17, 3) COCO keypoints → (..., 18, 3) OpenPose order with a
    synthesized neck, the rounded shoulder midpoint (visibility 2 iff both
    shoulders are 2, else their product)."""
    r_sh, l_sh = kpts17[..., 6, :], kpts17[..., 5, :]
    neck = (r_sh + l_sh) / 2.0
    both2 = (r_sh[..., 2] == 2) & (l_sh[..., 2] == 2)
    v = torch.where(both2, torch.full_like(neck[..., 2], 2.0), r_sh[..., 2] * l_sh[..., 2])
    neck = torch.round(torch.stack([neck[..., 0], neck[..., 1], v], -1))
    k18 = torch.cat([kpts17, neck[..., None, :]], dim=-2)
    return k18[..., list(COCO_ORDER), :]


def openpose18_to_coco17(kpts18: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`add_neck`'s reorder: (..., 18, C) → (..., 17, C)."""
    return kpts18[..., _coco_inverse().tolist(), :]


def _remove_illegal(kpts: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Out-of-frame joints → (-1, -1, 0)."""
    x, y = kpts[..., 0], kpts[..., 1]
    bad = (x >= width) | (x < 0) | (y >= height) | (y < 0)
    return torch.where(bad[..., None], kpts.new_tensor([-1.0, -1.0, 0.0]), kpts)


def _grid(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device, dtype=like.dtype)


def render_openpose_targets(kpts17: torch.Tensor, person_valid: torch.Tensor, input_hw,
                            stride: int = 8, sigma: float = 7.0, limb_width: float = 1.0):
    """kpts17 (B, M, 17, 3) in input pixels, person_valid (B, M) masking
    the padded rows → heatmaps (B, gy, gx, 19) and pafs (B, gy, gx, 38),
    in the keypoints' dtype."""
    ih, iw = input_hw
    gy, gx = ih // stride, iw // stride
    k18 = _remove_illegal(add_neck(kpts17), iw, ih)
    vis = k18[..., 2] * person_valid.to(k18.dtype)[..., None]      # (B, M, 18)

    # gaussian joint heatmaps
    start = stride / 2.0 - 0.5
    ys = _grid(gy, k18) * stride + start
    xs = _grid(gx, k18) * stride + start
    d2 = ((xs[None, None, None, :, None] - k18[:, :, None, None, :, 0]) ** 2 +
          (ys[None, None, :, None, None] - k18[:, :, None, None, :, 1]) ** 2)
    expo = d2 / (2.0 * sigma * sigma)                                # (B, M, gy, gx, 18)
    g = torch.where((expo <= 4.6052) & (vis[:, :, None, None, :] > 0.5), torch.exp(-expo),
                    torch.zeros((), dtype=expo.dtype, device=expo.device))
    heat = g.sum(1).clamp(max=1.0)                                   # (B, gy, gx, 18)
    bg = (1.0 - heat.amax(-1, keepdim=True)).clamp(min=0.0)
    heatmaps = torch.cat([heat, bg], -1)

    # part affinity fields
    la = [a for a, _ in LIMB_IDS]
    lb = [b for _, b in LIMB_IDS]
    pa = k18[:, :, la, :2] / stride                                  # (B, M, L, 2)
    pb = k18[:, :, lb, :2] / stride
    vec = pb - pa
    norm = torch.sqrt(vec[..., 0] * vec[..., 0] + vec[..., 1] * vec[..., 1])
    limb_ok = (vis[:, :, la] > 0.5) & (vis[:, :, lb] > 0.5) & (norm > 0.0)
    u = vec / norm.clamp(min=1e-12)[..., None]
    min_x = torch.round(torch.minimum(pa[..., 0], pb[..., 0]) - limb_width).clamp(min=0)
    max_x = torch.round(torch.maximum(pa[..., 0], pb[..., 0]) + limb_width).clamp(max=gx)
    min_y = torch.round(torch.minimum(pa[..., 1], pb[..., 1]) - limb_width).clamp(min=0)
    max_y = torch.round(torch.maximum(pa[..., 1], pb[..., 1]) + limb_width).clamp(max=gy)
    px = _grid(gx, k18)[None, None, None, None, :]
    py = _grid(gy, k18)[None, None, None, :, None]

    def e(t):
        return t[..., None, None]

    in_box = (px >= e(min_x)) & (px < e(max_x)) & (py >= e(min_y)) & (py < e(max_y))
    dist = torch.abs((px - e(pa[..., 0])) * e(u[..., 1]) - (py - e(pa[..., 1])) * e(u[..., 0]))
    cf = (in_box & (dist < limb_width) & e(limb_ok)).to(k18.dtype)  # (B, M, L, gy, gx)
    count = cf.sum(1).clamp(min=1.0)                                 # (B, L, gy, gx)
    paf_x = (cf * e(u[..., 0])).sum(1) / count
    paf_y = (cf * e(u[..., 1])).sum(1) / count
    pafs = torch.stack([paf_x, paf_y], 2).reshape(k18.shape[0], 2 * NUM_LIMBS, gy, gx)
    return heatmaps, pafs.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# bottom-up decode
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``'s order: float32 through ``ops.nms.top_k``, other
    dtypes by a stable descending sort (the same order where, as here,
    no -0.0 meets a 0.0)."""
    if x.dtype == torch.float32:
        return top_k(x, k)
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _parabola_offset(left, c, right):
    """Vertex offset in [-0.5, 0.5] of the parabola through (-1, left),
    (0, c), (1, right)."""
    denom = left + right - 2.0 * c
    off = torch.where(torch.abs(denom) > 1e-8, 0.5 * (left - right) / denom,
                      torch.zeros((), dtype=denom.dtype, device=denom.device))
    return off.clamp(-0.5, 0.5)


def find_peaks(heatmaps: torch.Tensor, max_peaks: int = 20, threshold: float = 0.1):
    """heatmaps (B, gy, gx, K) → xy (B, K, P, 2) grid coordinates, score
    (B, K, P), valid (B, K, P)."""
    B, gy, gx, K = heatmaps.shape
    x = heatmaps.permute(0, 3, 1, 2)                                 # (B, K, gy, gx)
    pad = torch.nn.functional.pad(x, (1, 1, 1, 1), value=float("-inf"))
    sh = [pad[:, :, 1 + dy:gy + 1 + dy, 1 + dx:gx + 1 + dx]
          for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    before = torch.stack(sh[:4]).amax(0)
    after = torch.stack(sh[5:]).amax(0)
    is_peak = (x > before) & (x >= after) & (x > threshold)
    neg_inf = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    flat = torch.where(is_peak, x, neg_inf).reshape(B, K, gy * gx)
    score, idx = _top_k(flat, max_peaks)                             # (B, K, P)
    valid = torch.isfinite(score)
    score = torch.where(valid, score, torch.zeros((), dtype=score.dtype, device=x.device))
    ix = idx % gx
    iy = idx // gx
    raw = x.reshape(B, K, gy * gx)

    def log_at(dy, dx):
        yy = (iy + dy).clamp(0, gy - 1)
        xx = (ix + dx).clamp(0, gx - 1)
        return torch.log(raw.gather(-1, yy * gx + xx).clamp(min=1e-10))

    lc = log_at(0, 0)
    dxs = _parabola_offset(log_at(0, -1), lc, log_at(0, 1))
    dys = _parabola_offset(log_at(-1, 0), lc, log_at(1, 0))
    xy = torch.stack([ix.to(x.dtype) + dxs, iy.to(x.dtype) + dys], -1)
    return xy, score, valid


def sample_positions(num_samples: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, num_samples)`` as XLA computes it: i times the
    rounded reciprocal 1 / (n − 1), in ``dtype`` (XLA rewrites the
    division by a constant; i / (n − 1) differs in the last bit at some
    i, 7 of 10 in float64)."""
    inv = torch.ones((), dtype=dtype, device=device) / (num_samples - 1)
    return torch.arange(num_samples, dtype=dtype, device=device) * inv


def score_limb_pairs(peaks_xy, peaks_valid, pafs, num_samples: int = 10,
                     sample_threshold: float = 0.05, min_good_frac: float = 0.8,
                     coord_offset: float = 0.4375):
    """PAF line-integral score of every candidate limb pair.

    peaks_xy (B, K, P, 2), peaks_valid (B, K, P), pafs (B, gy, gx, 2L) →
    scores (B, L, P, P) (A candidate × B candidate, with the distance
    prior) and ok (B, L, P, P): at least 80 % of the samples' dots above
    0.05, a positive score, both ends valid."""
    B, K, P, _ = peaks_xy.shape
    gy, gx = pafs.shape[1:3]
    la = [a for a, _ in LIMB_IDS]
    lb = [b for _, b in LIMB_IDS]
    # heatmap peaks sit on the grid-centre convention, PAFs on center/stride
    peaks_xy = peaks_xy + coord_offset
    a_xy = peaks_xy[:, la]                                           # (B, L, P, 2)
    b_xy = peaks_xy[:, lb]
    a_ok = peaks_valid[:, la]
    b_ok = peaks_valid[:, lb]
    vec = b_xy[:, :, None, :, :] - a_xy[:, :, :, None, :]            # (B, L, P, P, 2)
    norm = torch.sqrt(vec[..., 0] * vec[..., 0] + vec[..., 1] * vec[..., 1])
    u = vec / norm.clamp(min=1e-8)[..., None]
    ts = sample_positions(num_samples, vec.dtype, vec.device)
    # XLA contracts a + t·v into one fused multiply-add; float32 points
    # are computed in float64 and rounded once, as the fma rounds (a
    # point's pixel is its rounded position: one ulp moves a sample)
    wide = torch.float64 if vec.dtype == torch.float32 else vec.dtype
    pts = (a_xy[:, :, :, None, None, :].to(wide)
           + ts[:, None].to(wide) * vec[:, :, :, :, None, :].to(wide)).to(vec.dtype)
    ix = torch.round(pts[..., 0]).clamp(0, gx - 1).to(torch.int64)
    iy = torch.round(pts[..., 1]).clamp(0, gy - 1).to(torch.int64)
    paf_l = pafs.permute(0, 3, 1, 2).reshape(B, NUM_LIMBS, 2, gy * gx)
    flat = (iy * gx + ix).reshape(B, NUM_LIMBS, 1, -1).expand(-1, -1, 2, -1)
    g = paf_l.gather(-1, flat).reshape(B, NUM_LIMBS, 2, P, P, num_samples)
    dots = g[:, :, 0] * u[..., 0:1] + g[:, :, 1] * u[..., 1:2]      # (B, L, P, P, S)
    mean_dot = dots.mean(-1)
    prior = (0.5 * gy / norm.clamp(min=1e-8) - 1.0).clamp(max=0.0)
    scores = mean_dot + prior
    good = (dots > sample_threshold).to(dots.dtype).mean(-1) >= min_good_frac
    ok = good & (scores > 0) & a_ok[:, :, :, None] & b_ok[:, :, None, :]
    return scores, ok


def greedy_limb_match(scores: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Per-limb greedy bipartite matching on the scored pairs.

    scores/ok (B, L, P, P) → conns (B, L, P, 3): [a_slot, b_slot, score]
    rows in the order taken, -1 rows after them.  The score is stored
    through float32, as the JAX row is built."""
    B, L, P, _ = scores.shape
    with record_function("limb_match"):
        s = torch.where(ok, scores, torch.full((), float("-inf"), dtype=scores.dtype,
                                               device=scores.device)).reshape(B * L, P * P)
        order = torch.argsort(-s, dim=-1, stable=True)
        s_sorted = s.gather(-1, order)
        a_all, b_all = order // P, order % P
        out = torch.full((B * L, P, 3), -1.0, dtype=scores.dtype, device=scores.device)
        used_a = torch.zeros((B * L, P), dtype=torch.bool, device=scores.device)
        used_b = torch.zeros_like(used_a)
        n = torch.zeros(B * L, dtype=torch.int64, device=scores.device)
        rows = torch.arange(B * L, device=scores.device)
        # the sorted scores are finite first: past the last finite one of
        # every problem no pair is taken
        steps = int(torch.isfinite(s).sum(-1).max()) if s.numel() else 0
        for i in range(steps):
            a, b, sc = a_all[:, i], b_all[:, i], s_sorted[:, i]
            take = torch.isfinite(sc) & ~used_a[rows, a] & ~used_b[rows, b]
            slot = n.clamp(max=P - 1)
            row = torch.stack([a.to(out.dtype), b.to(out.dtype),
                               sc.to(torch.float32).to(out.dtype)], -1)
            out[rows, slot] = torch.where(take[:, None], row, out[rows, slot])
            used_a[rows, a] |= take
            used_b[rows, b] |= take
            n += take
    return out.reshape(B, L, P, 3)


def assemble_instances(peaks_xy, peaks_score, conns, max_people: int = 20,
                       min_parts: int = 3, min_score: float = 0.2):
    """Host instance assembly (the OpenPose paper's subset merge) for ONE
    image: numpy peaks_xy (18, P, 2), peaks_score (18, P), conns (L, P, 3)
    → (people (N, 18, 3) grid coordinates and per-joint score,
    instance_scores (N,)), N ≤ max_people."""
    subsets = []   # each: dict joint -> slot, plus the score accumulator
    for l, (k1, k2) in enumerate(LIMB_IDS):
        for row in conns[l]:
            a, b, sc = int(row[0]), int(row[1]), float(row[2])
            if a < 0:
                continue
            found = [s for s in subsets
                     if s["joints"].get(k1) == a or s["joints"].get(k2) == b]
            if not found:
                subsets.append({"joints": {k1: a, k2: b},
                                "score": sc + peaks_score[k1, a] + peaks_score[k2, b]})
            elif len(found) == 1:
                s = found[0]
                if s["joints"].get(k2) is None:
                    s["joints"][k2] = b
                    s["score"] += sc + peaks_score[k2, b]
                elif s["joints"].get(k1) is None:
                    s["joints"][k1] = a
                    s["score"] += sc + peaks_score[k1, a]
            else:
                s1, s2 = found[0], found[1]
                if not (set(s1["joints"]) & set(s2["joints"])):
                    s1["joints"].update(s2["joints"])
                    s1["score"] += s2["score"] + sc
                    subsets.remove(s2)
    out, out_scores = [], []
    for s in subsets:
        n = len(s["joints"])
        if n < min_parts or s["score"] / max(n, 1) < min_score:
            continue
        person = np.zeros((NUM_JOINTS, 3), np.float32)
        for j, slot in s["joints"].items():
            person[j, :2] = peaks_xy[j, slot]
            person[j, 2] = peaks_score[j, slot]
        out.append(person)
        out_scores.append(s["score"] / max(n, 1))
    order = np.argsort(-np.asarray(out_scores)) if out else []
    out = [out[i] for i in order][:max_people]
    out_scores = [out_scores[i] for i in order][:max_people]
    return (np.stack(out) if out else np.zeros((0, NUM_JOINTS, 3), np.float32),
            np.asarray(out_scores, np.float32))


def openpose_decode(heatmaps, pafs, max_peaks: int = 20, peak_threshold: float = 0.1,
                    max_people: int = 20):
    """Bottom-up decode of a batch: peaks, scoring and matching on the
    maps' device, host assembly → a list over images of (people (N, 18,
    3), scores (N,)) in heatmap grid pixels."""
    xy, score, valid = find_peaks(heatmaps[..., :NUM_JOINTS], max_peaks, peak_threshold)
    pair_scores, ok = score_limb_pairs(xy, valid, pafs)
    conns = greedy_limb_match(pair_scores, ok)
    xy_h, sc_h, conns_h = (t.cpu().numpy() for t in (xy, score, conns))
    return [assemble_instances(xy_h[b], sc_h[b], conns_h[b], max_people=max_people)
            for b in range(xy_h.shape[0])]


def instances_to_eval(decoded, stride, targets=None, max_people: int = 20):
    """Decoded people → the padded instances dict that
    ``CocoEvaluator(('bbox', 'keypoints'))`` takes: keypoints in COCO17
    order in original image pixels (un-letterboxed by the batch's
    ``pads``/``scales``), boxes the keypoints' extent, score the
    instance score (numpy)."""
    B = len(decoded)
    K = 17
    kpts = np.zeros((B, max_people, K, 3), np.float32)
    boxes = np.zeros((B, max_people, 4), np.float32)
    scores = np.zeros((B, max_people), np.float32)
    valid = np.zeros((B, max_people), bool)
    inv = _coco_inverse()
    for b, (people, pscores) in enumerate(decoded):
        n = min(len(people), max_people)
        for i in range(n):
            k17 = people[i][inv]
            # grid → network pixels with the renderer's grid-centre offset
            xy = k17[:, :2] * stride + (stride / 2.0 - 0.5)
            if targets is not None and "pads" in targets:
                pads = np.asarray(targets["pads"])[b]
                scl = np.asarray(targets["scales"])[b]
                xy = (xy - pads[None, :]) / scl[None, :]
            vis = k17[:, 2] > 0
            if not vis.any():
                continue
            kpts[b, i, :, :2] = xy
            kpts[b, i, :, 2] = np.where(vis, 2.0, 0.0)
            boxes[b, i] = [xy[vis, 0].min(), xy[vis, 1].min(),
                           xy[vis, 0].max(), xy[vis, 1].max()]
            scores[b, i] = pscores[i]
            valid[b, i] = True
    return {"boxes": boxes, "scores": scores,
            "labels": np.zeros((B, max_people), np.int32),
            "valid": valid, "keypoints": kpts}
