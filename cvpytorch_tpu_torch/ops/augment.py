"""Device-side detection augmentation (counterpart of
``cvpytorch_tpu/ops/augment.py``): mosaic-4, random scale+translate affine
(cropped to the output size), HSV gain jitter, horizontal flip and
normalise, as tensor operations on the device the batch is on.

The random draws are split from the transform: ``draw_aug_params`` takes
a ``torch.Generator`` and returns the mosaic centres, the affine matrices,
the HSV gains and the flip flags; ``apply_aug`` applies them and is
deterministic, so the same draws give the JAX package's result (the tests
hand it the draws of ``jax.random``, which a ``torch.Generator`` cannot
reproduce).  ``fused_det_augment`` is the two in a row.

The affine is scale+translate only (every shipped YOLO hyp has degrees 0
and shear 0), so the warp is separable: two products with per-axis
bilinear tent weights (``affine_warp_separable``).
"""
from __future__ import annotations

import math

import torch

HSV_GAINS = (0.015, 0.7, 0.4)  # hue, saturation, value


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step, seeded from ``(seed, step)``."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return g


def normalize(images, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
    """[0, 255] → (x/255 − mean)/std, float32."""
    x = images.to(torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _tent_weights(o: int, s: int, scale, off):
    """(B, o, s) bilinear weights of output pixel → source pixel."""
    src = scale[:, None] * torch.arange(o, dtype=torch.float32, device=scale.device) \
        + off[:, None]
    idx = torch.arange(s, dtype=torch.float32, device=scale.device)
    return (1.0 - (src[:, :, None] - idx).abs()).clamp(min=0.0)


def affine_warp_separable(images, inv_matrices, out_hw, fill: float = 114.0):
    """Axis-aligned warp as two batched products.

    images (B, H, W, C) float; inv_matrices (B, 2, 3) map output pixel
    coordinates to source coordinates (only the scale and translation
    terms are read).  Tent mass that falls outside the source blends
    toward ``fill``."""
    B, H, W, C = images.shape
    oh, ow = out_hw
    wx = _tent_weights(ow, W, inv_matrices[:, 0, 0], inv_matrices[:, 0, 2])
    wy = _tent_weights(oh, H, inv_matrices[:, 1, 1], inv_matrices[:, 1, 2])
    t = torch.einsum("byh,bhwc->bywc", wy, images.to(torch.float32))
    t = torch.einsum("bxw,bywc->byxc", wx, t)
    cov = wy.sum(2)[:, :, None] * wx.sum(2)[:, None, :]
    return t + (1.0 - cov)[..., None] * fill


def invert_affine(m):
    """Invert (…, 2, 3) forward affines → inverse maps."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    return torch.stack([
        torch.stack([ia, ib, -(ia * tx + ib * ty)], -1),
        torch.stack([ic, id_, -(ic * tx + id_ * ty)], -1),
    ], -2)


def transform_boxes(boxes, m):
    """Forward-affine xyxy boxes (B, N, 4) with (B, 2, 3) matrices; the
    axis-aligned box around the 4 warped corners."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    xs = torch.stack([x1, x2, x1, x2], -1)  # (B,N,4)
    ys = torch.stack([y1, y1, y2, y2], -1)
    m = m[:, None, None]  # (B,1,1,2,3)
    wx = m[..., 0, 0] * xs + m[..., 0, 1] * ys + m[..., 0, 2]
    wy = m[..., 1, 0] * xs + m[..., 1, 1] * ys + m[..., 1, 2]
    return torch.stack([wx.amin(-1), wy.amin(-1), wx.amax(-1), wy.amax(-1)], -1)


def box_candidates_mask(old, new, wh_thr=2.0, ar_thr=20.0, area_thr=0.1):
    """Validity of post-warp boxes (…, 4) against their pre-warp boxes."""
    w1 = old[..., 2] - old[..., 0]
    h1 = old[..., 3] - old[..., 1]
    w2 = new[..., 2] - new[..., 0]
    h2 = new[..., 3] - new[..., 1]
    ar = torch.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return (w2 > wh_thr) & (h2 > wh_thr) & \
        (w2 * h2 / (w1 * h1 + 1e-16) > area_thr) & (ar < ar_thr)


def _select(i, choices):
    """``jnp.select([i == 0, …, i == 5], choices)`` for i in [0, 5]."""
    out = choices[-1]
    for k in range(len(choices) - 2, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def hsv_jitter(images, gains):
    """Per-image HSV gain jitter.  images (B, H, W, 3) float RGB in
    [0, 255]; gains (B, 3) multiply hue, saturation and value."""
    x = images / 255.0
    maxc = x.amax(-1)
    minc = x.amin(-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / (maxc + 1e-12), 0.0)
    r, g, b = x.unbind(-1)
    h = torch.where(
        delta < 1e-12, 0.0,
        torch.where(maxc == r, torch.remainder((g - b) / (delta + 1e-12), 6),
                    torch.where(maxc == g, (b - r) / (delta + 1e-12) + 2,
                                (r - g) / (delta + 1e-12) + 4))) / 6.0

    h = torch.remainder(h * gains[:, None, None, 0], 1.0)
    s = (s * gains[:, None, None, 1]).clamp(0, 1)
    v = (v * gains[:, None, None, 2]).clamp(0, 1)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    r2 = _select(i, (v, q, p, p, t, v))
    g2 = _select(i, (t, v, v, q, p, p))
    b2 = _select(i, (p, p, t, v, v, q))
    return torch.stack([r2, g2, b2], -1) * 255.0


def random_hflip(images, boxes, flip):
    """Flip the images where ``flip`` (B,) is set, mirroring their boxes."""
    W = images.shape[2]
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    fb = torch.stack([W - boxes[..., 2], boxes[..., 1],
                      W - boxes[..., 0], boxes[..., 3]], -1)
    return images, torch.where(flip[:, None, None], fb, boxes)


def affine_matrices(ang, s, shx, shy, tx, ty, height: int, width: int):
    """(B, 2, 3) forward matrices T·S·R·C from the drawn angle (radians),
    scale, shear tangents and translation (pixels)."""
    B = ang.shape[0]
    dev = ang.device
    cos, sin = torch.cos(ang) * s, torch.sin(ang) * s
    zero, one = torch.zeros(B, device=dev), torch.ones(B, device=dev)
    last = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(B, 3)
    C = torch.tensor([[1.0, 0, -width / 2], [0, 1.0, -height / 2],
                      [0, 0, 1.0]], device=dev).expand(B, 3, 3)
    R = torch.stack([torch.stack([cos, -sin, zero], -1),
                     torch.stack([sin, cos, zero], -1), last], 1)
    S = torch.stack([torch.stack([one, shx, zero], -1),
                     torch.stack([shy, one, zero], -1), last], 1)
    T = torch.stack([torch.stack([one, zero, tx], -1),
                     torch.stack([zero, one, ty], -1), last], 1)
    return (T @ S @ R @ C)[:, :2]


def random_affine_matrices(generator, B: int, height: int, width: int,
                           degrees=0.0, translate=0.1, scale=(0.5, 1.5),
                           shear=0.0):
    dev = generator.device

    def uniform(lo, hi):
        return torch.rand(B, generator=generator, device=dev) * (hi - lo) + lo

    ang = uniform(-degrees, degrees) * math.pi / 180
    s = uniform(scale[0], scale[1]) if isinstance(scale, (tuple, list)) \
        else uniform(1 - scale, 1 + scale)
    shx = torch.tan(uniform(-shear, shear) * math.pi / 180)
    shy = torch.tan(uniform(-shear, shear) * math.pi / 180)
    tx = uniform(0.5 - translate, 0.5 + translate) * width
    ty = uniform(0.5 - translate, 0.5 + translate) * height
    return affine_matrices(ang, s, shx, shy, tx, ty, height, width)


def mosaic4(images, boxes, valid, centers, fill: float = 114.0):
    """Mosaic-4 around the given centres.

    images (B, 4, S, S, C); boxes (B, 4, M, 4) xyxy; valid (B, 4, M);
    centers (B, 2) = (xc, yc) in [S/2, 3S/2).  Tile j is placed with its
    top-left corner at the rounded offset (xc − S, yc − S), (xc, yc − S),
    (xc − S, yc), (xc, yc) on a 3S guard canvas (later tiles over earlier
    ones), and the canvas's central 2S window is returned.
    Returns canvas (B, 2S, 2S, C) float32, boxes (B, 4M, 4), valid (B, 4M)."""
    B, four, S, _, C = images.shape
    if four != 4:
        raise ValueError(f"mosaic4 takes 4 tiles per sample, got {four}")
    xc, yc = centers[:, 0], centers[:, 1]
    offs = torch.stack([torch.stack([xc - S, yc - S], -1),
                        torch.stack([xc, yc - S], -1),
                        torch.stack([xc - S, yc], -1),
                        torch.stack([xc, yc], -1)], 1)  # (B, 4, 2)
    half = S // 2
    start = (torch.round(offs).to(torch.int64) + half).clamp(0, 2 * S)
    pos = torch.arange(2 * S, device=images.device) + half
    canvas = torch.full((B, 2 * S, 2 * S, C), fill, dtype=torch.float32,
                        device=images.device)
    for j in range(4):
        ry = pos[None] - start[:, j, 1:2]  # (B, 2S) row inside tile j
        rx = pos[None] - start[:, j, 0:1]
        rows = images[:, j].gather(
            1, ry.clamp(0, S - 1)[:, :, None, None].expand(B, 2 * S, S, C))
        patch = rows.gather(
            2, rx.clamp(0, S - 1)[:, None, :, None].expand(B, 2 * S, 2 * S, C))
        inside = ((ry >= 0) & (ry < S))[:, :, None] & ((rx >= 0) & (rx < S))[:, None, :]
        canvas = torch.where(inside[..., None], patch.to(torch.float32), canvas)
    shifted = boxes + torch.cat([offs, offs], -1)[:, :, None, :]
    out_boxes = shifted.reshape(B, -1, 4).clamp(0, 2 * S)
    return canvas, out_boxes, valid.reshape(B, -1)


def draw_aug_params(generator, B: int, S: int, out_size: int) -> dict:
    """Every random draw of one augmented batch, on the generator's device:
    mosaic ``centers`` (B, 2), ``affine`` (B, 2, 3) forward matrices over the
    output square (scale 0.5–1.5, translate ±0.1), HSV ``gains`` (B, 3) and
    ``flip`` (B,) bool (p = 0.5)."""
    dev = generator.device
    centers = torch.rand(B, 2, generator=generator, device=dev) * S + S * 0.5
    affine = random_affine_matrices(generator, B, out_size, out_size)
    hsv = torch.tensor(HSV_GAINS, device=dev)
    gains = (torch.rand(B, 3, generator=generator, device=dev) * 2 - 1) * hsv + 1.0
    flip = torch.rand(B, generator=generator, device=dev) < 0.5
    return {"centers": centers, "affine": affine, "gains": gains, "flip": flip}


def apply_aug(images, boxes, valid, params: dict, out_size: int):
    """mosaic4 → affine (crop to out_size) → BGR→RGB → HSV → flip →
    normalise (to [0, 1]), with the draws of ``draw_aug_params``.

    images (B, 4, S, S, 3) uint8 BGR tiles; boxes (B, 4, M, 4) xyxy;
    valid (B, 4, M).  Returns normalised (B, out, out, 3) float32 RGB, the
    boxes (B, 4M, 4) and their validity after the warp."""
    canvas, mboxes, mvalid = mosaic4(images, boxes, valid, params["centers"])
    B, S = canvas.shape[0], images.shape[2]
    # tiles may come below the output resolution (DEVICE_AUG TILE < SIZE):
    # the canvas → output scale ts, and the border crop of S/2 a side,
    # fold into the affine
    ts = out_size / S
    dev = canvas.device
    shift = torch.tensor([[ts, 0.0, -S / 2 * ts], [0.0, ts, -S / 2 * ts],
                          [0.0, 0.0, 1.0]], device=dev)
    last = torch.tensor([[[0.0, 0.0, 1.0]]], device=dev).expand(B, 1, 3)
    ms = (torch.cat([params["affine"], last], 1) @ shift)[:, :2]
    inv = invert_affine(ms)
    out = affine_warp_separable(canvas, inv, (out_size, out_size))
    nboxes = transform_boxes(mboxes, ms).clamp(0, out_size)
    scale_b = torch.sqrt(torch.abs(ms[:, 0, 0] * ms[:, 1, 1] - ms[:, 0, 1] * ms[:, 1, 0]))
    keep = box_candidates_mask(mboxes * scale_b[:, None, None], nboxes) & mvalid
    out = out.flip(-1)  # BGR → RGB before the jitter, as ToTensor does
    out = hsv_jitter(out, params["gains"])
    out, nboxes = random_hflip(out, nboxes, params["flip"])
    return normalize(out), nboxes, keep


def fused_det_augment(images, boxes, valid, generator, out_size: int,
                      rows: slice | None = None, global_batch: int | None = None):
    """``apply_aug`` with fresh draws from ``generator``.  ``rows``: the
    batch is these rows of a global batch of ``global_batch`` (a rank's
    share under data parallelism): the global batch's draws are made and
    the rows' kept, so that the rows are augmented as in one process."""
    B = images.shape[0] if rows is None else global_batch
    params = draw_aug_params(generator, B, images.shape[2], out_size)
    if rows is not None:
        params = {k: v[rows] for k, v in params.items()}
    return apply_aug(images, boxes, valid, params, out_size)
