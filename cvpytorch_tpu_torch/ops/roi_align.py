"""ROIAlign (counterpart of ``cvpytorch_tpu/ops/roi_align.py``): plain torch
tensor ops, as the JAX module is plain XLA.

Bilinear 4-tap sampling at the standard ROIAlign grid (``sampling_ratio``
² samples per output bin, averaged), ``aligned=True`` (the −0.5 pixel
offset), taps outside the map zeroed per axis.  Features are NHWC
(B, H, W, C), as in the JAX package; the port's FPN maps are
``channels_last``, so ``f.permute(0, 2, 3, 1)`` is a view of their
memory.  Each tap is one ``index_select`` of rows of a (rows, C) buffer,
so its backward is one ``index_add_``.  The FPN level of a box follows
torchvision's heuristic k = floor(4 + log2(sqrt(area)/224)), clamped to
the levels present.

The bilinear weights are cast to the features' dtype, so under bf16
autocast the taps combine in bf16, as the JAX AMP step computes them.
``crop_resize_separable`` (the mask-target crop) is two batched products
in float32 with autocast off; the JAX package pins
``Precision.HIGHEST`` there, which TF32 left off gives.
"""
from __future__ import annotations

import torch


def _grid(boxes, output_size: int, sampling_ratio: int, aligned: bool):
    """(N, S) sample coordinates along y and x, S = output_size·ratio."""
    off = 0.5 if aligned else 0.0
    x1, y1 = boxes[:, 0] - off, boxes[:, 1] - off
    bw = torch.clamp(boxes[:, 2] - off - x1, min=1e-6)
    bh = torch.clamp(boxes[:, 3] - off - y1, min=1e-6)
    n = sampling_ratio
    g = (torch.arange(output_size * n, dtype=torch.float32,
                      device=boxes.device) + 0.5) / n  # bin units
    ys = y1[:, None] + bh[:, None] * g[None, :] / output_size
    xs = x1[:, None] + bw[:, None] * g[None, :] / output_size
    return ys, xs


def _gather_taps(flat, base, ys, xs, H, W, output_size, n):
    """Bilinear taps from the (rows, C) buffer ``flat`` for every box:
    ``base`` (N,) is the box's first row, H and W its map's extent (ints or
    (N,) tensors).  Returns (N, output_size, output_size, C)."""
    N, S = ys.shape
    C = flat.shape[1]
    if not torch.is_tensor(H):
        H = torch.full((N,), H, dtype=torch.int64, device=ys.device)
        W = torch.full((N,), W, dtype=torch.int64, device=ys.device)
    Hc, Wc = H[:, None], W[:, None]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0

    def tap(yy, xx):
        inb_y = (yy >= 0) & (yy < Hc)
        inb_x = (xx >= 0) & (xx < Wc)
        yi = torch.minimum(yy.clamp(min=0), Hc - 1).to(torch.int64)
        xi = torch.minimum(xx.clamp(min=0), Wc - 1).to(torch.int64)
        fidx = base[:, None, None] + yi[:, :, None] * W[:, None, None] + xi[:, None, :]
        v = flat.index_select(0, fidx.reshape(-1)).view(N, S, S, C)
        m = inb_y[:, :, None] & inb_x[:, None, :]
        return v, m

    wy = fy[:, :, None]
    wx = fx[:, None, :]
    sampled = 0
    for dy, dx, w in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                      (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        v, m = tap(y0 + dy, x0 + dx)
        sampled = sampled + v * torch.where(m, w, 0.0).to(v.dtype)[..., None]
    return sampled.view(N, output_size, n, output_size, n, C).mean((2, 4))


def roi_align(features, boxes, output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = True):
    """features (H, W, C); boxes (N, 4) xyxy in image pixels →
    (N, output_size, output_size, C)."""
    idx = torch.zeros(boxes.shape[0], dtype=torch.int64, device=boxes.device)
    return batched_roi_align(features[None], boxes, idx, output_size,
                             spatial_scale, sampling_ratio, aligned)


def batched_roi_align(features, boxes, box_batch_idx, output_size: int = 7,
                      spatial_scale: float = 1.0, sampling_ratio: int = 2,
                      aligned: bool = True):
    """features (B, H, W, C); boxes (N, 4); box_batch_idx (N,) image index.
    Gathers only the 4 bilinear taps of each sample, the image index folded
    into a row of the (B·H·W, C) buffer."""
    B, H, W, C = features.shape
    ys, xs = _grid(boxes * spatial_scale, output_size, sampling_ratio, aligned)
    base = box_batch_idx.to(torch.int64) * (H * W)
    return _gather_taps(features.reshape(B * H * W, C), base, ys, xs, H, W,
                        output_size, sampling_ratio)


def crop_resize_separable(planes, boxes, output_size: int = 28,
                          sampling_ratio: int = 2, aligned: bool = True):
    """ROIAlign on single-channel planes as two batched products: planes
    (N, H, W), one per box; boxes (N, 4) xyxy in plane pixels →
    (N, output_size, output_size).  The same samples as ``roi_align`` on
    (H, W, 1) features: each axis's tap weights are zeroed outside the
    plane."""
    N, H, W = planes.shape
    with torch.autocast(planes.device.type, enabled=False):
        ys, xs = _grid(boxes.float(), output_size, sampling_ratio, aligned)

        def axis_weights(coord, size):
            c0 = torch.floor(coord)
            f = coord - c0
            idx = torch.arange(size, dtype=torch.float32, device=coord.device)
            w0 = torch.where((c0 >= 0) & (c0 < size), 1.0 - f, 0.0)
            w1 = torch.where((c0 + 1 >= 0) & (c0 + 1 < size), f, 0.0)
            return (w0[..., None] * (idx == c0[..., None]) +
                    w1[..., None] * (idx == c0[..., None] + 1))  # (N, S, size)

        wy = axis_weights(ys, H)
        wx = axis_weights(xs, W)
        sampled = torch.bmm(torch.bmm(wy, planes.float()), wx.transpose(1, 2))
    n = sampling_ratio
    return sampled.view(N, output_size, n, output_size, n).mean((2, 4))


def _fpn_level_assign(n_levels: int, boxes, canonical_level, canonical_size,
                      min_level):
    areas = torch.clamp((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]),
                        min=1e-6)
    k = torch.floor(canonical_level + torch.log2(torch.sqrt(areas) / canonical_size))
    return torch.clamp(k - min_level, 0, n_levels - 1).to(torch.int64)


def multiscale_roi_align(fpn_feats, strides, boxes, box_batch_idx,
                         output_size: int = 7, canonical_level: int = 4,
                         canonical_size: float = 224.0, min_level: int = 2):
    """FPN level assignment and ROIAlign at the assigned level only, in one
    gather pass: every level's (B·Hi·Wi, C) rows are concatenated into one
    buffer, and a box's level sets its base row (level start + image
    index · Hi·Wi), its scale and its map's extent.

    fpn_feats: list of NHWC (B, Hi, Wi, C) maps; strides parallel to it."""
    B, _, _, C = fpn_feats[0].shape
    dev = boxes.device
    k = _fpn_level_assign(len(fpn_feats), boxes, canonical_level, canonical_size,
                          min_level)
    Hs = torch.tensor([f.shape[1] for f in fpn_feats], device=dev)
    Ws = torch.tensor([f.shape[2] for f in fpn_feats], device=dev)
    starts = torch.cumsum(B * Hs * Ws, 0) - B * Hs * Ws
    flat = torch.cat([f.reshape(-1, C) for f in fpn_feats], 0)
    scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=dev)
    H, W = Hs[k], Ws[k]
    base = starts[k] + box_batch_idx.to(torch.int64) * (Hs * Ws)[k]
    ys, xs = _grid(boxes * scale[k][:, None], output_size, 2, True)
    return _gather_taps(flat, base, ys, xs, H, W, output_size, 2)


def _multiscale_roi_align_masked(fpn_feats, strides, boxes, box_batch_idx,
                                 output_size: int = 7, canonical_level: int = 4,
                                 canonical_size: float = 224.0,
                                 min_level: int = 2):
    """Align on every level and keep the assigned one: the oracle of the
    single-gather form."""
    k = _fpn_level_assign(len(fpn_feats), boxes, canonical_level, canonical_size,
                          min_level)
    out = 0
    for li, (feat, stride) in enumerate(zip(fpn_feats, strides)):
        aligned = batched_roi_align(feat, boxes, box_batch_idx, output_size,
                                    1.0 / stride)
        out = out + torch.where((k == li)[:, None, None, None], aligned, 0.0)
    return out
