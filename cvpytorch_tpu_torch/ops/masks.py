"""Instance-mask pasting (counterpart of ``cvpytorch_tpu/ops/masks.py``).

Pasting a (mh, mw) ROI mask into an (oh, ow) canvas is a separable
bilinear resample: two batched products with per-detection interpolation
weights, fixed shapes, no scatter.
"""
from __future__ import annotations

import torch


def _axis_weights(centers, lo, hi, m: int):
    """(..., out) canvas-pixel centres → (..., out, m) bilinear weights into
    a ROI axis of ``m`` bins spanning [lo, hi]; zero outside."""
    t = (centers - lo[..., None]) / torch.clamp(hi - lo, min=1e-6)[..., None]
    inside = (t >= 0.0) & (t <= 1.0)
    mc = t * m - 0.5  # mask-bin coordinate
    idx = torch.arange(m, dtype=torch.float32, device=centers.device)
    w = torch.clamp(1.0 - (mc[..., None] - idx).abs(), min=0.0)
    # replicate the border half-bin so the boxes' edges stay solid
    first = torch.clamp(-mc, min=0.0) * (mc > -1.0)
    last = torch.clamp(mc - (m - 1), min=0.0) * (mc < m)
    w = torch.cat([w[..., :1] + first[..., None], w[..., 1:m - 1],
                   w[..., m - 1:] + last[..., None]], -1)
    return w * inside[..., None]


def paste_masks(masks, boxes, heights, widths, out_size: int = 112,
                threshold: float = 0.5):
    """masks (B, K, mh, mw) in [0, 1]; boxes (B, K, 4) xyxy in image pixels;
    heights/widths (B,) image extents → (B, K, out, out) binary canvas
    covering each full image."""
    B, K, mh, mw = masks.shape
    oh = ow = out_size
    dev = masks.device
    hs = heights.to(torch.float32)[:, None]
    ws = widths.to(torch.float32)[:, None]
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5)[None, None] * \
        (hs[..., None] / oh)  # (B, 1, oh)
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5)[None, None] * \
        (ws[..., None] / ow)
    x1, y1, x2, y2 = boxes.unbind(-1)
    wy = _axis_weights(ys, y1, y2, mh)  # (B, K, oh, mh)
    wx = _axis_weights(xs, x1, x2, mw)  # (B, K, ow, mw)
    canvas = torch.matmul(torch.matmul(wy, masks.float()), wx.transpose(-1, -2))
    return (canvas >= threshold).to(torch.float32)
