"""Max pooling with indices and max unpooling (counterpart of
``cvpytorch_tpu/ops/pool.py``), NCHW, as SegNet and ENet use them.

``max_pool_argmax`` takes the k² window taps as shifted slices of the
input padded with −inf: ``amax`` over the taps gives the values (its
gradient splits a tied maximum equally among the tied taps, as JAX's
``jnp.max`` does, where ``F.max_pool2d`` gives all of it to one), and
``argmax`` gives the first maximum in row-major window order, whose
position is the flat index into the H×W plane.

``max_unpool`` puts each pooled value back at its index in a zero canvas.
Overlapping windows (ENet's 3×3/s2) can name one position from two pooled
cells: the last cell in row-major pooled order wins, as JAX's
``.at[].set`` does, and only the winner gets a gradient.  A
``scatter_reduce`` "amax" of each cell's pooled position finds the
winners; each cell then adds its value, or 0 where it lost, into the
canvas.  A position receives one value and zeros, so the sum is exact in
any order: deterministic on the card, where a plain scatter (and
``F.max_unpool2d``) leaves the writer to the scheduler.  The backward is
a gather at the indices.  (Gathering the winners' values into the canvas
instead sends the gradient of every unwritten position to one cell: on
the H100 its atomics took 97 of SegNet's 228 busy ms a step.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_argmax(x, kernel: int = 2, stride: int = 2, padding: int = 0):
    """(B, C, H, W) → (pooled (B, C, Ho, Wo), int64 flat indices into each
    H×W plane); padded taps are −inf."""
    B, C, H, W = x.shape
    Ho = (H + 2 * padding - kernel) // stride + 1
    Wo = (W + 2 * padding - kernel) // stride + 1
    xp = F.pad(x, (padding,) * 4, value=float("-inf")) if padding else x
    span_h, span_w = stride * (Ho - 1) + 1, stride * (Wo - 1) + 1
    taps = torch.stack([xp[:, :, dy:dy + span_h:stride, dx:dx + span_w:stride]
                        for dy in range(kernel) for dx in range(kernel)], -1)
    pooled = taps.amax(-1)
    best = taps.argmax(-1)
    ys = torch.arange(Ho, device=x.device)[:, None] * stride - padding
    xs = torch.arange(Wo, device=x.device)[None, :] * stride - padding
    rows = torch.clamp(ys + torch.div(best, kernel, rounding_mode="floor"), 0, H - 1)
    cols = torch.clamp(xs + best % kernel, 0, W - 1)
    return pooled, rows * W + cols


def max_unpool(values, indices, out_hw):
    """Pooled ``values`` (B, C, h, w) at their flat ``indices`` in a zero
    (B, C, *out_hw) canvas; the last pooled cell naming a position wins."""
    B, C, h, w = values.shape
    oh, ow = out_hw
    idx = indices.reshape(B, C, h * w)
    order = torch.arange(h * w, device=values.device).expand(B, C, h * w)
    winner = torch.full((B, C, oh * ow), -1, dtype=torch.int64, device=values.device)
    winner.scatter_reduce_(-1, idx, order, "amax")
    won = winner.gather(-1, idx) == order
    src = torch.where(won, values.reshape(B, C, h * w),
                      torch.zeros((), dtype=values.dtype, device=values.device))
    out = torch.zeros((B, C, oh * ow), dtype=values.dtype, device=values.device)
    return out.scatter_add(-1, idx, src).reshape(B, C, oh, ow)
