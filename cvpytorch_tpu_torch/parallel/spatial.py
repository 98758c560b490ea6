"""Overlap-tile evaluation with the image height split over a mesh axis
(counterpart of ``cvpytorch_tpu/parallel/spatial.py``).

``spatial_apply(apply_fn, images, mesh, axis="model", overlap=32)`` runs a
fully convolutional ``apply_fn`` on (B, H, W, C) NHWC images with H cut
into one strip of H / n rows a rank of ``axis``.  Each rank keeps its
strip, takes ``overlap`` halo rows from each neighbour (zero rows at the
image's top and bottom, as the JAX ``shard_map`` pads them), runs
``apply_fn`` on the padded strip, crops ``overlap · out_H / in_H`` rows
off each end of the result and returns the whole output, the strips
gathered in rank order.

The halos travel as one all-gather of each rank's first and last
``overlap`` rows: gloo carries all-gathers of CUDA tensors (several ranks
on one card) where it may not carry point-to-point sends.  Exactness is
JAX's: every output row whose receptive field lies inside the image is
the unsplit forward's, the seams included, when ``overlap`` is at least
the receptive radius (and a multiple of the total stride of a stride
chain); the outermost rows see zero input rows where the unsplit model
pads at every layer.  Eval semantics: BN uses its running statistics.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def spatial_apply(apply_fn, images: torch.Tensor, mesh, axis: str = "model",
                  overlap: int = 32) -> torch.Tensor:
    n = mesh.size(axis)
    B, H, W, C = images.shape
    if H % n:
        raise ValueError(f"H={H} not divisible by {axis}={n}")
    h, i = H // n, mesh.index(axis)
    if not 0 < overlap <= h:
        raise ValueError(f"overlap {overlap} must be in (0, {h}], a strip's rows")
    x = images[:, i * h:(i + 1) * h]
    zeros = x.new_zeros((B, overlap, W, C))
    if n == 1:
        above = below = zeros
    else:
        group = mesh.group(axis)
        edges = torch.cat([x[:, :overlap], x[:, -overlap:]], 1).contiguous()
        pieces = [torch.empty_like(edges) for _ in range(n)]
        dist.all_gather(pieces, edges, group=group)
        above = pieces[i - 1][:, overlap:] if i > 0 else zeros
        below = pieces[i + 1][:, :overlap] if i < n - 1 else zeros
    padded = torch.cat([above, x, below], 1)
    y = apply_fn(padded)
    oh = overlap * y.shape[1] // padded.shape[1]
    y = y[:, oh:y.shape[1] - oh].contiguous()
    if n == 1:
        return y
    strips = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(strips, y, group=mesh.group(axis))
    return torch.cat(strips, 1)
