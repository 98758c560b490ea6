"""YOLOv5 detect layer (counterpart of
``cvpytorch_tpu/models/detects/yolov5_detect.py``).

Per-level 1×1 conv → (B, ny, nx, A, 5+C) raw maps, the JAX layout; decode
is a separate function (sigmoid grid decode).  The bias prior is the JAX
one: obj += log(8/(640/s)²), cls += log(0.6/(C−0.99…)).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...registry import DETECTS


def _bias_prior(num_anchors: int, num_classes: int, stride: float):
    b = torch.zeros(num_anchors, 5 + num_classes)
    b[:, 4] += math.log(8 / (640 / stride) ** 2)
    b[:, 5:] += math.log(0.6 / (num_classes - 0.999999))
    return b.reshape(-1)


@DETECTS.register(name="YOLOv5Detect")
class YOLOv5Detect(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 num_anchors: int = 3,
                 strides: Sequence[float] = (8.0, 16.0, 32.0)):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        no = 5 + num_classes
        for i, c in enumerate(in_channels):
            conv = nn.Conv2d(c, num_anchors * no, 1)
            with torch.no_grad():
                conv.bias.copy_(_bias_prior(num_anchors, num_classes, strides[i]))
            setattr(self, f"m{i}", conv)
        self.n_levels = len(in_channels)

    def forward(self, feats):
        """feats: (P3, P4, P5) NCHW → list of (B, ny, nx, A, 5+C).  The
        conv's channel order is A·(5+C); a channels_last output makes the
        permuted view contiguous."""
        outs = []
        no = 5 + self.num_classes
        for i, x in enumerate(feats):
            y = getattr(self, f"m{i}")(x)
            b, _, ny, nx = y.shape
            outs.append(y.view(b, self.num_anchors, no, ny, nx)
                        .permute(0, 3, 4, 1, 2))
        return outs


def decode_yolov5(raw_outs, anchors, strides):
    """Sigmoid grid decode.

    raw_outs: list of (B, ny, nx, A, 5+C); anchors (L, A, 2) in grid units.
    Returns (B, N_total, 5+C): cxcywh in network pixels + obj + cls probs.
    """
    decoded = []
    for i, x in enumerate(raw_outs):
        b, ny, nx, na, no = x.shape
        y = torch.sigmoid(x)
        gy, gx = torch.meshgrid(
            torch.arange(ny, dtype=torch.float32, device=x.device),
            torch.arange(nx, dtype=torch.float32, device=x.device),
            indexing="ij")
        grid = torch.stack([gx, gy], -1)[None, :, :, None, :]  # (1,ny,nx,1,2)
        anchor_grid = torch.tensor(anchors[i], dtype=torch.float32,
                                   device=x.device) * strides[i]
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * strides[i]
        wh = (y[..., 2:4] * 2.0) ** 2 * anchor_grid
        out = torch.cat([xy, wh, y[..., 4:]], -1)
        decoded.append(out.reshape(b, ny * nx * na, no))
    return torch.cat(decoded, 1)
