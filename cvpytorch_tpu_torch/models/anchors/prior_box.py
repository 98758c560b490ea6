"""SSD prior boxes (counterpart of ``cvpytorch_tpu/models/anchors/prior_box.py``;
numpy, no framework).

For each feature map, every cell (row-major) emits a small square, a big
(geometric-mean) square and a ±sqrt(ratio) rectangle pair per aspect
ratio: cxcywh relative to the image, computed in float64, returned as
float32, optionally clipped to [0, 1].
"""
from __future__ import annotations

from math import sqrt
from typing import Sequence

import numpy as np


def ssd_prior_boxes(
    image_size: int = 300,
    feature_maps: Sequence[int] = (38, 19, 10, 5, 3, 1),
    min_sizes: Sequence[int] = (21, 45, 99, 153, 207, 261),
    max_sizes: Sequence[int] = (45, 99, 153, 207, 261, 315),
    strides: Sequence[int] = (8, 16, 32, 64, 100, 300),
    aspect_ratios: Sequence[Sequence[int]] = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
    clip: bool = True,
) -> np.ndarray:
    """→ (num_priors, 4) cxcywh in [0, 1]."""
    out = []
    for k, f in enumerate(feature_maps):
        scale = image_size / strides[k]
        ii, jj = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
        cx = (jj.reshape(-1) + 0.5) / scale
        cy = (ii.reshape(-1) + 0.5) / scale
        s = min_sizes[k] / image_size
        whs = [(s, s), (sqrt(min_sizes[k] * max_sizes[k]) / image_size,) * 2]
        for r in aspect_ratios[k]:
            rr = sqrt(r)
            whs += [(s * rr, s / rr), (s / rr, s * rr)]
        wh = np.asarray(whs, np.float64)
        cells = np.stack([cx, cy], -1)
        out.append(np.concatenate([np.repeat(cells, len(wh), 0), np.tile(wh, (len(cells), 1))],
                                  -1))
    priors = np.concatenate(out, 0).astype(np.float32)
    return priors.clip(0.0, 1.0) if clip else priors


class PriorBox:
    """``PriorBox(**kwargs)()`` → ``ssd_prior_boxes(**kwargs)``."""

    def __init__(self, image_size=300, feature_maps=(38, 19, 10, 5, 3, 1),
                 min_sizes=(21, 45, 99, 153, 207, 261), max_sizes=(45, 99, 153, 207, 261, 315),
                 strides=(8, 16, 32, 64, 100, 300),
                 aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)), clip=True):
        self.kwargs = dict(image_size=image_size, feature_maps=feature_maps, min_sizes=min_sizes,
                           max_sizes=max_sizes, strides=strides, aspect_ratios=aspect_ratios,
                           clip=clip)

    def __call__(self) -> np.ndarray:
        return ssd_prior_boxes(**self.kwargs)
