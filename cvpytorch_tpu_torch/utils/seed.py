"""Seeding (counterpart of ``cvpytorch_tpu/utils/seed.py``): Python's
``random`` (the LOAD_NUM groups, the host flip), numpy's global state and
torch's default generators, which the model's initialisation draws from.
Random draws on the device take explicit ``torch.Generator``s."""
from __future__ import annotations

import random

import numpy as np
import torch

DEFAULT_SEED = 1029


def setup_seed(seed: int = DEFAULT_SEED) -> None:
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
