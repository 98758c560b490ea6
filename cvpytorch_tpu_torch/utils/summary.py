"""Model summary (counterpart of ``cvpytorch_tpu/utils/summary.py``):
parameter counts by top-level module and the forward pass's FLOPs.

The FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of one
forward at ``input_shape``: convolutions, matmuls and attention, two
FLOPs a multiply-add, and nothing for elementwise operations, pooling or
normalisation.  The JAX summary reports XLA's ``cost_analysis`` of the
compiled forward, which counts every operation, so the two FLOP counts
differ by design; ``flops_basis`` names the count.  The parameter counts
are the JAX summary's.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

FLOPS_BASIS = "torch.utils.flop_counter (convolutions, matmuls, attention)"


def params_by_module(model: nn.Module) -> dict[str, int]:
    """Top-level child (or direct parameter) → its parameter count;
    children without parameters are left out, as the Flax tree has no
    entry for them."""
    out = {name: p.numel() for name, p in model.named_parameters(recurse=False)}
    for name, child in model.named_children():
        n = sum(p.numel() for p in child.parameters())
        if n:
            out[name] = n
    return out


def model_summary(model: nn.Module, input_shape=(1, 224, 224, 3), targets: Any = None,
                  mode: str = "infer") -> dict:
    """→ {'total_params', 'params_by_module', 'flops', 'flops_g',
    'flops_basis', 'bytes_accessed' (None: no such count here),
    'input_shape'}.  One forward of zeros (NHWC, float32) on the device of
    the model's parameters, in ``mode``, under ``no_grad``."""
    from torch.utils.flop_counter import FlopCounterMode

    by_module = params_by_module(model)
    total = sum(by_module.values())
    param = next(model.parameters(), None)
    device = param.device if param is not None else torch.device("cpu")
    x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x, targets, mode=mode)
    flops = float(counter.get_total_flops()) or None
    return {
        "total_params": total,
        "params_by_module": by_module,
        "flops": flops,
        "flops_g": round(flops / 1e9, 3) if flops else None,
        "flops_basis": FLOPS_BASIS,
        "bytes_accessed": None,
        "input_shape": tuple(input_shape),
    }


def format_summary(info: dict, name: str = "model") -> str:
    lines = [f"{name}  (input {info['input_shape']})", "-" * 52]
    for k, v in sorted(info["params_by_module"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  {k:<30s} {v / 1e6:10.3f} M")
    lines.append("-" * 52)
    lines.append(f"  {'TOTAL params':<30s} {info['total_params'] / 1e6:10.3f} M")
    if info.get("flops"):
        lines.append(f"  {'forward FLOPs':<30s} {info['flops'] / 1e9:10.3f} G")
        lines.append(f"  (counted by {info['flops_basis']})")
    return "\n".join(lines)
