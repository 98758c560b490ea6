"""Post-training int8 quantization (counterpart of
``cvpytorch_tpu/utils/quantize.py``).

Weights: symmetric int8 with one scale per output channel,
scale = max|w| / 127 over the channel (at least 1e-12), q = round(w /
scale) clipped to ±127.  The JAX package quantizes every float parameter
of two or more dimensions over the last axis of its Flax layout; the port
quantizes the same parameters over the same channels in its own layout,
leaf by leaf as ``utils/porting.load_jax_variables`` maps the layouts:

  conv weight OIHW, ``nn.Linear`` (out, in), a 1×1 conv holding a Dense
  kernel, a ``MultiHeadDense`` output projection (C, H·D): axis 0;
  ``nn.ConvTranspose2d`` (I, O, kh, kw): axis 1;
  a ``MultiHeadDense`` query/key/value projection, Flax kernel (in, H, D)
  and bias (H, D): the D axis of the (H, D, in) and (H, D) views;
  any other parameter of two or more dimensions (ViT's position
  embedding): its last axis, the layout being the same.

So the int8 payload and scales equal JAX's, moved into the port's layout.
``quantize_tree`` gives that payload (a quarter of the float32 bytes),
``dequantize_tree`` the float weights back, and ``ptq_roundtrip`` writes
the round trip into the model in place.

Activations: ``calibrate_activations`` runs batches with a forward hook on
every module and returns each module's absmax / 127, keyed by its path
with ``/`` (the root is ``''``): the Flax module paths wherever the port
carries the Flax names, which it does for every module holding weights.
``quantized_apply`` runs the model with each calibrated module's float
outputs passed through ``fake_quant``, forward hooks standing for flax's
``intercept_methods``; its straight-through gradient makes the same call a
QAT loss.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import torch
from torch import nn

from ..models.bricks import MultiHeadDense


# ---------------------------------------------------------------- weights --
def quantize_kernel(w: torch.Tensor, axis: int = 0):
    """Symmetric int8 along channel ``axis`` → (q int8, scale float32 (C,)),
    computed in ``w``'s own float type as JAX computes it."""
    w = w.detach()
    moved = w.movedim(axis, -1)
    amax = moved.abs().reshape(-1, moved.shape[-1]).amax(0)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python scalar
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
    shape = [1] * w.dim()
    shape[axis] = -1
    q = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor, axis: int = 0) -> torch.Tensor:
    shape = [1] * q.dim()
    shape[axis] = -1
    return q.to(torch.float32) * scale.reshape(shape)


def channel_view(name: str, param: torch.Tensor, owner: nn.Module | None):
    """(view shape, channel axis) under which the port parameter ``name``
    is quantized as JAX quantizes its Flax leaf; None where JAX leaves the
    leaf in float (fewer than two dimensions in the Flax layout)."""
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(owner, MultiHeadDense) and owner.split == "heads":
        d = owner.out_features // owner.heads
        if leaf == "weight":
            return (owner.heads, d, owner.in_features), 1
        return (owner.heads, d), 1  # the Flax bias is (H, D)
    if param.dim() < 2:
        return None
    if leaf == "weight" and isinstance(owner, nn.ConvTranspose2d):
        return tuple(param.shape), 1
    if leaf == "weight" and isinstance(owner, (nn.Conv1d, nn.Conv2d, nn.Linear)):
        return tuple(param.shape), 0
    return tuple(param.shape), param.dim() - 1


def quantize_tree(model: nn.Module) -> dict:
    """Parameter name → ``{'q', 'scale', 'view', 'axis'}`` (int8 in the
    port's layout, float32 scales) for the quantized parameters, or the
    float tensor for the rest."""
    owners = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        how = channel_view(name, p, owners.get(name.rpartition(".")[0]))
        if how is None or not p.is_floating_point():
            out[name] = p.detach().clone()
            continue
        view, axis = how
        q, scale = quantize_kernel(p.detach().reshape(view), axis)
        out[name] = {"q": q.reshape(p.shape), "scale": scale, "view": view, "axis": axis}
    return out


def dequantize_tree(qtree: Mapping) -> dict:
    """Parameter name → float32 tensor."""
    out = {}
    for name, v in qtree.items():
        if isinstance(v, Mapping):
            q = v["q"]
            out[name] = dequantize_kernel(q.reshape(v["view"]), v["scale"],
                                          v["axis"]).reshape(q.shape)
        else:
            out[name] = v
    return out


@torch.no_grad()
def ptq_roundtrip(model: nn.Module) -> nn.Module:
    """float32 → int8 → float32 for every quantized parameter, in place
    (the PTQ accuracy-drift experiment)."""
    params = dict(model.named_parameters())
    for name, w in dequantize_tree(quantize_tree(model)).items():
        params[name].copy_(w)
    return model


# ------------------------------------------------------------ activations --
class FakeQuant(torch.autograd.Function):
    """Symmetric int8 quantize-dequantize: round(x / scale) clipped to
    ±127, times scale.  Backward: straight through where |x| <= 127·scale,
    zero outside."""

    @staticmethod
    def forward(ctx, x, scale: float):
        s = torch.full((), scale, dtype=x.dtype, device=x.device)
        ctx.save_for_backward(x, s)
        return (torch.clamp(torch.round(x / s), -127.0, 127.0) * s).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * (x.abs() <= 127.0 * s).to(g.dtype), None


def fake_quant(x: torch.Tensor, scale: float) -> torch.Tensor:
    return FakeQuant.apply(x, scale)


def site_key(module_name: str) -> str:
    return module_name.replace(".", "/")


def _float_tensors(out):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, Mapping):
        for v in out.values():
            yield from _float_tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _float_tensors(v)


def _map_floats(out, fn):
    if isinstance(out, torch.Tensor):
        return fn(out) if out.is_floating_point() else out
    if isinstance(out, Mapping):
        return type(out)({k: _map_floats(v, fn) for k, v in out.items()})
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(_map_floats(v, fn) for v in out))
    if isinstance(out, (list, tuple)):
        return type(out)(_map_floats(v, fn) for v in out)
    return out


@torch.no_grad()
def calibrate_activations(model: nn.Module, batches: Iterable, **call_kw) -> dict:
    """Runs ``model(b, **call_kw)`` for each batch ``b`` and returns
    ``{site: max(absmax / 127, 1e-12)}`` over every module's float outputs."""
    amax: dict[str, float] = {}

    def hook_for(key):
        def hook(module, inputs, out):
            for v in _float_tensors(out):
                if v.numel():
                    amax[key] = max(amax.get(key, 0.0), float(v.detach().abs().max()))
        return hook

    handles = [m.register_forward_hook(hook_for(site_key(n))) for n, m in model.named_modules()]
    try:
        for b in batches:
            model(b, **call_kw)
    finally:
        for h in handles:
            h.remove()
    return {k: max(v / 127.0, 1e-12) for k, v in amax.items()}


def quantized_apply(model: nn.Module, *args, act_scales: Mapping[str, float], **call_kw):
    """``model(*args, **call_kw)`` with the float outputs of every module
    in ``act_scales`` passed through ``fake_quant`` at its scale."""
    handles = []
    for name, m in model.named_modules():
        scale = act_scales.get(site_key(name))
        if scale is None:
            continue
        handles.append(m.register_forward_hook(
            lambda mod, inp, out, s=scale: _map_floats(out, lambda v: fake_quant(v, s))))
    try:
        return model(*args, **call_kw)
    finally:
        for h in handles:
            h.remove()
