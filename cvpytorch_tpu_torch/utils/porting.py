"""Weights carried from the JAX package into the port.

``load_jax_variables(model, variables)`` copies a Flax ``{'params',
'batch_stats'}`` tree (nested mappings of arrays) into a port module whose
submodules carry the Flax names, so the key map is a join of the path:

  params/…/conv/kernel (HWIO)     → ….conv.weight (OIHW, transpose(3,2,0,1))
  params/…/fc/kernel (in, out)    → ….fc.weight (out, in), transposed
  params/…/linear/kernel (in, out) → ….linear.weight (out, in, 1, 1) where
                                    the port's module is a 1×1 conv
  params/…/deconv/kernel (HWIO)   → ….deconv.weight (in, out, kh, kw),
                                    flipped: K[::-1, ::-1].transpose(2,3,0,1)
  params/…/<layer>/bias           → ….bias
  params/…/bn/scale | bn/bias     → ….bn.weight | ….bn.bias
  batch_stats/…/bn/mean | bn/var  → ….bn.running_mean | ….bn.running_var
  params/…/query|key|value/kernel (C, H, D) → (C, H·D) → ….weight (H·D, C),
      …/bias (H, D) → (H·D,)      where the port's module is a
  params/…/out/kernel (H, D, C) → (H·D, C) → ….weight (C, H·D),
      …/bias (C,) as is            ``MultiHeadDense`` (Flax's attention
                                    ``DenseGeneral``s; its ``split`` says
                                    which, the exact 3-D shape is checked)
  params/…/<name> (any other leaf) → ….<name>, where the port holds an
                                    ``nn.Parameter`` of that name (MSCAN's
                                    layer scales ``ls1``/``ls2``, TAN's
                                    ``pos_embed``, BiFPN's fusion weights
                                    ``p6_w1`` …), as is; a 0-d ``scale``
                                    (GFLv2's ``ScaleLayer``) → the 0-d
                                    ``weight``

The kernel rule follows the type of the port module that owns the tensor
(``MultiHeadDense``, ``nn.Linear``, a 1×1 ``nn.Conv2d`` given a Dense
kernel, ``nn.ConvTranspose2d``, otherwise a convolution), because
they cannot be told apart by shape: a square Dense kernel and a
ConvTranspose kernel with as many inputs as outputs pass the shape check
under the wrong rule.  Flax's ``ConvTranspose`` (``transpose_kernel=False``)
does not flip its kernel; ``nn.ConvTranspose2d`` is the gradient of a
convolution and does, hence the spatial flip.

The JAX YOLOv5 stem is a 3×3 conv over a 2×2 space-to-depth input, kernel
(3, 3, 4C, O); where the port's conv is 6×6 over C channels, that kernel is
mapped back with ``s2d_to_stem6_kernel``.  Strict: any tree key without a
port tensor, any port tensor without a tree key, or any shape mismatch
raises ``KeyError``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..models.bricks import MultiHeadDense

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def s2d_to_stem6_kernel(k3: np.ndarray) -> np.ndarray:
    """(3, 3, 4C, O) kernel over a space-to-depth input (channel =
    (2·dy + dx)·C + c) → the equivalent (6, 6, C, O) stride-2 kernel:
    k6[2a + dy, 2b + dx, c, o] = k3[a, b, (2dy + dx)·C + c, o]."""
    kh, kw, c4, O = k3.shape
    if (kh, kw) != (3, 3) or c4 % 4:
        raise ValueError(f"not a space-to-depth stem kernel: {k3.shape}")
    C = c4 // 4
    out = np.zeros((6, 6, C, O), k3.dtype)
    for a in range(3):
        for b in range(3):
            for dy in range(2):
                for dx in range(2):
                    out[2 * a + dy, 2 * b + dx] = \
                        k3[a, b, (2 * dy + dx) * C:(2 * dy + dx + 1) * C]
    return out


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(name: str, arr: np.ndarray, target: torch.Tensor,
             owner: nn.Module | None = None) -> np.ndarray:
    """The tree's leaf ``arr`` in the layout of the port tensor ``target``;
    ``owner`` is the port module holding it (None: a convolution or BN)."""
    if isinstance(owner, MultiHeadDense):
        leaf = "kernel" if target.ndim == 2 else "bias"
        if tuple(arr.shape) != owner.flax_shape(leaf):
            raise KeyError(f"shape mismatch at {name}: tree {arr.shape} vs the "
                           f"{owner.split} DenseGeneral {leaf} {owner.flax_shape(leaf)}")
        if leaf == "kernel":
            arr = (arr.reshape(arr.shape[0], -1) if owner.split == "heads"
                   else arr.reshape(-1, arr.shape[-1])).T
        else:
            arr = arr.reshape(-1)
    elif isinstance(owner, nn.Linear) and arr.ndim == 2:  # (in, out) → (out, in)
        arr = arr.T
    elif (isinstance(owner, nn.Conv2d) and owner.kernel_size == (1, 1)
          and owner.groups == 1 and arr.ndim == 2):  # Dense (in, out) → (out, in, 1, 1)
        arr = arr.T[:, :, None, None]
    elif isinstance(owner, nn.ConvTranspose2d) and arr.ndim == 4:
        arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)  # HWIO → (I, O, kh, kw)
    elif arr.ndim == 4 and name.endswith(".weight"):  # conv kernel HWIO → OIHW
        if tuple(target.shape[2:]) == (6, 6) and arr.shape[:2] == (3, 3):
            arr = s2d_to_stem6_kernel(arr)
        arr = arr.transpose(3, 2, 0, 1)
    if tuple(arr.shape) != tuple(target.shape):
        raise KeyError(f"shape mismatch at {name}: tree {arr.shape} "
                       f"vs port {tuple(target.shape)}")
    return arr


def port_name(coll: str, path: tuple, parameters) -> str | None:
    """The port's name of the tree leaf ``coll``/``path``: by the leaf
    tables, else (``params`` only) the path itself where ``parameters``
    (the port's parameter names) holds it; None where neither applies."""
    leaf = (_PARAM_LEAVES if coll == "params" else _STAT_LEAVES).get(path[-1])
    if leaf:
        return ".".join(path[:-1] + (leaf,))
    name = ".".join(path)
    return name if coll == "params" and name in parameters else None


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a Flax ``{'params', 'batch_stats'}`` tree into ``model`` in place."""
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    parameters = dict(model.named_parameters())
    owners = dict(model.named_modules())
    unmatched, seen = [], set()
    for coll in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(coll, {})):
            name = port_name(coll, path, parameters)
            if name not in state:
                unmatched.append("/".join((coll,) + path))
                continue
            target = state[name]
            arr = _convert(name, arr, target, owners.get(".".join(path[:-1])))
            with torch.no_grad():
                # a 0-d leaf (a scalar param) stays 0-d: ascontiguousarray makes it 1-d
                target.copy_(torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape))
            seen.add(name)
    missing = sorted(set(state) - seen)
    if unmatched or missing:
        raise KeyError(f"JAX tree keys without a port tensor: {unmatched[:10]}; "
                       f"port tensors without a tree key: {missing[:10]}")
    return model
