"""Tensor parallelism on the mesh's ``model`` axis: the layers and the
collectives (the compute half of ``cvpytorch_tpu/parallel/mesh.tp_shardings``,
whose collectives GSPMD inserts; ``parallel.mesh`` decides the layout).

A sharded parameter holds one block of the dim that carries its Flax
trailing (output) dim (``Shard``: that dim read as ``outer`` blocks of the
trailing size, each cut into ``parts`` pieces; ``outer`` is 1 but for a
``DenseGeneral`` kernel that folds the heads into the dim), and
``Shard.take`` cuts it from a full tensor; ``Shard.group`` is the model
group, bound when the layout is made, over which every collective of the
leaf runs.  Two autograd functions over the model group carry the layers:

* ``copy_to_model`` — identity forward, all-reduce of the gradient
  backward: a replicated input read by every rank's slice of a layer;
* ``gather_from_model`` — all-gather of the blocks forward, this rank's
  block of the gradient backward: a sliced output made whole again.

A ``Conv2d``, ``Linear`` or ``ConvTranspose2d`` whose weight is sharded
computes column-parallel (``ColumnParallel*``): its own output channels
from the replicated input (a grouped or depthwise convolution from its own
groups' input channels), gathers the channels and adds the replicated
bias whole (so that every rank holds its whole gradient).  Any other sharded leaf (a table, a position
embedding, the weight of a convolution with a forward of its own) is
gathered by a forward pre-hook of its module before the forward and put
back after it (``gather_leaves``).  Every rank of a model group then holds
the same activations, computes the whole batch's loss and the same
gradients of the replicated leaves up to rounding.

``broadcast_from_model_root_`` copies tensors from a mesh's model group's
first rank in one bucketed broadcast (as bytes): the train batch (the host
transforms draw from each process's own ``random``) and, each step, the
replicated leaves' gradients and the BN running statistics, so that the
replicated leaves stay identical on every model rank.  ``sq_norm`` is the
global-norm clip's Σg² with the sharded leaves' share summed over the
model group.  Collectives run on gloo (the CPU, or several ranks on one
card, for all-reduce, broadcast and all-gather of CUDA tensors) or NCCL.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class Shard:
    """This rank's block of a parameter of ``full_shape``: of ``dim`` read
    as (``outer``, ``parts``, k), the k-slice ``index``, the other blocks
    on ``group``'s ranks."""
    dim: int
    outer: int
    parts: int
    index: int
    full_shape: tuple
    group: object = field(default=None, compare=False, repr=False)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        return own_block(full, self.dim, self.outer, self.parts, self.index)

    def shape(self) -> tuple:
        s = list(self.full_shape)
        s[self.dim] //= self.parts
        return tuple(s)


def own_block(full: torch.Tensor, dim: int, outer: int, parts: int,
              index: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` of each of ``dim``'s ``outer`` blocks (a
    view for ``outer`` = 1)."""
    size = full.shape[dim]
    k = size // (outer * parts)
    if outer == 1:
        return full.narrow(dim, index * k, k)
    x = full.movedim(dim, -1)
    lead = x.shape[:-1]
    x = x.reshape(*lead, outer, parts, k)[..., index, :]
    return x.reshape(*lead, outer * k).movedim(-1, dim)


def _densely(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous or channels_last, else a contiguous copy."""
    if t.is_contiguous() or (t.dim() == 4
                             and t.is_contiguous(memory_format=torch.channels_last)):
        return t
    return t.contiguous()


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A contiguous view of a tensor ``_densely`` returns as it is (the
    NHWC view of a channels_last one)."""
    return t if t.is_contiguous() else t.permute(0, 2, 3, 1)


def all_gather_blocks(local: torch.Tensor, dim: int, outer: int, group) -> torch.Tensor:
    """The inverse of ``own_block`` over ``group``: every rank's block in
    rank order, put back in place along ``dim``."""
    parts = dist.get_world_size(group)
    x = local.movedim(dim, -1).contiguous()
    lead, k = x.shape[:-1], x.shape[-1] // outer
    pieces = [torch.empty_like(x) for _ in range(parts)]
    dist.all_gather(pieces, x, group=group)
    full = torch.stack([p.reshape(*lead, outer, k) for p in pieces], -2)
    return full.reshape(*lead, outer * parts * k).movedim(-1, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = _densely(grad.clone())
        dist.all_reduce(_dense(grad), group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, outer, group):
        ctx.dim, ctx.outer = dim, outer
        ctx.parts, ctx.index = dist.get_world_size(group), dist.get_rank(group)
        return all_gather_blocks(x, dim, outer, group)

    @staticmethod
    def backward(ctx, grad):
        return own_block(grad, ctx.dim, ctx.outer, ctx.parts, ctx.index), None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, outer: int, group) -> torch.Tensor:
    return _GatherFromModel.apply(x, dim, outer, group)


# -- the layers -----------------------------------------------------------------

def _own_bias(module: nn.Module) -> torch.Tensor | None:
    """The bias the local operation adds: its block where the bias is
    sharded too."""
    return module.bias if "bias" in module._tp_shards else None


def _with_bias(module: nn.Module, y: torch.Tensor, dim: int) -> torch.Tensor:
    """The gathered output plus a replicated bias: added whole, so that
    every rank's bias gradient is the whole one."""
    if module.bias is None or "bias" in module._tp_shards:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + module.bias.view(shape)


class _ColumnConv2d:
    """A ``Conv2d`` holding its block of output channels: ``_tp_in`` is the
    block of input channels they read (None: all), ``_tp_groups`` the
    groups of the local convolution."""

    def forward(self, x):
        group = self._tp_shards["weight"].group
        x = copy_to_model(x, group)
        if self._tp_in is not None:
            x = x[:, self._tp_in[0]:self._tp_in[1]]
        padding = self.padding
        if self.padding_mode != "zeros":
            x = F.pad(x, self._reversed_padding_repeated_twice, mode=self.padding_mode)
            padding = 0
        y = F.conv2d(x, self.weight, _own_bias(self), self.stride, padding, self.dilation,
                     self._tp_groups)
        return _with_bias(self, gather_from_model(y, 1, 1, group), 1)


class _ColumnLinear:
    """A ``Linear`` (or ``MultiHeadDense``) holding its block of output
    features (of each head's, for a heads split)."""

    def forward(self, x):
        s = self._tp_shards["weight"]
        y = F.linear(copy_to_model(x, s.group), self.weight, _own_bias(self))
        y = gather_from_model(y, y.dim() - 1, s.outer, s.group)
        return _with_bias(self, y, y.dim() - 1)


class _ColumnConvTranspose2d:
    """A ``ConvTranspose2d`` of one group holding its block of output
    channels."""

    def forward(self, x, output_size=None):
        output_padding = self._output_padding(x, output_size, self.stride, self.padding,
                                              self.kernel_size, 2, self.dilation)
        group = self._tp_shards["weight"].group
        y = F.conv_transpose2d(copy_to_model(x, group), self.weight, _own_bias(self),
                               self.stride, self.padding, output_padding, 1, self.dilation)
        return _with_bias(self, gather_from_model(y, 1, 1, group), 1)


_COLUMN = {nn.Conv2d: _ColumnConv2d, nn.Linear: _ColumnLinear,
           nn.ConvTranspose2d: _ColumnConvTranspose2d}
_column_classes: dict = {}


def column_kind(cls: type) -> type | None:
    """The torch layer (``nn.Conv2d``, ``nn.Linear``, ``nn.ConvTranspose2d``)
    whose forward ``cls`` runs unchanged, else None."""
    for base in _COLUMN:
        if issubclass(cls, base) and cls.forward is base.forward:
            return base
    return None


def column_parallel_class(cls: type) -> type:
    """``cls`` with the column-parallel forward of its ``column_kind``."""
    if cls not in _column_classes:
        _column_classes[cls] = type(f"ColumnParallel{cls.__name__}",
                                    (_COLUMN[column_kind(cls)], cls), {})
    return _column_classes[cls]


def _gather_hook(module, args):
    held = module.__dict__.setdefault("_tp_held", {})
    for leaf, s in module._tp_gather.items():
        shard = module._parameters[leaf]
        held[leaf] = shard
        module._parameters[leaf] = gather_from_model(shard, s.dim, s.outer, s.group)


def _release_hook(module, args, output):
    for leaf, shard in module.__dict__.pop("_tp_held", {}).items():
        module._parameters[leaf] = shard


def shards(module: nn.Module) -> dict:
    """Parameter name → ``Shard`` of every sharded leaf of ``module``."""
    return {f"{path}.{leaf}" if path else leaf: s
            for path, m in module.named_modules()
            for leaf, s in m.__dict__.get("_tp_shards", {}).items()}


def gather_leaves(module: nn.Module, leaves: dict) -> None:
    """Holds ``leaves`` (name → ``Shard``) of ``module`` sharded and gives
    its forward the gathered tensors."""
    if not getattr(module, "_tp_gather", None):
        module._tp_gather = {}
        module.register_forward_pre_hook(_gather_hook)
        module.register_forward_hook(_release_hook, always_call=True)
    module._tp_gather.update(leaves)


# -- the step -----------------------------------------------------------------

@torch.no_grad()
def broadcast_from_model_root_(tensors: list[torch.Tensor], mesh) -> None:
    """Overwrites each tensor with the first rank's of ``mesh``'s model
    group (a ``parallel.mesh.Mesh``; None: one process), one broadcast of
    their bytes a device."""
    if mesh is None or mesh.model == 1 or not tensors:
        return
    group, root = mesh.group("model"), mesh.ranks("model")[0]  # a global rank
    by_device: dict = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t)
    for group_tensors in by_device.values():
        dense = [_densely(t) for t in group_tensors]
        # a channels_last tensor goes as its NHWC view, which may have its
        # own shape (C = H = W): the flag, not the shape, says to permute back
        nhwc = [not d.is_contiguous() for d in dense]
        views = [_dense(d) for d in dense]
        flat = torch.cat([v.reshape(-1).view(torch.uint8) for v in views])
        dist.broadcast(flat, root, group=group)
        offset = 0
        for t, v, permuted in zip(group_tensors, views, nhwc):
            n = v.numel() * v.element_size()
            # a copy starts at offset 0, where any dtype may view it
            v = flat[offset:offset + n].clone().view(v.dtype).view(v.shape)
            t.copy_(v.permute(0, 3, 1, 2) if permuted else v)
            offset += n


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "tp_shard", None) is not None


def sq_norm(grads: list[torch.Tensor], params: list[torch.Tensor]) -> torch.Tensor:
    """Σg² of the whole model: the replicated leaves' here, the sharded
    leaves' summed over their model group."""
    rep = [g for g, p in zip(grads, params) if not is_sharded(p)]
    own = [(g, p.tp_shard.group) for g, p in zip(grads, params) if is_sharded(p)]
    total = sum((g * g).sum() for g in rep)
    if own:
        part = sum((g * g).sum() for g, _ in own)
        dist.all_reduce(part, group=own[0][1])
        total = total + part
    return total
