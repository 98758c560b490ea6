"""The ``(data, model, spatial)`` mesh over the ``torchrun`` ranks and the
tensor-parallel layout of the train state (counterpart of
``cvpytorch_tpu/parallel/mesh.py``).

``create_mesh(data=None, model=1, spatial=1)`` lays the live group's W
ranks out as JAX lays its devices, ``reshape(data, model, spatial)``: rank
= (d·M + m)·S + s.  ``data=None`` takes W / (M·S); a W that does not
divide raises.  The mesh keeps a ``dist.new_group`` for each axis longer
than 1 (the world where the axis is every rank) and for data × spatial,
and becomes the current mesh of ``parallel.dist``: its data group is what
BN's moments, the losses' normalisers and the gradient sum reduce over.

``tp_shardings(model, mesh, min_elems=4096)`` is JAX's rule, decided on
the Flax layout of each parameter as the weight carry lays it out
(``utils.porting.flax_layout``): a leaf of ndim ≥ 2 whose trailing
(output) dim divides by the model axis and which holds ≥ 4096 elements is
width-sharded over ``model``; every other leaf is replicated.  The Flax
trailing dim is torch's dim 0 for ``Conv2d`` and ``Linear`` weights, dim 1
for ``ConvTranspose2d`` and the last dim for leaves the carry does not
transpose.  ``shard_train_state(state, mesh)`` lays the model, its EMA
and the optimizer's moments out alike: each rank keeps only its block of
every leaf the rule shards (``parallel.tensor``: column-parallel
``Conv2d``/``Linear``/``ConvTranspose2d``, gathered tables), and the
optimizer steps the blocks.  A leaf the rule shards in a module that can
hold it neither way raises there, naming the module.  ``full_train_state``
is the inverse: the one-process state dicts, gathered over the model group
each block is bound to (every rank of the group calls it).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from ..utils.porting import flax_layout
from . import dist as dp
from .tensor import (Shard, all_gather_blocks, column_kind, column_parallel_class, gather_leaves,
                     shards)

AXES = ("data", "model", "spatial")


class Mesh:
    """``data`` × ``model`` × ``spatial`` ranks, this rank's coordinates and
    the process groups of its axes (None for an axis of one rank)."""

    def __init__(self, data: int = 1, model: int = 1, spatial: int = 1, rank: int = 0,
                 groups: dict | None = None):
        self.data, self.model, self.spatial = data, model, spatial
        self.rank = rank
        self._groups = groups or {}

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model, "spatial": self.spatial}

    def size(self, axis: str) -> int:
        if axis == "data_spatial":
            return self.data * self.spatial
        return self.shape[axis]

    def index(self, axis: str) -> int:
        d, rest = divmod(self.rank, self.model * self.spatial)
        m, s = divmod(rest, self.spatial)
        return {"data": d, "model": m, "spatial": s}[axis]

    def ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group on ``axis``, in axis order."""
        M, S = self.model, self.spatial
        d, m, s = (self.index(a) for a in AXES)
        if axis == "data":
            return [(j * M + m) * S + s for j in range(self.data)]
        if axis == "model":
            return [(d * M + j) * S + s for j in range(M)]
        if axis == "spatial":
            return [(d * M + m) * S + j for j in range(S)]
        return [(j * M + m) * S + k for j in range(self.data) for k in range(S)]

    def group(self, axis: str):
        return self._groups.get(axis)


def create_mesh(data: int | None = None, model: int = 1, spatial: int = 1) -> Mesh:
    """The mesh over the live group (one rank without one), made current."""
    W, rank = dp.world_size(), dp.rank()
    if data is None:
        if W % (model * spatial):
            raise ValueError(f"{W} ranks not divisible by model={model}*spatial={spatial}")
        data = W // (model * spatial)
    if data * model * spatial != W:
        raise ValueError(f"mesh {data}x{model}x{spatial} != {W} ranks")
    mesh = Mesh(data, model, spatial, rank)
    for axis in AXES + ("data_spatial",):
        size = mesh.size(axis)
        if size == 1:
            continue
        if size == W:
            mesh._groups[axis] = dist.group.WORLD
            continue
        seen = []  # every rank makes every group, in one order
        for q in range(W):
            members = Mesh(data, model, spatial, q).ranks(axis)
            if members not in seen:
                seen.append(members)
                group = dist.new_group(members)
                if rank in members:
                    mesh._groups[axis] = group
    dp.set_mesh(mesh)
    return mesh


# -- the tensor-parallel layout ---------------------------------------------------

def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return model.get_submodule(path), leaf


def tp_shardings(model: nn.Module, mesh: Mesh, min_elems: int = 4096) -> dict:
    """Parameter name → None (replicated) or ``(dim, outer)``: where the
    rule shards the leaf, the port dim holding its Flax trailing dim
    (``utils.porting.flax_layout``; ``(None, None)`` where no one dim
    does)."""
    n = mesh.model
    out = {}
    for name, p in model.named_parameters():
        owner, _ = _owner(model, name)
        fshape, where = flax_layout(name, p, owner)
        hit = (n > 1 and len(fshape) >= 2 and fshape[-1] % n == 0
               and math.prod(fshape) >= min_elems)
        out[name] = (where or (None, None)) if hit else None
    return out


def _conv_input_block(conv: nn.Conv2d, s: Shard) -> tuple[tuple | None, int]:
    """The input channels and groups of a Conv2d's block of outputs."""
    g, O, I = conv.groups, conv.out_channels, conv.in_channels
    k = O // s.parts
    if g == 1:
        return None, 1
    if k % (O // g) == 0:  # whole groups: g / parts of them
        per = I // s.parts
        return (s.index * per, (s.index + 1) * per), g // s.parts
    if (O // g) % k == 0:  # inside one group
        j = s.index * k // (O // g)
        return (j * (I // g), (j + 1) * (I // g)), 1
    raise NotImplementedError(
        f"a Conv2d of {O} outputs in {g} groups cannot be cut into {s.parts} column blocks "
        f"that align with its groups")


def _layout(model: nn.Module, plan: dict, mesh: Mesh) -> dict:
    """name → (owner, leaf, Shard, kind): 'column' or 'gather'; raises
    where a leaf the rule shards cannot be held so."""
    shared = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        shared.setdefault(id(p), []).append(name)
    index = mesh.index("model")
    out = {}
    for name, where in plan.items():
        p = model.get_parameter(name)
        owner, leaf = _owner(model, name)
        what = f"{name} ({type(owner).__name__})"
        if where[0] is None:
            raise NotImplementedError(
                f"{what}: the rule shards its Flax trailing dim, which does not lie on one "
                f"dim of the port tensor; this module kind cannot hold it sharded")
        if len(shared[id(p)]) > 1:
            raise NotImplementedError(f"{what} is shared by {shared[id(p)]}: a tied leaf is "
                                      "not held sharded")
        dim, outer = where
        s = Shard(dim, outer, mesh.model, index, tuple(p.shape), mesh.group("model"))
        kind = column_kind(type(owner)) if leaf == "weight" else None
        if kind is nn.Conv2d and dim == 0:
            _conv_input_block(owner, s)  # raises where the groups do not align
        elif not ((kind is nn.Linear and dim == 0)
                  or (kind is nn.ConvTranspose2d and dim == 1 and owner.groups == 1)):
            kind = None
        out[name] = (owner, leaf, s, "column" if kind else "gather")
    return out


def _shard_module(model: nn.Module, layout: dict) -> dict:
    """Replaces each laid-out leaf of ``model`` by its block; name → new
    parameter."""
    new = {}
    gathered: dict = {}
    for name, (_, leaf, s, kind) in layout.items():
        owner = model.get_submodule(name.rpartition(".")[0])
        p = owner._parameters[leaf]
        block = nn.Parameter(s.take(p.detach()).clone(), requires_grad=p.requires_grad)
        block.tp_shard = s
        owner._parameters[leaf] = block
        owner.__dict__.setdefault("_tp_shards", {})[leaf] = s
        new[name] = block
        if kind == "column":
            if isinstance(owner, nn.Conv2d):
                owner._tp_in, owner._tp_groups = _conv_input_block(owner, s)
            owner.__class__ = column_parallel_class(type(owner))
        else:
            gathered.setdefault(id(owner), (owner, {}))[1][leaf] = s
    for owner, leaves in gathered.values():
        gather_leaves(owner, leaves)
    return new


def _shard_optimizer(opt, swap: dict) -> None:
    """Points ``opt`` at the blocks and cuts its per-leaf state alike;
    ``swap``: id(full parameter) → (block, Shard)."""
    for group in opt.param_groups:
        group["params"] = [swap[id(p)][0] if id(p) in swap else p for p in group["params"]]
    olds = [p for p in list(opt.state) if id(p) in swap]
    for p in olds:
        block, s = swap[id(p)]
        opt.state[block] = {k: s.take(v).clone() if torch.is_tensor(v) and v.shape == p.shape
                            else v for k, v in opt.state.pop(p).items()}
    if hasattr(opt, "frozen"):  # the optax chain's frozen leaves and accumulator
        params = [p for g in opt.param_groups for p in g["params"]]
        opt.frozen = [swap[id(p)][0] if id(p) in swap else p for p in opt.frozen]
        if opt._acc is not None:
            opt._acc = [_block_of(a, p) for a, p in zip(opt._acc, params + opt.frozen)]


def _block_of(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    s = getattr(p, "tp_shard", None)
    return s.take(a).clone() if s is not None and tuple(a.shape) == s.full_shape else a


def shard_train_state(state, mesh: Mesh, min_elems: int = 4096):
    """Lays ``state`` (a ``train_state.TrainState`` in full) out for the
    model axis in place and returns it: the model's and the EMA's leaves
    that ``tp_shardings`` shards become this rank's blocks, bound to
    ``mesh``'s model group, the optimizer's per-leaf state is cut alike,
    and ``state.mesh`` is ``mesh``, which its train step computes on.
    Raises, changing nothing, where a leaf cannot be held sharded."""
    if mesh.model == 1:
        state.mesh = mesh
        return state
    plan = {k: v for k, v in tp_shardings(state.model, mesh, min_elems).items() if v}
    layout = _layout(state.model, plan, mesh)
    old = {name: state.model.get_parameter(name) for name in layout}
    new = _shard_module(state.model, layout)
    if state.ema is not None:
        _shard_module(state.ema, _layout(state.ema, plan, mesh))
    _shard_optimizer(state.optimizer, {id(old[k]): (new[k], layout[k][2]) for k in layout})
    state.mesh = mesh
    return state


def _gather(t: torch.Tensor, s: Shard) -> torch.Tensor:
    return all_gather_blocks(t.detach(), s.dim, s.outer, s.group)


@torch.no_grad()
def full_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with every sharded leaf gathered whole."""
    sd = module.state_dict()
    for name, s in shards(module).items():
        sd[name] = _gather(sd[name], s)
    return sd


@torch.no_grad()
def full_optimizer_state(opt) -> dict:
    """``opt.state_dict()`` with the per-leaf state of the sharded leaves
    gathered whole (the moments, the chain's accumulator)."""
    sd = opt.state_dict()
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        s = getattr(p, "tp_shard", None)
        if s is not None and i in sd["state"]:
            sd["state"][i] = {k: _gather(v, s) if torch.is_tensor(v) and v.shape == p.shape
                              else v for k, v in sd["state"][i].items()}
    chain = sd.get("chain")
    if chain is not None and chain["acc"] is not None:
        chain["acc"] = [_gather(a, p.tp_shard) if getattr(p, "tp_shard", None) is not None
                        else a for a, p in zip(chain["acc"], params + opt.frozen)]
    return sd


def full_train_state(state) -> dict:
    """The one-process ``model``, ``optimizer`` and ``ema`` state dicts of
    ``state``, sharded or not."""
    out = {"model": full_state_dict(state.model),
           "optimizer": full_optimizer_state(state.optimizer)}
    if state.ema is not None:
        out["ema"] = full_state_dict(state.ema)
    return out
