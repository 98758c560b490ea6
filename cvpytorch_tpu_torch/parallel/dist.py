"""Process groups for data parallelism (counterpart of the process half of
``cvpytorch_tpu/parallel/mesh.py``).

The JAX package trains data-parallel as one global batch on a mesh: the
batch is split on dim 0, the gradient is that of the global loss and BN
moments are taken over the global batch (GSPMD inserts the collectives).
The port runs one process per rank, launched by ``torchrun``
(``python -m torch.distributed.run``), and keeps those semantics with
explicit collectives:

* ``global_sum`` — a loss normaliser (a count of positives, of valid
  pixels) summed over the ranks, without gradient;
* ``all_reduce_with_grad`` — a sum over the ranks that carries autograd
  (its backward sums the ranks' gradients): BN's global moments;
* ``all_reduce_sum_`` — the ranks' partial-loss gradients summed in
  place, in buckets, before the optimizer runs;
* ``broadcast_module_`` — rank 0's parameters and buffers to every rank.

Each rank's loss is its share of the global loss (the normalisers are
global), so the ranks' losses sum to the global loss and their gradients
sum to its gradient.  Inside ``local_reductions()`` (the eval step) and
without a live group of more than one rank the helpers are identities.

``BATCH_SIZE`` is the global batch; ``process_batch_slice`` gives a
rank's rows of it.

The reductions above run over the **data group**: the ranks that hold
other rows of the global batch.  Without a mesh that is every rank (the
data-parallel layout); ``parallel.mesh.create_mesh`` sets the current
mesh (``set_mesh``), and a train step makes its state's mesh current
while it runs (``using_mesh``); the data group is then the mesh's ``data``
axis, so that the ranks of one model group, which hold the same rows,
count them once.
``broadcast_module_``, ``allgather_pickled``, ``barrier`` and the rank-0
writes stay on the world.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import threading

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
BUCKET_BYTES = 32 << 20  # gradient all-reduce bucket

_local = threading.local()
_mesh = None  # the current parallel.mesh.Mesh, None: the data group is the world


def group_live() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if group_live() else 1


def rank() -> int:
    return dist.get_rank() if group_live() else 0


def initialize_distributed(backend: str, timeout_s: float = DEFAULT_TIMEOUT_S,
                           device: torch.device | None = None) -> bool:
    """Joins the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) with
    ``backend`` ('nccl' on the card, 'gloo' on the CPU) and a timeout on
    the rendezvous and on every collective.  Without that environment it
    does nothing and returns False; an already live group is kept.  A
    CUDA ``device`` with an index becomes the process's current device
    first (NCCL and ``all_gather_object`` use it)."""
    if device is not None and torch.device(device).type == "cuda" \
            and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    if group_live():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def destroy() -> None:
    set_mesh(None)
    if group_live():
        dist.destroy_process_group()


def set_mesh(mesh) -> None:
    """Makes ``mesh`` (a ``parallel.mesh.Mesh``, or None) the current one:
    its ``data`` axis is the group the reductions run over."""
    global _mesh
    _mesh = mesh


@contextlib.contextmanager
def using_mesh(mesh):
    """``mesh`` current inside (None: the current one kept)."""
    before = _mesh
    if mesh is not None:
        set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(before)


def data_size() -> int:
    """Ranks holding other rows of the global batch."""
    return _mesh.data if _mesh is not None else world_size()


def data_group():
    """The process group of the data axis (None: the world)."""
    return _mesh.group("data") if _mesh is not None else None


def is_main_process() -> bool:
    """Rank-0 gating (logs, checkpoints, summaries)."""
    return rank() == 0


def local_device_count() -> int:
    """Devices this host drives: one a rank, so the ranks on this host."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def process_batch_slice(global_batch_size: int, rank_: int | None = None,
                        world: int | None = None) -> slice:
    """This rank's rows of a global batch; raises when the batch does not
    divide by the world size, as the JAX package does."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{world} ranks")
    per = global_batch_size // world
    return slice(rank_ * per, (rank_ + 1) * per)


def allgather_pickled(obj) -> list:
    """One picklable object from every rank, in rank order (``[obj]``
    without a live group)."""
    if not group_live():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def reductions_active() -> bool:
    """True with more than one rank on the data axis, outside
    ``local_reductions()``."""
    return not getattr(_local, "off", False) and data_size() > 1


@contextlib.contextmanager
def local_reductions():
    """Normalisers and BN moments of this rank alone (the eval step: the
    ranks run different numbers of val batches)."""
    before = getattr(_local, "off", False)
    _local.off = True
    try:
        yield
    finally:
        _local.off = before


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (detached) summed over the data group."""
    x = x.detach()
    if not reductions_active():
        return x
    x = x.clone()
    dist.all_reduce(x, group=data_group())
    return x


def global_batch(local: int) -> int:
    """The global batch of a rank's ``local`` rows (the data ranks hold
    equal shares of a global batch)."""
    return local * data_size() if reductions_active() else local


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _SumOverGroup.apply(grad, ctx.group), None


def all_reduce_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Sum over the data group whose backward sums the ranks' gradients:
    the gradient of the ranks' summed losses with respect to this rank's
    ``x``."""
    if not reductions_active():
        return x
    return _SumOverGroup.apply(x, data_group())


def _bucketed(tensors: list[torch.Tensor], collective) -> None:
    """Runs ``collective`` in place on flat buckets of up to
    ``BUCKET_BYTES`` of one dtype and device, and copies the results back."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        start = 0
        while start < len(group):
            size, end = 0, start
            while end < len(group) and (end == start
                                        or size + group[end].nbytes <= BUCKET_BYTES):
                size += group[end].nbytes
                end += 1
            part = group[start:end]
            flat = torch.cat([t.reshape(-1) for t in part])
            collective(flat)
            offset = 0
            for t in part:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            start = end


@torch.no_grad()
def all_reduce_sum_(tensors: list[torch.Tensor]) -> None:
    """Sums each tensor over the data group in place, a bucket an
    all-reduce."""
    if data_size() > 1 and tensors:
        group = data_group()
        _bucketed(tensors, lambda flat: dist.all_reduce(flat, group=group))


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank."""
    if group_live():
        _bucketed([t.data for t in list(module.parameters()) + list(module.buffers())],
                  lambda flat: dist.broadcast(flat, 0))


def barrier() -> None:
    if group_live():
        dist.barrier()
