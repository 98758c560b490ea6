"""Spawned gloo ranks for the port's data-parallel tests (imports the port
and torch, never JAX).

``RankPool(world)`` spawns ``world`` processes with ``torch.multiprocessing``
(spawn), each joining a gloo group through the port's
``initialize_distributed`` from torchrun's variables (a free port found by
binding to port 0) with a collective timeout; ``pool.run(job, *args,
timeout=…)`` runs the named job of this module on every rank and returns
the ranks' results in rank order.  A job that raises on a rank fails the
call with that rank's traceback; a call that outlasts its timeout, or a
rank that dies, kills every rank and fails, so a rank left in a
collective cannot hold the suite.  The ranks run torch on one intra-op
thread, and each job asserts that no JAX module was imported.
"""
from __future__ import annotations

import os
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank: int, world: int, port: int, jobs, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from cvpytorch_tpu_torch.parallel import dist as dp

    dp.initialize_distributed("gloo", timeout_s=COLLECTIVE_TIMEOUT_S)
    while True:
        job = jobs.get()
        if job is None:
            break
        name, args = job
        try:
            out = globals()[name](*args)
            bad = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax"})
            assert not bad, f"a rank imported {bad}"
            results.put((rank, True, out))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    dp.destroy()


class RankPool:
    """Ranks spawned at the first ``run`` and again after a failed one."""

    def __init__(self, world: int = 2):
        self.world = world
        self._procs = []

    def _start(self) -> None:
        world = self.world
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        port = free_port()
        self._procs = [ctx.Process(target=_serve, args=(r, world, port, self._jobs[r],
                                                        self._results), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, job: str, *args, timeout: float = 60.0) -> list:
        if not self._procs:
            self._start()
        for q in self._jobs:
            q.put((job, args))
        out, deadline = {}, time.monotonic() + timeout
        while len(out) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.pid for p in self._procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close(kill=True)
                    raise AssertionError(f"{job}: ranks {dead} died" if dead
                                         else f"{job}: no result within {timeout} s")
                continue
            if not ok:
                self.close(kill=True)
                raise AssertionError(f"{job} failed on rank {rank}:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        if not kill:
            for q in self._jobs:
                q.put(None)
            for p in self._procs:
                p.join(timeout=10)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []


# -- jobs (run on every rank) ------------------------------------------------

def _rows(n: int):
    from cvpytorch_tpu_torch.parallel import dist as dp

    return dp.process_batch_slice(n)


def job_process_helpers(global_batch: int, obj):
    from cvpytorch_tpu_torch.parallel import dist as dp

    sl = dp.process_batch_slice(global_batch)
    try:
        dp.process_batch_slice(global_batch + 1)
        odd = None
    except ValueError as e:
        odd = str(e)
    return {"slice": (sl.start, sl.stop), "odd": odd, "main": dp.is_main_process(),
            "local_devices": dp.local_device_count(),
            "gathered": dp.allgather_pickled({"rank": dp.rank(), **obj})}


def job_bn(x, weight, bias, mean, var, momentum, grad_out, steps: int = 2):
    """The bricks' BN in train mode on this rank's rows, ``steps`` times."""
    from cvpytorch_tpu_torch.models.bricks import BatchNorm2d
    from cvpytorch_tpu_torch.parallel import dist as dp

    sl = _rows(len(x))
    bn = BatchNorm2d(x.shape[1], eps=1e-3, momentum=momentum).train()
    with torch.no_grad():
        for t, v in ((bn.weight, weight), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    xs = torch.from_numpy(x[sl]).requires_grad_(True)
    for _ in range(steps):
        y = bn(xs)
    (y * torch.from_numpy(grad_out[sl])).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    dp.all_reduce_sum_(grads)
    return {"y": y.detach().numpy(), "x_grad": xs.grad.numpy(),
            "w_grad": grads[0].numpy(), "b_grad": grads[1].numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy(),
            "tracked": int(bn.num_batches_tracked)}


def job_bn_refuses_bf16_stats():
    from cvpytorch_tpu_torch.models.bricks import BatchNorm2d

    bn = BatchNorm2d(4).train()
    bn.bf16_stats = True
    try:
        bn(torch.ones(2, 4, 3, 3))
    except NotImplementedError as e:
        return str(e)
    return None


def job_yolov5_loss(raws, targets, num_classes: int, anchors):
    """This rank's share of the loss of a global batch, its grads w.r.t.
    this rank's raw maps, and the loss of the rows with per-rank
    normalisers."""
    from cvpytorch_tpu_torch.models.losses.yolov5_loss import YOLOv5Loss
    from cvpytorch_tpu_torch.parallel import dist as dp

    sl = _rows(len(targets["boxes"]))
    loss = YOLOv5Loss(num_classes=num_classes, anchors=anchors)
    raw = [torch.from_numpy(r[sl]).requires_grad_(True) for r in raws]
    tgt = {k: torch.from_numpy(v[sl]) for k, v in targets.items()}
    total, parts = loss(raw, tgt)
    total.backward()
    with dp.local_reductions():
        local, _ = loss([r.detach() for r in raw], tgt)
    return {"total": float(total.detach()), **{k: float(v.detach()) for k, v in parts.items()},
            "grads": [r.grad.numpy() for r in raw], "local_total": float(local)}


def _yolov5(weights: dict, subtype: str = "yolov5_n", classes: int = 3):
    from cvpytorch_tpu_torch.models.yolov5 import YOLOv5

    model = YOLOv5(dictionary=tuple({f"class{i}": 1.0} for i in range(classes)),
                   model_cfg={"TYPE": subtype})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model


def state_arrays(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def job_yolov5_step(weights, ema_weights, recipe, start: int, ema_decay: float,
                    image, target):
    """One float32 train step with EMA on this rank's rows."""
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler
    from cvpytorch_tpu_torch.train_state import TrainState, make_train_step

    sl = _rows(len(image))
    model = _yolov5(weights)
    cfg = CommonConfiguration(recipe)
    state = TrainState(model=model,
                       optimizer=build_optimizer(cfg, model, build_lr_scheduler(cfg, 10)),
                       ema=_yolov5(ema_weights).eval(), step=start)
    state, metrics = make_train_step(amp=False, ema_decay=ema_decay)(
        state, {"image": torch.from_numpy(image[sl]),
                "target": {k: torch.from_numpy(v[sl]) for k, v in target.items()}})
    momentum = {name: state.optimizer.state[p]["momentum_buffer"].numpy().copy()
                for name, p in model.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "model": state_arrays(model), "ema": state_arrays(state.ema),
            "momentum": momentum, "step": state.step}


def job_unet_step(weights, image, labels, recipe, extra_loss):
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler
    from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step

    sl = _rows(len(image))
    model = unet(extra_loss)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    cfg = CommonConfiguration(recipe)
    state = create_train_state(model, build_optimizer(cfg, model, build_lr_scheduler(cfg, 4)))
    state, metrics = make_train_step()(state, {"image": torch.from_numpy(image[sl]),
                                               "target": torch.from_numpy(labels[sl])})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "model": state_arrays(model)}


def unet(extra_loss=None):
    from cvpytorch_tpu_torch.models.unet import UNet

    dictionary = tuple({f"c{i}": 1.0 + 0.5 * i} for i in range(4))
    loss = {"EXTRA": extra_loss} if extra_loss else {}
    return UNet(dictionary=dictionary, model_cfg={"LOSS": loss}, base_channels=4, depth=2)


def job_evaluator_merge(name: str, kwargs: dict, batches: list):
    """``batches`` of the single-process val order as (targets, preds,
    positions) triples: this rank scores its rows of each, then the
    states are gathered, merged and evaluated."""
    from cvpytorch_tpu_torch import evaluator  # noqa: F401  (registers)
    from cvpytorch_tpu_torch.parallel import dist as dp
    from cvpytorch_tpu_torch.registry import EVALUATORS

    ev = EVALUATORS.get(name)(**kwargs)
    for targets, preds, positions in batches:
        mine = np.array_split(np.arange(len(positions)), dp.world_size())[dp.rank()]

        def take(tree):
            if isinstance(tree, dict):
                return {k: take(v) for k, v in tree.items()}
            return np.asarray(tree)[mine]
        ev.update(take(targets), take(preds), indices=np.asarray(positions)[mine])
    ev.merge_state_dicts(dp.allgather_pickled(ev.state_dict()))
    return ev.evaluate()


def fixed_groups(ds, idx):
    """``SyntheticDetection.__getitem__`` with the ``LOAD_NUM`` group's
    other items the next indices, in place of ``random.randrange`` draws
    (each rank's own host ``random``, and racing loader threads)."""
    group = [ds._load_one((idx + k) % ds.length) for k in range(ds.load_num)]
    return ds.transform(group) if ds.transform else group


def job_trainer_run(setting: str, float64: bool = False):
    """``Trainer.run()`` on the CPU with ``fixed_groups``: every step's
    logged metrics, every val epoch's metrics and the files this rank
    wrote.  ``float64`` trains the model in float64 (the step's images
    cast up; the data pipeline stays as it is)."""
    from cvpytorch_tpu_torch import train_state
    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.data.datasets.synthetic import SyntheticDetection

    logged, vals = [], []
    real = trainer_mod.make_train_step
    real_prepare = train_state.prepare_images
    if float64:
        train_state.prepare_images = lambda images: real_prepare(images).double()

    def recording(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(state, batch):
            state, m = step(state, batch)
            logged.append({k: float(v) for k, v in m.items()})
            return state, m
        return recorded

    trainer_mod.make_train_step = recording
    real_getitem = SyntheticDetection.__getitem__
    SyntheticDetection.__getitem__ = lambda ds, idx: (
        fixed_groups(ds, idx) if ds.load_num > 1 else real_getitem(ds, idx))
    try:
        trainer = trainer_mod.Trainer(CommonConfiguration.from_file(setting), device="cpu")
        if float64:
            trainer.model.double()
        initial = state_arrays(trainer.model)
        val_epoch = trainer.val_epoch

        def recorded_val(*args):
            out = val_epoch(*args)
            vals.append(out[1])
            return out
        trainer.val_epoch = recorded_val
        state = trainer.run()
    finally:
        trainer_mod.make_train_step = real
        train_state.prepare_images = real_prepare
        SyntheticDetection.__getitem__ = real_getitem
    full = full_arrays(state)
    return {"logged": logged, "val": vals, "initial": initial, "model": full["model"],
            "ema": full.get("ema"), "held": held(state.model),
            "save_dir": trainer.checkpoints.save_dir if trainer.checkpoints else None,
            "iters": trainer.iters_per_epoch, "world": trainer.world}


def job_trainer_resume(setting: str):
    """The train state a ``Trainer`` builds to resume ``setting``'s
    ``PRETRAIN_MODEL``, gathered, and what this rank holds of it."""
    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration

    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(setting), device="cpu")
    state = trainer._build_train_state()
    return {**full_arrays(state), "step": state.step, "start_epoch": trainer.start_epoch,
            "held": held(state.model)}


def job_trainer_refusal(setting: str):
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.trainer import Trainer

    try:
        Trainer(CommonConfiguration.from_file(setting), device="cpu")
    except NotImplementedError as e:
        return str(e)
    return None


def job_seg_loss_share(name: str, logits, labels, kwargs: dict):
    """This rank's share of a seg loss of the global batch and its gradient
    with respect to this rank's logits."""
    from cvpytorch_tpu_torch.models.losses.seg_loss import SEG_LOSSES

    sl = _rows(len(logits))
    x = torch.from_numpy(logits[sl]).requires_grad_(True)
    loss = SEG_LOSSES[name](x, torch.from_numpy(labels[sl]), **kwargs)
    loss.backward()
    return {"loss": float(loss.detach()), "grad": x.grad.numpy()}


def job_seg_loss_refusal(name: str):
    from cvpytorch_tpu_torch.models.losses.seg_loss import SEG_LOSSES

    logits = torch.randn(2, 3, 4, 4)
    labels = torch.randint(0, 3, (2, 4, 4))
    try:
        SEG_LOSSES[name](logits, labels)
    except NotImplementedError as e:
        return str(e)
    return None


# -- tensor parallelism ------------------------------------------------------------

def held(model) -> dict:
    """What this rank holds of each parameter, and its blocks' values."""
    from cvpytorch_tpu_torch.parallel.tensor import shards

    blocks = shards(model)
    return {"shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "blocks": {n: (model.get_parameter(n).detach().numpy().copy(), s.dim, s.outer,
                           s.parts, s.index) for n, s in blocks.items()}}


def full_arrays(state) -> dict:
    """The gathered one-process state: model and EMA state dicts, and the
    optimizer's per-leaf state by its index in the optimizer's state dict."""
    from cvpytorch_tpu_torch.parallel.mesh import full_train_state

    full = full_train_state(state)
    arrays = lambda sd: {k: v.detach().numpy().copy() for k, v in sd.items()}
    out = {"model": arrays(full["model"]),
           "optimizer": {i: {k: v.numpy().copy() for k, v in st.items() if torch.is_tensor(v)}
                         for i, st in full["optimizer"]["state"].items()}}
    if "ema" in full:
        out["ema"] = arrays(full["ema"])
    return out


def tp_model(kind: str, weights: dict):
    """The tests' tensor-parallel models: YOLOv5-n of 4 classes (JAX's TP
    test's), or MobileNetV2 (width 1, dropout 0.2) classifying 8."""
    if kind == "yolov5_n":
        return _yolov5(weights, "yolov5_n", classes=4)
    from cvpytorch_tpu_torch.models.classification import Classification

    model = Classification(dictionary=tuple({f"c{i}": 1.0} for i in range(8)),
                           model_cfg={"BACKBONE": {"name": "MobileNetV2"}})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return model


def job_tp_steps(kind: str, weights, recipe, image, target, model_ranks: int, steps: int,
                 float64: bool = False, channels_last: bool = False):
    """``steps`` train steps without EMA on a (data, ``model_ranks``) mesh
    of the live ranks (one process: a mesh of one), each rank on its data
    index's rows, the model in ``channels_last`` where asked (as the
    trainer lays it out); every step's loss, the gathered state and what
    this rank holds.  Dropout draws from ``torch.manual_seed(0)``."""
    from cvpytorch_tpu_torch import train_state
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler
    from cvpytorch_tpu_torch.parallel import dist as dp
    from cvpytorch_tpu_torch.parallel.mesh import create_mesh, shard_train_state

    mesh = create_mesh(model=model_ranks)
    sl = dp.process_batch_slice(len(image), mesh.index("data"), mesh.data)
    model = tp_model(kind, weights)
    if float64:
        model.double()
    if channels_last:
        model.to(memory_format=torch.channels_last)
    cfg = CommonConfiguration(recipe)
    state = shard_train_state(train_state.TrainState(
        model=model, optimizer=build_optimizer(cfg, model, build_lr_scheduler(cfg, 10))), mesh)
    cut = lambda v: torch.from_numpy(v[sl]) if isinstance(v, np.ndarray) else v
    batch = {"image": cut(image),
             "target": ({k: cut(v) for k, v in target.items()} if isinstance(target, dict)
                        else cut(target))}
    real_prepare = train_state.prepare_images
    if float64:
        train_state.prepare_images = lambda images: real_prepare(images).double()
    torch.manual_seed(0)
    try:
        step = train_state.make_train_step()
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(steps)]
    finally:
        train_state.prepare_images = real_prepare
    return {"losses": losses, **full_arrays(state), "held": held(model),
            "mesh": mesh.shape}


def job_mesh_refusal(model: int, spatial: int = 1):
    from cvpytorch_tpu_torch.parallel.mesh import create_mesh

    try:
        create_mesh(model=model, spatial=spatial)
    except ValueError as e:
        return str(e)
    return None


def spatial_model(kind: str, params: dict):
    """The JAX spatial tests' models in torch on NHWC input, from their
    Flax parameters: ``fcn`` (three 3×3 convolutions, ReLU between) and
    ``down_up`` (a stride-2 3×3 convolution, ReLU, a 4×4 stride-2
    transposed convolution as Flax's 'SAME' pads it, a 3×3 head)."""
    import torch.nn.functional as F

    w = {k: (torch.from_numpy(np.ascontiguousarray(np.asarray(v["kernel"]))),
             torch.from_numpy(np.asarray(v["bias"]))) for k, v in params.items()}

    def conv(x, name, stride=1):
        k, b = w[name]
        return F.conv2d(x, k.permute(3, 2, 0, 1), b, stride=stride, padding=1)

    def fn(x):
        x = x.permute(0, 3, 1, 2)
        if kind == "fcn":
            x = conv(torch.relu(conv(torch.relu(conv(x, "c0")), "c1")), "c2")
        else:
            x = torch.relu(conv(x, "down", stride=2))
            k, b = w["up"]  # Flax's kernel unflipped is torch's flipped
            x = F.conv_transpose2d(x, k.flip(0, 1).permute(2, 3, 0, 1), b, stride=2,
                                   padding=1)
            x = conv(x, "head")
        return x.permute(0, 2, 3, 1)
    return fn


def job_spatial(kind: str, params: dict, images, overlap: int):
    """``spatial_apply`` of ``spatial_model`` over the live ranks on the
    model axis."""
    from cvpytorch_tpu_torch.parallel.mesh import create_mesh
    from cvpytorch_tpu_torch.parallel.spatial import spatial_apply

    mesh = create_mesh(model=dist_world())
    with torch.no_grad():
        return spatial_apply(spatial_model(kind, params), torch.from_numpy(images), mesh,
                             axis="model", overlap=overlap).numpy()


def dist_world() -> int:
    from cvpytorch_tpu_torch.parallel import dist as dp

    return dp.world_size()


class TPLayers(torch.nn.Module):
    """The layer kinds YOLOv5 and MobileNetV2 do not reach: a one-group
    ``ConvTranspose2d`` (column-parallel), a transposed convolution with
    a forward of its own (its weight gathered by the pre-hook), a
    heads-split ``MultiHeadDense`` (column blocks of each head, its bias
    added whole) and a table read in the forward (gathered)."""

    class OwnForward(torch.nn.ConvTranspose2d):
        def forward(self, x):
            return torch.relu(super().forward(x))

    def __init__(self):
        super().__init__()
        from cvpytorch_tpu_torch.models.bricks import MultiHeadDense

        self.up = torch.nn.ConvTranspose2d(16, 64, 4, stride=2, padding=1)
        self.up2 = TPLayers.OwnForward(64, 64, 4, stride=2, padding=1)
        self.query = MultiHeadDense(64, 128, heads=4, split="heads")
        self.pos = torch.nn.Parameter(torch.randn(1, 64, 128))

    def forward(self, x):
        y = self.up2(torch.relu(self.up(x)))  # (B, 64, 4H, 4W)
        tokens = torch.nn.functional.adaptive_avg_pool2d(y, 8).flatten(2).transpose(1, 2)
        return self.query(tokens) + self.pos


def job_tp_layers(weights, x, model_ranks: int):
    """``TPLayers`` in float64 laid out on a model axis of ``model_ranks``:
    the output, every parameter's gradient gathered whole, each layer's
    class and what this rank holds."""
    from cvpytorch_tpu_torch.parallel import dist as dp
    from cvpytorch_tpu_torch.parallel.mesh import create_mesh, shard_train_state
    from cvpytorch_tpu_torch.parallel.tensor import all_gather_blocks, shards
    from cvpytorch_tpu_torch.train_state import TrainState

    mesh = create_mesh(model=model_ranks)
    model = TPLayers().double()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    shard_train_state(TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(),
                                                                        lr=0.0)), mesh)
    y = model(torch.from_numpy(x))
    (y * y).sum().backward()
    blocks = shards(model)
    grads = {n: (all_gather_blocks(p.grad, blocks[n].dim, blocks[n].outer, mesh.group("model"))
                 if n in blocks else p.grad).numpy() for n, p in model.named_parameters()}
    return {"y": y.detach().numpy(), "grads": grads, "held": held(model),
            "classes": {n: type(m).__name__ for n, m in model.named_children()},
            "world": dp.world_size()}
