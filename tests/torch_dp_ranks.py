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


def _yolov5(weights: dict, subtype: str = "yolov5_n"):
    from cvpytorch_tpu_torch.models.yolov5 import YOLOv5

    model = YOLOv5(dictionary=tuple({f"class{i}": 1.0} for i in range(3)),
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
    return {"logged": logged, "val": vals, "initial": initial, "model": state_arrays(state.model),
            "ema": state_arrays(state.ema) if state.ema is not None else None,
            "save_dir": trainer.checkpoints.save_dir if trainer.checkpoints else None,
            "iters": trainer.iters_per_epoch, "world": trainer.world}


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
