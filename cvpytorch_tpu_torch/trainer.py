"""Trainer (counterpart of ``cvpytorch_tpu/trainer.py``): the epoch loop.

``python -m cvpytorch_tpu_torch.trainer --setting conf/X.yml|X.json
[--device cuda|cpu] [--backend nccl|gloo]`` — reads the config,
dictionary, datasets and model, builds the optimizer and schedule, and
runs ``Trainer.run()``: train epochs through a ``DevicePrefetcher``, a
val epoch every ``EVALUATOR.EVAL_INTERVALS`` epochs on the EMA weights,
early stopping on the evaluator's 'performance', and
``last``/``best``/``deploy`` checkpoints.

Runs on ``cuda`` unless ``--device cpu`` is given; without CUDA that
raises.  With ``DATASET.TRAIN.DEVICE_AUG`` the host only letterboxes the
LOAD_NUM=4 raw tiles of each sample; mosaic, affine, HSV, flip and
normalise run on the device inside the train step, from a generator
seeded by (SEED + 7919, step).  Classification (``CLS_CLASSES``) and
segmentation (``SEG_CLASSES``) batches stack the images and the labels
(class ids, or (H, W) label maps), and the evaluator gets the host labels
and the argmax as uint8; detection, instance and keypoint
(``KEYPOINT_CLASSES``) batches are the padded detection collate's, with
the keypoints and annotation areas when the dataset has them.

``PROFILER: {DIR, START_STEP, NUM_STEPS}`` traces NUM_STEPS train steps
with ``torch.profiler`` into a Chrome trace under DIR.
``AMP_BN_BF16_STATS: true`` takes the train-mode BN batch moments in
bfloat16 under AMP (``models/bricks.BatchNorm2d``), on this trainer's model
only.

Data parallelism: under ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node W -m cvpytorch_tpu_torch.trainer --setting X``) every
rank joins the process group (``parallel.dist.initialize_distributed``;
NCCL on the card, gloo on the CPU, unless ``--backend`` says), runs on
``cuda:LOCAL_RANK`` unless ``--device`` names a card, and takes its rows
of each global batch (``BATCH_SIZE`` is the global batch, as in the JAX
package): the train step is the single-process step on the global batch
(global loss normalisers and BN moments, gradients summed over the
ranks), the device augmentation draws the global batch's randoms and
keeps the rank's rows, rank 0's weights are broadcast at the start, val
scores each image on one rank and merges the evaluators in the
single-process order before ``evaluate()``, so every rank takes the same
best-checkpoint and early-stop decisions.  Only rank 0 logs at INFO and
writes checkpoints, summaries and the profiler trace.  A model whose loss
still takes per-rank normalisers (a class without its own
``dp_global_loss = True``), ``AMP_BN_BF16_STATS`` and a BN other than the
bricks' raise with more than one rank on the data axis (ROADMAP, Queue 1
item 11c).  The host transforms draw from each rank's own
``random``/``np.random``, as a JAX multi-host run's do.

Tensor parallelism: ``PARALLEL: {MODEL: n}`` lays the W ranks out as JAX's
``(data, model, spatial)`` mesh (``parallel.mesh.create_mesh``: rank =
d·n + m, data = W / n) and the train state as ``tp_shardings`` lays it out
(``shard_train_state``, after the weights are loaded in full and
broadcast): each rank holds its block of every leaf the rule shards, of
the model, the EMA and the optimizer's moments.  The ranks of one model
group load the same rows (``BATCH_SIZE`` divides by the data size), take
their first rank's train batch, compute those rows' whole loss and reduce
over the data group only; so data = 1 trains every model family, and the
refusals above apply when data > 1.  Val: every rank of a model group runs
the forward, and only its first rank's records and losses are merged.
Rank 0's model group gathers each checkpoint in full (rank 0 writes it),
so it restores in one process, and a one-process checkpoint resumes under
tensor parallelism.  The log's parameter count is the full model's.
``SPATIAL`` above 1 raises (item 11b-2).  Every rank seeds alike, so a
model group's device random streams (dropout, DropPath) draw alike.
"""
from __future__ import annotations

import argparse
import math
import os

import torch

from .config import CommonConfiguration, load_dictionary
from .data.loader import DataLoader, DevicePrefetcher, default_collate, map_arrays
from .data.transforms import build_transforms
from .data.transforms.det_transforms import make_det_collate, make_device_aug_collate
from .evaluator import build_evaluator
from .infer import TASKS, build_model, resolve_device
from .models.bricks import BatchNorm2d, set_bn_bf16_stats
from .ops.augment import fused_det_augment, step_generator
from .optim.optimizers import build_optimizer
from .optim.schedules import build_lr_scheduler
from .parallel import dist as dp
from .parallel.mesh import create_mesh, shard_train_state
from .parallel.tensor import broadcast_from_model_root_
from .registry import DATASETS
from .train_state import create_train_state, make_eval_step, make_train_step
from .utils.checkpoints import Checkpoints, EarlyStopping
from .utils.logger import setup_logger
from .utils.meters import LossLogger
from .utils.seed import DEFAULT_SEED, setup_seed
from .utils.tensorboard import DummyWriter
from .utils.timer import Timer

from .data import datasets as _datasets  # noqa: F401  (registers)

AUG_SEED_OFFSET = 7919


def tensors(tree):
    """The tensors of a nested batch."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def check_parallel(par) -> tuple[int, int]:
    """``PARALLEL: {MODEL: n, SPATIAL: m}`` → (n, m): the data axis is the
    rest of the ranks (``torchrun``).  ``SPATIAL`` above 1 and any other
    key raise."""
    if not par:
        return 1, 1
    items = dict(par.items()) if hasattr(par, "items") else {"": par}
    unknown = {k: v for k, v in items.items() if k not in ("MODEL", "SPATIAL")}
    if unknown:
        raise NotImplementedError(
            f"PARALLEL {unknown} is not ported: the port reads MODEL (tensor parallelism) and "
            "SPATIAL (ROADMAP, Queue 1 item 11b-2)")
    spatial = int(items.get("SPATIAL") or 1)
    if spatial != 1:
        raise NotImplementedError(
            f"PARALLEL SPATIAL {spatial} is not ported yet: train-time spatial parallelism "
            "(halo-partitioned convolutions, BN moments over data × spatial) is ROADMAP, "
            "Queue 1 item 11b-2")
    return int(items.get("MODEL") or 1), spatial


class Trainer:
    def __init__(self, cfg: CommonConfiguration, device: str = "cuda",
                 backend: str | None = None):
        self.cfg = cfg
        model_ranks, spatial_ranks = check_parallel(cfg.PARALLEL)
        self.device = resolve_device(device)
        dp.initialize_distributed(
            backend or ("nccl" if self.device.type == "cuda" else "gloo"), device=self.device)
        self.rank, self.world = dp.rank(), dp.world_size()
        self.rank0 = self.rank == 0
        self.mesh = create_mesh(model=model_ranks, spatial=spatial_ranks)
        # the rows this rank holds: its place on the data axis
        self.data_index, self.data_size = self.mesh.index("data"), self.mesh.data
        # the ranks of rank 0's model group gather the checkpoint; the
        # model group's first rank gives the val records
        self.saves = self.data_index == 0 and self.mesh.index("spatial") == 0
        self.scores = self.mesh.index("model") == 0 and self.mesh.index("spatial") == 0
        self.logger = setup_logger(rank=self.rank)
        self.seed = int(cfg.SEED or DEFAULT_SEED)
        setup_seed(self.seed)
        self.start_epoch = -1
        self.n_epochs = int(cfg.N_MAX_EPOCHS or 1)
        self._profiler = None
        self.logger.info("device: %s, rank %d of %d, mesh %s", self.device, self.rank,
                         self.world, self.mesh.shape)
        self._device_aug_size = None
        self._parser_dict()
        self._parser_datasets()
        self._parser_model()

    # ------------------------------------------------------------------
    def _parser_dict(self):
        self.dictionary = []
        if self.cfg.DATASET and self.cfg.DATASET.DICTIONARY:
            _, self.dictionary = load_dictionary(
                self.cfg.DATASET.DICTIONARY, self.cfg.DATASET.DICTIONARY_NAME)
        self.dictionary_name = (self.cfg.DATASET.DICTIONARY_NAME
                                if self.cfg.DATASET else None) or "CLS_CLASSES"
        if self.dictionary_name not in TASKS:
            raise NotImplementedError(
                f"the port trains classification, detection, segmentation and keypoints, "
                f"not {self.dictionary_name}")

    def _parser_datasets(self):
        ds_cls = DATASETS.get(self.cfg.DATASET.CLASS)
        max_boxes = int(self.cfg.DATASET.MAX_BOXES or 64)
        self.datasets, self.dataloaders = {}, {}
        for stage in ("train", "val"):
            stage_cfg = self.cfg.DATASET.get(stage.upper())
            if stage_cfg is None:
                continue
            transform = build_transforms(self.dictionary_name,
                                         stage_cfg.get("TRANSFORMS"), stage)
            ds = ds_cls(data_cfg=stage_cfg, dictionary=self.dictionary,
                        transform=transform, stage=stage)
            self.datasets[stage] = ds
            dev_aug = stage_cfg.get("DEVICE_AUG") if stage == "train" else None
            if dev_aug:
                # the host letterboxes the LOAD_NUM=4 raw tiles at TILE²
                # (default SIZE/2: each tile covers about a quadrant of the
                # mosaic); the rest runs on the device in the train step
                size = int(dev_aug.get("SIZE", 640))
                tile = int(dev_aug.get("TILE", size // 2))
                collate = make_device_aug_collate(max_boxes // 4, tile)
                self._device_aug_size = size
            elif self.dictionary_name in ("CLS_CLASSES", "SEG_CLASSES"):
                collate = default_collate  # stacks images and labels
            else:
                collate = make_det_collate(max_boxes)
            self.dataloaders[stage] = DataLoader(
                ds, collate_fn=collate,
                batch_size=int(stage_cfg.get("BATCH_SIZE", 1)),
                shuffle=bool(stage_cfg.get("SHUFFLE", stage == "train")),
                num_workers=int(stage_cfg.get("NUM_WORKER", 4) or 4),
                drop_last=(stage == "train"), seed=self.seed,
                rank=self.data_index, world_size=self.data_size)
        self.batch_size = int(self.cfg.DATASET.TRAIN.get("BATCH_SIZE", 1))  # global
        # this rank's rows of the global train batch (the device augmentation's draws)
        self._rows = (dp.process_batch_slice(self.batch_size, self.data_index, self.data_size)
                      if self.data_size > 1 else None)
        self.iters_per_epoch = max(len(self.dataloaders["train"]), 1)
        self.evaluator = (build_evaluator(self.cfg, self.datasets.get("val"))
                          if self.cfg.EVALUATOR and "val" in self.datasets
                          else None)

    def _parser_model(self):
        """Lowercase USE_MODEL keys the model's constructor takes are
        passed to it, and the dataset's ``mask_size`` to a model that takes
        one."""
        self.model = build_model(self.cfg, self.dictionary,
                                 self.datasets.get("train") or self.datasets.get("val"))
        # this model's own setting: a later Trainer's model starts from off
        set_bn_bf16_stats(self.model, bool(self.cfg.AMP_BN_BF16_STATS))
        if self.data_size > 1:
            self._check_data_parallel()

    def _check_data_parallel(self):
        """Refuses what would train on per-rank statistics with more than
        one rank on the data axis."""
        model = self.model
        item = "(ROADMAP, Queue 1 item 11c)"
        if not vars(type(model)).get("dp_global_loss", False):
            raise NotImplementedError(
                f"{type(model).__name__}'s loss takes per-rank normalisers: data-parallel "
                f"training of it is not ported yet {item}")
        if self.cfg.AMP_BN_BF16_STATS:
            raise NotImplementedError("AMP_BN_BF16_STATS takes per-rank BN moments: not "
                                      f"ported under data parallelism yet {item}")
        for name, m in model.named_modules():
            if (isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                    and not isinstance(m, BatchNorm2d)):
                raise NotImplementedError(
                    f"{name} is a {type(m).__name__}, whose moments are per rank: global "
                    f"BN moments need the bricks' BatchNorm2d {item}")

    # ------------------------------------------------------------------
    def _build_train_state(self):
        cfg = self.cfg
        lr = float(cfg.INIT_LR or 0.01)
        scale_lr = float(cfg.SCALE_LR or 0)
        if scale_lr:  # linear LR scaling on the batch
            cfg.INIT_LR = lr * self.batch_size / scale_lr
        self.lr_schedule = build_lr_scheduler(cfg, self.iters_per_epoch)
        model = self.model.to(self.device, memory_format=torch.channels_last)
        optimizer = build_optimizer(cfg, model, self.lr_schedule)
        state = create_train_state(model, optimizer, use_ema=bool(cfg.EMA))
        n_params = sum(p.numel() for p in model.parameters())  # in full
        self.logger.info("model %s: %.2fM params", cfg.USE_MODEL.CLASS, n_params / 1e6)
        if cfg.PRETRAIN_MODEL:  # in full, then sharded
            if cfg.RESUME:
                state = Checkpoints.restore_into(state, cfg.PRETRAIN_MODEL)
                self.start_epoch = state.step // self.iters_per_epoch - 1
                self.logger.info("resumed from %s @ step %d",
                                 cfg.PRETRAIN_MODEL, state.step)
            else:
                state = Checkpoints.load_weights_into(state, cfg.PRETRAIN_MODEL)
                self.logger.info("loaded weights from %s", cfg.PRETRAIN_MODEL)
        for module in (state.model, state.ema):  # every rank starts from rank 0's
            if module is not None:
                dp.broadcast_module_(module)
        return shard_train_state(state, self.mesh)

    # ------------------------------------------------------------------
    def run(self):
        cfg = self.cfg
        train_loader = self.dataloaders["train"]
        state = self._build_train_state()
        ema_decay = 0.0
        if cfg.EMA:
            # EMA: True → decay 0.9999; EMA: {DECAY: d} → d
            ema_decay = float(cfg.EMA.get("DECAY", 0.9999)) \
                if hasattr(cfg.EMA, "get") else 0.9999
        train_step = make_train_step(
            amp=bool(cfg.AMP), ema_decay=ema_decay,
            preprocess=self._device_aug_preprocess() if self._device_aug_size else None)
        eval_step = make_eval_step(use_ema=bool(cfg.EMA))

        ckpts = writer = None
        if self.rank0:  # the other ranks write nothing (rank 0's model group gathers)
            ckpts = Checkpoints(
                cfg.CHECKPOINT_DIR or "checkpoints", cfg.EXPERIMENT_NAME or "exp",
                str(cfg.USE_MODEL.CLASS).split(".")[-1],
                async_save=cfg.ASYNC_CHECKPOINT is not False)
            writer = DummyWriter(cfg.TENSORBOARD_LOG_DIR if cfg.TENSORBOARD else None,
                                 enabled=bool(cfg.TENSORBOARD))
        stopper = EarlyStopping(int(cfg.PATIENCE or 0) or 10**9)
        eval_intervals = int(
            (cfg.EVALUATOR.get("EVAL_INTERVALS", 1) if cfg.EVALUATOR else 1) or 1)
        save_intervals = int(cfg.N_EPOCHS_TO_SAVE_MODEL or 1)
        display = int(cfg.N_ITERS_TO_DISPLAY_STATUS or 50)

        best_perf = -math.inf
        for epoch in range(self.start_epoch + 1, self.n_epochs):
            train_loader.set_epoch(epoch)
            state = self.train_epoch(epoch, state, train_step, train_loader,
                                     writer, display)
            if self.evaluator and (epoch + 1) % eval_intervals == 0:
                perf, _ = self.val_epoch(epoch, state, eval_step, writer)
                is_best = perf > best_perf
                best_perf = max(best_perf, perf)
                self._autosave(ckpts, state, epoch, is_best, {"best": best_perf})
                if stopper(epoch, perf):
                    break
            elif (epoch + 1) % save_intervals == 0:
                self._autosave(ckpts, state, epoch, False, {})
        if writer:
            writer.close()
        if ckpts:
            ckpts.wait()
        self._stop_profiler()
        self.checkpoints = ckpts
        self.state = state
        return state

    def _autosave(self, ckpts, state, epoch, is_best, extra):
        """Rank 0 writes the checkpoint the ranks of its model group gather."""
        if self.saves:
            payload = Checkpoints.payload(state, dict(extra, epoch=epoch))
            if ckpts:
                ckpts.autosave_payload(payload, is_best)

    def _device_aug_preprocess(self):
        """``batch -> batch`` for ``make_train_step``: raw tiles → the
        augmented train batch, on the device, with the step's generator."""
        size = self._device_aug_size
        seed = self.seed + AUG_SEED_OFFSET

        def preprocess(batch):
            t = batch["target"]
            images = batch["image"]
            gen = step_generator(seed, int(t["aug_step"]), images.device)
            imgs, boxes, keep = fused_det_augment(images, t["boxes"], t["valid"],
                                                  gen, size, rows=self._rows,
                                                  global_batch=self.batch_size)
            B = imgs.shape[0]
            new_t = {
                "boxes": boxes, "labels": t["labels"].reshape(B, -1), "valid": keep,
                "pads": torch.zeros((B, 2), device=imgs.device),
                "scales": torch.ones((B, 2), device=imgs.device),
                "height": torch.full((B,), size, dtype=torch.int32, device=imgs.device),
                "width": torch.full((B,), size, dtype=torch.int32, device=imgs.device),
                "epoch": t["epoch"],
            }
            return {**batch, "image": imgs, "target": new_t}

        return preprocess

    def _profiler_hook(self, step: int):
        """``PROFILER: {DIR: traces, START_STEP: 10, NUM_STEPS: 5}``:
        ``torch.profiler`` (CPU, and CUDA on a CUDA device) from global
        step START_STEP for NUM_STEPS steps, written as a Chrome trace
        ``DIR/trace_steps_<first>-<last>.json``; each profiled step is a
        ``train_step_<n>`` range."""
        prof = self.cfg.PROFILER
        if not prof or not hasattr(prof, "get") or not self.rank0:
            return
        start = prof.get("START_STEP")
        start = 10 if start is None else int(start)
        num = prof.get("NUM_STEPS")
        num = 5 if num is None else int(num)
        if step == start and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()
            self._profile_range = (start, start + num - 1)
            self.logger.info("profiler trace started @ step %d", step)
        elif step == start + num:
            self._stop_profiler()

    def _stop_profiler(self):
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.__exit__(None, None, None)
        out_dir = str(self.cfg.PROFILER.get("DIR", "traces"))
        os.makedirs(out_dir, exist_ok=True)
        first, last = self._profile_range
        self.trace_path = os.path.join(out_dir, f"trace_steps_{first}-{last}.json")
        self._profiler.export_chrome_trace(self.trace_path)
        self._profiler = None
        self.logger.info("profiler trace written to %s", self.trace_path)

    def train_epoch(self, epoch, state, train_step, loader, writer, display):
        loss_logger = LossLogger()
        timer = Timer()
        timer.tic()
        pending = None  # (metrics, iter): read one step late, no stall

        def prepared():
            for i, batch in enumerate(loader):
                if not isinstance(batch["target"], dict):  # class ids, label maps
                    yield batch
                    continue
                extra = {"epoch": epoch}
                if self._device_aug_size:
                    extra["aug_step"] = epoch * len(loader) + i
                yield {**batch, "target": {**batch["target"], **extra}}

        for it, batch in enumerate(DevicePrefetcher(prepared(), self.device)):
            if self.mesh.model > 1:  # the host draws are each process's own
                broadcast_from_model_root_(list(tensors(batch)), self.mesh)
            gstep = epoch * len(loader) + it
            self._profiler_hook(gstep)
            if self._profiler is not None:
                with torch.profiler.record_function(f"train_step_{gstep}"):
                    state, metrics = train_step(state, batch)
            else:
                state, metrics = train_step(state, batch)
            if pending is not None and (pending[1] + 1) % display == 0:
                loss_logger.update({k: float(v) for k, v in pending[0].items()})
                timer.toc(display)
                lr = self.lr_schedule(state.step - 1)
                self.logger.info("epoch %d iter %d/%d lr %.5f %s (%.1f im/s)",
                                 epoch, pending[1] + 1, len(loader), lr,
                                 loss_logger, timer.ips(self.batch_size))
                timer.reset()
                timer.tic()
            pending = (metrics, it)
        if pending is not None:
            loss_logger.update({k: float(v) for k, v in pending[0].items()})
        if writer:
            for k, m in loss_logger.meters.items():
                writer.add_scalar(f"loss/train_{k}", m.global_avg, epoch)
        return state

    def _host_predictions(self, preds):
        """Detection dicts and float predictions (decoded keypoints) to
        numpy; an argmax (class ids, or (B, H, W) maps) as uint8 (int32
        past 256 classes), a quarter of its int64 copy."""
        if isinstance(preds, dict):
            return {k: v.cpu().numpy() for k, v in preds.items()}
        if preds.is_floating_point():
            return preds.cpu().numpy()
        dtype = torch.uint8 if len(self.dictionary) <= 256 else torch.int32
        return preds.to(dtype).cpu().numpy()

    def val_epoch(self, epoch, state, eval_step, writer):
        """Scores this rank's val rows; with a live process group the
        evaluators are merged (in the single-process order) before
        ``evaluate()``, and the val losses logged are the mean over every
        rank's batches of the losses each takes with its own normalisers."""
        self.evaluator.reset()
        loss_logger = LossLogger()
        loader = self.dataloaders["val"]
        for positions, batch in zip(loader.batch_positions(), loader):
            targets_host = batch["target"]
            if isinstance(targets_host, dict):
                # the epoch reaches the val targets too, so that a loss
                # scheduled by epoch reports on the train step's branch
                batch = {**batch, "target": {**targets_host, "epoch": epoch}}
            loss_dict, preds = eval_step(state, map_arrays(
                batch, lambda a: torch.from_numpy(a).to(self.device)))
            loss_logger.update({k: float(v) for k, v in loss_dict.items()})
            # the images' places in the single-process order, for the merge
            kw = {"indices": positions} if dp.group_live() else {}
            self.evaluator.update(targets_host, self._host_predictions(preds), **kw)
        if dp.group_live():  # the records of each data index's first model rank
            states = dp.allgather_pickled(self.evaluator.state_dict() if self.scores else None)
            self.evaluator.merge_state_dicts([s for s in states if s is not None])
            sums = dp.allgather_pickled({k: (m.total, m.count)
                                         for k, m in loss_logger.meters.items()}
                                        if self.scores else None)
            sums = [s for s in sums if s is not None]
            loss_logger = LossLogger()
            for k in sorted({k for s in sums for k in s}):  # a rank may have had no batch
                total, count = (sum(s[k][i] for s in sums if k in s) for i in (0, 1))
                loss_logger.update({k: total / max(count, 1)})
        metrics = self.evaluator.evaluate()
        perf = float(metrics.get("performance", 0.0))
        self.logger.info(
            "epoch %d VAL %s | %s", epoch, loss_logger,
            ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items()
                      if isinstance(v, float)))
        if writer:
            for k, m in loss_logger.meters.items():
                writer.add_scalar(f"loss/val_{k}", m.global_avg, epoch)
            for k, v in metrics.items():
                if isinstance(v, float) and math.isfinite(v):
                    writer.add_scalar(f"performance/{k}", v, epoch)
        return perf, metrics


def main(argv=None):
    parser = argparse.ArgumentParser("cvpytorch_tpu_torch trainer")
    parser.add_argument("--setting", required=True, help="path to a .yml or .json config")
    parser.add_argument("--device", default="cuda",
                        help="cuda (under torchrun cuda:LOCAL_RANK), cuda:<i> or cpu")
    parser.add_argument("--backend", default=None,
                        help="process-group backend under torchrun: nccl (default on "
                        "cuda) or gloo (default on cpu)")
    args = parser.parse_args(argv)
    trainer = Trainer(CommonConfiguration.from_file(args.setting), device=args.device,
                      backend=args.backend)
    trainer.run()


if __name__ == "__main__":
    main()
