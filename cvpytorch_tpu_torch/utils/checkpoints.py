"""Checkpointing (counterpart of ``cvpytorch_tpu/utils/checkpoints.py``).

A run directory ``CHECKPOINT_DIR/<EXPERIMENT>#<Model>#<timestamp>`` holds
``last.pt`` and, on improvement, ``best.pt`` and ``deploy.pt`` (the bare
``state_dict`` of the weights to serve: EMA's when EMA is on).  A trainer
checkpoint is one ``torch.save``d dict: ``step``, ``model``, ``optimizer``
(with the chain's counters), ``ema`` when EMA is on, and ``extra`` (epoch,
best performance).  Resume is exact: restoring a checkpoint and taking a
step gives what the uninterrupted run gives.  A state laid out for tensor
parallelism is saved gathered, as one process holds it, so a checkpoint
restores into either layout; ``restore_into`` and ``load_weights_into``
take a state in full, which the trainer shards after.

``async_save=True`` copies the tensors on their device and writes them
on a daemon thread, so the save overlaps the next epoch; one save is in
flight at a time, and ``wait`` re-raises a failed save.
"""
from __future__ import annotations

import logging
import os
import threading
import time

import torch

from ..parallel.mesh import full_train_state
from ..train_state import TrainState

logger = logging.getLogger("cvpytorch_tpu_torch")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _clone(tree):
    return _map(tree, lambda t: t.detach().clone())


def _to_cpu(tree):
    return _map(tree, lambda t: t.detach().cpu())


class Checkpoints:
    def __init__(self, checkpoint_dir: str, experiment_name: str = "exp",
                 model_name: str = "model", timestamp: str | None = None,
                 async_save: bool = False):
        stamp = timestamp or time.strftime("%Y-%m-%d-%H-%M-%S")
        self.save_dir = os.path.abspath(
            os.path.join(checkpoint_dir, f"{experiment_name}#{model_name}#{stamp}"))
        os.makedirs(self.save_dir, exist_ok=True)
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self._save_error: BaseException | None = None

    def wait(self):
        """Block until an in-flight save has landed; re-raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _launch(self, work):
        self.wait()
        if not self.async_save:
            work()
            return

        def guarded():
            try:
                work()
            except BaseException as e:  # surfaced by the next wait()
                logger.error("async checkpoint save failed: %s", e)
                self._save_error = e

        self._pending = threading.Thread(target=guarded, daemon=True)
        self._pending.start()

    @staticmethod
    def payload(state: TrainState, extra: dict | None = None) -> dict:
        """The checkpoint of ``state``.  Laid out for tensor parallelism, it
        is the gathered one-process state (``parallel.mesh.full_train_state``),
        so every rank of the model group calls this."""
        payload = {"step": state.step, **full_train_state(state)}
        if extra:
            payload["extra"] = dict(extra)
        return payload

    def _save(self, payloads: dict):
        """name → payload, each written as ``name.pt``; tensors are copied
        now (the next step changes them in place) and written to the CPU
        in the save."""
        payloads = {k: _clone(v) for k, v in payloads.items()} \
            if self.async_save else payloads

        def work():
            for name, payload in payloads.items():
                path = os.path.join(self.save_dir, f"{name}.pt")
                tmp = path + ".tmp"
                torch.save(_to_cpu(payload), tmp)
                os.replace(tmp, path)
            logger.info("saved %s in %s", ", ".join(payloads), self.save_dir)

        self._launch(work)

    def save_checkpoint(self, state: TrainState, name: str = "last",
                        extra: dict | None = None):
        self._save({name: self.payload(state, extra)})

    def autosave_checkpoint(self, state: TrainState, epoch: int, is_best: bool,
                            extra: dict | None = None):
        """``last`` every call; ``best`` and the weights-only ``deploy`` on
        improvement."""
        self.autosave_payload(self.payload(state, dict(extra or {}, epoch=epoch)), is_best)

    def autosave_payload(self, payload: dict, is_best: bool):
        """``autosave_checkpoint`` of a ``payload`` already taken."""
        payloads = {"last": payload}
        if is_best:
            payloads["best"] = payload
            payloads["deploy"] = payload.get("ema", payload["model"])
        self._save(payloads)

    # -- load --------------------------------------------------------------
    @staticmethod
    def load(path: str) -> dict:
        return torch.load(path, map_location="cpu", weights_only=True)

    @staticmethod
    def restore_into(state: TrainState, path: str) -> TrainState:
        """Full resume: model, optimizer, EMA and step."""
        payload = Checkpoints.load(path)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        if state.ema is not None and "ema" in payload:
            state.ema.load_state_dict(payload["ema"])
        state.step = int(payload["step"])
        return state

    @staticmethod
    def load_weights_into(target, path: str):
        """Weights only, into a model or a ``TrainState``'s model.  Takes a
        bare ``state_dict`` or a trainer checkpoint, and from a trainer
        checkpoint the EMA weights when it has them."""
        payload = Checkpoints.load(path)
        if "model" in payload and "step" in payload:
            payload = payload.get("ema", payload["model"])
        model = target.model if isinstance(target, TrainState) else target
        model.load_state_dict(payload)
        return target


class EarlyStopping:
    """Patience on the scalar 'performance' metric."""

    def __init__(self, patience: int = 30):
        self.patience = patience if patience and patience > 0 else float("inf")
        self.best_epoch = 0
        self.best_perf = -float("inf")

    def __call__(self, epoch: int, performance: float) -> bool:
        if performance >= self.best_perf:
            self.best_perf = performance
            self.best_epoch = epoch
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            logger.info("early stop at epoch %d (best %.4f @ epoch %d)",
                        epoch, self.best_perf, self.best_epoch)
        return stop
