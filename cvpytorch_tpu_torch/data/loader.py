"""Host data loader and device prefetcher (counterpart of
``cvpytorch_tpu/data/loader.py``).

``DataLoader``: thread-pool sample fetch with ordered batch assembly and a
bounded background queue of ready numpy batches.  With ``shuffle`` the
order of an epoch is ``np.random.RandomState(seed + epoch)``'s shuffle of
the indices, as in the JAX package.  ``batch_size`` is the global batch:
with ``world_size`` ranks every rank draws the same order and loads only
its rows of each global batch, so the ranks' batches together are the
single-process batch.  With ``drop_last`` (train) the global batch must
divide by the world size and rank r takes rows [r·B/W, (r+1)·B/W); without
it (val) each global batch, the last partial one too, is split as
``np.array_split`` splits it, so that every item is loaded by exactly one
rank, and a rank skips a split that comes out empty.
``batch_positions()`` gives each of this rank's batches' positions in the
epoch's single-process order (what the evaluators' merge sorts by).

``DevicePrefetcher``: a depth-2 feed of batches already on the device.  A
producer thread pulls host batches and, on ``cuda``, copies every array
into pinned host memory and from there ``non_blocking`` to the card on a
side stream, so that the copy of batch k+1 overlaps the step on batch k.
The consumer's stream waits for the side stream, and every tensor handed
out is recorded on the consumer's stream, so that the caching allocator
does not reuse its memory while the step still reads it.  On the CPU the
transfer is ``torch.from_numpy``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np
import torch

PREFETCH = 2  # ready batches queued ahead of the consumer


def default_collate(samples: list[dict]) -> dict:
    """Stack images; stack array targets, keep dict/None targets as lists."""
    batch: dict[str, Any] = {}
    batch["image"] = np.stack([s["image"] for s in samples])
    targets = [s.get("target") for s in samples]
    if targets[0] is None:
        pass
    elif isinstance(targets[0], dict):
        batch["target"] = targets  # task-specific collate should pad these
    else:
        batch["target"] = np.stack([np.asarray(t) for t in targets])
    for k in samples[0]:
        if k not in ("image", "target"):
            batch[k] = [s[k] for s in samples]
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 4, collate_fn: Callable | None = None,
                 drop_last: bool = False, seed: int = 0, rank: int = 0,
                 world_size: int = 1):
        if drop_last and batch_size % world_size:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{world_size} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.seed = seed
        self.rank, self.world_size = rank, world_size
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def _global_batches(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def batch_positions(self) -> list[np.ndarray]:
        """This rank's batches as positions in the epoch's order."""
        n, B, W = len(self.dataset), self.batch_size, self.world_size
        out = []
        for b in range(self._global_batches()):
            rows = np.arange(b * B, min((b + 1) * B, n))
            if W > 1:
                rows = (rows[self.rank * B // W:(self.rank + 1) * B // W] if self.drop_last
                        else np.array_split(rows, W)[self.rank])
            if len(rows):
                out.append(rows)
        return out

    def __len__(self) -> int:
        """Batches this rank loads an epoch (at train, the global batches)."""
        if self.drop_last or self.world_size == 1:
            return self._global_batches()
        n, B = len(self.dataset), self.batch_size
        # array_split gives rank r a row of a batch of m rows iff m > r
        return (n // B) * (B > self.rank) + (n % B > self.rank)

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        chunks = [indices[rows] for rows in self.batch_positions()]
        out_q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for chunk in chunks:
                    if stop.is_set():
                        return
                    try:
                        samples = list(pool.map(self.dataset.__getitem__, chunk))
                        out_q.put(self.collate_fn(samples))
                    except Exception as e:  # surface worker errors to consumer
                        out_q.put(e)
                        return
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break


def map_arrays(tree, fn):
    """Applies ``fn`` to every numpy array (ndim ≥ 1) of a nested batch;
    numpy scalars become Python numbers, everything else passes through."""
    if isinstance(tree, dict):
        return {k: map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim:
        return fn(tree)
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


class DevicePrefetcher:
    """Iterates ``iterator``'s host batches as batches on ``device``,
    ``depth`` of them transferred ahead (see the module docstring).  An
    exception in the producer is raised in the consumer."""

    def __init__(self, iterator, device, depth: int = 2):
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def producer():
            try:
                for batch in iterator:
                    if self._stop.is_set():
                        return
                    self._q.put(self._transfer(batch))
            except Exception as e:  # surfaced in the consumer
                self._q.put(e)
                return
            self._q.put(None)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def _transfer(self, batch):
        if self._side is None:
            return map_arrays(batch, lambda a: torch.from_numpy(a).to(self.device))
        with torch.cuda.stream(self._side):
            return map_arrays(batch, lambda a: torch.from_numpy(a).pin_memory()
                               .to(self.device, non_blocking=True))

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        if self._side is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self._side)
            _map_tensors(item, lambda t: t.record_stream(current))
        return item

    def close(self):
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.01)


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        for v in tree.values():
            _map_tensors(v, fn)
    elif isinstance(tree, torch.Tensor):
        fn(tree)
