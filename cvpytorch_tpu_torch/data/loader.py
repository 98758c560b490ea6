"""Host data loader with background prefetch (counterpart of
``cvpytorch_tpu/data/loader.py``).

Thread-pool sample fetch with ordered batch assembly and a bounded
background queue of ready batches.  Batches are numpy; the caller moves
them to the device.  This is the serving loader: samples in dataset
order, the last batch may be short.  Shuffling, epochs and the CUDA-stream
device prefetcher come with the training slice.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np

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
    def __init__(self, dataset, batch_size: int = 1, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n, n_batches = len(self.dataset), len(self)
        out_q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    chunk = range(b * self.batch_size,
                                  min((b + 1) * self.batch_size, n))
                    try:
                        samples = list(pool.map(self.dataset.__getitem__, chunk))
                        out_q.put(default_collate(samples))
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
