"""TensorBoard writer (a copy of ``cvpytorch_tpu/utils/tensorboard.py``):
backed by ``tf.summary`` when TensorFlow is installed, else a no-op."""
from __future__ import annotations


class DummyWriter:
    def __init__(self, log_dir: str | None = None, enabled: bool = True):
        self._writer = None
        if enabled and log_dir:
            try:
                import tensorflow as tf

                self._writer = tf.summary.create_file_writer(log_dir)
            except Exception:
                self._writer = None

    def add_scalar(self, tag: str, value: float, step: int):
        if self._writer is None:
            return
        import tensorflow as tf

        with self._writer.as_default():
            tf.summary.scalar(tag, float(value), step=int(step))

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        self.flush()
