"""Console + file logger (a copy of ``cvpytorch_tpu/utils/logger.py``).

Coloured console output plus a dated logfile under ``logs/``.  Rank
gating: rank 0 logs at INFO, others at WARNING.
"""
from __future__ import annotations

import logging
import os
import sys
import time

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[36m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def setup_logger(name: str = "cvpytorch_tpu_torch", log_dir: str | None = "logs",
                 rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_cvt_configured", False):
        return logger
    logger._cvt_configured = True  # type: ignore[attr-defined]
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
    console = logging.StreamHandler(sys.stderr)
    console.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    console.setFormatter(_ColorFormatter(fmt))
    logger.addHandler(console)

    if log_dir and rank == 0:
        try:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, time.strftime("%Y%m%d") + ".log")
            fh = logging.FileHandler(path)
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(logging.Formatter(fmt))
            logger.addHandler(fh)
        except OSError:
            pass
    return logger
