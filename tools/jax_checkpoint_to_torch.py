"""Convert a JAX-package (orbax) checkpoint into a checkpoint of the
PyTorch port.

    python tools/jax_checkpoint_to_torch.py --setting conf/X.yml \\
        --checkpoint <orbax checkpoint dir> --out ckpt.pt

The checkpoint is restored with ``cvpytorch_tpu.utils.checkpoints.
Checkpoints.load``; the config builds the port's model
(``cvpytorch_tpu_torch.infer.build_model``) and
``cvpytorch_tpu_torch.utils.porting.load_jax_variables`` carries the
weights into it.  A trainer checkpoint becomes the port's trainer payload
``{'step', 'model', 'ema' (when the checkpoint has EMA weights), 'extra'
(epoch and the rest of JAX's 'extra')}``, which ``infer``, ``exports`` and
``PRETRAIN_MODEL`` read (the EMA weights first); a weights-only
``deploy`` checkpoint becomes a bare ``state_dict``.  The optimizer state is
not converted: a port run cannot resume the JAX run's optimizer, only
start from its weights.

This tool imports JAX, so it lives outside the port's package.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _plain(tree):
    """Orbax restores nested dicts of arrays; numpy leaves for the carry."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _scalar(v):
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a.tolist()


def convert(setting: str, checkpoint: str, out: str) -> dict:
    from cvpytorch_tpu.utils.checkpoints import Checkpoints as JaxCheckpoints
    from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.utils.porting import load_jax_variables

    cfg = CommonConfiguration.from_file(setting)
    dictionary = []
    if cfg.DATASET and cfg.DATASET.DICTIONARY:
        _, dictionary = load_dictionary(cfg.DATASET.DICTIONARY, cfg.DATASET.DICTIONARY_NAME)
    payload = JaxCheckpoints.load(checkpoint)

    def weights(params_key: str, stats_key: str) -> dict:
        variables = {"params": _plain(payload[params_key]),
                     "batch_stats": _plain(payload.get(stats_key) or {})}
        return load_jax_variables(build_model(cfg, dictionary), variables).state_dict()

    if "step" not in payload:  # a weights-only deploy checkpoint
        result = weights("params", "batch_stats")
    else:
        result = {"step": int(np.asarray(payload["step"])),
                  "model": weights("params", "batch_stats")}
        if payload.get("ema_params") is not None:
            result["ema"] = weights("ema_params", "ema_batch_stats")
        if payload.get("extra"):
            result["extra"] = {k: _scalar(v) for k, v in payload["extra"].items()}
    torch.save(result, out)
    print(f"wrote {out}: weights{' and EMA weights' if 'ema' in result else ''}; "
          "the optimizer state is not converted")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser("jax_checkpoint_to_torch")
    parser.add_argument("--setting", required=True, help="the config the checkpoint trained")
    parser.add_argument("--checkpoint", required=True, help="an orbax checkpoint directory")
    parser.add_argument("--out", required=True, help="the port's .pt checkpoint to write")
    args = parser.parse_args(argv)
    convert(args.setting, args.checkpoint, args.out)


if __name__ == "__main__":
    main()
