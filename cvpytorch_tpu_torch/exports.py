"""Deploy export (counterpart of ``cvpytorch_tpu/exports.py``).

The model's ``mode="infer"`` path, decode and greedy NMS included, goes
through ``torch.export.export`` at one fixed input shape, as JAX exports
its jitted infer function to StableHLO at one shape, and is written with
``torch.export.save`` as a ``.pt2`` file.  The NMS stays the ``cvt::nms_keep``
op (``ops/nms_kernel.py``): one node of the exported graph, which runs the
CUDA kernels on CUDA tensors and the plain version on CPU tensors.
``load_exported`` imports the port, which registers that op, before it
loads a program.

``--fuse`` folds each conv + BN pair into the conv first
(``utils.model_utils.fuse_model_conv_bn``).  The weights are the EMA
weights when the checkpoint has them.  The program is traced on the
device it is exported on (``--device``, ``cuda`` unless ``cpu`` is
asked for) and runs there.

CLI: ``python -m cvpytorch_tpu_torch.exports --setting conf/X.yml
--checkpoint ckpt.pt [--out export_out] [--input-size H W] [--batch B]
[--fuse] [--device cuda|cpu]``; ``--format`` takes ``torch_export`` only.
"""
from __future__ import annotations

import argparse

import torch
from torch import nn

from .ops import nms_kernel as _nms_kernel  # noqa: F401  (registers cvt::nms_keep)


class InferProgram(nn.Module):
    """``images -> model(images, mode='infer')``: the function exported."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images):
        return self.model(images, mode="infer")


def export_program(model: nn.Module, input_shape, dtype=torch.float32,
                   device: str | torch.device = "cuda"):
    """The ``mode='infer'`` path of ``model`` (in eval mode, moved to
    ``device``, channels-last as ``infer`` serves it) exported at NHWC
    ``input_shape`` → a ``torch.export.ExportedProgram``.  ``device`` is
    the card unless the CPU is asked for; there is no fallback."""
    from .infer import resolve_device

    device = resolve_device(str(device))
    model = model.eval().to(device=device, memory_format=torch.channels_last)
    example = torch.zeros(tuple(input_shape), dtype=dtype, device=device)
    with torch.no_grad():
        return torch.export.export(InferProgram(model), (example,))


def export_torch(model: nn.Module, input_shape, out_path: str,
                 dtype=torch.float32, device: str | torch.device = "cuda") -> str:
    """Exports and saves the infer path to ``out_path`` (``.pt2``), without
    the example batch of zeros the program would otherwise carry."""
    program = export_program(model, input_shape, dtype, device)
    program.example_inputs = None
    torch.export.save(program, out_path)
    return out_path


def load_exported(path: str):
    """The saved program's callable: ``images -> predictions``."""
    return torch.export.load(path).module()


def main(argv=None):
    parser = argparse.ArgumentParser("cvpytorch_tpu_torch exports")
    parser.add_argument("--setting", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--format", default="torch_export", choices=["torch_export"])
    parser.add_argument("--out", default="export_out")
    parser.add_argument("--input-size", type=int, nargs=2, default=[640, 640])
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--fuse", action="store_true",
                        help="fold conv + BN before export")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from .config import CommonConfiguration, load_dictionary
    from .infer import build_model, resolve_device
    from .utils.checkpoints import Checkpoints

    device = resolve_device(args.device)
    cfg = CommonConfiguration.from_file(args.setting)
    dictionary = []
    if cfg.DATASET and cfg.DATASET.DICTIONARY:
        _, dictionary = load_dictionary(cfg.DATASET.DICTIONARY, cfg.DATASET.DICTIONARY_NAME)
    model = build_model(cfg, dictionary)
    Checkpoints.load_weights_into(model, args.checkpoint)  # EMA weights when present
    model.eval()
    if args.fuse:
        from .utils.model_utils import fuse_model_conv_bn

        fuse_model_conv_bn(model)
    shape = (args.batch, args.input_size[0], args.input_size[1], 3)
    out = args.out if args.out.endswith(".pt2") else args.out + ".pt2"
    export_torch(model, shape, out, device=device)
    print(f"exported {args.format} to {out}")
    return out


if __name__ == "__main__":
    main()
