"""Inference CLI (counterpart of ``cvpytorch_tpu/infer.py``).

``python -m cvpytorch_tpu_torch.infer --setting conf/X.yml|X.json
--checkpoint ckpt.pt [--out out_dir] [--device cuda|cpu]`` — loads the
config, dictionary, dataset (stage ``infer``) and model, loads the
weights through ``Checkpoints.load_weights_into`` (a bare ``state_dict``,
or a trainer checkpoint, whose EMA weights it takes when it has them),
runs the predict step over the loader and writes ``out_dir/predictions.json``
— detections, or for classification (``CLS_CLASSES``) the list of class
ids, one an image, as the JAX CLI writes them — or for segmentation
(``SEG_CLASSES``) one 8-bit palette PNG a prediction,
``out_dir/{index:06d}.png`` with ``CITYSCAPES_PALETTE``, written by
``data/png.py``.  Keypoints (``KEYPOINT_CLASSES``): a heatmap model's
decoded (B, K, 3) flattened into one list, as the JAX CLI writes it; a
bottom-up model's maps (OpenPose) decoded into people
(``ops/paf.openpose_decode``, ``instances_to_eval``), one
``{'keypoints', 'boxes', 'scores'}`` an image in original pixels (the JAX
CLI cannot write that dict).

Runs on ``cuda`` unless ``--device cpu`` is given; without CUDA that
raises.  Serving is float32: making the predict step turns both TF32
switches off for the process (``train_state.make_predict_step``).
Infer-stage samples carry no target; the detection letterbox records
their ``pads``/``scales`` as batch keys, which go to the model as its
targets, so served boxes are in the original image's pixels.  (The JAX
CLI passes no targets and serves network pixels.)
"""
from __future__ import annotations

import argparse
import inspect
import json
import logging
import os

import numpy as np
import torch

from .config import CommonConfiguration, load_dictionary
from .data.loader import DataLoader
from .data.png import write_palette_png
from .data.transforms import build_transforms
from .ops import paf
from .registry import DATASETS, MODELS
from .train_state import make_predict_step
from .utils.checkpoints import Checkpoints

logger = logging.getLogger("cvpytorch_tpu_torch")

TASKS = ("CLS_CLASSES", "DET_CLASSES", "INS_CLASSES", "SEG_CLASSES", "KEYPOINT_CLASSES")
LETTERBOX_KEYS = ("pads", "scales")  # infer-stage batch keys the model takes

# Cityscapes palette, one RGB triple per train id
CITYSCAPES_PALETTE = [
    128, 64, 128, 244, 35, 232, 70, 70, 70, 102, 102, 156, 190, 153, 153,
    153, 153, 153, 250, 170, 30, 220, 220, 0, 107, 142, 35, 152, 251, 152,
    70, 130, 180, 220, 20, 60, 255, 0, 0, 0, 0, 142, 0, 0, 70, 0, 60, 100,
    0, 80, 100, 0, 0, 230, 119, 11, 32,
]


def save_seg_mask(pred, path: str, palette=None) -> None:
    """(H, W) class ids → an 8-bit palette PNG."""
    write_palette_png(path, pred, palette or CITYSCAPES_PALETTE)


def resolve_device(name: str) -> torch.device:
    """``cuda`` must be available when asked for; there is no fallback.
    Under ``torchrun`` (``LOCAL_RANK`` set) a bare ``cuda`` is this rank's
    card, ``cuda:LOCAL_RANK``, which must exist."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {device.index} has no card of its own "
                               f"({torch.cuda.device_count()} visible): pass --device "
                               "cuda:<index> to place the ranks")
    return device


# The JAX package's models the port lacks yet → their ROADMAP item (none)
NOT_PORTED: dict[str, str] = {}


def build_model(cfg, dictionary, dataset=None) -> torch.nn.Module:
    """The ``USE_MODEL`` model; lowercase ``USE_MODEL`` keys its constructor
    takes are passed to it.  A model that takes ``mask_size`` gets the
    dataset's instance-mask raster size unless the config sets it, so the
    segm evaluator compares masks of one resolution.  A model of the JAX
    package that the port lacks raises ``KeyError`` naming its ROADMAP
    item."""
    from . import models as _m  # noqa: F401 (registers)

    name = cfg.USE_MODEL.CLASS.split(".")[-1]
    if name in NOT_PORTED and name not in MODELS:
        raise KeyError(f"the model {name} is not ported yet "
                       f"(ROADMAP, Queue 1 item {NOT_PORTED[name]})")
    model_cls = MODELS.get(cfg.USE_MODEL.CLASS)
    params = inspect.signature(model_cls).parameters
    extra = {k: v for k, v in cfg.USE_MODEL.items()
             if k in params and k not in ("dictionary", "model_cfg")}
    if ("mask_size" in params and "mask_size" not in extra
            and hasattr(dataset, "mask_size")):
        extra["mask_size"] = int(dataset.mask_size)
    return model_cls(dictionary=tuple(dictionary), model_cfg=cfg.USE_MODEL,
                     **extra)


def keypoint_results(preds, images, targets) -> list:
    """A keypoint batch's entries of ``predictions.json``: the flattened
    (B, K, 3) decode, or one dict of people an image for a bottom-up
    model's maps."""
    if not isinstance(preds, dict):
        return preds.cpu().numpy().reshape(-1).tolist()
    stride = images.shape[1] // preds["heatmaps"].shape[1]
    people = paf.instances_to_eval(paf.openpose_decode(preds["heatmaps"], preds["pafs"]),
                                   stride, {k: v.cpu().numpy() for k, v in targets.items()})
    return [{key: people[key][i][people["valid"][i]].tolist()
             for key in ("keypoints", "boxes", "scores")}
            for i in range(len(people["valid"]))]


def main(argv=None):
    parser = argparse.ArgumentParser("cvpytorch_tpu_torch infer")
    parser.add_argument("--setting", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", default="infer_out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = CommonConfiguration.from_file(args.setting)
    dictionary = []
    if cfg.DATASET.DICTIONARY:
        _, dictionary = load_dictionary(cfg.DATASET.DICTIONARY,
                                        cfg.DATASET.DICTIONARY_NAME)
    dictionary_name = cfg.DATASET.DICTIONARY_NAME or "CLS_CLASSES"
    if dictionary_name not in TASKS:
        raise NotImplementedError(
            f"the port serves classification, detection, segmentation and keypoints, "
            f"not {dictionary_name}")

    from .data import datasets as _d  # noqa: F401 (registers)

    stage_cfg = cfg.DATASET.get("INFER") or cfg.DATASET.get("VAL")
    transform = build_transforms(dictionary_name,
                                 stage_cfg.get("TRANSFORMS"), "infer")
    ds = DATASETS.get(cfg.DATASET.CLASS)(
        data_cfg=stage_cfg, dictionary=dictionary, transform=transform,
        stage="infer",
    )
    loader = DataLoader(ds, batch_size=int(stage_cfg.get("BATCH_SIZE", 1)),
                        num_workers=int(stage_cfg.get("NUM_WORKER", 4) or 4))

    model = build_model(cfg, dictionary, ds)
    Checkpoints.load_weights_into(model, args.checkpoint)
    model.to(device=device, memory_format=torch.channels_last)
    predict = make_predict_step(model)

    os.makedirs(args.out, exist_ok=True)
    results, n_seg = [], 0
    for batch in loader:
        images = torch.from_numpy(batch["image"]).to(device)
        if dictionary_name == "SEG_CLASSES":
            for p in predict(images).to(torch.uint8).cpu().numpy():
                save_seg_mask(p, os.path.join(args.out, f"{n_seg:06d}.png"))
                n_seg += 1
            continue
        if dictionary_name == "CLS_CLASSES":
            results.extend(predict(images).cpu().numpy().reshape(-1).tolist())
            continue
        targets = {k: torch.from_numpy(np.stack(batch[k])).to(device)
                   for k in LETTERBOX_KEYS if k in batch}
        if dictionary_name == "KEYPOINT_CLASSES":
            results.extend(keypoint_results(predict(images, targets), images, targets))
            continue
        preds = {k: v.cpu().numpy() for k, v in predict(images, targets).items()}
        for i in range(len(batch["image"])):
            v = preds["valid"][i]
            results.append({
                "boxes": preds["boxes"][i][v].tolist(),
                "scores": preds["scores"][i][v].tolist(),
                "labels": preds["labels"][i][v].tolist(),
            })
    if results:
        with open(os.path.join(args.out, "predictions.json"), "w") as f:
            json.dump(results, f)
    logger.info("wrote %d predictions to %s", len(results) + n_seg, args.out)


if __name__ == "__main__":
    main()
