"""NanoDet v1 and YOLOv6 end to end through the port's ``Trainer.run()``
and ``infer.main`` on the CPU, from their configs as written with the
dataset swapped for ``SyntheticDetection`` and the sizes cut.

``conf/coco_nanodet.yml`` (ShuffleNetV2-1.0, PAN, its letterbox, affine,
flip and HSV transforms, AMP, EMA) cut to 107×160 frames letterboxed to
128² at batch 2: two steps, bbox validation, then the served boxes equal
the predict step's on the checkpoint's EMA weights, un-letterboxed.
``conf/coco_yolov6_s.yml`` at yolov6_n's multipliers (mosaic + affine at
128², flip, HSV) for five epochs of one step: the loss assigns with ATSS
in epochs 0–3 and TAL in epoch 4, from the host integer the trainer puts
in the targets, and the val epoch (epoch 4) runs the TAL branch.
"""
import json
import os

import numpy as np
import torch

from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models import yolov6
from cvpytorch_tpu_torch.train_state import make_predict_step
from cvpytorch_tpu_torch.trainer import Trainer
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DICTIONARY = [{f"c{i}": 1.0} for i in range(4)]
FRAME = [107, 160]


def write_config(tmp_path, name, epochs=1, train_len=4, size=128):
    dict_path = tmp_path / "dict.json"
    dict_path.write_text(json.dumps({"DET_CLASSES": DICTIONARY}))
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", f"{name}.yml"))
    data = cfg.DATASET
    data.CLASS = "SyntheticDetection"
    data.DICTIONARY = str(dict_path)
    data.MAX_BOXES = 16
    for stage, length in ((data.TRAIN, train_len), (data.VAL, 4)):
        stage.update({"SIZE": FRAME, "LENGTH": length, "SEED": 1, "BATCH_SIZE": 2,
                      "NUM_WORKER": 2})
        for t in ("Resize", "RandomAffineWithMosaic"):
            if t in stage.TRANSFORMS:
                stage.TRANSFORMS[t]["size"] = [size, size]
    data.INFER = dict(data.VAL)
    cfg.EVALUATOR.EVAL_INTERVALS = epochs
    cfg.update({"N_MAX_EPOCHS": epochs, "CHECKPOINT_DIR": str(tmp_path / "ckpts"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return str(path)


def test_nanodet_v1_trains_validates_and_serves(tmp_path):
    setting = write_config(tmp_path, "coco_nanodet")
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    assert [type(t).__name__ for t in trainer.datasets["train"].transform.transforms] == [
        "Resize", "RandomAffine", "RandomHorizontalFlip", "ColorHSV", "ToTensor", "Normalize"]
    results = []
    val_epoch = trainer.val_epoch
    trainer.val_epoch = lambda *a: results.append(val_epoch(*a)) or results[-1]
    state = trainer.run()
    model = state.model
    assert model.v1 and model.strides == (8, 16, 32) and type(model.neck).__name__ == "PAN"
    assert state.step == 2 and state.ema is not None
    (perf, metrics), = results
    assert np.isfinite(perf) and perf == metrics["mAP"]

    infer.main(["--setting", setting, "--checkpoint",
                os.path.join(trainer.checkpoints.save_dir, "last.pt"),
                "--out", str(tmp_path / "served"), "--device", "cpu"])
    got = json.loads((tmp_path / "served" / "predictions.json").read_text())
    batch = next(iter(torch.utils.data.DataLoader(
        trainer.datasets["val"], batch_size=4, collate_fn=trainer.dataloaders["val"].collate_fn)))
    t = batch["target"]
    want = make_predict_step(state.ema)(
        torch.from_numpy(np.asarray(batch["image"])),
        {"pads": torch.from_numpy(np.asarray(t["pads"])),
         "scales": torch.from_numpy(np.asarray(t["scales"]))})
    assert len(got) == 4
    for i, g in enumerate(got):
        v = want["valid"][i]
        assert g["labels"] == want["labels"][i][v].tolist()
        np.testing.assert_allclose(g["boxes"], want["boxes"][i][v].numpy(), atol=1e-3)


def test_yolov6_switches_from_atss_to_tal_at_epoch_4(tmp_path, monkeypatch):
    setting = write_config(tmp_path, "coco_yolov6_s", epochs=5, train_len=2)
    cfg = CommonConfiguration.from_file(setting)
    cfg.USE_MODEL.TYPE = "yolov6_n"
    calls = []
    loss = yolov6.yolov6_loss

    def spy(preds, priors, targets, num_classes, num_level_priors=None, epoch=None,
            warmup_epoch=4):
        assert epoch is None or type(epoch) is int  # a host integer, never a device value
        calls.append(epoch)
        return loss(preds, priors, targets, num_classes, num_level_priors, epoch, warmup_epoch)

    monkeypatch.setattr(yolov6, "yolov6_loss", spy)
    branches = []
    atss, tal = yolov6.atss_assign, yolov6.tal_assign
    monkeypatch.setattr(yolov6, "atss_assign", lambda *a, **k: branches.append("atss") or atss(*a, **k))
    monkeypatch.setattr(yolov6, "tal_assign", lambda *a, **k: branches.append("tal") or tal(*a, **k))
    trainer = Trainer(cfg, device="cpu")
    assert [type(t).__name__ for t in trainer.datasets["train"].transform.transforms] == [
        "RandomAffineWithMosaic", "RandomHorizontalFlip", "ColorHSV", "ToTensor", "Normalize"]
    state = trainer.run()
    assert state.step == 5
    # five train steps (epochs 0-4), then the val epoch's two batches (epoch 4)
    assert calls == [0, 1, 2, 3, 4, 4, 4]
    assert branches == ["atss"] * 4 + ["tal"] * 3
