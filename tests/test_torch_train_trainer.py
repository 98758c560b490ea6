"""The port's ``Trainer.run()`` on the CPU: the two configurations of
``tests/test_trainer_det.py`` (host collate, and ``DEVICE_AUG``) end to end
with the checkpoint served through the port's ``infer.main``, and the
detection convergence proof of ``tests/test_convergence.py``."""
import json
import os

import numpy as np
import pytest

from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.train_state import make_eval_step
from cvpytorch_tpu_torch.trainer import Trainer
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

NORMALIZE = {"mean": [0, 0, 0], "std": [1, 1, 1]}
VAL_64 = {"LENGTH": 8, "SIZE": [96, 96], "BATCH_SIZE": 8, "NUM_WORKER": 2,
          "SHUFFLE": False,
          "TRANSFORMS": {"Resize": {"size": [64, 64], "keep_ratio": True},
                         "ToTensor": None, "Normalize": NORMALIZE}}


def write_config(tmp_path, train, val, **top):
    dict_path = tmp_path / "dict.json"
    dict_path.write_text(json.dumps({"DET_CLASSES": [{"thing": 1.0}, {"stuff": 1.0}]}))
    cfg = {
        "EXPERIMENT_NAME": "det_smoke",
        "DATASET": {"CLASS": "SyntheticDetection", "DICTIONARY": str(dict_path),
                    "DICTIONARY_NAME": "DET_CLASSES", "MAX_BOXES": 16,
                    "TRAIN": train, "VAL": val},
        "USE_MODEL": {"CLASS": "src.models.yolov5.YOLOv5", "TYPE": "yolov5_n",
                      "LOSS": {"name": "YOLOv5Loss", "hyp_box": 0.05,
                               "hyp_obj": 1.0, "hyp_cls": 0.5}},
        "CHECKPOINT_DIR": str(tmp_path / "ckpts"),
        "INIT_LR": 0.01, "OPTIMIZER": {"TYPE": "SGD", "MOMENTUM": 0.9},
        "LR_SCHEDULER": {"TYPE": "CosineAnnealingLR"},
        "AMP": False, "EMA": False, "TENSORBOARD": False,
        "N_ITERS_TO_DISPLAY_STATUS": 2, **top,
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


HOST = dict(
    train={"LENGTH": 32, "SIZE": [96, 96], "BATCH_SIZE": 8, "NUM_WORKER": 2,
           "SHUFFLE": True,
           "TRANSFORMS": {"Resize": {"size": [64, 64], "keep_ratio": True},
                          "RandomHorizontalFlip": {"p": 0.5},
                          "ToTensor": None, "Normalize": NORMALIZE}},
    top={"EVALUATOR": {"NAME": "coco_detection", "EVAL_TYPE": "mAP", "EVAL_INTERVALS": 2},
         "N_MAX_EPOCHS": 2, "EMA": True})
DEVICE_AUG = dict(
    train={"LENGTH": 16, "SIZE": [96, 96], "BATCH_SIZE": 8, "NUM_WORKER": 2,
           "SHUFFLE": True, "LOAD_NUM": 4, "DEVICE_AUG": {"SIZE": 64}},
    top={"EVALUATOR": {"NAME": "coco_detection", "EVAL_TYPE": "mAP", "EVAL_INTERVALS": 5},
         "N_MAX_EPOCHS": 1})


@pytest.mark.parametrize("case", [HOST, DEVICE_AUG], ids=["host", "device_aug"])
def test_trainer_runs_and_its_checkpoint_serves(tmp_path, case):
    setting = write_config(tmp_path, case["train"], VAL_64, **case["top"])
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    state = trainer.run()
    assert state.step == trainer.iters_per_epoch * trainer.n_epochs
    assert all(np.isfinite(p.detach().numpy()).all() for p in state.model.parameters())
    saved = sorted(os.listdir(trainer.checkpoints.save_dir))
    assert saved == (["best.pt", "deploy.pt", "last.pt"] if case is HOST else ["last.pt"])
    perf, metrics = trainer.val_epoch(99, state, make_eval_step(use_ema=False), None)
    assert "mAP" in metrics and perf >= 0.0

    infer.main(["--setting", setting, "--checkpoint",
                os.path.join(trainer.checkpoints.save_dir, "last.pt"),
                "--out", str(tmp_path / "served"), "--device", "cpu"])
    preds = json.loads((tmp_path / "served" / "predictions.json").read_text())
    assert len(preds) == VAL_64["LENGTH"]
    assert all(len(p["boxes"]) == len(p["scores"]) == len(p["labels"]) for p in preds)


def test_detection_learns(tmp_path):
    """YOLOv5-n on 8 synthetic 64² images, Adam, val on the same images
    (overfit protocol of ``tests/test_convergence.py``): mAP ≥ 0.5 after
    200 epochs.  Measured on the CPU with SEED 1029 (the default), 1 and
    2: mAP 0.82, 0.83 and 0.77 at 200 epochs, 0.96, 0.97 and 0.93 at 300.
    (At 96² it took the JAX proof's 300 epochs, 0.97 each; runs of 200 and
    150 epochs reached 0.72–0.77 and 0.33–0.44 there.)"""
    data = {"LENGTH": 8, "SIZE": [64, 64], "BATCH_SIZE": 8, "NUM_WORKER": 2,
            "TRANSFORMS": {"ToTensor": None, "Normalize": NORMALIZE}}
    setting = write_config(
        tmp_path, {**data, "SHUFFLE": True}, {**data, "SHUFFLE": False},
        EVALUATOR={"NAME": "coco_detection", "EVAL_TYPE": "mAP", "EVAL_INTERVALS": 1000},
        WARMUP={"NAME": "linear", "ITERS": 8, "FACTOR": 0.1}, N_MAX_EPOCHS=200,
        OPTIMIZER={"TYPE": "Adam"}, N_ITERS_TO_DISPLAY_STATUS=1000,
        N_EPOCHS_TO_SAVE_MODEL=1000)
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    trainer.dataloaders["val"].dataset._seeds = trainer.dataloaders["train"].dataset._seeds
    state = trainer.run()
    perf, metrics = trainer.val_epoch(99, state, make_eval_step(use_ema=False), None)
    assert perf >= 0.5, metrics


@pytest.mark.parametrize("key, value", [
    ("PARALLEL", {"MESH": [1, 1]}),
    ("PROFILER", {"DIR": "traces", "START_STEP": 2, "NUM_STEPS": 1}),
    ("AMP_BN_BF16_STATS", True)])
def test_trainer_refuses_the_keys_it_does_not_port(tmp_path, key, value):
    """The JAX mesh (``PARALLEL``) is the one key the port still refuses,
    naming its ROADMAP item.  ``PROFILER`` traces exactly steps
    START_STEP … START_STEP + NUM_STEPS − 1 into a Chrome trace under DIR;
    ``AMP_BN_BF16_STATS`` switches this trainer's model's BNs to bfloat16
    moments and a later trainer's model starts from off.  Unset (or an
    empty mapping) no key is read."""
    if key == "PARALLEL":
        with pytest.raises(NotImplementedError, match="PARALLEL .*ROADMAP, Queue 1 item 11"):
            Trainer(CommonConfiguration({key: value}), device="cpu")
    elif key == "PROFILER":
        train = {**VAL_64, "LENGTH": 24, "SHUFFLE": True}
        trainer = Trainer(CommonConfiguration.from_file(write_config(
            tmp_path, train, dict(VAL_64), N_MAX_EPOCHS=1,
            PROFILER={**value, "DIR": str(tmp_path / "traces")})), device="cpu")
        trainer.run()
        assert trainer.trace_path == str(tmp_path / "traces" / "trace_steps_2-2.json")
        events = json.loads(open(trainer.trace_path).read())["traceEvents"]
        steps = {e["name"] for e in events if e.get("name", "").startswith("train_step_")}
        assert steps == {"train_step_2"}
    else:
        bns = lambda t: [m for m in t.model.modules() if hasattr(m, "bf16_stats")]
        on = Trainer(CommonConfiguration.from_file(write_config(
            tmp_path, dict(VAL_64), dict(VAL_64), AMP=True, **{key: value})), device="cpu")
        assert bns(on) and all(m.bf16_stats for m in bns(on))
        off = Trainer(CommonConfiguration.from_file(write_config(
            tmp_path, dict(VAL_64), dict(VAL_64), AMP=True)), device="cpu")
        assert not any(m.bf16_stats for m in bns(off))
        assert all(m.bf16_stats for m in bns(on))
    cfg = write_config(tmp_path, dict(VAL_64), dict(VAL_64), **{key: {}})
    assert Trainer(CommonConfiguration.from_file(cfg), device="cpu").cfg.get(key) == {}
