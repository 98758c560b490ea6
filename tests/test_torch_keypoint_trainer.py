"""The keypoint task through the port's entry points on the CPU.

OpenPose over the config of ``tests/test_paf.py``'s JAX end-to-end test
(``CocoKeypoint`` of 96² frames, ResNet-18 to stage 2, 2 stages,
``coco_keypoints``; the last stage's maps replaced by the frames' people
rendered, so that there are people to decode) through ``Trainer.run()``:
its OKS and box stats equal
what the JAX package's ``CocoEvaluator`` gives on the same targets and
predictions, and ``infer.main`` serves the people that the JAX package's
``openpose_decode`` → ``instances_to_eval`` give on the predict step's
maps.  ``coco_litepose`` cut to 64² fails at its first train step (the
collated (B, M, 17, 3) keypoints: the JAX model fails there too,
``tests/test_torch_pose_heads.py``), and its checkpoint serves the
flattened decode, as the JAX CLI's else-branch writes it.

Tolerances: stats equal; served keypoints, boxes and scores within 1e-5.
"""
import copy
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.evaluator.coco import CocoEvaluator as JaxCocoEvaluator
from cvpytorch_tpu.ops import paf as J
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.infer import build_model
from cvpytorch_tpu_torch.models import keypoint
from cvpytorch_tpu_torch.ops.paf import render_openpose_targets
from cvpytorch_tpu_torch.train_state import make_predict_step
from cvpytorch_tpu_torch.trainer import Trainer
from tests.test_torch_jpeg import scene
from tests.test_torch_keypoint_data import write_person_keypoints
from tests.test_torch_paf import skeleton
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stage(img_dir, ann_file, size, shuffle):
    return {"IMG_DIR": img_dir, "ANN_FILE": ann_file, "BATCH_SIZE": 2, "NUM_WORKER": 2,
            "SHUFFLE": shuffle,
            "TRANSFORMS": {"Resize": {"size": [size, size], "keep_ratio": True},
                           "ToTensor": None, "Normalize": {"mean": [0, 0, 0], "std": [1, 1, 1]}}}


# three people on every 96² frame
PEOPLE = np.stack([skeleton(24, 38, 0.3), skeleton(70, 36, 0.3), skeleton(48, 46, 0.28)])


def openpose_config(tmp_path, n_images=5):
    """``tests/test_paf.py:192-236``'s config, on a written directory of
    96² frames, each with the three ``PEOPLE``."""
    img_dir = tmp_path / "coco" / "images"
    img_dir.mkdir(parents=True)
    images, anns = [], []
    for i in range(n_images):
        cv2.imwrite(str(img_dir / f"{i}.jpg"), scene(96, 96, i))
        images.append({"id": i + 1, "file_name": f"{i}.jpg", "height": 96, "width": 96})
        for k in PEOPLE:
            x1, y1 = k[:, :2].min(0) - 2
            x2, y2 = k[:, :2].max(0) + 2
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                         "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                         "iscrowd": 0, "area": float((x2 - x1) * (y2 - y1) * 0.5),
                         "keypoints": k.reshape(-1).tolist(), "num_keypoints": 17})
    ann_file = tmp_path / "coco" / "person_keypoints.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": anns,
                                    "categories": [{"id": 1, "name": "person"}]}))
    dict_path = tmp_path / "dict.json"
    dict_path.write_text(json.dumps({"KEYPOINT_CLASSES": [{"person": 1.0}]}))
    cfg = {
        "EXPERIMENT_NAME": "openpose_e2e",
        "DATASET": {"CLASS": "CocoKeypoint", "DICTIONARY": str(dict_path),
                    "DICTIONARY_NAME": "KEYPOINT_CLASSES", "MAX_BOXES": 8,
                    "TRAIN": stage(str(img_dir), str(ann_file), 96, True),
                    "VAL": stage(str(img_dir), str(ann_file), 96, False)},
        "USE_MODEL": {"CLASS": "src.models.openpose.OpenPose", "num_stages": 2,
                      "BACKBONE": {"name": "ResNet", "subtype": "resnet18", "out_stages": [2]}},
        "EVALUATOR": {"NAME": "coco_keypoints", "EVAL_TYPE": "keypoints_mAP",
                      "EVAL_INTERVALS": 1},
        "CHECKPOINT_DIR": str(tmp_path / "ckpts"), "N_MAX_EPOCHS": 1, "INIT_LR": 0.001,
        "OPTIMIZER": {"TYPE": "SGD", "MOMENTUM": 0.9},
        "LR_SCHEDULER": {"TYPE": "CosineAnnealingLR"}, "AMP": False, "EMA": False,
        "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0}
    path = tmp_path / "openpose.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def people_maps(monkeypatch):
    """The last stage's maps become the rendered targets of ``PEOPLE`` (a
    trained model's, which random weights are not), so that the val
    decode, the evaluator and the served people hold people."""
    stages = keypoint.OpenPose.stages

    def with_people(self, images):
        hms, pafs = stages(self, images)
        kp = torch.from_numpy(PEOPLE).to(images.device)[None].repeat(len(images), 1, 1, 1)
        hm, paf = render_openpose_targets(kp, torch.ones(kp.shape[:2]), tuple(images.shape[1:3]))
        return hms[:-1] + [hm.permute(0, 3, 1, 2)], pafs[:-1] + [paf.permute(0, 3, 1, 2)]

    monkeypatch.setattr(keypoint.OpenPose, "stages", with_people)


def test_openpose_trains_validates_and_serves(tmp_path, monkeypatch):
    people_maps(monkeypatch)
    setting = openpose_config(tmp_path)
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    seen, results = [], []
    update = trainer.evaluator.update
    trainer.evaluator.update = lambda t, p: seen.append(copy.deepcopy((t, p))) or update(t, p)
    val_epoch = trainer.val_epoch
    trainer.val_epoch = lambda *a: results.append(val_epoch(*a)) or results[-1]
    state = trainer.run()
    assert state.step == 2
    (perf, metrics), = results
    assert set(seen[0][1]) == {"heatmaps", "pafs", "peaks_xy", "peaks_score", "conns", "stride"}
    want = JaxCocoEvaluator(trainer.datasets["val"], num_classes=1, eval_type="keypoints_mAP",
                            iou_types=("bbox", "keypoints"))
    for t, p in seen:
        want.update(t, p)
    assert metrics == want.evaluate()
    assert perf == metrics["keypoints_mAP"] > 0.5 and metrics["keypoints_Recall_20"] > 0.5

    infer.main(["--setting", setting, "--checkpoint",
                os.path.join(trainer.checkpoints.save_dir, "last.pt"),
                "--out", str(tmp_path / "served"), "--device", "cpu"])
    got = json.loads((tmp_path / "served" / "predictions.json").read_text())
    assert len(got) == 5 and set(got[0]) == {"keypoints", "boxes", "scores"}
    ds = trainer.datasets["val"]
    items = [ds.transform(ds._load_one(i)) for i in range(4)]
    maps = make_predict_step(state.model)(torch.from_numpy(np.stack([it["image"] for it in items])))
    letterbox = {k: np.stack([it["target"][k] for it in items]) for k in ("pads", "scales")}
    want = J.instances_to_eval(J.openpose_decode(jnp.asarray(maps["heatmaps"].numpy()),
                                                 jnp.asarray(maps["pafs"].numpy())),
                               96 // maps["heatmaps"].shape[1], letterbox)
    for i, g in enumerate(got[:4]):
        v = want["valid"][i]
        assert v.sum() >= 3
        for key in ("keypoints", "boxes", "scores"):
            np.testing.assert_allclose(np.reshape(g[key], want[key][i][v].shape),
                                       want[key][i][v], atol=1e-5, err_msg=key)


def litepose_config(tmp_path):
    """``conf/coco_litepose.yml`` as written but for the data: 64² crops,
    batch 2, a written ``person_keypoints`` directory."""
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", "coco_litepose.yml"))
    img_dir, ann_file = write_person_keypoints(tmp_path / "coco", n_images=4)
    for s in (cfg.DATASET.TRAIN, cfg.DATASET.VAL):
        s.update({"IMG_DIR": img_dir, "ANN_FILE": ann_file, "BATCH_SIZE": 2, "NUM_WORKER": 2})
    cfg.DATASET.TRAIN.TRANSFORMS.RandomResizedCrop["size"] = [64, 64]
    cfg.DATASET.VAL.TRANSFORMS.Resize["size"] = [64, 64]
    cfg.DATASET.DICTIONARY = os.path.join(ROOT, cfg.DATASET.DICTIONARY)
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(tmp_path / "ckpts"),
                "TENSORBOARD": False, "SEED": 0})
    path = tmp_path / "litepose.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return str(path)


def test_litepose_config_fails_where_jax_fails_and_serves(tmp_path):
    setting = litepose_config(tmp_path)
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    with pytest.raises(ValueError, match=r"single-instance keypoints"):
        trainer.run()
    ckpt = tmp_path / "litepose.pt"
    torch.save(trainer.model.state_dict(), ckpt)
    infer.main(["--setting", setting, "--checkpoint", str(ckpt),
                "--out", str(tmp_path / "served"), "--device", "cpu"])
    got = json.loads((tmp_path / "served" / "predictions.json").read_text())
    ds = trainer.datasets["val"]
    served = build_model(CommonConfiguration.from_file(setting), trainer.dictionary)
    served.load_state_dict(torch.load(ckpt))
    items = [ds.transform(ds._load_one(i)) for i in range(len(ds))]
    want = make_predict_step(served)(torch.from_numpy(np.stack([it["image"] for it in items])))
    assert want.shape == (len(ds), 17, 3)
    np.testing.assert_allclose(got, want.numpy().reshape(-1).tolist(), atol=1e-5)
