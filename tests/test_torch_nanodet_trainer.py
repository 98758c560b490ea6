"""The port's NanoDet-Plus path end to end on the CPU, and its host
transforms against the JAX package.

``Trainer.run()`` on ``conf/coco_nanodetplus.yml``'s recipe (AdamW with
weight decay 0.05, cosine schedule, warmup, AMP, EMA, its letterbox,
flip, ``ColorHSV`` p=1, bbox validation) cut to 107×160
``SyntheticDetection`` frames letterboxed to 128² at batch 2, from seeded
weights; then ``infer.main`` on the trained checkpoint (its EMA weights),
against the JAX model on the same weights and images, given the same
``pads``/``scales`` as targets: labels equal, boxes and scores within
1e-4, boxes in the original frame's pixels.
"""
import copy
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets.synthetic import SyntheticDetection as JaxSyntheticDetection
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms import det_transforms as jax_det
from cvpytorch_tpu.models.nanodet_plus import NanoDetPlus as JaxNanoDetPlus
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.data.datasets.synthetic import SyntheticDetection
from cvpytorch_tpu_torch.data.transforms import build_transforms
from cvpytorch_tpu_torch.data.transforms import det_transforms
from cvpytorch_tpu_torch.models.nanodet_plus import NanoDetPlus
from cvpytorch_tpu_torch.trainer import Trainer
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_cls_trainer import port_to_jax
from tests.test_torch_rcnn_ops import fill_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DICTIONARY = [{f"c{i}": 1.0} for i in range(4)]
FRAME = [107, 160]  # letterboxed to 128²: scale 0.8, 21 rows of padding above


# -- host transforms ------------------------------------------------------------------
def det_sample(seed, shape=(96, 100, 3)):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, shape).astype(np.uint8),
            "target": {"boxes": np.array([[3, 4, 50, 60]], np.float32),
                       "labels": np.array([1], np.int32)}}


@pytest.mark.parametrize("width", [100, 320, 427])
@pytest.mark.parametrize("p", [0.5, 1.0])
def test_color_hsv_equals_jax(p, width):
    """Under one seed of ``random`` and of numpy's global RNG (the gains
    come from ``np.random.uniform``): the image equal, and both streams
    left where the JAX transform leaves them.  Widths of a 32-pixel
    multiple and with a row tail (OpenCV's HSV2BGR rounds there)."""
    for seed in range(4):
        sample = det_sample(seed, (40, width, 3))
        random.seed(seed)
        np.random.seed(seed)
        want = jax_det.ColorHSV(p=p, hue=0.015, saturation=0.7, value=0.4)(copy.deepcopy(sample))
        after = random.random(), np.random.rand()
        random.seed(seed)
        np.random.seed(seed)
        got = build_transforms("DET_CLASSES", {"ColorHSV": {
            "p": p, "hue": 0.015, "saturation": 0.7, "value": 0.4}})(copy.deepcopy(sample))
        assert (random.random(), np.random.rand()) == after
        np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("stage", ["TRAIN", "VAL"])
def test_nanodetplus_pipelines_equal_jax(stage):
    """``conf/coco_nanodetplus.yml``'s pipelines as written on 427×640
    synthetic frames (letterboxed to 320: not an exact half), over 4
    items: float images, boxes, pads and scales equal."""
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", "coco_nanodetplus.yml"))
    tcfg = cfg.DATASET.get(stage).TRANSFORMS.data
    data = {"SIZE": [427, 640], "LENGTH": 4, "SEED": 7, "MAX_BOXES": 64}
    port = SyntheticDetection(CommonConfiguration(data), DICTIONARY,
                              build_transforms("DET_CLASSES", tcfg, stage.lower()))
    ref = JaxSyntheticDetection(JaxConfig(data), DICTIONARY,
                                jax_build_transforms("DET_CLASSES", tcfg, stage.lower()))
    for i in range(4):
        random.seed(30 + i)
        np.random.seed(30 + i)
        want = ref[i]
        random.seed(30 + i)
        np.random.seed(30 + i)
        got = port[i]
        assert got["image"].shape == (320, 320, 3) and got["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])
        for key in ("boxes", "labels", "pads", "scales"):
            np.testing.assert_array_equal(got["target"][key], want["target"][key])


def test_color_hsv_is_no_longer_refused():
    assert not hasattr(det_transforms, "NEEDS_OPENCV")  # no det transform is refused
    assert det_transforms.DET_TRANSFORMS["ColorHSV"] is det_transforms.ColorHSV


# -- Trainer.run() and infer.main ----------------------------------------------------
def seeded_checkpoint(tmp_path):
    jm = JaxNanoDetPlus(dictionary=tuple(DICTIONARY), model_cfg={})
    x = jnp.zeros((2, 128, 128, 3))
    t = {"boxes": jnp.zeros((2, 4, 4)), "labels": jnp.zeros((2, 4), jnp.int32),
         "valid": jnp.zeros((2, 4), bool)}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, t, mode="train"))
    model = load_jax_variables(NanoDetPlus(dictionary=DICTIONARY, model_cfg={}),
                               fill_tree(shapes, 3))
    path = tmp_path / "seeded.pt"
    torch.save(model.state_dict(), path)
    return str(path), jm, shapes


def write_config(tmp_path, pretrained):
    dict_path = tmp_path / "dict.json"
    dict_path.write_text(json.dumps({"DET_CLASSES": DICTIONARY}))
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", "coco_nanodetplus.yml"))
    data = cfg.DATASET
    data.CLASS = "SyntheticDetection"
    data.DICTIONARY = str(dict_path)
    for stage, length in ((data.TRAIN, 4), (data.VAL, 4)):
        stage.update({"SIZE": FRAME, "LENGTH": length, "SEED": 1, "BATCH_SIZE": 2,
                      "NUM_WORKER": 2})
        stage.TRANSFORMS.Resize.size = [128, 128]
    data.INFER = dict(data.VAL)
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(tmp_path / "ckpts"),
                "PRETRAIN_MODEL": pretrained, "TENSORBOARD": False,
                "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = tmp_path / "nanodetplus.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return str(path), cfg


def test_trainer_validates_and_serves_the_jax_predictions(tmp_path):
    pretrained, jm, shapes = seeded_checkpoint(tmp_path)
    setting, cfg = write_config(tmp_path, pretrained)
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    assert [type(t).__name__ for t in trainer.datasets["train"].transform.transforms] == [
        "Resize", "RandomHorizontalFlip", "ColorHSV", "ToTensor", "Normalize"]
    results = []
    val_epoch = trainer.val_epoch
    trainer.val_epoch = lambda *a: results.append(val_epoch(*a)) or results[-1]
    state = trainer.run()
    assert state.step == 2 and state.ema is not None
    assert sorted(os.listdir(trainer.checkpoints.save_dir)) == ["best.pt", "deploy.pt", "last.pt"]
    (perf, metrics), = results
    assert np.isfinite(perf) and perf == metrics["mAP"]

    infer.main(["--setting", setting, "--checkpoint",
                os.path.join(trainer.checkpoints.save_dir, "last.pt"),
                "--out", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads((tmp_path / "port" / "predictions.json").read_text())

    # the oracle: the JAX pipeline's images and the JAX model on the served
    # (EMA) weights, with the letterbox's pads/scales as targets
    variables = port_to_jax(state.ema.cpu(), shapes)
    stage = JaxConfig(cfg.DATASET.VAL.data)
    ds = JaxSyntheticDetection(stage, DICTIONARY,
                               jax_build_transforms("DET_CLASSES", stage.TRANSFORMS, "val"),
                               stage="val")
    batch = jax_det.make_det_collate(64)([ds[i] for i in range(4)])
    t = batch["target"]
    np.testing.assert_array_equal(t["pads"], np.tile([[0, 21]], (4, 1)))
    want = jm.apply(variables, jnp.asarray(batch["image"]),
                    {"pads": jnp.asarray(t["pads"]), "scales": jnp.asarray(t["scales"])},
                    mode="infer")
    want = {k: np.asarray(v) for k, v in want.items()}
    assert len(got) == 4
    for i, g in enumerate(got):
        v = want["valid"][i]
        assert len(g["labels"]) > 0
        assert g["labels"] == want["labels"][i][v].tolist()
        np.testing.assert_allclose(g["scores"], want["scores"][i][v], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g["boxes"], want["boxes"][i][v], atol=1e-4, rtol=1e-4)
    net = jm.apply(variables, jnp.asarray(batch["image"]), mode="infer")  # network pixels
    assert not np.allclose(got[0]["boxes"], np.asarray(net["boxes"][0])[want["valid"][0]])
