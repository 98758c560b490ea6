"""The port's segmentation path end to end on the CPU: ``Trainer.run()``
on ``conf/cityscapes_unet.yml``'s recipe (SGD 0.9, weight decay 1e-4,
PolyLR 0.9, linear warmup, its transforms, mIoU validation) cut to UNet
``base_channels`` 8 on 64×128 ``SyntheticSegmentation`` frames cropped to
32×64, from seeded weights, then ``infer.main`` on the trained
checkpoint, and the JAX infer CLI on the same weights: the palette PNGs
hold equal predictions.

The dictionary has 6 classes: the JAX ``SyntheticSegmentation`` cannot
paint class 6 or above under numpy 2 (``tests/test_torch_seg_data.py``).
The JAX CLI initialises its state in train mode from an infer batch, which
carries no labels, and loads orbax checkpoints; the test hands it a state
holding the trained port weights carried back to the Flax layout."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import cvpytorch_tpu.data.datasets  # noqa: F401  (registers the JAX datasets)
from cvpytorch_tpu import infer as jax_infer
from cvpytorch_tpu.models.unet import UNet as JaxUNet
from cvpytorch_tpu.train_state import TrainState
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.models.unet import UNet
from cvpytorch_tpu_torch.trainer import Trainer
from cvpytorch_tpu_torch.utils.porting import _flatten, load_jax_variables
from tests.test_torch_rcnn_ops import fill_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DICTIONARY = [{f"c{i}": 1.0} for i in range(6)]


def seeded_checkpoint(tmp_path):
    """Seeded Flax weights carried into a port ``state_dict``, the run's
    ``PRETRAIN_MODEL``: predictions that vary over the image, which two
    steps from torch's initialisation do not give."""
    jm = JaxUNet(dictionary=tuple(DICTIONARY), model_cfg={}, base_channels=8)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3)),
                                            jnp.zeros((1, 32, 64), jnp.int32), mode="train"))
    model = load_jax_variables(UNet(dictionary=DICTIONARY, base_channels=8),
                               fill_tree(shapes, 2))
    path = tmp_path / "seeded.pt"
    torch.save(model.state_dict(), path)
    return str(path), jm, shapes


def write_config(tmp_path, pretrained):
    dict_path = tmp_path / "dict.json"
    dict_path.write_text(json.dumps({"SEG_CLASSES": DICTIONARY}))
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", "cityscapes_unet.yml"))
    data = cfg.DATASET
    data.CLASS = "SyntheticSegmentation"
    data.DICTIONARY = str(dict_path)
    for stage, length in ((data.TRAIN, 4), (data.VAL, 4)):
        stage.update({"SIZE": [64, 128], "LENGTH": length, "SEED": 1, "BATCH_SIZE": 2,
                      "NUM_WORKER": 2})
    data.TRAIN.TRANSFORMS.RandomScaleCrop.size = [32, 64]
    data.VAL.TRANSFORMS.Resize.size = [32, 64]
    data.INFER = dict(data.VAL)
    cfg.USE_MODEL.base_channels = 8
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(tmp_path / "ckpts"),
                "PRETRAIN_MODEL": pretrained,
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = tmp_path / "unet.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return str(path)


def port_to_jax(model, shapes):
    """The port's weights in the Flax tree of ``shapes`` (the inverse of
    ``load_jax_variables`` for convolutions and BN)."""
    state = model.state_dict()
    leaves = {"params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
              "batch_stats": {"mean": "running_mean", "var": "running_var"}}
    out = {}
    for coll, names in leaves.items():
        tree = {}
        for path, _ in _flatten(jax.tree_util.tree_map(lambda s: np.zeros(()), shapes[coll])):
            arr = state[".".join(path[:-1] + (names[path[-1]],))].numpy()
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)  # OIHW → HWIO
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(arr)
        out[coll] = tree
    return out


def test_trainer_validates_miou_and_serves_the_jax_predictions(tmp_path, monkeypatch):
    pretrained, jm, shapes = seeded_checkpoint(tmp_path)
    setting = write_config(tmp_path, pretrained)
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    results = []
    val_epoch = trainer.val_epoch
    trainer.val_epoch = lambda *a: results.append(val_epoch(*a)) or results[-1]
    state = trainer.run()
    assert state.step == 2
    assert sorted(os.listdir(trainer.checkpoints.save_dir)) == ["best.pt", "deploy.pt", "last.pt"]
    (perf, metrics), = results
    assert {"PA", "mPA", "mIoU", "FWIoU", "IoU_c0", "performance"} <= set(metrics)
    assert perf == metrics["mIoU"] and 0 <= perf <= 1

    ckpt = os.path.join(trainer.checkpoints.save_dir, "last.pt")
    infer.main(["--setting", setting, "--checkpoint", ckpt, "--out", str(tmp_path / "port"),
                "--device", "cpu"])

    variables = port_to_jax(state.model.cpu(), shapes)

    def jax_state(model, tx, rng, batch, use_ema=False):
        return TrainState(step=0, params=variables["params"],
                          batch_stats=variables["batch_stats"], opt_state=None,
                          ema_params=None, ema_batch_stats=None, rng=rng,
                          apply_fn=model.apply, tx=tx)

    monkeypatch.setattr(jax_infer, "create_train_state", jax_state)
    monkeypatch.setattr(jax_infer.Checkpoints, "load_weights_into",
                        staticmethod(lambda state, path: state))
    jax_infer.main(["--setting", setting, "--checkpoint", "unused",
                    "--out", str(tmp_path / "jax")])

    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [f"{i:06d}.png" for i in range(4)]
    for name in names:
        got, want = Image.open(tmp_path / "port" / name), Image.open(tmp_path / "jax" / name)
        assert got.size == (64, 32) and got.getpalette() == want.getpalette()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    served = np.stack([np.asarray(Image.open(tmp_path / "port" / n)) for n in names])
    assert len(np.unique(served)) > 1


def test_trainer_refuses_the_tasks_it_does_not_train(tmp_path, monkeypatch):
    """Every task of the JAX package trains in the port (keypoints since
    ROADMAP item 9; datasets and model left out here); a dictionary name
    of no task is refused."""
    monkeypatch.setattr(Trainer, "_parser_datasets", lambda self: None)
    monkeypatch.setattr(Trainer, "_parser_model", lambda self: None)
    for name in ("KEYPOINT_CLASSES", "POSE_CLASSES"):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({name: [{"a": 1.0}]}))
        cfg = CommonConfiguration({"DATASET": {"DICTIONARY": str(path),
                                               "DICTIONARY_NAME": name}})
        if name == "KEYPOINT_CLASSES":
            assert Trainer(cfg, device="cpu").dictionary_name == name
            continue
        with pytest.raises(NotImplementedError, match=f"not {name}"):
            Trainer(cfg, device="cpu")
