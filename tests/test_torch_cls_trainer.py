"""The port's classification path end to end on the CPU: ``Trainer.run()``
on ``conf/mini-imagenet.yml``'s recipe (AdamW with weight decay 0.01,
cosine schedule with linear warmup, AMP, its transforms, mAcc validation)
cut to MobileNetV2 at width 0.35 on 48×64 ``SyntheticClassification``
frames cropped to 32², from seeded weights; then ``infer.main`` on the
trained checkpoint, and the JAX infer CLI on the same weights: the class
ids of ``predictions.json`` are equal.

The dictionary has 6 classes: the JAX ``SyntheticClassification`` cannot
paint class 7 or above under numpy 2.  The JAX CLI initialises its state
in train mode from an infer batch, which carries no labels, and loads
orbax checkpoints; the test hands it a state holding the trained port
weights carried back to the Flax layout."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import cvpytorch_tpu.data.datasets  # noqa: F401  (registers the JAX datasets)
from cvpytorch_tpu import infer as jax_infer
from cvpytorch_tpu.models.classification import Classification as JaxClassification
from cvpytorch_tpu.train_state import TrainState
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.data.datasets.synthetic import SyntheticClassification
from cvpytorch_tpu_torch.data.transforms import build_transforms
from cvpytorch_tpu_torch.models.classification import Classification
from cvpytorch_tpu_torch.trainer import Trainer
from cvpytorch_tpu_torch.utils.porting import _flatten, load_jax_variables
from tests.test_torch_rcnn_ops import fill_tree
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DICTIONARY = [{f"c{i}": 1.0} for i in range(6)]
BACKBONE = {"name": "MobileNetV2", "classifier": True, "width_mult": 0.35}


def port_to_jax(model, shapes):
    """The port's weights in the Flax tree of ``shapes``: the inverse of
    ``load_jax_variables`` for convolutions (OIHW → HWIO), linear layers
    ((out, in) → (in, out)) and BN."""
    state = model.state_dict()
    leaves = {"params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
              "batch_stats": {"mean": "running_mean", "var": "running_var"}}
    out = {}
    for coll, names in leaves.items():
        tree = {}
        for path, _ in _flatten(jax.tree_util.tree_map(lambda s: np.zeros(()), shapes[coll])):
            arr = state[".".join(path[:-1] + (names[path[-1]],))].cpu().numpy()
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(arr)
        out[coll] = tree
    return out


def jax_cli_serves(monkeypatch, variables, setting, out):
    """The JAX infer CLI on ``setting`` with ``variables`` as its state."""
    def jax_state(model, tx, rng, batch, use_ema=False):
        return TrainState(step=0, params=variables["params"],
                          batch_stats=variables["batch_stats"], opt_state=None,
                          ema_params=None, ema_batch_stats=None, rng=rng,
                          apply_fn=model.apply, tx=tx)

    monkeypatch.setattr(jax_infer, "create_train_state", jax_state)
    monkeypatch.setattr(jax_infer.Checkpoints, "load_weights_into",
                        staticmethod(lambda state, path: state))
    jax_infer.main(["--setting", setting, "--checkpoint", "unused", "--out", out])


def seeded_checkpoint(tmp_path):
    """Seeded Flax weights carried into a port ``state_dict``, the run's
    ``PRETRAIN_MODEL``.  A random MobileNetV2 pools nearly the same
    features from every image (their spread is ~1e-3 of the logits'), so
    the ``fc`` bias is set to centre the logits over the val images, and
    the served class ids vary."""
    model_cfg = {"BACKBONE": BACKBONE}
    jm = JaxClassification(dictionary=tuple(DICTIONARY), model_cfg=model_cfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            jnp.zeros((1,), jnp.int32), mode="val"))
    model = load_jax_variables(Classification(dictionary=DICTIONARY, model_cfg=model_cfg),
                               fill_tree(shapes, 2)).eval()
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", "mini-imagenet.yml"))
    tcfg = {**cfg.DATASET.VAL.TRANSFORMS.data, "Resize": {"size": [32, 32]}}
    ds = SyntheticClassification(CommonConfiguration({"SIZE": [48, 64], "LENGTH": 6, "SEED": 1}),
                                 DICTIONARY, build_transforms("CLS_CLASSES", tcfg), stage="val")
    x = torch.from_numpy(np.stack([ds[i]["image"] for i in range(len(ds))]))
    with torch.no_grad():
        model.backbone.fc.bias -= model.backbone(x.permute(0, 3, 1, 2)).mean(0)
    path = tmp_path / "seeded.pt"
    torch.save(model.state_dict(), path)
    return str(path), shapes


def write_config(tmp_path, pretrained):
    dict_path = tmp_path / "dict.json"
    dict_path.write_text(json.dumps({"CLS_CLASSES": DICTIONARY}))
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", "mini-imagenet.yml"))
    data = cfg.DATASET
    data.CLASS = "SyntheticClassification"
    data.DICTIONARY = str(dict_path)
    for stage, length in ((data.TRAIN, 8), (data.VAL, 6)):
        stage.update({"SIZE": [48, 64], "LENGTH": length, "SEED": 1, "BATCH_SIZE": 4,
                      "NUM_WORKER": 2})
    data.TRAIN.TRANSFORMS.RandomResizedCrop.size = [32, 32]
    data.VAL.TRANSFORMS.Resize.size = [32, 32]
    data.INFER = dict(data.VAL)
    cfg.USE_MODEL.BACKBONE = BACKBONE
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(tmp_path / "ckpts"),
                "PRETRAIN_MODEL": pretrained, "TENSORBOARD": False,
                "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = tmp_path / "mini_imagenet.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return str(path)


def test_trainer_validates_macc_and_serves_the_jax_predictions(tmp_path, monkeypatch):
    pretrained, shapes = seeded_checkpoint(tmp_path)
    setting = write_config(tmp_path, pretrained)
    trainer = Trainer(CommonConfiguration.from_file(setting), device="cpu")
    assert [type(t).__name__ for t in trainer.datasets["train"].transform.transforms] == [
        "RandomResizedCrop", "RandomHorizontalFlip", "ColorJitter", "ToTensor", "Normalize"]
    results = []
    val_epoch = trainer.val_epoch
    trainer.val_epoch = lambda *a: results.append(val_epoch(*a)) or results[-1]
    state = trainer.run()
    assert state.step == 2
    assert sorted(os.listdir(trainer.checkpoints.save_dir)) == ["best.pt", "deploy.pt", "last.pt"]
    (perf, metrics), = results
    assert {"Acc", "mAcc", "Acc_c0", "performance"} <= set(metrics)
    assert perf == metrics["mAcc"] and 0 <= perf <= 1

    # the trained checkpoint, and the seeded one (whose class ids vary: two
    # AdamW steps of 1e-4 outweigh the logits' spread between images)
    seeded = Classification(dictionary=DICTIONARY, model_cfg={"BACKBONE": BACKBONE})
    seeded.load_state_dict(torch.load(pretrained, weights_only=True))
    served = {}
    for name, ckpt, model in (
            ("trained", os.path.join(trainer.checkpoints.save_dir, "last.pt"), state.model),
            ("seeded", pretrained, seeded)):
        infer.main(["--setting", setting, "--checkpoint", ckpt,
                    "--out", str(tmp_path / name / "port"), "--device", "cpu"])
        jax_cli_serves(monkeypatch, port_to_jax(model.cpu(), shapes), setting,
                       str(tmp_path / name / "jax"))
        got = json.loads((tmp_path / name / "port" / "predictions.json").read_text())
        want = json.loads((tmp_path / name / "jax" / "predictions.json").read_text())
        assert got == want and len(got) == 6 and all(isinstance(c, int) for c in got)
        served[name] = got
    assert len(set(served["seeded"])) > 1


def test_cls_batches_stack_scalar_labels(tmp_path):
    pretrained, _ = seeded_checkpoint(tmp_path)
    trainer = Trainer(CommonConfiguration.from_file(write_config(tmp_path, pretrained)),
                      device="cpu")
    batch = next(iter(trainer.dataloaders["val"]))
    assert batch["image"].shape == (4, 32, 32, 3) and batch["image"].dtype == np.float32
    assert batch["target"].shape == (4,) and batch["target"].dtype == np.int32
    # RandomRotation (OpenCV's warp in the JAX package) builds in a trainer
    trainer.cfg.DATASET.TRAIN.TRANSFORMS["RandomRotation"] = {}
    rotated = Trainer(trainer.cfg, device="cpu")
    names = [type(t).__name__ for t in rotated.datasets["train"].transform.transforms]
    assert names[-1] == "RandomRotation"
