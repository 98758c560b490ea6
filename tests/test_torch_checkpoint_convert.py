"""``tools/jax_checkpoint_to_torch.py``: a checkpoint the JAX package's
``Checkpoints`` wrote (orbax) becomes a port checkpoint, and the port's
``infer.main`` on it serves what the JAX model serves with the EMA weights
(labels equal; boxes and scores within 1e-4, as the infer test holds
them).  A weights-only ``deploy`` checkpoint becomes a bare state dict.
The optimizer state is not converted."""
import importlib.util
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets.synthetic import SyntheticDetection as JaxSyntheticDetection
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms.det_transforms import make_det_collate as jax_det_collate
from cvpytorch_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from cvpytorch_tpu.utils.checkpoints import Checkpoints as JaxCheckpoints
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.models.yolov5 import YOLOv5
from cvpytorch_tpu_torch.utils.checkpoints import Checkpoints
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_infer import write_config
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolov5 import DICTIONARY, jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", os.path.join(ROOT, "tools", "jax_checkpoint_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_converted_checkpoint_serves_the_jax_ema_predictions(tmp_path, capsys):
    setting, cfg = write_config(tmp_path)
    jm = JaxYOLOv5(dictionary=DICTIONARY, model_cfg={"TYPE": "yolov5_n"})
    weights, ema = jax_variables(jm, seed=0), jax_variables(jm, seed=1)
    state = SimpleNamespace(
        step=np.int32(12), params=weights["params"], batch_stats=weights["batch_stats"],
        opt_state={"momentum": weights["params"]}, rng=np.zeros(2, np.uint32),
        ema_params=ema["params"], ema_batch_stats=ema["batch_stats"])
    ckpts = JaxCheckpoints(str(tmp_path / "jax"), async_save=False)
    ckpts.autosave_checkpoint(state, epoch=3, is_best=True, extra={"best": 0.25})
    ckpts.wait()

    tool = converter()
    out = str(tmp_path / "port.pt")
    tool.main(["--setting", setting, "--checkpoint", os.path.join(ckpts.save_dir, "last"),
               "--out", out])
    assert "optimizer state is not converted" in capsys.readouterr().out
    payload = Checkpoints.load(out)
    assert payload["step"] == 12 and payload["extra"] == {"best": 0.25, "epoch": 3}
    assert "optimizer" not in payload and set(payload) == {"step", "model", "ema", "extra"}
    port_ema = load_jax_variables(YOLOv5(dictionary=DICTIONARY, model_cfg={"TYPE": "yolov5_n"}),
                                  ema).state_dict()
    for k, v in port_ema.items():
        assert torch.equal(payload["ema"][k], v), k

    infer.main(["--setting", setting, "--checkpoint", out, "--out", str(tmp_path / "served"),
                "--device", "cpu"])
    stage = JaxConfig(cfg["DATASET"]["VAL"])
    ds = JaxSyntheticDetection(stage, list(DICTIONARY),
                               jax_build_transforms("DET_CLASSES", stage.TRANSFORMS, "val"),
                               stage="val")
    batch = jax_det_collate(64)([ds[i] for i in range(4)])
    t = batch["target"]
    want = jax.jit(lambda v, x, tg: jm.apply(v, x, tg, mode="infer"))(
        ema, jnp.asarray(batch["image"]),
        {"pads": jnp.asarray(t["pads"]), "scales": jnp.asarray(t["scales"])})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = json.loads((tmp_path / "served" / "predictions.json").read_text())
    assert len(got) == 4
    for i, g in enumerate(got):
        v = want["valid"][i]
        assert len(g["labels"]) > 0
        assert g["labels"] == want["labels"][i][v].tolist()
        np.testing.assert_allclose(g["boxes"], want["boxes"][i][v], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g["scores"], want["scores"][i][v], atol=1e-4, rtol=1e-4)

    deploy = str(tmp_path / "deploy.pt")
    tool.convert(setting, os.path.join(ckpts.save_dir, "deploy"), deploy)
    bare = Checkpoints.load(deploy)
    assert set(bare) == set(port_ema)
    for k, v in port_ema.items():
        assert torch.equal(bare[k], v), k
