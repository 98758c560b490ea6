"""The port's infer CLI and serving transforms against the JAX package.

``cvpytorch_tpu_torch.infer.main(... --device cpu)`` and the JAX
``cvpytorch_tpu.infer.main`` run the same JSON config (SyntheticDetection,
yolov5_n, 64²) on the same weights.  The JAX CLI builds its state by
initialising the model in train mode, which YOLOv5 cannot do without
targets, and loads weights from an orbax checkpoint; the test hands it a
state built from the same variables instead.
"""
import json

import numpy as np
import pytest
import torch

import cvpytorch_tpu.data.datasets  # noqa: F401  (registers the JAX datasets)
from cvpytorch_tpu import infer as jax_infer
from cvpytorch_tpu.data.transforms.det_transforms import Resize as JaxResize
from cvpytorch_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from cvpytorch_tpu.train_state import TrainState
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.data.transforms.det_transforms import Resize
from cvpytorch_tpu_torch.models.yolov5 import YOLOv5
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_yolov5 import DICTIONARY, jax_variables


def write_config(tmp_path):
    dict_path = tmp_path / "dict.json"
    dict_path.write_text(json.dumps({"DET_CLASSES": list(DICTIONARY)}))
    cfg = {
        "DATASET": {
            "CLASS": "SyntheticDetection",
            "DICTIONARY": str(dict_path),
            "DICTIONARY_NAME": "DET_CLASSES",
            "VAL": {
                "SIZE": [64, 64], "LENGTH": 4, "SEED": 3,
                "BATCH_SIZE": 2, "NUM_WORKER": 2,
                "TRANSFORMS": {
                    "Resize": {"size": [64, 64], "keep_ratio": True,
                               "fill": [114, 114, 114]},
                    "ToTensor": None,
                    "Normalize": {"mean": [0, 0, 0], "std": [1, 1, 1]},
                },
            },
        },
        "USE_MODEL": {"CLASS": "src.models.yolov5.YOLOv5", "TYPE": "yolov5_n"},
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_infer_cli_writes_the_jax_predictions(tmp_path, monkeypatch):
    setting = write_config(tmp_path)
    model_cfg = {"TYPE": "yolov5_n"}
    variables = jax_variables(JaxYOLOv5(dictionary=DICTIONARY,
                                        model_cfg=model_cfg), seed=0)
    port = load_jax_variables(YOLOv5(dictionary=DICTIONARY,
                                      model_cfg=model_cfg), variables)
    ckpt = tmp_path / "yolov5_n.pt"
    torch.save(port.state_dict(), ckpt)
    infer.main(["--setting", setting, "--checkpoint", str(ckpt),
                "--out", str(tmp_path / "port"), "--device", "cpu"])

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

    got = json.loads((tmp_path / "port" / "predictions.json").read_text())
    want = json.loads((tmp_path / "jax" / "predictions.json").read_text())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g["labels"]) > 0
        assert g["labels"] == w["labels"]
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4, rtol=1e-4)


def test_config_and_dictionary_read_like_jax(tmp_path):
    """YAML through ``from_yaml``/``from_file``, and the same mapping as
    JSON, read to what the JAX package reads."""
    from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
    from cvpytorch_tpu.config import load_dictionary as jax_load_dictionary
    from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary

    want = JaxConfig.from_yaml("conf/coco_yolov5_s.yml")
    got = CommonConfiguration.from_file("conf/coco_yolov5_s.yml")
    assert got.DATASET.VAL.TRANSFORMS.Resize.size == [640, 640]
    assert got.USE_MODEL.TYPE == want.USE_MODEL.TYPE == "yolov5_s"
    assert got.MISSING_KEY is None and got.DATASET.MISSING_KEY is None
    as_json = tmp_path / "cfg.json"
    as_json.write_text(json.dumps(want.to_dict()))
    for cfg in (CommonConfiguration.from_yaml("conf/coco_yolov5_s.yml"),
                CommonConfiguration.from_json(str(as_json))):
        assert json.dumps(cfg.data, default=dict) == \
            json.dumps(want.data, default=dict)
    task, classes = load_dictionary("conf/dicts/coco_dict.yml")
    assert (task, classes) == jax_load_dictionary("conf/dicts/coco_dict.yml")
    assert len(classes) == 80


@pytest.mark.parametrize("shape,size,keep_ratio", [
    ((37, 53, 3), [64, 64], True),     # upscale + pad
    ((100, 150, 3), [64, 64], True),   # downscale + pad
    ((48, 80, 3), [64, 64], False),    # plain resize
])
def test_letterbox_resize_within_one_level_of_opencv(shape, size, keep_ratio):
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, shape).astype(np.uint8)
    boxes = np.array([[1, 2, 20, 30]], np.float32)

    def sample():
        return {"image": img.copy(),
                "target": {"boxes": boxes.copy(), "labels": np.array([1])}}

    want = JaxResize(size, keep_ratio=keep_ratio)(sample())
    got = Resize(size, keep_ratio=keep_ratio)(sample())
    assert got["image"].shape == want["image"].shape
    assert got["image"].dtype == np.uint8
    diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
    assert diff.max() <= 1
    for key in ("boxes", "pads", "scales"):
        np.testing.assert_array_equal(got["target"][key], want["target"][key])


def test_predict_step_serves_float32():
    """Making the predict step turns both TF32 switches off, whatever they
    were before, and its calls leave them off."""
    from cvpytorch_tpu_torch.train_state import make_predict_step

    seen = []

    class Probe(torch.nn.Module):
        def forward(self, images, mode):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32,
                         images.dtype, mode))
            return {}

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        predict = make_predict_step(Probe())
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
        predict(torch.zeros((1, 4, 4, 3), dtype=torch.uint8))
        assert seen == [(False, False, torch.float32, "infer")]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_loader_yields_batches_in_order():
    from cvpytorch_tpu_torch.data.loader import DataLoader

    class Numbers:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return {"image": np.full((2, 2, 3), i, np.uint8), "index": i}

    loader = DataLoader(Numbers(), batch_size=3, num_workers=2)
    batches = list(loader)
    assert len(loader) == len(batches) == 3
    assert [b["index"] for b in batches] == [[0, 1, 2], [3, 4, 5], [6]]
    assert batches[2]["image"].shape == (1, 2, 2, 3)
