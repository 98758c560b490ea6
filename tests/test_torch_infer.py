"""The port's infer CLI and serving transforms against the JAX package.

``cvpytorch_tpu_torch.infer.main(... --device cpu)`` serves a JSON config
(SyntheticDetection at 48×80, letterboxed to 64², yolov5_n) on weights
carried from the JAX model.  The infer stage carries the letterbox's
``pads``/``scales`` to the model, so the served boxes are in the original
frame's pixels; the oracle is the JAX model called on the same images
with those ``pads``/``scales`` as its targets.  (The JAX CLI passes no
targets and serves network pixels.)
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets.synthetic import SyntheticDetection as JaxSyntheticDetection
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms.det_transforms import Resize as JaxResize
from cvpytorch_tpu.data.transforms.det_transforms import make_det_collate as jax_det_collate
from cvpytorch_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.data.transforms.det_transforms import Resize
from cvpytorch_tpu_torch.models.yolov5 import YOLOv5
from cvpytorch_tpu_torch.utils.porting import load_jax_variables
from tests.test_torch_yolov5 import DICTIONARY, jax_variables

FRAME = [48, 80]  # letterboxed to 64²: scale 0.8, 13 rows of padding above


def write_config(tmp_path):
    dict_path = tmp_path / "dict.json"
    dict_path.write_text(json.dumps({"DET_CLASSES": list(DICTIONARY)}))
    cfg = {
        "DATASET": {
            "CLASS": "SyntheticDetection",
            "DICTIONARY": str(dict_path),
            "DICTIONARY_NAME": "DET_CLASSES",
            "VAL": {
                "SIZE": FRAME, "LENGTH": 4, "SEED": 3,
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
    return str(path), cfg


def test_infer_cli_writes_the_jax_predictions(tmp_path):
    setting, cfg = write_config(tmp_path)
    model_cfg = {"TYPE": "yolov5_n"}
    jm = JaxYOLOv5(dictionary=DICTIONARY, model_cfg=model_cfg)
    variables = jax_variables(jm, seed=0)
    port = load_jax_variables(YOLOv5(dictionary=DICTIONARY,
                                      model_cfg=model_cfg), variables)
    ckpt = tmp_path / "yolov5_n.pt"
    torch.save(port.state_dict(), ckpt)
    infer.main(["--setting", setting, "--checkpoint", str(ckpt),
                "--out", str(tmp_path / "port"), "--device", "cpu"])

    # the oracle: the JAX pipeline's images (its val stage draws the same
    # frames as the infer stage) and the JAX model with the letterbox's
    # pads/scales as targets
    stage = JaxConfig(cfg["DATASET"]["VAL"])
    ds = JaxSyntheticDetection(stage, list(DICTIONARY),
                               jax_build_transforms("DET_CLASSES", stage.TRANSFORMS, "val"),
                               stage="val")
    batch = jax_det_collate(64)([ds[i] for i in range(4)])
    t = batch["target"]
    np.testing.assert_array_equal(t["pads"], np.tile([[0, 13]], (4, 1)))
    np.testing.assert_allclose(t["scales"], 0.8)
    want = jm.apply(variables, jnp.asarray(batch["image"]),
                    {"pads": jnp.asarray(t["pads"]), "scales": jnp.asarray(t["scales"])},
                    mode="infer")
    want = {k: np.asarray(v) for k, v in want.items()}

    got = json.loads((tmp_path / "port" / "predictions.json").read_text())
    assert len(got) == 4
    for i, g in enumerate(got):
        v = want["valid"][i]
        assert len(g["labels"]) > 0
        assert g["labels"] == want["labels"][i][v].tolist()
        np.testing.assert_allclose(g["boxes"], want["boxes"][i][v], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g["scores"], want["scores"][i][v], atol=1e-4, rtol=1e-4)
    # the original frame's pixels, not the network's
    net = jm.apply(variables, jnp.asarray(batch["image"]), mode="infer")
    v = np.asarray(net["valid"][0])
    assert not np.allclose(got[0]["boxes"], np.asarray(net["boxes"][0])[v])


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
    ((427, 640, 3), [320, 320], True),  # NanoDet-Plus: a COCO frame to 320
    ((640, 640, 3), [320, 320], True),  # the DEVICE_AUG collate's tile (exact half)
    ((480, 640, 3), [640, 640], True),  # YOLOv5's letterbox, upscale
])
def test_letterbox_resize_within_one_level_of_opencv(shape, size, keep_ratio):
    """Equal to the JAX (OpenCV) letterbox, pixel for pixel (the name
    dates from when the port resized with ``F.interpolate``, ±1)."""
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
    np.testing.assert_array_equal(got["image"], want["image"])
    for key in ("boxes", "pads", "scales"):
        np.testing.assert_array_equal(got["target"][key], want["target"][key])


def test_predict_step_serves_float32():
    """Making the predict step turns both TF32 switches off, whatever they
    were before, and its calls leave them off."""
    from cvpytorch_tpu_torch.train_state import make_predict_step

    seen = []

    class Probe(torch.nn.Module):
        def forward(self, images, targets=None, mode="train"):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32,
                         images.dtype, targets, mode))
            return {}

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        predict = make_predict_step(Probe())
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (False, False)
        predict(torch.zeros((1, 4, 4, 3), dtype=torch.uint8))
        assert seen == [(False, False, torch.float32, None, "infer")]
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
