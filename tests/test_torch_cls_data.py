"""The port's classification data path against the JAX package (which runs
on OpenCV): every cls transform under one ``random`` seed, the pipelines
of ``conf/mini-imagenet.yml``, ``SyntheticClassification``, the file
datasets on PNGs that the test writes, and the evaluator.  Images and
labels are held equal, not within a tolerance."""
import copy
import os
import random

import cv2
import numpy as np
import pytest

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets import mini_imagenet as jax_files
from cvpytorch_tpu.data.datasets.synthetic import SyntheticClassification as JaxSynthetic
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms import cls_transforms as jax_cls
from cvpytorch_tpu.evaluator.classification import ClassificationEvaluator as JaxEvaluator
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.data.datasets import mini_imagenet
from cvpytorch_tpu_torch.data.datasets.synthetic import SyntheticClassification
from cvpytorch_tpu_torch.data.transforms import build_transforms, cls_transforms
from cvpytorch_tpu_torch.evaluator.classification import ClassificationEvaluator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRANSFORMS = [
    ("Resize", {"size": [48, 80]}),
    ("Resize", {"size": [64, 100]}),  # exactly half
    ("Resize", {"size": [200, 200], "keep_ratio": True}),  # upscale, canvas
    ("Resize", {"size": [50, 90], "keep_ratio": True}),
    ("RandomResizedCrop", {"size": [56, 56], "keep_ratio": False}),
    ("RandomResizedCrop", {"size": [224, 224]}),  # upscale
    ("RandomResizedCrop", {"size": [40, 40], "scale": [2.0, 3.0]}),  # the fallback
    ("CenterCrop", {"size": [64, 64]}),
    ("CenterCrop", {"size": [150, 150]}),  # upscales the short side first
    ("RandomHorizontalFlip", {"p": 0.5}),
    ("RandomVerticalFlip", {"p": 0.5}),
    ("ColorJitter", {"p": 0.5, "brightness": 0.125, "contrast": [0.5, 1.5],
                     "saturation": [0.5, 1.5], "hue": 0.07}),
    ("ColorJitter", {"p": 1.0, "brightness": 0, "contrast": 0, "hue": 0.2}),
    ("RGB2BGR", {}),
    ("ToTensor", {}),
    ("Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}),
    ("RandomRotation", {"degrees": 10}),
    ("RandomRotation", {"degrees": [-45, 30], "p": 1.0}),
]


def cls_sample(seed, float_image=False):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (128, 200, 3)).astype(np.uint8)
    if float_image:
        img = img.astype(np.float32) / 255
    return {"image": img, "target": int(rng.randint(0, 10))}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name,kwargs", TRANSFORMS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(TRANSFORMS)])
def test_transform_equals_jax_under_the_same_seed(name, kwargs, seed):
    """Image and label equal, and the same number of draws from ``random``."""
    sample = cls_sample(seed, float_image=name == "Normalize")
    random.seed(seed)
    want = jax_cls.CLS_TRANSFORMS[name](**kwargs)(copy.deepcopy(sample))
    after_jax = random.random()
    random.seed(seed)
    got = cls_transforms.CLS_TRANSFORMS[name](**kwargs)(copy.deepcopy(sample))
    assert random.random() == after_jax
    assert got["image"].dtype == want["image"].dtype
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["target"], want["target"])


def test_random_rotation_raises_naming_the_roadmap():
    """``RandomRotation`` no longer raises: it builds from a config and,
    under one ``random`` seed, equals the JAX transform (OpenCV's
    ``warpAffine``)."""
    for seed in range(4):
        sample = cls_sample(seed)
        random.seed(seed)
        want = jax_cls.RandomRotation(degrees=10, p=0.5)(copy.deepcopy(sample))
        random.seed(seed)
        got = build_transforms("CLS_CLASSES", {"RandomRotation": {"degrees": 10}})(
            copy.deepcopy(sample))
        np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("stage", ["TRAIN", "VAL"])
def test_mini_imagenet_pipelines_equal_jax(stage):
    """``conf/mini-imagenet.yml``'s pipelines, as written, on 375×500
    synthetic frames (ImageNet's typical size): float images equal."""
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", "mini-imagenet.yml"))
    tcfg = cfg.DATASET.get(stage).TRANSFORMS.data
    data = {"SIZE": [375, 500], "LENGTH": 4, "SEED": 2}
    dictionary = [{f"c{i}": 1.0} for i in range(6)]
    port = SyntheticClassification(CommonConfiguration(data), dictionary,
                                   build_transforms("CLS_CLASSES", tcfg, stage.lower()))
    ref = JaxSynthetic(JaxConfig(data), dictionary,
                       jax_build_transforms("CLS_CLASSES", tcfg, stage.lower()))
    for i in range(4):
        random.seed(50 + i)
        want = ref[i]
        random.seed(50 + i)
        got = port[i]
        assert got["image"].shape == (224, 224, 3) and got["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["target"] == want["target"]


def test_synthetic_classification_equals_jax_below_seven_classes():
    dictionary = [{f"c{i}": 1.0} for i in range(7)]
    for stage in ("train", "val", "infer"):
        cfg = {"SIZE": [24, 40], "LENGTH": 12, "SEED": 3}
        got = SyntheticClassification(CommonConfiguration(cfg), dictionary, stage=stage)
        want = JaxSynthetic(JaxConfig(cfg), dictionary, stage=stage)
        assert len(got) == len(want) == 12
        for i in range(12):
            g, w = got[i], want[i]
            np.testing.assert_array_equal(g["image"], w["image"])
            assert g["target"] == w["target"]
            assert (g["target"] is None) == (stage == "infer")


def test_synthetic_classification_paints_100_classes_mod_256():
    """Past class 6 the JAX dataset raises under numpy 2; the port adds
    (40·t) mod 256 with uint8 wrap-around."""
    ds = SyntheticClassification(CommonConfiguration({"SIZE": [16, 30], "LENGTH": 40}),
                                 [{f"c{i}": 1.0} for i in range(100)])
    assert max(ds[i]["target"] for i in range(40)) >= 7
    for i in range(40):
        s = ds[i]
        t = s["target"]
        rng = np.random.RandomState(ds._seeds[i])
        noise = rng.randint(0, 40, (16, 30, 3))
        want = ((noise + 40 * t) % 256).astype(np.uint8)
        want[:, ::t + 2] = 255
        np.testing.assert_array_equal(s["image"], want)


def write_pngs(root, names, n, size=(30, 44)):
    """n BGR PNGs for each class folder, written by OpenCV."""
    rng = np.random.RandomState(0)
    paths = []
    for name in names:
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for i in range(n):
            path = os.path.join(root, name, f"{i:03d}.png")
            cv2.imwrite(path, rng.randint(0, 256, (*size, 3)).astype(np.uint8))
            paths.append(os.path.join(name, f"{i:03d}.png"))
    return paths


def test_folder_classification_equals_jax(tmp_path):
    names = ["ants", "bees"]
    write_pngs(str(tmp_path), names + ["wasps"], 3)  # wasps: not in the dictionary
    dictionary = [{n: 1.0} for n in names]
    cfg = {"IMG_DIR": str(tmp_path)}
    for stage in ("train", "infer"):
        got = mini_imagenet.FolderClassification(CommonConfiguration(cfg), dictionary,
                                                 stage=stage)
        want = jax_files.FolderClassification(JaxConfig(cfg), dictionary, stage=stage)
        assert len(got) == len(want) == 6
        for i in range(6):
            np.testing.assert_array_equal(got[i]["image"], want[i]["image"])
            assert got[i]["target"] == want[i]["target"]


def test_mini_imagenet_classification_equals_jax(tmp_path):
    paths = write_pngs(str(tmp_path), ["n01", "n02"], 2)
    index = tmp_path / "train.txt"
    index.write_text("".join(f"{p} {i % 2}\n" for i, p in enumerate(paths)))
    for stage, extra in (("train", {"INDICES": str(index)}), ("infer", {})):
        cfg = {"IMG_DIR": str(tmp_path), **extra}
        got = mini_imagenet.MiniImageNetClassification(CommonConfiguration(cfg), stage=stage)
        want = jax_files.MiniImageNetClassification(JaxConfig(cfg), stage=stage)
        assert len(got) == len(want) == 4
        for i in range(4):
            np.testing.assert_array_equal(got[i]["image"], want[i]["image"])
            assert got[i]["target"] == want[i]["target"]


def test_jpeg_files_raise_naming_the_roadmap(tmp_path):
    """JPEG files are read now (as the JAX dataset reads them through
    cv2.imread); a file that is neither JPEG nor PNG still raises, naming
    the file."""
    os.makedirs(tmp_path / "ants")
    rng = np.random.RandomState(0)
    cv2.imwrite(str(tmp_path / "ants" / "a.jpg"), rng.randint(0, 255, (8, 8, 3), np.uint8))
    cfg = {"IMG_DIR": str(tmp_path)}
    ds = mini_imagenet.FolderClassification(CommonConfiguration(cfg), [{"ants": 1.0}])
    want = jax_files.FolderClassification(JaxConfig(cfg), [{"ants": 1.0}])
    np.testing.assert_array_equal(ds[0]["image"], want[0]["image"])
    (tmp_path / "ants" / "a.jpg").write_bytes(b"GIF89a not an image")
    with pytest.raises(ValueError, match="a.jpg: neither a JPEG nor a PNG"):
        ds[0]


def test_classification_evaluator_equals_jax():
    rng = np.random.RandomState(0)
    dataset = type("DS", (), {"num_classes": 5, "id2name": {i: f"k{i}" for i in range(5)}})()
    ports = [ClassificationEvaluator(dataset) for _ in range(2)]
    refs = [JaxEvaluator(dataset) for _ in range(2)]
    for k in range(2):
        for _ in range(3):
            t = rng.randint(0, 4, 16)  # class 4 never appears: its accuracy is NaN
            p = np.where(rng.rand(16) < 0.6, t, rng.randint(0, 5, 16)).astype(np.uint8)
            ports[k].update(t, p)
            refs[k].update(t, p)
    got, want = ports[0].evaluate(), refs[0].evaluate()
    assert got.keys() == want.keys() and np.isnan(got["Acc_k4"])
    for key in want:
        np.testing.assert_equal(got[key], want[key])
    ports[0].merge_state_dicts([e.state_dict() for e in ports])
    refs[0].merge_state_dicts([e.state_dict() for e in refs])
    np.testing.assert_equal(ports[0].evaluate(), refs[0].evaluate())
    acc = ClassificationEvaluator(dataset, eval_type="Acc")
    acc.update(np.array([0, 1]), np.array([0, 0]))
    assert acc.evaluate()["performance"] == 0.5
