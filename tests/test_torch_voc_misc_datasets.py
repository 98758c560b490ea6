"""The port's VOC and remaining datasets against the JAX package's on the
CPU, on directories in each dataset's own layout written by
``cvpytorch_tpu_torch.data.layouts`` (JPEG copies of the committed
fixtures, PNGs from the port's writer, seeded numpy).

Each of the nine classes, item by item against the JAX class (which
reads with OpenCV 5.0.0): images equal, and boxes, labels, ``difficult``,
``track_ids``, masks and PennFudan's 112² instance masks equal (exact).
The one exception is a palette label map: the port reads its indices,
the JAX datasets' ``cv2.IMREAD_GRAYSCALE`` the luma of its colours
(ROADMAP Queue 3); those tests hold the port to the known indices and
show the JAX reading differs.
"""
import os
from pathlib import Path

import cv2
import numpy as np
import pytest

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets import misc_datasets as jax_misc
from cvpytorch_tpu.data.datasets import voc as jax_voc
from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
from cvpytorch_tpu_torch.data import layouts
from cvpytorch_tpu_torch.data.datasets import misc_datasets, voc
from cvpytorch_tpu_torch.data.image_io import imread_label
from cvpytorch_tpu_torch.data.png import rgb_to_gray, write_palette_png
from cvpytorch_tpu_torch.registry import DATASETS

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "torch_jpeg"
JPEGS = sorted(str(p) for p in FIXTURES.glob("*.jpg"))


def dictionary(name, key):
    return load_dictionary(str(ROOT / "conf" / "dicts" / f"{name}_dict.yml"), key)[1]


def pair(port_cls, jax_cls, data, dic, stage="train"):
    return (port_cls(data_cfg=CommonConfiguration(data), dictionary=dic, stage=stage),
            jax_cls(data_cfg=JaxConfig(data), dictionary=dic, stage=stage))


def assert_items_equal(port_ds, jax_ds, keys=("boxes", "labels")):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(port_ds)):
        got, want = port_ds[i], jax_ds[i]
        np.testing.assert_array_equal(got["image"], want["image"], err_msg=str(i))
        if want["target"] is None:
            assert got["target"] is None
        elif isinstance(want["target"], dict):
            assert set(got["target"]) == set(want["target"])
            for k in keys:
                g, w = got["target"][k], want["target"][k]
                assert g.dtype == w.dtype and g.shape == w.shape, (i, k)
                np.testing.assert_array_equal(g, w, err_msg=f"{i} {k}")
        else:
            assert got["target"].dtype == want["target"].dtype
            np.testing.assert_array_equal(got["target"], want["target"], err_msg=str(i))


# -- label maps -------------------------------------------------------------
def test_palette_masks_read_as_indices_and_jax_reads_luma(tmp_path):
    """VOC's palette: the port reads indices 0–20 and 255 back; OpenCV's
    gray (what the JAX datasets read) is the luma of each colour, so index
    1 (128, 0, 0) reads 38 there.  Colour PNGs read as OpenCV's gray."""
    rng = np.random.RandomState(0)
    index = rng.randint(0, 21, (37, 53)).astype(np.uint8)
    index[:3] = 255
    path = str(tmp_path / "m.png")
    write_palette_png(path, index, layouts.voc_palette())
    np.testing.assert_array_equal(imread_label(path), index)
    luma = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    pal = np.asarray(layouts.voc_palette(), np.uint8).reshape(-1, 3)
    np.testing.assert_array_equal(luma, rgb_to_gray(pal[index]))
    assert luma[index == 1].tolist()[0] == 38 and (luma != index).mean() > 0.9
    img = layouts.smooth_image(rng, 23, 31)
    cv2.imwrite(str(tmp_path / "c.png"), img)
    np.testing.assert_array_equal(imread_label(str(tmp_path / "c.png")),
                                  cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_GRAYSCALE))


# -- VOC ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    names = [next(iter(d)) for d in dictionary("voc", "DET_CLASSES")][1:]
    root = str(tmp_path_factory.mktemp("voc") / "VOC2012")
    return layouts.write_voc(root, JPEGS, names, n=9, n_train=6)


def test_voc_detection_equals_jax(voc_root):
    """All 9 ids (sorted Annotations), then the train INDICES; objects
    named in no dictionary skipped, ``difficult`` 1/0/empty/absent, the
    ``.png`` image of the first id."""
    dic = dictionary("voc", "DET_CLASSES")
    data = {"IMG_DIR": voc_root["IMG_DIR"]}
    port_ds, jax_ds = pair(voc.VOCDetection, jax_voc.VOCDetection, data, dic)
    assert_items_equal(port_ds, jax_ds, ("boxes", "labels", "difficult"))
    diffs = np.concatenate([port_ds[i]["target"]["difficult"] for i in range(len(port_ds))])
    assert set(diffs.tolist()) == {0, 1}
    n_objects = sum(len(port_ds[i]["target"]["labels"]) for i in range(len(port_ds)))
    xml = "".join(open(os.path.join(voc_root["IMG_DIR"], "Annotations", f)).read()
                  for f in sorted(os.listdir(os.path.join(voc_root["IMG_DIR"], "Annotations"))))
    assert xml.count("<object>") - xml.count("notaclass") == n_objects
    assert port_ds.ids[0] == "2008_000000" and port_ds[0]["image"].shape == (375, 500, 3)
    data["INDICES"] = voc_root["train"]
    port_ds, jax_ds = pair(voc.VOCDetection, jax_voc.VOCDetection, data, dic, "infer")
    assert len(port_ds) == 6
    assert_items_equal(port_ds, jax_ds)


def test_voc_segmentation_reads_palette_indices(voc_root):
    """Images equal JAX's; the masks are the palette indices, 255 borders
    kept, where the JAX dataset reads luma."""
    dic = dictionary("voc", "SEG_CLASSES")
    data = {"IMG_DIR": voc_root["IMG_DIR"], "INDICES": voc_root["val"]}
    port_ds, jax_ds = pair(voc.VOCSegmentation, jax_voc.VOCSegmentation, data, dic)
    assert len(port_ds) == len(jax_ds) == 2
    pal = np.asarray(layouts.voc_palette(), np.uint8).reshape(-1, 3)
    for i in range(2):
        got, want = port_ds[i], jax_ds[i]
        np.testing.assert_array_equal(got["image"], want["image"])
        mask = got["target"]
        assert mask.dtype == np.uint8 and mask.shape == got["image"].shape[:2]
        assert set(np.unique(mask)) <= set(range(21)) | {255} and (mask == 255).any()
        np.testing.assert_array_equal(want["target"], rgb_to_gray(pal[mask]))
    assert len(voc.VOCSegmentation(data_cfg=CommonConfiguration(
        {"IMG_DIR": voc_root["IMG_DIR"]}), dictionary=dic)) == 9


# -- image/mask folders ---------------------------------------------------------
@pytest.mark.parametrize("case", ["ade20k", "ade20k_beside", "portrait", "camvid",
                                  "camvid_gray_masks"])
def test_paired_seg_datasets_equal_jax(tmp_path, case):
    """ADE20K (1-based masks, 0 → 255; with SEG_DIR, and beside the images
    without), Portrait, Camvid (its ``.png`` images are their own masks
    without SEG_DIR, read as OpenCV's gray; and with gray masks)."""
    port_cls, jax_cls, kw = {
        "ade20k": (misc_datasets.ADE20KSegmentation, jax_misc.ADE20KSegmentation,
                   dict(jpegs=JPEGS, num_classes=150, offset=1)),
        "ade20k_beside": (misc_datasets.ADE20KSegmentation, jax_misc.ADE20KSegmentation,
                          dict(jpegs=JPEGS, num_classes=150, offset=1, seg_dir=False)),
        "portrait": (misc_datasets.PortraitSegmentation, jax_misc.PortraitSegmentation,
                     dict(jpegs=JPEGS, num_classes=2)),
        "camvid": (misc_datasets.CamvidSegmentation, jax_misc.CamvidSegmentation,
                   dict(num_classes=11, seg_dir=False)),
        "camvid_gray_masks": (misc_datasets.CamvidSegmentation, jax_misc.CamvidSegmentation,
                              dict(num_classes=11)),
    }[case]
    out = layouts.write_paired_seg(str(tmp_path), n=4, **kw)
    data = {"IMG_DIR": out["IMG_DIR"]}
    if out["SEG_DIR"]:
        data["LABELS"] = {"SEG_DIR": out["SEG_DIR"]}
    dic = [{f"c{i}": 1.0} for i in range(kw["num_classes"])]
    port_ds, jax_ds = pair(port_cls, jax_cls, data, dic)
    assert_items_equal(port_ds, jax_ds)
    mask = port_ds[0]["target"]
    if case.startswith("ade20k"):
        assert (mask[:mask.shape[0] // 5] == 255).all() and mask[mask != 255].max() <= 149
    if case == "camvid":
        np.testing.assert_array_equal(mask, rgb_to_gray(port_ds[0]["image"][..., ::-1]))
    suffix = "*_0001" + (".png" if case.startswith("camvid") else ".jpg")
    assert len(port_cls(data_cfg=CommonConfiguration({**data, "IMG_SUFFIX": suffix}),
                        dictionary=dic)) == 1


# -- detection lists ------------------------------------------------------------
@pytest.mark.parametrize("dic_name", ["visdrone", "ten_classes"])
def test_visdrone_detection_equals_jax(tmp_path, dic_name):
    """Categories 0 and above the dictionary dropped (11 is kept with the
    config's 11-entry dictionary, dropped with 10), boxes under 2 pixels
    dropped, trailing commas and short rows; an image without its txt."""
    dic = dictionary("visdrone", "DET_CLASSES")
    if dic_name == "ten_classes":
        dic = dic[1:]
    img_dir = layouts.write_visdrone(str(tmp_path / "VisDrone2019-DET-val"), JPEGS, n=6)
    port_ds, jax_ds = pair(misc_datasets.VisDroneDetection, jax_misc.VisDroneDetection,
                           {"IMG_DIR": img_dir}, dic)
    assert_items_equal(port_ds, jax_ds)
    labels = np.concatenate([port_ds[i]["target"]["labels"] for i in range(6)])
    assert labels.min() >= 0 and (10 in labels) == (dic_name == "visdrone")
    assert len(port_ds[5]["target"]["boxes"]) == 0


def test_visdrone_track_equals_jax(tmp_path):
    dic = dictionary("visdrone", "DET_CLASSES")[1:4]
    root = layouts.write_visdrone_mot(str(tmp_path), JPEGS, n_seq=2, n_frames=3)
    port_ds, jax_ds = pair(misc_datasets.VisDroneTrack, jax_misc.VisDroneTrack,
                           {"IMG_DIR": root}, dic)
    assert len(port_ds) == 6
    assert_items_equal(port_ds, jax_ds, ("boxes", "labels", "track_ids"))
    assert sum(len(port_ds[i]["target"]["track_ids"]) for i in range(6)) > 0


def test_widerface_equals_jax(tmp_path):
    """Entries with a count of 0 (and their row of zeros), faces of 2
    pixels dropped (strictly w > 2 and h > 2)."""
    out = layouts.write_widerface(str(tmp_path), JPEGS, n=8)
    port_ds, jax_ds = pair(misc_datasets.WiderFaceDetection, jax_misc.WiderFaceDetection,
                           out, [{"face": 1.0}])
    assert len(port_ds) == 8
    assert_items_equal(port_ds, jax_ds)
    assert len(port_ds[3]["target"]["boxes"]) == 0
    assert DATASETS.get("src.data.datasets.widerface.WiderFace") is \
        misc_datasets.WiderFaceDetection


@pytest.mark.parametrize("palette", [False, True])
def test_pennfudan_equals_jax(tmp_path, palette):
    """Gray instance maps: boxes [xmin, ymin, xmax + 1, ymax + 1], labels
    and the 112² nearest-resized masks equal JAX's.  Palette maps (as
    PennFudanPed ships them): the port reads the ids; JAX reads their
    colours' luma, which orders the instances otherwise."""
    root = layouts.write_pennfudan(str(tmp_path), n=3, palette=palette, size=(90, 120))
    dic = dictionary("pennfudan", "DET_CLASSES")
    port_ds, jax_ds = pair(misc_datasets.PennFudanDetection, jax_misc.PennFudanDetection,
                           {"IMG_DIR": root}, dic)
    if not palette:
        assert_items_equal(port_ds, jax_ds, ("boxes", "labels", "masks"))
        return
    for i in range(3):
        t = port_ds[i]["target"]
        ids = imread_label(port_ds._masks[i])
        assert len(t["boxes"]) == len(np.unique(ids)) - 1 == t["masks"].shape[0]
        ys, xs = np.where(ids == 1)
        np.testing.assert_array_equal(t["boxes"][0], [xs.min(), ys.min(), xs.max() + 1,
                                                      ys.max() + 1])
        assert t["masks"].shape[1:] == (112, 112) and t["masks"].dtype == np.float32
    luma = cv2.imread(port_ds._masks[0], cv2.IMREAD_GRAYSCALE)
    assert not np.array_equal(luma, imread_label(port_ds._masks[0]))


@pytest.mark.parametrize("config", ["ade20k_deeplabv3plus", "camvid_unet", "pennfudan_maskrcnn",
                                    "pennfudan_fasterrcnn", "portrait", "portrait_unet",
                                    "visdrone_yolov5", "voc_deeplabv3plus",
                                    "widerface_faceboxes", "voc_nanodet"])
def test_config_dataset_names_resolve(config):
    cls = CommonConfiguration.from_file(str(ROOT / "conf" / f"{config}.yml")).DATASET.CLASS
    assert DATASETS.get(cls).__module__.startswith("cvpytorch_tpu_torch.data.datasets.")


def test_visdrone_groups_load_num_samples_for_the_mosaic(tmp_path):
    """``LOAD_NUM: 4`` at the train stage (``conf/visdrone_yolov5.yml``): an
    item is the sample and three ``random.randrange`` draws, as
    ``CocoDetection`` draws them; val items stay single samples."""
    import random

    img_dir = layouts.write_visdrone(str(tmp_path / "VisDrone2019-DET-train"), JPEGS, n=5)
    dic = dictionary("visdrone", "DET_CLASSES")
    data = CommonConfiguration({"IMG_DIR": img_dir, "LOAD_NUM": 4, "MOSAIC_PROB": 1.0})
    ds = misc_datasets.VisDroneDetection(data_cfg=data, dictionary=dic, stage="train")
    random.seed(3)
    group = ds[2]
    random.seed(3)
    random.random()
    extra = [random.randrange(5) for _ in range(3)]
    assert isinstance(group, list) and len(group) == 4
    for s, i in zip(group, [2, *extra]):
        np.testing.assert_array_equal(s["image"], ds._load_one(i)["image"])
        np.testing.assert_array_equal(s["target"]["boxes"], ds._load_one(i)["target"]["boxes"])
    val = misc_datasets.VisDroneDetection(data_cfg=data, dictionary=dic, stage="val")
    assert isinstance(val[2], dict)
