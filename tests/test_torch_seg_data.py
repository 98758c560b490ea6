"""The port's segmentation data path against the JAX package and OpenCV on
the CPU: OpenCV's uint8 resize and HSV conversions in numpy, every
segmentation transform against its JAX counterpart under the same Python
``random`` seed, the two Cityscapes pipelines, ``SyntheticSegmentation``,
the segmentation evaluator, the PNG codec (against ``cv2.imread`` and
PIL) and ``CityscapesSegmentation`` on a tree of PNG files.

Every comparison asks for equality.  Measured on this installation
(OpenCV 5.0.0): no unequal value in any image or mask, including the
resize's vectorised fixed-point rounding and the HSV round trip over all
256³ and 180·256² inputs, in OpenCV's vector steps and in the scalar tail
of a row."""
import copy
import os
import random
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from cvpytorch_tpu.config import CommonConfiguration as JaxConfig
from cvpytorch_tpu.data.datasets.cityscapes import CityscapesSegmentation as JaxCityscapes
from cvpytorch_tpu.data.datasets.synthetic import SyntheticSegmentation as JaxSynthetic
from cvpytorch_tpu.data.transforms import build_transforms as jax_build_transforms
from cvpytorch_tpu.data.transforms import seg_transforms as jax_seg
from cvpytorch_tpu.evaluator.segmentation import SegmentationEvaluator as JaxEvaluator
from cvpytorch_tpu.infer import save_seg_mask as jax_save_seg_mask
from cvpytorch_tpu_torch import infer
from cvpytorch_tpu_torch.config import CommonConfiguration
from cvpytorch_tpu_torch.data import png
from cvpytorch_tpu_torch.data.datasets.cityscapes import CityscapesSegmentation
from cvpytorch_tpu_torch.data.datasets.synthetic import SyntheticSegmentation
from cvpytorch_tpu_torch.data.transforms import build_transforms
from cvpytorch_tpu_torch.data.transforms import imgproc, seg_transforms
from cvpytorch_tpu_torch.evaluator.segmentation import SegmentationEvaluator
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- OpenCV's operations ----------------------------------------------------------
@pytest.mark.parametrize("src,dst", [
    ((37, 53, 3), (64, 64)),      # upscale
    ((100, 150, 3), (71, 97)),    # downscale
    ((64, 128, 3), (32, 64)),     # exactly half: OpenCV's 2×2 area mean
    ((30, 44), (15, 22)),         # exactly half, one channel
    ((20, 33), (41, 5)),          # one channel, mixed
    ((48, 80, 3), (48, 80)),      # same size: a copy
    ((9, 7, 3), (200, 150)),      # large upscale: clamped edges
])
def test_resizes_equal_opencv(src, dst):
    rng = np.random.RandomState(sum(src) + sum(dst))
    img = rng.randint(0, 256, src).astype(np.uint8)
    h, w = dst
    np.testing.assert_array_equal(imgproc.resize_linear(img, dst),
                                  cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(imgproc.resize_nearest(img, dst),
                                  cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))


def test_resize_linear_equals_opencv_on_random_shapes():
    """60 seeded draws of source and target sizes (1–200 → 1–300 a side;
    gray, 1, 3 or 4 channels): equal to ``cv2.resize``, and each random
    window equal to the crop of the full resize."""
    rng = np.random.RandomState(0)
    for _ in range(60):
        (H, W), (oh, ow) = rng.randint(1, 200, 2), rng.randint(1, 300, 2)
        C = rng.choice([0, 1, 3, 4])
        img = rng.randint(0, 256, (H, W, C) if C else (H, W)).astype(np.uint8)
        got = imgproc.resize_linear(img, (oh, ow))
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, want.reshape(got.shape))
        assert got.shape == (oh, ow) + img.shape[2:]
        rows, cols = slice(rng.randint(0, oh), None), slice(None, rng.randint(1, ow + 1))
        np.testing.assert_array_equal(imgproc.resize_linear(img, (oh, ow), rows, cols),
                                      got[rows, cols])


def test_resize_window_is_the_crop_of_the_full_resize():
    img = np.random.RandomState(1).randint(0, 256, (100, 200, 3)).astype(np.uint8)
    rows, cols = slice(20, 90), slice(5, 300)
    for fn in (imgproc.resize_linear, imgproc.resize_nearest):
        for size in ((173, 311), (50, 100)):  # (50, 100): the exact half
            np.testing.assert_array_equal(fn(img, size, rows, cols), fn(img, size)[rows, cols])


def test_hsv_round_trip_equals_opencv_on_every_input():
    a = np.arange(256)
    bgr = np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(4096, 4096, 3)
    bgr = bgr.astype(np.uint8)
    np.testing.assert_array_equal(imgproc.bgr_to_hsv(bgr),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), a, a, indexing="ij"), -1)
    hsv = hsv.reshape(180 * 256, 256, 3).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.hsv_to_bgr(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("width", [1, 31, 33, 200])
def test_hsv_to_bgr_equals_opencv_in_the_row_tail(width):
    """OpenCV converts the last W mod 32 pixels of a row one by one,
    rounding differently from its vector steps."""
    rng = np.random.RandomState(width)
    hsv = np.stack([rng.randint(0, 180, (40, width)), rng.randint(0, 256, (40, width)),
                    rng.randint(0, 256, (40, width))], -1).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    bgr = rng.randint(0, 256, (40, width, 3)).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.bgr_to_hsv(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))


# -- transforms -----------------------------------------------------------------
TRANSFORMS = [
    ("Resize", {"size": [48, 80]}),
    ("Resize", {"size": [64, 100]}),  # exactly half
    ("RandomHorizontalFlip", {"p": 0.5}),
    ("RandomScaleCrop", {"size": [64, 96], "scale": [0.5, 2.0]}),
    ("RandomScaleCrop", {"size": [160, 240], "scale": [0.5, 1.2]}),  # pads
    ("RandomScaleResize", {"size": [40, 60], "scale": [0.75, 1.5]}),
    ("RandomCrop", {"size": [64, 96]}),
    ("RandomCrop", {"size": [160, 120]}),  # pads the rows
    ("Pad", {"size": [150, 230]}),
    ("PhotoMetricDistortion", {}),
    ("ColorJitter", {"brightness": 0.3, "hue": 0.1}),
    ("RGB2BGR", {}),
    ("ToTensor", {}),
    ("Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}),
    ("RandomRotate", {"degrees": 30, "p": 1.0}),  # image bilinear, mask nearest
    ("RandomRotate", {"degrees": [-10, 10], "p": 0.5, "ignore_label": 0}),
]


def seg_sample(seed, float_image=False):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (128, 200, 3)).astype(np.uint8)
    mask = rng.randint(0, 19, (128, 200)).astype(np.uint8)
    mask[:10] = 255
    if float_image:
        img = img.astype(np.float32) / 255
    return {"image": img, "target": mask}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,kwargs", TRANSFORMS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(TRANSFORMS)])
def test_transform_equals_jax_under_the_same_seed(name, kwargs, seed):
    """Image and mask equal, and the same number of draws from ``random``."""
    sample = seg_sample(seed, float_image=name == "Normalize")
    random.seed(seed)
    want = jax_seg.SEG_TRANSFORMS[name](**kwargs)(copy.deepcopy(sample))
    after_jax = random.random()
    random.seed(seed)
    got = seg_transforms.SEG_TRANSFORMS[name](**kwargs)(copy.deepcopy(sample))
    assert random.random() == after_jax
    assert got["image"].dtype == want["image"].dtype
    np.testing.assert_array_equal(got["image"], want["image"])
    assert got["target"].dtype == want["target"].dtype
    np.testing.assert_array_equal(got["target"], want["target"])


@pytest.mark.parametrize("config", ["cityscapes_deeplabv3plus.yml", "cityscapes_unet.yml"])
@pytest.mark.parametrize("stage", ["TRAIN", "VAL"])
def test_config_pipelines_equal_jax(config, stage):
    """The configs' TRAIN and VAL pipelines on SyntheticSegmentation
    frames of 256×512 (a quarter of Cityscapes' side) cropped or resized
    to 128×256: float images and int32 masks equal over 4 seeded items."""
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", config))
    tcfg = copy.deepcopy(cfg.DATASET.get(stage).TRANSFORMS.data)
    first = "RandomScaleCrop" if stage == "TRAIN" else "Resize"
    tcfg[first] = {**tcfg[first], "size": [128, 256]}
    data = {"SIZE": [256, 512], "LENGTH": 4, "SEED": 5}
    dictionary = [{f"c{i}": 1.0} for i in range(6)]
    port = SyntheticSegmentation(CommonConfiguration(data), dictionary,
                                 build_transforms("SEG_CLASSES", tcfg, stage.lower()))
    ref = JaxSynthetic(JaxConfig(data), dictionary,
                       jax_build_transforms("SEG_CLASSES", tcfg, stage.lower()))
    for i in range(4):
        random.seed(100 + i)
        want = ref[i]
        random.seed(100 + i)
        got = port[i]
        assert got["image"].shape == (128, 256, 3) and got["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["target"], want["target"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_photometric_distortion_takes_p_and_equals_jax(seed):
    """``PhotoMetricDistortion: {p: 0.5}`` (42 of the seg configs) builds,
    and under one ``random`` seed equals the JAX transform, which takes no
    ``p``: each step draws its own coin."""
    sample = seg_sample(seed)
    random.seed(seed)
    want = jax_seg.PhotoMetricDistortion()(copy.deepcopy(sample))
    after_jax = random.random()
    random.seed(seed)
    got = build_transforms("SEG_CLASSES", {"PhotoMetricDistortion": {"p": 0.5}})(
        copy.deepcopy(sample))
    assert random.random() == after_jax
    np.testing.assert_array_equal(got["image"], want["image"])


def test_cityscapes_deeplabv3_pipeline_builds():
    """``conf/cityscapes_deeplabv3.yml`` passes ``p`` to
    PhotoMetricDistortion; its TRAIN and VAL pipelines build."""
    cfg = CommonConfiguration.from_file(os.path.join(ROOT, "conf", "cityscapes_deeplabv3.yml"))
    assert cfg.DATASET.TRAIN.TRANSFORMS.PhotoMetricDistortion.p == 0.5
    for stage in ("TRAIN", "VAL"):
        pipeline = build_transforms("SEG_CLASSES", cfg.DATASET.get(stage).TRANSFORMS,
                                    stage.lower())
        assert pipeline.transforms


def test_unported_transforms_name_the_roadmap():
    """No seg transform is left unported: ``RandAugment`` (PIL's operations
    in the JAX package, numpy in the port) builds from the config's name
    and gives JAX's image and mask under one ``random`` seed, all fourteen
    operations drawn; ``RandomRotate`` builds too
    (``test_transform_equals_jax_under_the_same_seed``).  An unknown name
    raises."""
    rng = np.random.RandomState(4)
    kwargs = {"p": 0.9, "n_ops": 3, "magnitude": 0.7, "ops": "full", "fill": [5, 6, 7]}
    for seed in range(6):
        sample = {"image": rng.randint(0, 256, (40, 56, 3)).astype(np.uint8),
                  "target": rng.randint(0, 19, (40, 56)).astype(np.uint8)}
        random.seed(seed)
        want = jax_build_transforms("SEG_CLASSES", {"RandAugment": kwargs}, "train")(
            copy.deepcopy(sample))
        random.seed(seed)
        got = build_transforms("SEG_CLASSES", {"RandAugment": kwargs}, "train")(
            copy.deepcopy(sample))
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["target"], want["target"])
    assert build_transforms("SEG_CLASSES", {"RandomRotate": {}}, "train").transforms
    with pytest.raises(KeyError, match="no segmentation transform"):
        build_transforms("SEG_CLASSES", {"NoSuchTransform": {}}, "train")


# -- datasets ---------------------------------------------------------------------
def test_synthetic_segmentation_equals_jax():
    """Six classes (the JAX dataset paints class c with 50·c, which
    numpy 2 refuses for a uint8 past 255)."""
    dictionary = [{f"c{i}": 1.0} for i in range(6)]
    for stage in ("train", "val", "infer"):
        cfg = {"SIZE": [48, 80], "LENGTH": 5, "SEED": 3}
        got = SyntheticSegmentation(CommonConfiguration(cfg), dictionary, stage=stage)
        want = JaxSynthetic(JaxConfig(cfg), dictionary, stage=stage)
        assert len(got) == len(want) == 5
        for i in range(5):
            g, w = got[i], want[i]
            np.testing.assert_array_equal(g["image"], w["image"])
            if stage == "infer":
                assert g["target"] is None and w["target"] is None
            else:
                np.testing.assert_array_equal(g["target"], w["target"])


def test_synthetic_segmentation_paints_19_classes_mod_256():
    ds = SyntheticSegmentation(CommonConfiguration({"SIZE": [64, 128], "LENGTH": 3}),
                               [{f"c{i}": 1.0} for i in range(19)])
    seen = set()
    for i in range(3):
        s = ds[i]
        m = s["target"].astype(np.int64)
        fg = m > 0
        np.testing.assert_array_equal(s["image"][fg], ((50 * m[fg]) % 256)[:, None]
                                      .repeat(3, 1).astype(np.uint8))
        seen |= set(np.unique(m).tolist())
    assert max(seen) > 6


def write_cityscapes_tree(root, rng, n=3):
    """leftImg8bit RGB and gtFine labelIds gray PNGs for two cities, written
    by OpenCV as the dataset's files are; returns the relative pairs."""
    pairs = []
    for i in range(n):
        city = ("aachen", "bremen")[i % 2]
        stem = f"{city}_{i:06d}_000019"
        img_rel = f"{city}/{stem}_leftImg8bit.png"
        lab_rel = f"{city}/{stem}_gtFine_labelIds.png"
        for rel, arr in ((img_rel, rng.randint(0, 256, (24, 40, 3))),
                         (lab_rel, rng.randint(0, 34, (24, 40)))):
            base = "leftImg8bit" if rel == img_rel else "gtFine"
            path = os.path.join(root, base, "train", rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            cv2.imwrite(path, arr.astype(np.uint8))
        pairs.append((img_rel, lab_rel))
    return pairs


def test_cityscapes_dataset_equals_jax(tmp_path):
    """Glob layout and INDICES file, every stage: images, train-id masks
    (labelId → trainId, others 255) and ids equal to the JAX dataset's."""
    pairs = write_cityscapes_tree(str(tmp_path), np.random.RandomState(0))
    indices = tmp_path / "train.txt"
    indices.write_text("".join(f"{a} {b}\n" for a, b in pairs[::-1]) + "\n")
    base = {"IMG_DIR": str(tmp_path / "leftImg8bit" / "train"),
            "LABELS": {"SEG_DIR": str(tmp_path / "gtFine" / "train")}}
    for cfg in (base, {**base, "INDICES": str(indices)}):
        for stage in ("train", "infer"):
            got = CityscapesSegmentation(CommonConfiguration(cfg), stage=stage)
            want = JaxCityscapes(JaxConfig(cfg), stage=stage)
            assert len(got) == len(want) == 3
            for i in range(3):
                g, w = got[i], want[i]
                np.testing.assert_array_equal(g["image"], w["image"])
                if stage == "infer":
                    assert g["target"] is None and g["id"] == w["id"]
                else:
                    np.testing.assert_array_equal(g["target"], w["target"])
                    assert set(np.unique(g["target"])) <= set(range(19)) | {255}


# -- evaluator --------------------------------------------------------------------
def test_segmentation_evaluator_equals_jax():
    """Batches with ignored pixels and labels past the classes; one class
    never present (its IoU NaN); then the state merged from two halves."""
    rng = np.random.RandomState(2)

    class DS:
        num_classes = 6
        id2name = {i: f"c{i}" for i in range(6)}

    got, want = SegmentationEvaluator(DS(), eval_type="mIoU"), JaxEvaluator(DS())
    halves = [SegmentationEvaluator(DS()), SegmentationEvaluator(DS())]
    for b in range(4):
        t = rng.randint(0, 5, (2, 16, 24)).astype(np.int32)
        t[:, :2] = 255
        t[0, -1] = 7
        p = np.where(rng.rand(2, 16, 24) < 0.6, t % 6, rng.randint(0, 5, t.shape))
        got.update(t, p.astype(np.uint8))
        want.update(t, p.astype(np.int32))
        halves[b % 2].update(t, p)
    g, w = got.evaluate(), want.evaluate()
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_equal(g[k], w[k], err_msg=k)
    assert np.isnan(g["IoU_c5"]) and 0 < g["mIoU"] < 1
    merged = SegmentationEvaluator(DS())
    merged.merge_state_dicts([h.state_dict() for h in halves])
    np.testing.assert_array_equal(merged.confusion, got.confusion)


# -- PNG codec --------------------------------------------------------------------
def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(path, pixels, ctype, filters, palette=None):
    """A PNG whose row y is filtered with ``filters[y]`` (0–4), by the
    specification's predictors on the original bytes."""
    h, w, bpp = pixels.shape
    x = pixels.reshape(h, w * bpp).astype(np.int64)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0 * x, 1: a, 2: b, 3: (a + b) // 2, 4: _paeth(a, b, c)}
    rows = b"".join(bytes([f]) + ((x[y] - pred[f][y]) % 256).astype(np.uint8).tobytes()
                    for y, f in enumerate(filters))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", bytes(palette))
    # two IDAT chunks: the stream may be split anywhere
    data = zlib.compress(rows)
    body += chunk(b"IDAT", data[:7]) + chunk(b"IDAT", data[7:]) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body)


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_reader_undoes_every_filter_as_opencv_reads(tmp_path, filters, ctype):
    rng = np.random.RandomState(ctype * 7 + len(filters))
    h, w = 23, 31
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    # a gradient with noise: every predictor is exercised, with wrap-around
    yy, xx = np.mgrid[:h, :w]
    pixels = ((yy[..., None] * 9 + xx[..., None] * 5 + rng.randint(0, 40, (h, w, samples)))
              % 256).astype(np.uint8)
    palette = None
    if ctype == 3:
        pixels %= 20
        palette = rng.randint(0, 256, 60).astype(np.uint8)
    kinds = rng.randint(0, 5, h) if filters == "mixed" else [int(filters)] * h
    path = str(tmp_path / "f.png")
    encode_png(path, pixels, ctype, kinds, palette)
    np.testing.assert_array_equal(png.imread(path), cv2.imread(path))
    decoded, got_type, _ = png.decode(open(path, "rb").read())
    assert got_type == ctype
    np.testing.assert_array_equal(decoded, pixels)
    np.testing.assert_array_equal(png.imread(path, grayscale=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P"])
def test_png_reader_reads_opencv_and_pil_files(tmp_path, mode):
    """A 96×160 gradient written by PIL (adaptive filters) and, for RGB and
    gray, by OpenCV."""
    rng = np.random.RandomState(len(mode))
    yy, xx = np.mgrid[:96, :160]
    base = np.stack([(xx // 3 + yy // 5) % 256, (xx * yy // 50) % 256,
                     rng.randint(100, 130, xx.shape), (xx + yy) % 256], -1).astype(np.uint8)
    arr = {"RGB": base[..., :3], "L": base[..., 0], "RGBA": base, "LA": base[..., :2],
           "P": base[..., 0] % 19}[mode]
    img = Image.fromarray(arr, mode)
    if mode == "P":
        img.putpalette(infer.CITYSCAPES_PALETTE)
    path = str(tmp_path / "pil.png")
    img.save(path)
    np.testing.assert_array_equal(png.imread(path), cv2.imread(path))
    if mode in ("RGB", "L"):
        cv2.imwrite(str(tmp_path / "cv.png"), arr[..., ::-1] if mode == "RGB" else arr)
        np.testing.assert_array_equal(png.imread(str(tmp_path / "cv.png")),
                                      cv2.imread(str(tmp_path / "cv.png")))


def test_palette_writer_equals_the_jax_cli_file(tmp_path):
    """``infer.save_seg_mask`` (the port's writer) and the JAX CLI's PIL
    writer give the same pixels and palette read back by PIL, and OpenCV
    reads the same colours from both."""
    pred = np.random.RandomState(4).randint(0, 19, (37, 53)).astype(np.uint8)
    infer.save_seg_mask(pred, str(tmp_path / "port.png"))
    jax_save_seg_mask(pred, str(tmp_path / "jax.png"))
    got, want = Image.open(tmp_path / "port.png"), Image.open(tmp_path / "jax.png")
    assert got.mode == want.mode == "P"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.getpalette() == want.getpalette() == infer.CITYSCAPES_PALETTE
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png")),
                                  cv2.imread(str(tmp_path / "jax.png")))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, np.zeros((4, 5), np.uint16))  # 16-bit gray
    with pytest.raises(ValueError, match="bit depth 16"):
        png.imread(path)
    cv2.imwrite(path, np.zeros((4, 5, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 1  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")
