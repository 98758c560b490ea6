"""Which ``conf/*.yml`` the port builds: each config's TRAIN and VAL
transform pipelines and its model, as written (weights random, nothing
run).  The test holds the configs that build now to building; run as a
script (``python -m tests.test_torch_config_census``) it prints the
census, each config that does not build with the first error it meets,
and whether its dataset class is in the port."""
import glob
import os
import sys

import pytest
import torch

from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
from cvpytorch_tpu_torch.data import datasets  # noqa: F401  (registers the datasets)
from cvpytorch_tpu_torch.data.transforms import build_transforms
from cvpytorch_tpu_torch.infer import build_model
from cvpytorch_tpu_torch.registry import DATASETS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "conf", "*.yml")))

# the configs the host detection transforms let build (every YOLOv5
# config; coco_nanodetplus_m's RandomAffine), one of each family before,
# SegFormer (MiT-b0…b5) and SFNet (R18/50/101), and SegNeXt (MSCAN-T/S/B/L),
# IncepFormer (T/S/B), TopFormer (T/S/B) and RegSeg, and the self-contained
# segmenters: STDC, ICNet, PP-LiteSeg, LEDNet, LSPNet, SGCPNet, SegNet, ENet
SEG_ZOO = ([f"cityscapes_segnext_{s}" for s in "tsbl"]
           + [f"cityscapes_incepformer_{s}" for s in "tsb"]
           + [f"cityscapes_topformer_{s}" for s in "tsb"] + ["cityscapes_regseg"]
           + ["cityscapes_stdc", "cityscapes_stdc2", "camvid_stdc", "cityscapes_icnet",
              "cityscapes_ppliteseg", "cityscapes_lednet", "cityscapes_lspnet",
              "cityscapes_sgcpnet", "cityscapes_segnet", "cityscapes_enet", "camvid_enet"])
# NanoDet v1 (ShuffleNetV2, RepVGG, EfficientNet-Lite, CustomCspNet; PAN and
# TAN) and YOLOv6 n/t/s/m/l
DET_V1_V6 = (["coco_nanodet", "coco_nanodet_416", "coco_nanodet_t", "coco_nanodet_g",
              "coco_nanodet_repvgg", "coco_nanodet_efficientnet_lite", "voc_nanodet"]
             + [f"coco_yolov6_{s}" for s in "ntsml"])
# YOLOX and PAI-YOLOX, YOLOv7, FCOS, LFD and RetinaNet
DET_OTA_FCOS = ["coco_yolox_s", "coco_yolox_n", "coco_pai_yolox", "coco_pai_yolox_s",
                "coco_yolov7", "coco_yolov7x", "coco_fcos", "coco_lfd", "widerface_faceboxes",
                "pennfudan_retinanet"]
# EfficientDet, AIRDet, GiraffeDet, ObjectBox, YOLOP and FastestDet
DET_REST = ["coco_efficientdet", "coco_airdet", "coco_giraffedet", "coco_objectbox",
            "coco_yolop", "coco_fastestdet"]
# the keypoint configs: OpenPose (VGG16-bn) and LitePose (MobileNetV2)
KEYPOINT = ["coco_openpose", "coco_litepose"]
NOW_BUILD = ["coco_yolov5_s", "coco_yolov5", "coco_yolov5_m", "visdrone_yolov5",
             "coco_nanodetplus_m", "coco_nanodetplus", "mini-imagenet", "cityscapes_unet",
             "coco_maskrcnn"] + [f"cityscapes_segformer_b{i}" for i in range(6)] + [
             f"cityscapes_sfnet_r{d}" for d in (18, 50, 101)] + SEG_ZOO + DET_V1_V6 + DET_OTA_FCOS \
    + DET_REST + KEYPOINT


# configs whose dataset class the port has: the COCO ones (CocoDetection,
# CocoSegmentation, CocoKeypoint), the JPEG classification folders, VOC and the
# remaining datasets
WITH_DATASET = ["coco_yolov5_s", "coco_yolov5", "coco_yolov5_m", "coco_nanodetplus",
                "coco_nanodetplus_m", "coco_maskrcnn", "mini-imagenet", "imagenet", "flower",
                "hymenoptera", "pet", "cityscapes_unet", "ade20k_deeplabv3plus", "camvid_unet",
                "pennfudan_maskrcnn", "pennfudan_fasterrcnn", "portrait", "portrait_unet",
                "visdrone_yolov5", "voc_deeplabv3plus",
                "cityscapes_segformer_b2", "cityscapes_sfnet_r18"] + SEG_ZOO + DET_V1_V6 \
    + DET_OTA_FCOS + DET_REST + KEYPOINT


def build(path):
    """Builds the config's pipelines and model; returns None, or the
    first error as a string."""
    try:
        cfg = CommonConfiguration.from_file(path)
        data = cfg.DATASET
        name = data.DICTIONARY_NAME or "CLS_CLASSES"
        dictionary = [{f"c{i}": 1.0} for i in range(4)]
        if data.DICTIONARY and os.path.exists(os.path.join(ROOT, data.DICTIONARY)):
            _, dictionary = load_dictionary(os.path.join(ROOT, data.DICTIONARY), name)
        for stage in ("TRAIN", "VAL"):
            if data.get(stage) is not None:
                build_transforms(name, data.get(stage).get("TRANSFORMS"), stage.lower())
        with torch.device("meta"):
            build_model(cfg, dictionary)
    except Exception as e:  # noqa: BLE001  (the census reports every kind)
        return f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"[:160]
    return None


def has_dataset(path):
    try:
        DATASETS.get(CommonConfiguration.from_file(path).DATASET.CLASS)
    except Exception:  # noqa: BLE001
        return False
    return True


@pytest.mark.parametrize("name", NOW_BUILD)
def test_config_builds_in_the_port(name):
    assert build(os.path.join(ROOT, "conf", f"{name}.yml")) is None


@pytest.mark.parametrize("name", WITH_DATASET)
def test_config_has_its_dataset_class(name):
    assert has_dataset(os.path.join(ROOT, "conf", f"{name}.yml"))


def main():
    results = {os.path.basename(p)[:-4]: (build(p), has_dataset(p)) for p in CONFIGS}
    ok = sorted(n for n, (err, _) in results.items() if err is None)
    print(f"{len(ok)} of {len(results)} configs build their TRAIN and VAL transforms "
          f"and model in the port; {sum(results[n][1] for n in ok)} of these also "
          "have their dataset class")
    for n in ok:
        print(f"  builds: {n}{'' if results[n][1] else '  (dataset class not ported)'}")
    for n, (err, _) in sorted(results.items()):
        if err is not None:
            print(f"  fails: {n}: {err}")


if __name__ == "__main__":
    sys.exit(main())



def test_census_reads_every_config():
    """Every ``conf/*.yml`` builds its transforms and model in the port and
    has its dataset class: 89 of 89 since ROADMAP item 9 (the keypoint
    configs)."""
    assert len(CONFIGS) == 89
    failing = {os.path.basename(p): err for p in CONFIGS
               if (err := build(p)) is not None or not has_dataset(p)}
    assert not failing, failing
