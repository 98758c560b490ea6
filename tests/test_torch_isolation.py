"""The port stands alone: it imports neither JAX, the JAX package,
OpenCV nor PIL, its kernel module imports without nvcc, and its entry
points refuse to fall back to the CPU when CUDA is absent and the caller
did not ask for it."""
import os
import subprocess
import sys

import pytest
import torch

from cvpytorch_tpu_torch.config import CommonConfiguration

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_python(code: str, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, **env})


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cvpytorch_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'cvpytorch_tpu', 'cv2', 'PIL'))\n"
        "assert not bad, bad\n"
        "for n in ('infer', 'ops.nms_kernel', 'trainer', 'optim.optimizers', "
        "'optim.schedules', 'ops.augment', 'evaluator.coco', 'models.rcnn', "
        "'ops.roi_align', 'ops.masks', 'models.backbones.resnet', 'data.png', "
        "'data.transforms.imgproc', 'data.transforms.seg_transforms', "
        "'data.datasets.cityscapes', 'evaluator.segmentation', 'models.segmentor', "
        "'models.unet', 'models.heads.seg_heads', 'models.losses.seg_loss', "
        "'models.backbones.mobilenetv2', 'models.losses.cls_loss', 'models.classification', "
        "'data.transforms.cls_transforms', 'data.datasets.mini_imagenet', "
        "'evaluator.classification', 'models.backbones.shufflenetv2', "
        "'models.necks.ghost_pan', 'models.losses.gfl_loss', "
        "'models.assigners.dsl_assigner', 'models.heads.nanodet_head', "
        "'models.nanodet_plus', 'native', 'data.jpeg', 'data.image_io', "
        "'data.datasets.coco', 'data.datasets.voc', 'data.datasets.misc_datasets', "
        "'data.layouts', 'evaluator.voc', 'models.heads.seg_heads_extra', "
        "'models.backbones.seg_transformers', 'models.backbones.seg_light', "
        "'models.light_seg', 'models.light_seg2', 'models.light_seg3', "
        "'models.segnet_enet', 'ops.pool', 'models.assigners.atss_assigner', "
        "'models.assigners.tal_assigner', 'models.necks.pan', 'models.necks.tan', "
        "'models.backbones.repvgg', 'models.backbones.efficientnet_lite', "
        "'models.backbones.custom_cspnet', 'models.yolov6', 'models.necks.asff', "
        "'models.assigners.ota_assigner', 'models.yolox', 'models.losses.yolov7_loss', "
        "'models.yolov7', 'models.necks.fcos_fpn', 'models.heads.fcos_head', 'models.fcos', "
        "'models.backbones.lfd_resnet', 'models.lfd', 'models.retinanet', "
        "'models.backbones.efficientnet', 'models.efficientdet', 'models.objectbox', "
        "'models.losses.objectbox_loss', 'models.yolop', 'models.necks.giraffe_neck', "
        "'models.heads.gflv2_head', 'models.airdet', 'models.giraffedet', "
        "'models.necks.nas_fpn', 'models.necks.rfp', 'models.anchors', "
        "'models.anchors.prior_box', 'models.backbones.vgg', 'ops.paf', 'models.keypoint', "
        "'data.transforms.keypoint_transforms', 'evaluator.keypoint', 'parallel', "
        "'parallel.dist', 'parallel.mesh', 'parallel.tensor', 'parallel.spatial'):\n"
        "    assert 'cvpytorch_tpu_torch.' + n in names, n\n"
        "print(len(names))\n"
    )
    r = run_python(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20


def test_kernel_module_imports_and_serves_cpu_without_nvcc():
    code = (
        "import torch\n"
        "from cvpytorch_tpu_torch.ops import nms_kernel as k\n"
        "keep = k.nms_keep(torch.tensor([[[0., 0, 10, 10], [0, 0, 10, 9]]]), 0.5)\n"
        "assert keep.tolist() == [[True, False]], keep\n"
        "assert k.nms_keep.launches == 0 and k._lib is None\n"
        "try:\n"
        "    k._nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n"
    )
    r = run_python(code, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    assert r.returncode == 0, r.stderr
    assert "raised nvcc not found" in r.stdout


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    from cvpytorch_tpu_torch import infer

    from cvpytorch_tpu_torch import trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--setting", "unused.json", "--checkpoint", "unused.pt"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.Trainer(CommonConfiguration({}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.main(["--setting", "conf/coco_yolov5_s.yml"])
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_host_library_build_failure_raises(tmp_path):
    """No C compiler: reading a JPEG raises, nothing falls back to numpy."""
    code = (
        "from pathlib import Path\n"
        "from cvpytorch_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "from cvpytorch_tpu_torch.data import image_io\n"
        "try:\n"
        f"    image_io.imread({os.path.join(ROOT, 'tests', 'data', 'torch_jpeg', 'grey_320x240.jpg')!r})\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n"
    )
    r = run_python(code, PATH=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "raised no C compiler" in r.stdout
