#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cvpytorch_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds every kernel of the serving and training paths from
   ``cvpytorch_tpu_torch/csrc`` with nvcc (sm_90a) and prints the build time
   and what ``-Xptxas -v`` reports (registers, shared memory, spills).
1b. Image decode phase (host only): builds the host C library
   (``cvpytorch_tpu_torch/native``: JPEG decoder, PNG row unfilter, COCO
   RLE codec and matcher) and prints its build time; decodes every JPEG
   fixture of ``tests/data/torch_jpeg`` and holds its pixels to the sha256
   of ``cv2.imread``'s in the manifest (the card's machine has no OpenCV);
   times the decode of the 640×427 4:2:0 fixture on one thread and on 8,
   and the PNG decode of a 1024×2048 RGB frame of Sub, Average or Paeth
   rows with its unfilter in C beside the numpy plain version's.  Then a
   COCO-format directory is written from copies of the fixtures (320 train
   and 160 val images, seeded boxes and polygons, a crowd and a non-crowd
   RLE; each phase reads the first images it needs) for the phases below.
2. Kernel timing: ``nms_keep`` and ``nms_keep_plain`` by CUDA events at
   K = 1024, B in {32, 1}, and on a dense input.
3. Path phase: full-width YOLOv5-s (80 classes) with seeded random
   weights, served at 640x640, batch 32, through
   ``cvpytorch_tpu_torch.infer.main``; checks that the NMS kernel was
   launched once per batch, that ``predictions.json`` is well-formed, and
   that the detections equal those of the same model with the plain NMS
   (TF32 off).  Times bs1 predict latency, bs32 throughput, and the NMS
   kernel on the path's own input (the first batch's class-shifted boxes).
4. Train phase: full-width YOLOv5-s at 640², 80 classes, trained through
   ``cvpytorch_tpu_torch.trainer.Trainer(cfg).run()`` on the flagship's
   recipe (``conf/coco_yolov5_s.yml``: AMP, EMA, SGD 0.937 with wd 5e-4,
   LambdaLR, linear warmup, grad clip 10, batch 32) with the device
   augmentation, 2 steps an epoch for 2 epochs, validating 64 images every
   epoch; checks that every step's loss is finite, that ``nms_keep`` ran
   once per val batch, that checkpoints were written and that the last one
   serves a batch through ``infer.main``.  Times the train step at bs32
   (AMP and f32) on a batch already on the card, the device augmentation,
   the fed rate of epoch 2 and the val epoch; peak memory.  Then one f32
   train step at 640², B = 2, on the card against the same step on the
   CPU (loss within 1e-4 relative), and one AMP step (loss within 5e-2 of
   the f32 loss).  Then the letterbox's host time on one thread (the
   OpenCV-exact ``imgproc.resize_linear`` against the ``F.interpolate``
   resize it replaced, on the same 640² and 427×640 frames) beside the
   YOLOv5 loader rate.
5. Mask R-CNN phase: ``conf/coco_maskrcnn.yml`` (R50-FPN, 80 classes,
   AMP, SGD 0.9, MultiStepLR, warmup, bbox + segm evaluation) on
   SyntheticInstanceSegmentation at 800² (MASK_SIZE 112), trained through
   ``Trainer.run()`` for 2 steps at batch 16 and validated on 16 images;
   checks that the five losses are finite and that ``nms_keep`` ran once
   per step (the RPN's proposals) and twice per val batch (proposals and
   detections); serves the checkpoint through ``infer.main``.  Times the
   AMP and f32 train steps at batch 16 by CUDA events (peak memory; an f32
   step that does not fit is reported), the val step and the bs16 predict
   step; holds ``nms_keep`` to ``nms_keep_plain`` bit for bit on the path's
   own inputs, the RPN's (16, 1000) boxes and the (16, 256) detection
   boxes; compares R50-FPN at B = 1, f32, on the card and on the CPU (in
   eval mode the FPN and RPN maps within 1e-4; from the CPU's RPN maps the
   candidates' scores within 1e-6 and boxes within 1e-2 px, and from the
   CPU's candidates the proposals equal bit for bit; the losses of a
   train-mode forward within 1e-3 relative).  Then ``conf/coco_maskrcnn.yml``'s
   ``CocoSegmentation`` VAL stage as written on 16 of the COCO JPEG files:
   one ``val_epoch`` of the trained model with bbox + segm through the host
   C matcher and RLE IoU (finite metrics, 2 ``nms_keep`` launches), and the
   evaluator's share of its wall.
6. Segmentation phases: ``conf/cityscapes_deeplabv3plus.yml`` (ResNet-50
   at output stride 8, separable ASPP, low-level fusion, FCN aux head)
   and ``conf/cityscapes_unet.yml``, each as written (19 classes, AMP,
   SGD 0.9 with weight decay 1e-4, PolyLR, warmup, batch 8, 512×1024
   crops with flip and photometric distortion) on SyntheticSegmentation
   at the 1024×2048 Cityscapes frame: trained through ``Trainer.run()``
   (one step each), validated on one batch (mIoU), the checkpoint served
   through ``infer.main`` as 4 palette PNGs checked against the predict
   step's argmax; ``nms_keep`` is not launched on these paths.  Times the
   AMP and f32 train steps at batch 8 (CUDA events, peak memory), the
   val and predict steps; for DeepLabV3+ also the host's loader rate and
   each transform's time on one item (the PNG decoder is timed in 1b),
   and R50 at 256×512, B = 1, f32 on the card
   against the CPU (eval-mode logits within 1e-4 of their largest value,
   argmax equal on ≥ 99.9 % of the pixels, train-mode losses within
   1e-3 relative).
6b. SegFormer and SFNet, the same way: ``conf/cityscapes_segformer_b2.yml``
   (MiT-B2, 256-channel SegFormerHead, batch 8, SGD, PolyLR, warmup, AMP,
   EMA, grad clip 10; 2 steps) and ``conf/cityscapes_sfnet_r18.yml``
   (ResNet-18 v1c at output stride 8, 128-channel UperNetAlignHead, its
   batch 16; 2 steps), each as written on SyntheticSegmentation at
   1024×2048: ``Trainer.run()``, mIoU val of 16 images, one served batch,
   the AMP and f32 steps with EMA (peak memory), the val and predict
   steps, and each model at B = 1 card vs CPU with dropout and DropPath
   off at the DeepLabV3+ gates; 0 ``nms_keep`` launches.
6c. The transformer and light zoo, the same way, each config as written:
   ``conf/cityscapes_segnext_b.yml`` (MSCAN-B, LightHamHead of 256
   channels and NMF rank 64, batch 8; 2 steps, 8 served images, AMP and
   f32 steps over 3 calls, card vs CPU at B = 1 with 7 NMF rounds in eval
   mode and 6 in train mode), ``conf/cityscapes_incepformer_t.yml``
   (IPT-T, UpConcatHead of 512 channels, batch 8, ``BACKBONE_LR``; 2
   steps, card vs CPU; its AMP peak beside the GB of one stage-1 block's
   float32 attention logits), ``conf/cityscapes_topformer_b.yml`` and
   ``conf/cityscapes_regseg.yml`` (batch 16; 2 steps each, the AMP step
   timed): mIoU val of 16 images, one served batch, 0 ``nms_keep``
   launches.
6e. The self-contained segmenters, the same way, each config as written:
   ``conf/cityscapes_stdc.yml`` (STDCNet-1, OHEM + detail loss, batch 16,
   EMA, clip 10; 2 steps, 16 val images, 4 served, AMP and f32 steps over
   3 calls, card vs CPU at B = 1; the detail target is the
   ``detail_target`` range of its profile), ``conf/cityscapes_ppliteseg.yml``
   and ``conf/cityscapes_sgcpnet.yml`` (batch 16), ``conf/cityscapes_enet.yml``
   and ``conf/cityscapes_segnet.yml`` (batch 8; SegNet trains on BCE of
   logit channel 0), 2 steps each with 16 val images and the AMP step
   timed; STDC also counts the AMP step's FLOPs
   (``torch.utils.flop_counter``: matmuls and convolutions, forward and
   backward) for an achieved TFLOP/s.  ENet and SegNet run the card vs
   CPU check with the CPU's pool indices handed to the card
   (``SharedPools``): the card's own indices differ only in windows whose
   two largest taps lie within 1e-5 of the map's largest |value| (their
   share is reported), and ``max_unpool`` on the CPU's values and indices
   equals the CPU's bit for bit.  ``conf/cityscapes_icnet.yml`` (ResNet-50
   run twice a step), ``conf/cityscapes_lednet.yml`` and
   ``conf/cityscapes_lspnet.yml``: one step and one val batch each, one
   served batch.  0 ``nms_keep`` launches on all eight.
6d. Dataset layouts (``dataset_layouts``): ``conf/pennfudan_maskrcnn.yml``
   on PennFudanPed PNG images and palette instance masks (2 steps at
   batch 4, bbox + segm val of 8 images: ``nms_keep`` 2 + 2 × 2),
   ``conf/voc_deeplabv3plus.yml`` on a VOCdevkit of JPEG copies, palette
   masks with 255 borders and ImageSets split files (2 steps at batch 16,
   mIoU val of 16) and ``conf/visdrone_yolov5.yml`` on VisDrone-DET JPEG
   copies with txt rows of categories 0–11 (2 steps of its host mosaic
   pipeline at batch 16, bbox val of 16: ``nms_keep`` 1), each through
   ``Trainer.run()`` with only ``IMG_DIR``/``INDICES`` changed
   (``cvpytorch_tpu_torch/data/layouts.py`` writes the directories from
   seeded numpy); finite losses and metrics, each loader's img/s, and
   ``nms_keep`` bit-exact against ``nms_keep_plain`` on every input the
   detection paths gave it.
7. Classification phase: ``conf/mini-imagenet.yml`` as written
   (MobileNetV2 classifier, 100 classes, RandomResizedCrop 224, flip,
   ColorJitter, AdamW, cosine, warmup, AMP, batch 64) on
   SyntheticClassification at 375×500: ``Trainer.run()`` for 4 steps,
   mAcc validation of 64 images, the checkpoint served through
   ``infer.main`` (class ids equal to the predict step's argmax), 0
   ``nms_keep`` launches; the AMP train step at batch 64 and at
   bench.py's batch 256, the val and predict steps, peak
   memory; each
   host transform's time and the loader rate; MobileNetV2 at B = 2, f32,
   card vs CPU (logits within 1e-4 of their largest value, loss 1e-4);
   then ``MiniImageNetClassification`` over an ``INDICES`` file of the JPEG
   fixtures (64 items) through the config's train transforms and loader:
   the loader's img/s.
8. NanoDet-Plus phase: ``conf/coco_nanodetplus.yml`` as written
   (ShuffleNetV2 x1.0, GhostPAN, 80 classes, letterbox 320, flip,
   ColorHSV, AdamW, cosine, warmup, AMP, EMA, batch 96) on
   SyntheticDetection at 427×640: ``Trainer.run()`` for 2 steps, bbox
   validation of 96 images (``nms_keep`` once per val batch), the
   checkpoint served through ``infer.main`` on 16 images (once more;
   boxes equal to the predict step's un-letterboxed to the 427×640
   frame); the AMP train step at batch 96 and at
   bench.py's batch 128, the DSL assigner alone (time and peak memory), the val and
   predict steps; ``nms_keep`` bit-exact on the path's (96, 1024) val
   input and timed; host transforms and loader rate; card vs CPU at B = 2,
   f32 (head outputs within 1e-4 of their largest value, the DSL
   assignment equal, losses 1e-4).
8c. NanoDet v1 (``nanodet_v1``): ``conf/coco_nanodet.yml`` as written
   (ShuffleNetV2-1.0, PAN, 3×3 head stacks, strides 8–32, the ATSS-assigned
   GFL loss, letterbox 320, RandomAffine, flip, ColorHSV, SGD, cosine,
   warmup, AMP, EMA, batch 160) with only ``IMG_DIR``/``ANN_FILE`` pointed
   at the COCO directory of JPEG files (320 train, 160 val images):
   ``Trainer.run()`` for 2 steps, bbox validation of 160 images
   (``nms_keep`` once, at (160, 1024)), 16 images served through
   ``infer.main`` (once more; boxes the predict step's un-letterboxed); the
   AMP step at batch 160 (peak memory), the ATSS assignment alone,
   the val and predict steps; ``nms_keep`` bit-exact on the path's val
   input and timed; card vs CPU at B = 2, f32 (head outputs within 1e-4 of
   their largest value, ATSS ``matched_gt`` equal, losses 1e-4).
8d. YOLOv6-s (``yolov6_s``): ``conf/coco_yolov6_s.yml`` as written
   (EfficientRep, RepBiPAN, Effidehead, mosaic + affine at 640², flip,
   ColorHSV, AMP, EMA, batch 32) on 32 of the COCO directory's train
   images: ``Trainer.run()`` for 5 epochs of one step, epochs 0–3 assigned
   with ATSS and epoch 4 with TAL (each ``yolov6_loss`` call's epoch, a
   host integer, and assigner recorded and checked), bbox validation of 64
   images after epoch 4 (``nms_keep`` once a batch), one served batch (once
   more); the class logits' biases start at 0 so that these batches hold
   detections.  The AMP step at batch 32 with TAL and with ATSS (epoch 3),
   the val and predict steps; ``nms_keep`` bit-exact on the (32, 1024) val
   input; card vs CPU at B = 2 in both branches (head outputs 1e-4,
   ``matched_gt`` of ATSS and of TAL equal on the CPU's inputs, the val
   losses in float32 and the train losses in float64 1e-4; the float32
   train losses reported beside the CPU's own float32-vs-float64 gap).
8e. NanoDet v1's other configs, one train step each at their batch and
   one val batch (at most 32 images on the COCO directory), not timed:
   ``coco_nanodet_t`` (TAN), ``coco_nanodet_g`` (CustomCspNet, 128
   channels), ``coco_nanodet_repvgg``,
   ``coco_nanodet_efficientnet_lite`` and ``coco_nanodet_416`` on the COCO
   directory, ``voc_nanodet`` on a VOCdevkit through the ``voc_detection``
   evaluator; ``nms_keep`` once each, bit-exact on its val input.
8f. Slice 13 (``slice13_phases``), each config as written on the COCO
   directory's JPEG files: ``conf/coco_yolox_s.yml`` (Focus CSPDarknet,
   PAFPN, the decoupled head, SimOTA; mosaic + affine at 640², SGD,
   cosine, AMP, EMA; class and objectness biases at 0 so that the batches
   hold detections) through ``Trainer.run()`` for one epoch of 2 steps at
   bs32, bbox validation of 32 images after it (``nms_keep`` once a
   batch), one served batch (once more); the AMP step at bs32, the val
   and predict steps; ``nms_keep`` bit-exact on its (32, 1024) val
   input and timed; card vs CPU at B = 2 (head outputs 1e-4, SimOTA
   ``matched_gt`` equal on the CPU's inputs, val losses in f32 and train
   losses in f64 1e-4).  ``conf/coco_yolov7.yml`` (YOLOv7-l, its OTA
   loss): 2 steps at bs16, one val and one served batch, the AMP step,
   ``nms_keep`` on its (16, 1024) val input, card vs CPU at B = 2 (raw
   maps 1e-4, the OTA stage's selection and matched gts equal on the CPU's
   raw maps, val losses 1e-4).  ``conf/coco_fcos.yml`` (ResNet-50, FCOSFPN
   P3–P7, the FCOS head at 800²): 2 steps at bs16, one val batch, the AMP
   step, ``nms_keep`` on its (16, 1024) val input.  Then one train step and
   one val batch each of ``coco_yolox_n``, ``coco_pai_yolox`` and
   ``coco_pai_yolox_s`` (EfficientRep with the ReLU SPPF, ASFF),
   ``coco_yolov7x`` (bs12), ``coco_lfd``, ``widerface_faceboxes`` (on
   WIDER FACE's layout) and ``pennfudan_retinanet`` (on PennFudanPed's),
   ``nms_keep`` once each and bit-exact on its val input.
8g. Slice 14 (``slice14_phases``), each config as written on the COCO
   directory's JPEG files: ``conf/coco_efficientdet.yml`` (EfficientDet-D0:
   EfficientNet-B0, 3 BiFPN cells of 64 channels, the shared heads over
   49,104 anchors at 512²) through ``Trainer.run()`` for one epoch of 2
   steps at bs32, bbox validation of 32 images after it (``nms_keep``
   once a batch), one served batch (once more); the AMP step, the
   val and predict steps; ``nms_keep`` bit-exact on its (32, 1024) val
   input and timed; card vs CPU at B = 2 (head outputs 1e-4, the loss's
   positive, negative and ignored anchors and best gts equal in f64 on
   shared targets, losses in f64 1e-4, stochastic depth off).
   ``conf/coco_airdet.yml`` (AIRDet-s: CSPDarknet-s, GiraffeNeck, GFLv2
   with DGQP; mosaic at 640²; its class biases at 0 so that the batches
   hold detections): 2 steps at bs32, one val and one served batch, the
   AMP step, ``nms_keep`` on its (32, 1024) val input, card vs CPU at B = 2
   (head outputs 1e-4, SimOTA's ``matched_gt`` equal in f64 on the CPU's
   outputs, losses in f64 1e-4).  Then one train step and one val batch
   each of ``coco_giraffedet`` (bs24), ``coco_objectbox`` (bs32),
   ``coco_yolop`` (bs24, its two seg decoders) and ``coco_fastestdet``
   (bs64 at 352², ``nms_keep`` at (64, 484)), ``nms_keep`` once each and
   bit-exact on its val input; then NAS-FPN and RFP (ResNet-18 inside) at
   64 channels: one train-mode forward and backward on the card against
   the CPU (outputs and gradients 1e-4).
8h. Slice 15 (``slice15_phases``), the keypoint task on a COCO
   ``person_keypoints`` directory of JPEG fixture copies (64 train, 64
   val images, 1–6 seeded skeletons each): ``conf/coco_openpose.yml`` as
   written (VGG16-bn to conv4_3, 3 stages, 368², bs32, SGD, PolyLR,
   warmup, AMP, EMA, clip 10) but ``EVALUATOR.NAME`` ``coco_keypoints``
   through ``Trainer.run()`` for 2 epochs of 2 steps (targets rendered on
   the card), a val epoch of 64 images (OKS stats; peaks, pair scores and
   the greedy matching on the card), one served batch of people through
   ``infer.main``; the AMP and f32 steps, the val step, bs1 p50 and bs32
   predict, the decode's stages alone; card vs CPU at B = 2 (maps 1e-4,
   float64 targets 1e-12, f64 losses 1e-4, each decode stage on shared
   inputs).  ``conf/coco_litepose.yml`` as far as JAX runs it: 368² and
   the collated keypoints refused as JAX fails on them, then at 384² the
   AMP step on single-instance targets, a val decode, one served
   batch, card vs CPU on the heatmaps.  SimplePose at 256² and the five
   hand-written optimizers (float64, 7 updates) card vs CPU.  ``nms_keep``
   launches 0 on every one.
8b. YOLOv5 host-augmentation phase (``yolov5_host_aug``), after the
   other phases:
   ``conf/coco_yolov5_s.yml`` as written, its ``CocoDetection`` reading
   the COCO directory's JPEG files through the port's decoder and its
   host pipeline included (mosaic + affine on LOAD_NUM = 4 groups, flip,
   ColorHSV, Gaussian and median blur, grayscale, ToCXCYWH, ToTensor,
   Normalize on ``imgproc``, no OpenCV), only ``IMG_DIR``/``ANN_FILE``
   changed: ``Trainer.run()`` for one epoch of 2 steps at batch 32 with no
   ``DEVICE_AUG``, bbox validation of 32 images (``nms_keep`` once per val
   batch), the checkpoint served through ``infer.main`` on 32 images (once
   more); prints the train epoch wall and fed rate beside the
   ``DEVICE_AUG`` phase's, the loader rate, an item's one-thread ms split
   into its 4 JPEG decodes, the rest of the load and each transform (the
   three rare ones also forced on), the AMP step on a host batch, and
   holds ``nms_keep`` to ``nms_keep_plain`` bit for bit on the path's val
   input.
8c. Slice 16 (``slice16_phases``), after the host-augmentation phase:
   full-width YOLOv5-s at 640² trained through ``Trainer.run()`` for one
   epoch of 3 steps at bs32 (``DEVICE_AUG``, AMP, EMA) with
   ``AMP_BN_BF16_STATS`` and ``PROFILER`` on step 1, whose Chrome trace
   must hold that step's CUDA kernels; the AMP step with the BN moments in
   bfloat16 and in float32; the checkpoint through ``exports.main``
   without and with ``--fuse`` at bs32 and bs1, each ``.pt2`` loaded back
   with one ``cvt.nms_keep`` node and served a letterboxed batch
   (``nms_keep`` counted around the four calls: ``yolov5_exported_served``;
   the unfused programs' detections equal the predict step's, the fused
   raw maps within 1e-3 of scale, the differing detections counted);
   the ``cvt::nms_keep`` op, the programs' route, bit-exact against
   ``nms_keep_plain`` on the path's NMS input and timed beside the direct
   call; bs32 ms and bs1 p50 of each program beside the eager predict step;
   PTQ (round-tripped weights equal, calibrated scales 1e-4, the
   fake-quantized maps 1e-4 in float64) and ``precise_bn`` (float64, 1e-6)
   card vs CPU; ``model_summary``.  Then the
   seven backbones under ``Classification`` at 224² (one AMP step at
   bs64, eval logits card vs CPU at B = 2, 1e-4), the attention blocks
   card vs CPU (1e-5) and the seg ``RandAugment``'s host ms at 512×1024.
9. Kernel checks, after every host-clock timing: ``nms_keep`` against
   ``nms_keep_plain`` on the card, bit-exact, over B in {1, 3, 32} x K in
   {1, 63, 64, 65, 300, 1000, 1024} x every threshold the detectors use,
   with clustered, class-offset boxes of 3 and of 80 classes and a dense
   set where most boxes of a class overlap, score ties and a pair whose
   IoU equals 0.6, and NanoDet-Plus's (96, 1024) case of 80 classes in a
   320² canvas; then constructed pairs at IoU == thr, one f32 ulp
   either side, with no overlap and with non-finite coordinates, held
   against the plain version and numpy's f32 division.
10. Device phase, last because a profiler session slows the host's later
   launches: the device time of each of the two NMS kernels of a call
   (torch.profiler) on the inputs timed above and against the number of
   64-box tiles, and the device operations one call runs, counted from the
   launches the profiler recorded on the host and held to
   ``nms_kernel.DEVICE_KERNELS_PER_CALL``; then the
   device busy and idle share and the top operations of the YOLOv5 AMP
   train step with the device augmentation, and of the Mask R-CNN AMP
   train step with the share of the ROIAlign gathers and of their
   backward, and of the YOLOX-s, EfficientDet-D0 and AIRDet-s AMP steps
   with the share of the ``simota_assign`` and ``effdet_targets`` ranges
   (every path's val input among the NMS kernel inputs).  The other
   paths' steps are timed, not profiled: a profiler session of one step
   costs seconds of the run's time limit (the device augmentation, STDC,
   NanoDet-Plus, SegNeXt-B and OpenPose are timed only,
   as are the AMP steps at the bench milestones' batches).
11. Data parallelism (``data_parallel_phase``, after the YOLOv5 train
   phase): full-width YOLOv5-s 640 on the flagship's recipe
   (``DEVICE_AUG``, AMP, EMA) at the global batch of 32 through
   ``Trainer.run()`` in two ``torchrun``s of this script at once: two
   gloo ranks on the one card (2 steps, val of 64 images merged across
   the ranks; NCCL 2.28.9 refuses two ranks on one device: "Duplicate
   GPU detected") and one NCCL rank (1 step, one val batch); then, with the card to the two ranks alone, the two-rank AMP
   step by CUDA events.  Checks: every rank's losses finite and equal, ``nms_keep``
   launched once per val batch on each rank and bit-exact on a rank's
   (16, 1024) input, only rank 0 writing checkpoints, one f32 step of two
   ranks on a fixed global batch against one process (loss and parameters
   1e-4 of the largest leaf, the update 1e-2), and the merged val's
   records and metrics equal to one process's on rank 0's checkpoint.
   Then, in the same two-rank session, tensor parallelism: YOLOv5-s 640
   with ``PARALLEL: {MODEL: 2}`` (data = 1) through ``Trainer.run()`` at a
   global batch of 8 (2 steps, AMP, EMA, the grad clip, one val batch,
   one checkpoint).  Checks: ``nms_keep`` once per val batch and
   bit-exact on a rank's input, the replicated leaves bit-identical
   across the ranks, each rank holding only its blocks of the leaves the
   rule shards, rank 0's checkpoint served in this process, one f32 step
   laid out on the mesh against one process (loss 1e-4), and
   ``spatial_apply`` of JAX's two test models on a Cityscapes frame
   against the unsplit forward (interior and seam rows 1e-5); the TP AMP
   step and its share of the model group's collectives by CUDA events.
   Two ranks sharing one card measure correctness, not scaling.

Prints the card's name and power limit, one JSON line of kernel records,
and as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without CUDA or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH = 32  # VAL and TRAIN BATCH_SIZE of conf/coco_yolov5_s.yml
TRAIN_STEPS_PER_EPOCH = 2
TRAIN_EPOCHS = 2
VAL_IMAGES = 64  # the evaluator's matcher is Python: a small val set

# f32 peak outside the tensor cores and HBM rate of one H100 SXM
# (NVIDIA data sheet, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FLOPs of one IoU-and-compare: 2 max + 2 min + 2 sub + 2 clamp + mul
# (inter), add + sub (union), add (eps), div, compare
IOU_FLOPS = 14
IOU_THR = 0.6  # YOLOv5's serving iou_threshold (models/yolov5.py)


START = time.perf_counter()


def mark(after: str) -> None:
    """Prints the seconds since the script started, after a phase: where
    the run's time limit goes."""
    print(json.dumps({"elapsed_s": round(time.perf_counter() - START, 1), "after": after}),
          flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, calls: int = 30, warmup: int = 5) -> list:
    """Each of ``calls`` calls of ``fn`` after ``warmup``, timed alone by
    CUDA events (the bs1 predict latencies)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def nms_bound_ms(B: int, K: int) -> tuple[float, str]:
    bytes_moved = B * K * 4 * 4 + B * K  # boxes in once, keep out once
    ops = B * K * (K - 1) / 2 * IOU_FLOPS
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def build_kernels() -> float:
    from cvpytorch_tpu_torch.ops import nms_kernel

    t0 = time.perf_counter()
    nms_kernel.load_library()
    return time.perf_counter() - t0


def nms_event_ms(boxes, thr: float) -> float:
    """``nms_keep`` by CUDA events over 200 calls back to back, so the
    host's launch rate counts where it is the limit."""
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep

    return cuda_time_ms(lambda: nms_keep(boxes, thr), iters=200)


# CUDA runtime and driver calls that put an operation on the device
DEVICE_OP_CALL = re.compile(r"^cu(da)?(LaunchKernel|Memset|Memcpy|GraphLaunch)")


def nms_device_ms(boxes, thr: float, calls: int = 50, sessions: int = 5) -> dict:
    """Device time per call of each of the two kernels of ``nms_keep``
    (torch.profiler over ``calls`` calls), their sum, and the device
    operations one call runs.

    Each session traces a warm-up round of ``calls`` calls that it
    discards, then the measured round.  On the H100's machine the profiler
    loses device records now and then (47, 48, 49 or none of 50 kernels in
    one run, while it kept all 100 of the ``cudaLaunchKernel`` records on
    the host), so:

    - each kernel's time is the mean over the records it kept, and a
      session that kept fewer than half of either kernel's records is
      printed and profiled again, up to ``sessions`` times;
    - the device operations of one call are counted on the host, from the
      launch, memset and memcpy calls the profiler recorded, and every
      operation it saw on the card must be one of the two kernels.

    Run after every host-clock and event timing: a profiler session
    leaves the host's launches slower for the rest of the process."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from cvpytorch_tpu_torch.ops.nms_kernel import DEVICE_KERNELS_PER_CALL, nms_keep

    for session in range(1, sessions + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up round, then the measured one
                for _ in range(calls):
                    nms_keep(boxes, thr)
                torch.cuda.synchronize()
                prof.step()
        events = prof.key_averages()
        on_device = [e for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        hits = {phase: [e for e in on_device if f"nms_{phase}_kernel" in e.key]
                for phase in ("mask", "scan")}
        counts = {phase: sum(e.count for e in h) for phase, h in hits.items()}
        if min(counts.values()) >= calls / 2:
            break
        print(f"profiler session {session} of {sessions} recorded {counts} "
              f"NMS kernels for {calls} calls; saw: "
              + ", ".join(f"{e.key[:60]} ({e.device_type}) x{e.count}"
                          for e in events), file=sys.stderr, flush=True)
    else:
        raise AssertionError(f"no profiler session recorded both NMS kernels "
                             f"{calls // 2} times of {calls}")
    others = [e for e in on_device if not any(e in h for h in hits.values())]
    launched = sum(e.count for e in events if e.device_type
                   == torch.autograd.DeviceType.CPU and DEVICE_OP_CALL.match(e.key))
    out = {f"{phase}_kernel_ms": sum(e.self_device_time_total for e in h) / 1e3
           / counts[phase] for phase, h in hits.items()}
    out["device_ms"] = out["mask_kernel_ms"] + out["scan_kernel_ms"]
    out["device_kernels_per_call"] = launched / calls
    out["device_records"] = counts
    out["profiler_sessions"] = session
    if others or out["device_kernels_per_call"] != DEVICE_KERNELS_PER_CALL:
        raise AssertionError(
            f"one nms_keep call put {out['device_kernels_per_call']} operations "
            f"on the device, not {DEVICE_KERNELS_PER_CALL}: "
            + ", ".join(f"{e.key[:60]} ({e.device_type}) x{e.count}" for e in events))
    return out


def kernel_timing() -> dict:
    """``nms_keep`` and ``nms_keep_plain`` timed by CUDA events at K = 1024
    on the inputs the device phase times again, first in the process so
    that nothing before them slows the host's launches."""
    import torch

    from cvpytorch_tpu_torch.ops.nms_cases import nms_inputs
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    launches_before = nms_keep.launches
    times = {"inputs": {}}
    for name, B, kw in (("B32", BATCH, {}), ("B1", 1, {}),
                        ("dense", BATCH, {"dense": True})):
        boxes = torch.from_numpy(nms_inputs(B, 1024, seed=5, **kw)).cuda()
        times["inputs"][name] = (boxes, IOU_THR)
        times[name] = {"ms": nms_event_ms(boxes, IOU_THR)}
        if name != "dense":
            times[name]["plain_ms"] = cuda_time_ms(
                lambda: nms_keep_plain(boxes, IOU_THR), iters=5, warmup=1)
        print(f"nms_keep {name} K=1024: {json.dumps(times[name])}", flush=True)
    nms_keep.launches = launches_before  # comparison launches do not count
    return times


def kernel_checks() -> dict:
    """nms_keep vs nms_keep_plain on the card, bit-exact.  Runs after the
    path phase's timings: when these checks (and their plain version's
    many small launches) came first, the bs1 predict p50 read
    milliseconds slower than after a short check."""
    import torch

    from cvpytorch_tpu_torch.ops.nms_cases import (
        NANODET_CASE, THRESHOLDS, iou_f32, nanodet_inputs, near_threshold_pairs, nms_inputs)
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    launches_before = nms_keep.launches
    max_err = 0

    def check(boxes, thr, what):
        nonlocal max_err
        got = nms_keep(boxes, thr)
        want = nms_keep_plain(boxes, thr)
        torch.cuda.synchronize()
        max_err = max(max_err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"nms_keep != nms_keep_plain at {what}: "
                                 f"{int((got != want).sum())} flags differ")
        return got

    n_cases = 0
    kinds = (("3 classes", {}), ("80 classes", {"n_classes": 80}),
             ("3 classes, dense", {"dense": True}))
    for kind, kw in kinds:
        for B in (1, 3, BATCH):
            kept = []
            for K in (1, 63, 64, 65, 300, 1000, 1024):
                boxes = torch.from_numpy(nms_inputs(B, K, seed=B * 7 + K, **kw)).cuda()
                for thr in THRESHOLDS:
                    got = check(boxes, thr, f"{kind} B={B} K={K} thr={thr}")
                    if thr == IOU_THR and K >= 2 and not bool(got[:, 1].all()):
                        raise AssertionError("the IoU == thr pair was suppressed")
                    n_cases += 1
                kept.append(f"K={K}: {int(got.sum())}/{B * K}")
            print(f"nms_keep {kind} B={B}: bit-exact at thresholds "
                  f"{THRESHOLDS}; kept at {THRESHOLDS[-1]}: " + ", ".join(kept),
                  flush=True)
    for thr in THRESHOLDS:
        check(torch.from_numpy(nanodet_inputs(seed=11)).cuda(), thr,
              f"NanoDet-Plus {NANODET_CASE} thr={thr}")
        n_cases += 1
    print(f"nms_keep NanoDet-Plus case {NANODET_CASE}: bit-exact at thresholds {THRESHOLDS}",
          flush=True)
    for thr in THRESHOLDS:
        pairs, counts = near_threshold_pairs(thr)
        got = check(torch.from_numpy(pairs).cuda(), thr, f"near-threshold pairs {thr}")
        want = ~(iou_f32(pairs[:, 0], pairs[:, 1]) > np.float32(thr))
        if not (got[:, 0].all() and np.array_equal(got[:, 1].cpu().numpy(), want)):
            raise AssertionError(f"near-threshold pairs at {thr}: the kernel "
                                 "disagrees with numpy's f32 division")
        n_cases += 1
        print(f"nms_keep near-threshold pairs at {thr}: bit-exact against "
              f"nms_keep_plain and numpy f32 division, {counts}", flush=True)
    nms_keep.launches = launches_before  # comparison launches do not count
    return {"max_abs_err": float(max_err), "cases": n_cases}


def device_phase(inputs: dict) -> dict:
    """The device time of each kernel of ``nms_keep`` on each input, and
    against the number of 64-box tiles T (the scan's dependent block
    steps; the mask kernel's T(T+1)/2 tile pairs per image)."""
    import torch

    from cvpytorch_tpu_torch.ops.nms_cases import nms_inputs

    out = {name: nms_device_ms(*args) for name, args in inputs.items()}
    out["by_tiles"] = {}
    for B in (1, BATCH):
        for T in (1, 2, 4, 8, 16):
            boxes = torch.from_numpy(nms_inputs(B, 64 * T, seed=T)).cuda()
            t = nms_device_ms(boxes, IOU_THR)
            out["by_tiles"][f"B{B}_T{T}"] = {
                k: t[k] for k in ("mask_kernel_ms", "scan_kernel_ms")}
    print(f"nms kernels, device ms: {json.dumps(out)}", flush=True)
    return out


def write_dictionary(workdir: Path) -> Path:
    """The 80 COCO classes of conf/dicts/coco_dict.yml as JSON (no PyYAML
    needed)."""
    text = (ROOT / "conf" / "dicts" / "coco_dict.yml").read_text()
    names = re.findall(r"^\s*-\s*([^:\s]+):\s*([0-9.]+)\s*$", text, re.M)
    if len(names) != 80:
        raise AssertionError(f"expected 80 COCO classes, parsed {len(names)}")
    dict_path = workdir / "coco_dict.json"
    dict_path.write_text(json.dumps(
        {"DET_CLASSES": [{n: float(w)} for n, w in names]}))
    return dict_path


FLAGSHIP_MODEL = {  # USE_MODEL of conf/coco_yolov5_s.yml
    "CLASS": "src.models.yolov5.YOLOv5",
    "TYPE": "yolov5_s",
    "BACKBONE": {"name": "YOLOv5CSPDarknet", "subtype": "cspdark_s"},
    "NECK": {"name": "YOLOv5Neck", "subtype": "yolov5_s"},
    "DETECT": {"name": "YOLOv5Detect"},
    "LOSS": {"name": "YOLOv5Loss", "hyp_box": 0.05, "hyp_obj": 1.0,
             "hyp_cls": 0.5},
}


def val_stage(n_images: int) -> dict:
    """The flagship's VAL stage on SyntheticDetection at 640²."""
    return {
        "SIZE": [640, 640], "LENGTH": n_images, "SEED": 0,
        "SHUFFLE": False, "BATCH_SIZE": BATCH, "NUM_WORKER": 8,
        "TRANSFORMS": {
            "Resize": {"size": [640, 640], "keep_ratio": True,
                       "fill": [114, 114, 114]},
            "ToTensor": None,
            "Normalize": {"mean": [0, 0, 0], "std": [1, 1, 1]},
        },
    }


def smoke_config(workdir: Path, n_batches: int) -> Path:
    """The flagship's serving config (conf/coco_yolov5_s.yml: USE_MODEL and
    the VAL transforms) on SyntheticDetection at 640², 80 COCO classes,
    written as JSON."""
    cfg = {
        "EXPERIMENT_NAME": "chip_smoke_yolov5s",
        "DATASET": {
            "CLASS": "SyntheticDetection",
            "DICTIONARY": str(write_dictionary(workdir)),
            "DICTIONARY_NAME": "DET_CLASSES",
            "VAL": val_stage(BATCH * n_batches),
        },
        "USE_MODEL": FLAGSHIP_MODEL,
    }
    path = workdir / "coco_yolov5_s_synthetic.json"
    path.write_text(json.dumps(cfg))
    return path


def train_config(workdir: Path) -> Path:
    """conf/coco_yolov5_s.yml's training recipe on SyntheticDetection at
    640² with the device augmentation (``DEVICE_AUG``, in place of the
    host transforms that ``host_aug_config`` runs): AMP, EMA, SGD momentum
    0.937 with weight decay 5e-4, LambdaLR with LRF 0.1, linear warmup of
    1000 iterations from 0.1, grad-clip norm 10, batch 32; cut to 8 steps
    an epoch, 2 epochs, 64 val images validated every epoch.  The INFER
    stage (one batch) serves the checkpoint afterwards."""
    cfg = {
        "EXPERIMENT_NAME": "chip_smoke_train",
        "SEED": 0,
        "DATASET": {
            "CLASS": "SyntheticDetection",
            "DICTIONARY": str(write_dictionary(workdir)),
            "DICTIONARY_NAME": "DET_CLASSES",
            "MAX_BOXES": 128,
            "TRAIN": {
                "SIZE": [640, 640], "LENGTH": BATCH * TRAIN_STEPS_PER_EPOCH,
                "SEED": 0, "SHUFFLE": True, "BATCH_SIZE": BATCH,
                "NUM_WORKER": 8, "LOAD_NUM": 4,
                "DEVICE_AUG": {"SIZE": 640, "TILE": 320},
            },
            "VAL": val_stage(VAL_IMAGES),
            "INFER": val_stage(BATCH),
        },
        "USE_MODEL": FLAGSHIP_MODEL,
        "EVALUATOR": {"NAME": "coco_detection", "EVAL_TYPE": "mAP",
                      "EVAL_INTERVALS": 1},
        "CHECKPOINT_DIR": str(workdir / "checkpoints"),
        "N_EPOCHS_TO_SAVE_MODEL": 1,
        "N_MAX_EPOCHS": TRAIN_EPOCHS,
        "INIT_LR": 0.01,
        "SCALE_LR": 0,
        "OPTIMIZER": {"TYPE": "SGD", "MOMENTUM": 0.937,
                      "WEIGHT_PARAMS": {"weight_decay": 0.0005},
                      "BIAS_LR_MULTIPLIER": 1},
        "LR_SCHEDULER": {"TYPE": "LambdaLR", "LRF": 0.1},
        "WARMUP": {"NAME": "linear", "ITERS": 1000, "FACTOR": 0.1},
        "AMP": True,
        "EMA": True,
        "PATIENCE": 100,
        "GRAD_CLIP": {"TYPE": "norm", "VALUE": 10.0},
        "N_ITERS_TO_DISPLAY_STATUS": 4,
        "TENSORBOARD": False,
    }
    path = workdir / "coco_yolov5_s_train_synthetic.json"
    path.write_text(json.dumps(cfg))
    return path


def seeded_weights(model, seed: int, obj_bias: float = 6.0) -> None:
    """Random weights from one torch.Generator: lecun-normal convs, BN
    affine and running stats away from identity, and the detect layer's
    objectness bias raised by ``obj_bias`` so that many candidates pass
    conf_threshold and NMS has real overlaps to suppress."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            leaf = name.rsplit(".", 1)[-1]
            if t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=g)
                        / float(np.prod(t.shape[1:])) ** 0.5)
            elif leaf in ("weight", "running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.startswith("detect."):
                t.add_(torch.randn(t.shape, generator=g) * 0.1)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
        no = 5 + model.num_classes
        for i in range(model.detect.n_levels):
            getattr(model.detect, f"m{i}").bias.view(-1, no)[:, 4] += obj_bias


def check_predictions(path: Path, n_images: int, num_classes: int,
                      min_dets: int = 1, size: int = 640, max_dets: int = 300) -> int:
    preds = json.loads(path.read_text())
    if len(preds) != n_images:
        raise AssertionError(f"{len(preds)} predictions for {n_images} images")
    total = 0
    for p in preds:
        boxes = np.asarray(p["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(p["scores"], np.float64)
        labels = np.asarray(p["labels"])
        n = len(labels)
        if not (len(boxes) == len(scores) == n and min_dets <= n <= max_dets):
            raise AssertionError(f"malformed prediction with {n} detections")
        if not (np.isfinite(boxes).all() and (boxes >= 0).all()
                and (boxes <= size).all() and (boxes[:, 2:] >= boxes[:, :2]).all()):
            raise AssertionError(f"boxes outside the {size}² canvas or not xyxy")
        if not ((scores > 0).all() and (scores <= 1).all()
                and (np.diff(scores) <= 0).all()):
            raise AssertionError("scores not in (0, 1] and descending")
        if not (all(isinstance(x, int) for x in p["labels"]) and (labels >= 0).all()
                and (labels < num_classes).all()):
            raise AssertionError("labels not class ids")
        total += n
    return total


def profile_device(fn, top: int = 12, groups=None) -> dict:
    """torch.profiler over one call of ``fn`` after a warm-up call (reading a
    session's trace back costs seconds per profiled train step, and the
    run's time limit holds them): device time by kernel (the ``top``
    largest) and the device's busy share of the wall;
    with ``groups`` ({name: regex}), the device time of the
    kernels whose names match each regex and its share of the busy time.
    Ranges that code marks with ``record_function`` (``Optimizer.step``)
    come back as device events too; they span kernels counted already, so
    they are listed apart (``annotated_ms``: first to last kernel in the
    range) and left out of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    annotated = [e for e in on_device if getattr(e, "is_user_annotation", False)]
    kernels = [e for e in on_device if e not in annotated]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    grouped = {}
    for name, pattern in (groups or {}).items():
        ms = sum(e.self_device_time_total for e in kernels if pattern.search(e.key)) / 1e3
        grouped[name] = {"ms": ms, "share_of_busy": ms / busy_ms}
    return {
        **({"groups": grouped} if groups else {}),
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "device_ops_per_call": sum(e.count for e in kernels),
        "annotated_ms": {e.key: e.self_device_time_total / 1e3 for e in annotated},
        "top": [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in kernels[:top]],
    }


def path_phase(workdir: Path) -> dict:
    """YOLOv5-s 640 served through ``infer.main`` on the card."""
    import torch

    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
    from cvpytorch_tpu_torch.data.datasets.synthetic import SyntheticDetection
    from cvpytorch_tpu_torch.data.loader import default_collate
    from cvpytorch_tpu_torch.data.transforms import build_transforms
    from cvpytorch_tpu_torch.models.detects.yolov5_detect import decode_yolov5
    from cvpytorch_tpu_torch.models.yolov5 import DEFAULT_ANCHORS, STRIDES
    from cvpytorch_tpu_torch.ops import nms as nms_mod
    from cvpytorch_tpu_torch.ops.nms import top_k
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from cvpytorch_tpu_torch.train_state import make_predict_step, prepare_images

    n_batches = 2
    setting = smoke_config(workdir, n_batches)
    cfg = CommonConfiguration.from_file(str(setting))
    _, dictionary = load_dictionary(cfg.DATASET.DICTIONARY, "DET_CLASSES")
    model = infer.build_model(cfg, dictionary)
    seeded_weights(model, seed=0)
    ckpt = workdir / "yolov5_s_seed0.pt"
    torch.save(model.state_dict(), ckpt)

    # the main path: the infer CLI, counts read just around it.  TF32 is at
    # PyTorch's defaults (cuDNN's on) until the CLI's predict step turns it off
    nms_keep.launches = 0
    t0 = time.perf_counter()
    infer.main(["--setting", str(setting), "--checkpoint", str(ckpt),
                "--out", str(workdir / "out")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = nms_keep.launches
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("infer.main served with TF32 switched on")
    if launches != n_batches:
        raise AssertionError(f"nms_keep launched {launches} times for "
                             f"{n_batches} batches")
    n_dets = check_predictions(workdir / "out" / "predictions.json",
                               BATCH * n_batches, len(dictionary))
    print(f"infer.main: {BATCH * n_batches} images in {cli_s:.2f} s "
          f"(host clock, includes model build and data), {n_dets} "
          f"detections, nms_keep launches {launches}", flush=True)

    # the same model on the first batch, at the precision the CLI left set
    # (both TF32 switches off): the kernel's detections equal the plain
    # NMS's on the same raw maps
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    stage = cfg.DATASET.VAL
    ds = SyntheticDetection(stage, dictionary,
                            build_transforms("DET_CLASSES", stage.TRANSFORMS),
                            stage="infer")
    images = torch.from_numpy(
        default_collate([ds[i] for i in range(BATCH)])["image"]).cuda()
    nms_input = []

    def capture(boxes, thr):
        nms_input.append((boxes.clone(), thr))
        return nms_keep(boxes, thr)

    with torch.inference_mode():
        raw = model._raw(images)
        nms_mod.nms_keep = capture
        try:
            with_kernel = model._predict(images, raw)
            nms_mod.nms_keep = nms_keep_plain
            with_plain = model._predict(images, raw)
        finally:
            nms_mod.nms_keep = nms_keep
    torch.cuda.synchronize()
    for key in ("boxes", "scores", "labels", "valid", "num"):
        if not torch.equal(with_kernel[key], with_plain[key]):
            raise AssertionError(f"path detections differ from plain NMS: {key}")
    first = json.loads((workdir / "out" / "predictions.json").read_text())[0]
    if first["labels"] != with_kernel["labels"][0][with_kernel["valid"][0]].tolist():
        raise AssertionError("infer.main and the predict step disagree")
    print(f"path detections with nms_keep == with nms_keep_plain "
          f"(batch {BATCH}, {int(with_kernel['num'].sum())} detections)",
          flush=True)
    # the kernel on the path's own NMS input: the (32, 1024, 4) class-shifted
    # boxes that batched_nms handed to nms_keep for this batch
    (path_boxes, path_thr), = nms_input

    # the card against the CPU on two images (f32, TF32 off on the card)
    cpu_model = infer.build_model(cfg, dictionary)
    cpu_model.load_state_dict(torch.load(ckpt, weights_only=True))
    with torch.inference_mode():
        cpu_raw = cpu_model.eval()._raw(images[:2].cpu())
    raw_err = max(float((a[:2].cpu() - b).abs().max()) for a, b in zip(raw, cpu_raw))
    if not raw_err < 1e-3:
        raise AssertionError(f"raw maps on the card vs CPU differ by {raw_err}")
    print(f"raw maps, card vs CPU (2 images): max abs err {raw_err:.3g}")

    # timings with CUDA events
    predict = make_predict_step(model)
    one = images[:1].contiguous()
    bs1 = call_ms(lambda: predict(one))
    bs32_ms = cuda_time_ms(lambda: predict(images), iters=10)
    with torch.inference_mode():
        raw_ms = cuda_time_ms(lambda: model._raw(images), iters=10)
        post_ms = cuda_time_ms(lambda: model._predict(images, raw), iters=10)
        # the cost of JAX's tie order: top_k over the (B, N·C) multi-label
        # scores against torch.topk, which promises no order among ties
        decoded = decode_yolov5(raw, DEFAULT_ANCHORS, STRIDES)
        scores = (decoded[..., 5:] * decoded[..., 4:5]).reshape(BATCH, -1)
        decode_ms = cuda_time_ms(
            lambda: decode_yolov5(raw, DEFAULT_ANCHORS, STRIDES), iters=10)
        top_k_ms = cuda_time_ms(lambda: top_k(scores, 1024), iters=10)
        torch_topk_ms = cuda_time_ms(lambda: scores.topk(1024), iters=10)
    # the model with TF32 convolutions (PyTorch's default), which the
    # predict step turns off: what serving would gain from TF32
    torch.backends.cudnn.allow_tf32 = True
    with torch.inference_mode():
        bs32_tf32_ms = cuda_time_ms(
            lambda: model(prepare_images(images), mode="infer"), iters=10)
    torch.backends.cudnn.allow_tf32 = False
    path_nms_ms = nms_event_ms(path_boxes, path_thr)
    print(f"nms_keep on the path's input {tuple(path_boxes.shape)} thr "
          f"{path_thr}: {path_nms_ms} ms", flush=True)
    print(json.dumps({"bs32_predict_profile": profile_device(lambda: predict(images))}))
    # (no bs1 predict profile: its session held the run's time limit)
    return {
        "launches": launches,
        "bs1_predict_ms_p50": float(np.median(bs1)),
        "bs1_predict_ms_min": float(np.min(bs1)),
        "bs32_predict_ms": bs32_ms,
        "bs32_images_per_s": BATCH / bs32_ms * 1e3,
        "bs32_backbone_neck_detect_ms": raw_ms,
        "bs32_decode_nms_ms": post_ms,
        "bs32_decode_ms": decode_ms,
        "bs32_multilabel_top_k_ms": top_k_ms,
        "bs32_multilabel_torch_topk_ms": torch_topk_ms,
        "bs32_images_per_s_tf32_convs": BATCH / bs32_tf32_ms * 1e3,
        "infer_cli_s": cli_s,
        "infer_cli_images": BATCH * n_batches,
        "raw_maps_card_vs_cpu_max_abs_err": raw_err,
        "nms_keep_on_path_input_ms": path_nms_ms,
    }, (path_boxes, path_thr)


def _tree(batch, fn):
    if isinstance(batch, dict):
        return {k: _tree(v, fn) for k, v in batch.items()}
    return fn(batch) if hasattr(batch, "device") else batch


def train_phase(workdir: Path) -> dict:
    """YOLOv5-s 640 trained through ``Trainer.run()`` on the card, then its
    last checkpoint served through ``infer.main``."""
    import torch

    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep

    workdir.mkdir()
    setting = train_config(workdir)
    cfg = CommonConfiguration.from_file(str(setting))
    trainer = trainer_mod.Trainer(cfg)  # on cuda, the entry point's default
    # the main path of this phase, counts read just around it
    run = run_instrumented(trainer, trainer_mod)
    state, times, run_s, launches = (run[k] for k in ("state", "times", "run_s", "launches"))
    losses = [m["loss"] for m in run["metrics"]]
    steps = TRAIN_STEPS_PER_EPOCH * TRAIN_EPOCHS
    loss = torch.stack(losses).float().cpu()
    if len(losses) != steps or state.step != steps:
        raise AssertionError(f"{len(losses)} losses, state at step {state.step}, "
                             f"for {steps} steps")
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"non-finite train loss: {loss.tolist()}")
    val_batches = -(-VAL_IMAGES // BATCH) * TRAIN_EPOCHS
    if launches != val_batches:
        raise AssertionError(f"nms_keep launched {launches} times for "
                             f"{val_batches} val batches")
    saved = sorted(p.name for p in Path(trainer.checkpoints.save_dir).iterdir())
    if saved != ["best.pt", "deploy.pt", "last.pt"]:
        raise AssertionError(f"checkpoints written: {saved}")
    print(f"Trainer.run(): {steps} steps in {run_s:.2f} s (host clock, from "
          f"model build to the last checkpoint), losses {loss.tolist()}, "
          f"nms_keep launches {launches} for {val_batches} val batches, "
          f"checkpoints {saved}", flush=True)

    # the last checkpoint serves one batch through the infer CLI
    nms_keep.launches = 0
    infer.main(["--setting", str(setting), "--checkpoint",
                str(Path(trainer.checkpoints.save_dir) / "last.pt"),
                "--out", str(workdir / "served")])
    if nms_keep.launches != 1:
        raise AssertionError(f"serving the checkpoint launched nms_keep "
                             f"{nms_keep.launches} times for 1 batch")
    n_dets = check_predictions(workdir / "served" / "predictions.json", BATCH,
                               len(trainer.dictionary), min_dets=0)
    print(f"infer.main on the trained checkpoint: {BATCH} images, {n_dets} "
          "detections", flush=True)
    n_train = BATCH * TRAIN_STEPS_PER_EPOCH
    return {
        "steps": steps,
        "launches": launches,
        "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
        "run_s": run_s,
        "epoch_s": times["train_epoch"],
        "fed_images_per_s_epoch2": n_train / times["train_epoch"][-1],
        "val_epoch_s": times["val_epoch"],
        "val_evaluator_s": times["evaluator"] / TRAIN_EPOCHS,
        "val_evaluator_share": times["evaluator"] / sum(times["val_epoch"]),
        "served_detections": n_dets,
    }, trainer


def raw_train_batch(trainer) -> dict:
    """The first host batch of the train loader (raw tiles), on the card,
    tagged as step 0 of epoch 0."""
    import torch

    host = next(iter(trainer.dataloaders["train"]))
    return {"image": torch.from_numpy(host["image"]).cuda(),
            "target": {**{k: torch.from_numpy(v).cuda()
                          for k, v in host["target"].items()},
                       "epoch": 0, "aug_step": 0}}


def train_timing(trainer) -> dict:
    """The train step at bs32 on one augmented batch already on the card,
    by CUDA events over 5 steps after 2 warm-up steps, AMP and f32; the
    device augmentation of one batch; the peak memory of each step."""
    import torch

    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step
    from cvpytorch_tpu_torch.infer import build_model

    raw = raw_train_batch(trainer)
    preprocess = trainer._device_aug_preprocess()
    aug_ms = cuda_time_ms(lambda: preprocess(raw), iters=10)
    batch = preprocess(raw)

    def fresh_state():
        torch.manual_seed(0)
        model = build_model(trainer.cfg, trainer.dictionary).to(
            "cuda", memory_format=torch.channels_last)
        opt = build_optimizer(trainer.cfg, model, trainer.lr_schedule)
        return create_train_state(model, opt, use_ema=True)

    out = {"device_aug_ms": aug_ms}
    for name, amp in (("amp", True), ("f32", False)):
        state = fresh_state()
        step = make_train_step(amp=amp, ema_decay=0.9999)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: step(state, batch), iters=5, warmup=2)
        out[f"{name}_step_ms"] = ms
        out[f"{name}_images_per_s"] = BATCH / ms * 1e3
        out[f"{name}_max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del state
    out["kept_boxes_per_image"] = float(batch["target"]["valid"].sum()) / BATCH
    out.update(host_data_timing(trainer))
    return out, batch


def host_data_timing(trainer) -> dict:
    """The host's side of the fed rate, with no device work: the train
    loader's rate over one epoch (its worker threads drawing the
    synthetic samples and the collate letterboxing their tiles), and on
    one thread the draw of one item (a LOAD_NUM group of 4 raw 640²
    samples) and the collate of one batch of such items."""
    loader = trainer.dataloaders["train"]
    ds, collate = loader.dataset, loader.collate_fn
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in loader)
    loader_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    items = [ds[i] for i in range(BATCH)]
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    collate(items)
    collate_s = time.perf_counter() - t0
    return {"host_loader_images_per_s": n / loader_s,
            "host_item_draw_ms_one_thread": draw_s * 1e3 / BATCH,
            "host_collate_ms_one_thread": collate_s * 1e3}


def train_step_check(trainer, batch) -> dict:
    """One f32 train step (TF32 off) of YOLOv5-s at 640², B = 2, from the
    same seeded weights on one fixed batch, on the card and on the CPU;
    then one AMP step on the card from the same weights."""
    import copy

    import torch

    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step

    two = _tree(batch, lambda t: t[:2] if t.dim() else t)
    torch.manual_seed(1)
    base = build_model(trainer.cfg, trainer.dictionary)
    results = {}
    for name, device, amp in (("cpu_f32", "cpu", False), ("card_f32", "cuda", False),
                              ("card_amp", "cuda", True)):
        model = copy.deepcopy(base).to(device, memory_format=torch.channels_last)
        opt = build_optimizer(trainer.cfg, model, trainer.lr_schedule)
        state = create_train_state(model, opt, use_ema=True)
        _, metrics = make_train_step(amp=amp, ema_decay=0.9999)(
            state, _tree(two, lambda t: t.to(device)))
        results[name] = (float(metrics["loss"]),
                         {k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    ref_loss, ref = results["cpu_f32"]
    card = results["card_f32"][1]
    before = base.state_dict()
    loss_rel = abs(results["card_f32"][0] - ref_loss) / abs(ref_loss)
    amp_rel = abs(results["card_amp"][0] - results["card_f32"][0]) / abs(results["card_f32"][0])

    def worst(rel):  # (largest relative difference, its tensor) over the floats
        return max((rel(k, v), k) for k, v in ref.items() if v.is_floating_point())

    param_rel, param_at = worst(lambda k, v: float(
        (card[k] - v).abs().max() / max(float(v.abs().max()), 1e-12)))
    # the same against the size of the step's change of each tensor
    update_rel, update_at = worst(lambda k, v: float(
        (card[k] - v).abs().max()
        / max(float((v - before[k].float()).abs().max()), 1e-12)))
    out = {"loss_cpu_f32": ref_loss, "loss_card_f32": results["card_f32"][0],
           "loss_card_amp": results["card_amp"][0], "loss_rel_card_vs_cpu": loss_rel,
           "max_param_rel_card_vs_cpu": param_rel, "max_param_rel_at": param_at,
           "max_update_rel_card_vs_cpu": update_rel, "max_update_rel_at": update_at,
           "loss_rel_amp_vs_f32": amp_rel}
    if not loss_rel <= 1e-4:
        raise AssertionError(f"f32 train-step loss, card vs CPU: {loss_rel:.3g} relative")
    if not amp_rel <= 5e-2:
        raise AssertionError(f"AMP train-step loss vs f32: {amp_rel:.3g} relative")
    return out


def _profiled_train_state(trainer):
    """One AMP train step of a fresh YOLOv5-s, with the device augmentation
    of a raw batch on the card inside it, as a callable for the
    profiler."""
    import torch

    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step

    torch.manual_seed(0)
    model = build_model(trainer.cfg, trainer.dictionary).to(
        "cuda", memory_format=torch.channels_last)
    state = create_train_state(
        model, build_optimizer(trainer.cfg, model, trainer.lr_schedule), use_ema=True)
    step = make_train_step(amp=True, ema_decay=0.9999,
                           preprocess=trainer._device_aug_preprocess())
    raw = raw_train_batch(trainer)
    return lambda: step(state, raw)


# -- data parallelism: YOLOv5-s 640 over torchrun ranks on the one card ----

DP_RANKS = 2
DP_STEPS = 2  # one epoch at the global batch of 32, 16 images a rank
DP_VAL_IMAGES = 64  # 2 val batches a rank (16 images each)
DP_NCCL_STEPS = 1  # the one-rank NCCL run: one step, one val batch
DP_NCCL_VAL_IMAGES = BATCH
DP_CHECK_SEED = 3  # the f32 check's model
DP_TIMEOUT_S = 300
TP_TIMEOUT_S = 240  # the two-rank session's tensor-parallel part


def dp_config(workdir: Path, name: str, steps: int, val_images: int,
              val_batch: int = BATCH, batch: int = BATCH, parallel: dict | None = None) -> Path:
    """``train_config``'s recipe (AMP, EMA, ``DEVICE_AUG``, the global batch
    of 32 or ``batch``) cut to one epoch of ``steps`` steps and a val of
    ``val_images`` at ``val_batch``, with ``parallel`` as its
    ``PARALLEL``."""
    workdir.mkdir(parents=True, exist_ok=True)
    cfg = json.loads(train_config(workdir).read_text())
    cfg["EXPERIMENT_NAME"] = f"chip_smoke_{name}"
    cfg["N_MAX_EPOCHS"] = 1
    cfg["CHECKPOINT_DIR"] = str(workdir / "checkpoints")
    cfg["DATASET"]["TRAIN"].update(LENGTH=batch * steps, BATCH_SIZE=batch)
    cfg["DATASET"]["VAL"].update(LENGTH=val_images, BATCH_SIZE=val_batch)
    if parallel:
        cfg["PARALLEL"] = parallel
    path = workdir / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return path


def fixed_raw_batch(trainer, rows: range) -> dict:
    """``rows`` of a global raw train batch that every process builds alike:
    item i's ``LOAD_NUM`` group is samples i, i + 1, i + 2, i + 3 (the
    loader draws the group's others from each process's own host
    ``random``), letterboxed by the ``DEVICE_AUG`` collate; on the card,
    as step 0 of epoch 0."""
    import torch

    loader = trainer.dataloaders["train"]
    ds = loader.dataset
    host = loader.collate_fn([[ds._load_one((i + k) % len(ds)) for k in range(4)]
                              for i in rows])
    dev = trainer.device
    return {"image": torch.from_numpy(host["image"]).to(dev),
            "target": {**{k: torch.from_numpy(v).to(dev) for k, v in host["target"].items()},
                       "epoch": 0, "aug_step": 0}}


def dp_f32_step(trainer, rows: range) -> dict:
    """One f32 train step (TF32 off) with EMA and the device augmentation
    of a fresh YOLOv5-s from ``DP_CHECK_SEED`` on ``rows`` of
    ``fixed_raw_batch``; rank 0's weights are broadcast first under a live
    group, then laid out on the trainer's mesh.  Returns the loss, and the
    weights before and after (gathered whole), on the CPU."""
    import torch

    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler
    from cvpytorch_tpu_torch.parallel import dist as dp
    from cvpytorch_tpu_torch.parallel.mesh import full_state_dict, shard_train_state
    from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step

    torch.manual_seed(DP_CHECK_SEED)
    model = build_model(trainer.cfg, trainer.dictionary).to(
        trainer.device, memory_format=torch.channels_last)
    opt = build_optimizer(trainer.cfg, model,
                          build_lr_scheduler(trainer.cfg, trainer.iters_per_epoch))
    state = create_train_state(model, opt, use_ema=True)
    dp.broadcast_module_(model)
    dp.broadcast_module_(state.ema)
    before = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    shard_train_state(state, trainer.mesh)
    step = make_train_step(amp=False, ema_decay=0.9999,
                           preprocess=trainer._device_aug_preprocess())
    _, metrics = step(state, fixed_raw_batch(trainer, rows))
    return {"loss": float(metrics["loss"]), "before": before,
            "after": {k: v.detach().float().cpu() for k, v in full_state_dict(model).items()},
            "params": [name for name, _ in model.named_parameters()]}


def dp_step_split(step, state, raw) -> dict:
    """The W-rank AMP step with BN's all-reduces made identities (the
    global moments' float32 passes kept), timed by CUDA events on both
    ranks at once: what BN's collectives take of the step.  (The split's
    other two variants, each rank's own moments and the gradient sum
    alone, are in PERF.md §5 from earlier runs.)"""
    from cvpytorch_tpu_torch.parallel import dist as dp

    real = dp.all_reduce_with_grad
    dp.all_reduce_with_grad = lambda x: x
    try:
        return {"bn_collectives_off_ms": cuda_time_ms(lambda: step(state, raw), iters=2,
                                                      warmup=1)}
    finally:
        dp.all_reduce_with_grad = real


def dp_rank_main(out_dir: str, setting: str, backend: str, device: str, go: str,
                 tp_setting: str = "") -> int:
    """One rank of ``data_parallel_phase`` (run by ``torchrun``): the
    trainer's ``Trainer(cfg, device, backend).run()`` (its model's class
    and objectness biases at 0, ``zero_class_biases``, so that the val
    holds detections to merge) with ``nms_keep``'s count set to 0 just
    before and read just after.  With ``go`` (a file
    the phase writes once nothing else runs on the card), also:
    ``nms_keep`` bit-exact against ``nms_keep_plain`` on this rank's first
    val input and timed; ``dp_f32_step`` on this rank's rows;
    ``tp_rank_run`` on ``tp_setting`` (while the phase's one-process
    reference and the NCCL rank still run); then, after ``go``, the
    W-rank AMP step timed by CUDA events and ``tp_rank_timings``.  Writes
    ``rank<r>.json`` (and rank 0 ``f32.pt``) under ``out_dir``."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from cvpytorch_tpu_torch.parallel import dist as dp
    from cvpytorch_tpu_torch.train_state import make_train_step

    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(setting), device=device,
                                  backend=backend)
    zero_class_biases(trainer.model)  # so that the val holds detections to merge
    rank, world = dp.rank(), dp.world_size()
    seen, restore = capture_nms_inputs()
    try:
        run = run_instrumented(trainer, trainer_mod)
    finally:
        restore()
    out = {"rank": rank, "world": world, "backend": backend, "device": str(trainer.device),
           "launches": run["launches"], "val_batches": len(trainer.dataloaders["val"]),
           "losses": [float(m["loss"]) for m in run["metrics"]], "step": run["state"].step,
           "val": run["val"], "run_s": run["run_s"],
           "save_dir": trainer.checkpoints.save_dir if trainer.checkpoints else None}
    if go:
        boxes, thr = seen[0]
        out["nms"] = {"shape": list(boxes.shape), "thr": thr,
                      "bit_exact": bool(torch.equal(nms_keep(boxes, thr),
                                                    nms_keep_plain(boxes, thr)))}
        sl = trainer._rows or slice(0, BATCH)
        rows = range(sl.start, sl.stop)
        out["rows"] = len(rows)
        f32 = dp_f32_step(trainer, rows)
        out["f32_loss"] = f32["loss"]
        if rank == 0:
            torch.save(f32, Path(out_dir) / "f32.pt")
            # the merged val records (per image: scores, matches), for the
            # phase to hold to one process's
            torch.save(trainer.evaluator.state_dict(), Path(out_dir) / "val_state.pt")
        tp_trainer, tp_state, out["tp"] = tp_rank_run(tp_setting, backend, device, out_dir)
        deadline = time.monotonic() + DP_TIMEOUT_S
        while not Path(go).exists():  # the card to ourselves for the timings
            if time.monotonic() > deadline:
                raise AssertionError(f"{go} did not appear")
            time.sleep(0.05)
        dp.barrier()
        out["nms"]["ms"] = nms_event_ms(boxes, thr)
        out["nms"]["plain_ms"] = cuda_time_ms(lambda: nms_keep_plain(boxes, thr),
                                              iters=2, warmup=1)
        step = make_train_step(amp=True, ema_decay=0.9999,
                               preprocess=trainer._device_aug_preprocess())
        raw = fixed_raw_batch(trainer, rows)
        # the run's state and shapes: warm already
        out["amp_step_ms"] = cuda_time_ms(lambda: step(run["state"], raw), iters=2, warmup=0)
        out["amp_step_split"] = dp_step_split(step, run["state"], raw)
        del run, step, raw, trainer
        torch.cuda.empty_cache()
        out["tp"].update(tp_rank_timings(tp_trainer, tp_state))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    dp.barrier()
    dp.destroy()
    return 0


# -- tensor parallelism: YOLOv5-s 640 over the model axis of the same ranks ----

TP_BATCH = 8  # the global batch: data = 1, so each rank computes all 8 images
TP_STEPS = 2
TP_VAL_IMAGES = TP_BATCH  # one val batch
SPATIAL_FRAME = (1, 1024, 2048, 3)  # a Cityscapes frame, NHWC


def replicated_digests(state) -> dict:
    """sha256 of every replicated leaf: the model's and the EMA's
    floating tensors (parameters and BN statistics) that are not blocks,
    and the optimizer's per-leaf state of the replicated parameters."""
    import hashlib

    import torch

    from cvpytorch_tpu_torch.parallel.tensor import is_sharded, shards

    digest = lambda t: hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    out = {}
    for prefix, module in (("model", state.model), ("ema", state.ema)):
        blocks = shards(module)
        for name, t in module.state_dict().items():
            if name not in blocks and t.is_floating_point():
                out[f"{prefix}.{name}"] = digest(t)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        if not is_sharded(p):
            for k, v in state.optimizer.state.get(p, {}).items():
                if torch.is_tensor(v) and v.is_floating_point():
                    out[f"optimizer.{i}.{k}"] = digest(v)
    return out


def held_report(trainer, state) -> dict:
    """What this rank holds against the rule: every leaf ``tp_shardings``
    shards on a full model is a block of its shape over the model axis and
    every other leaf is whole; the leaves and megabytes held against one
    process's."""
    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.parallel.mesh import tp_shardings
    from cvpytorch_tpu_torch.parallel.tensor import shards

    full = build_model(trainer.cfg, trainer.dictionary)
    plan = {k for k, v in tp_shardings(full, trainer.mesh).items() if v}
    blocks = shards(state.model)
    shapes = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
    whole = {n: tuple(p.shape) for n, p in full.named_parameters()}
    only_blocks = set(blocks) == plan and all(
        shapes[n] == (blocks[n].shape() if n in plan else whole[n]) for n in whole)
    return {"sharded_leaves": len(blocks), "leaves": len(whole), "only_blocks": only_blocks,
            "params_mb_held": sum(p.nbytes for p in state.model.parameters()) / 2**20,
            "params_mb_one_process": sum(p.nbytes for p in full.parameters()) / 2**20}


class _LocalStandIns:
    """``torch.distributed`` with the model axis's collectives done locally
    at their shapes (an all-gather repeats this rank's block): the step's
    time without them."""

    def __getattr__(self, name):
        import torch.distributed as dist

        return getattr(dist, name)

    @staticmethod
    def all_gather(pieces, x, group=None):
        for p in pieces:
            p.copy_(x)

    @staticmethod
    def all_reduce(x, group=None):
        pass

    @staticmethod
    def broadcast(x, src, group=None):
        pass


def tp_step_split(step, state, raw) -> dict:
    """The tensor-parallel AMP step, and the same step with the model
    group's collectives as local stand-ins, timed by CUDA events on both
    ranks at once (the ranks wait on each other's collectives: the host
    clock of a step is its wall).  The stand-ins leave the state garbage:
    this runs last."""
    from cvpytorch_tpu_torch.parallel import dist as dp
    from cvpytorch_tpu_torch.parallel import tensor

    dp.barrier()
    ms = cuda_time_ms(lambda: step(state, raw), iters=2, warmup=0)  # warm from the run
    real = tensor.dist
    tensor.dist = _LocalStandIns()
    try:
        local = cuda_time_ms(lambda: step(state, raw), iters=2, warmup=1)
    finally:
        tensor.dist = real
    dp.barrier()
    return {"amp_step_ms": ms, "model_collectives_local_ms": local,
            "model_collectives_share": 1 - local / ms}


def spatial_models(device) -> dict:
    """JAX's two ``spatial_apply`` test models in torch, on NHWC input,
    weights from a seed: the 3-conv FCN (receptive radius 3, overlap 4)
    and the stride-2 down/up chain (a 3×3 stride-2 convolution, ReLU, a
    4×4 stride-2 transposed convolution, a 3×3 head; overlap 8, interior
    from row 6)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)

    def conv(o, i, k=3):
        return ((torch.randn(o, i, k, k, generator=g) / (i * k * k) ** 0.5).to(device),
                (torch.randn(o, generator=g) * 0.1).to(device))

    c0, c1, c2 = conv(8, 3), conv(8, 8), conv(2, 8)
    down, head = conv(8, 3), conv(2, 4)
    up = ((torch.randn(8, 4, 4, 4, generator=g) / 32 ** 0.5).to(device),
          (torch.randn(4, generator=g) * 0.1).to(device))

    def fcn(x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(F.conv2d(x, *c0, padding=1))
        x = F.relu(F.conv2d(x, *c1, padding=1))
        return F.conv2d(x, *c2, padding=1).permute(0, 2, 3, 1)

    def down_up(x):
        x = F.relu(F.conv2d(x.permute(0, 3, 1, 2), *down, stride=2, padding=1))
        x = F.conv_transpose2d(x, *up, stride=2, padding=1)
        return F.conv2d(x, *head, padding=1).permute(0, 2, 3, 1)

    return {"fcn": (fcn, 4, 3), "down_up": (down_up, 8, 6)}


def spatial_check(mesh, device) -> dict:
    """``spatial_apply`` of both models over the model axis's two ranks on a
    Cityscapes frame against this process's unsplit forward, float32 with
    TF32 off: the largest difference over the interior rows and over the
    rows either side of each seam, and both times by CUDA events."""
    import torch

    from cvpytorch_tpu_torch.parallel.spatial import spatial_apply

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    x = torch.rand(SPATIAL_FRAME, generator=g).to(device)
    h = SPATIAL_FRAME[1] // mesh.model
    out = {}
    with torch.no_grad():
        for name, (fn, overlap, r) in spatial_models(device).items():
            run = lambda: spatial_apply(fn, x, mesh, axis="model", overlap=overlap)
            got, ref = run(), fn(x)
            seams = [h * s + d for s in range(1, mesh.model) for d in (-1, 0)]
            out[name] = {
                "overlap": overlap, "shape": list(got.shape),
                "interior_max_abs_err": float((got - ref)[:, r:-r].abs().max()),
                "seam_max_abs_err": float((got - ref)[:, seams].abs().max()),
                "border_max_abs_err": float((got - ref).abs().max()),
                "split_ms": cuda_time_ms(run, iters=2, warmup=1),
                "unsplit_ms": cuda_time_ms(lambda: fn(x), iters=2, warmup=1)}
    return out


def tp_rank_run(setting: str, backend: str, device: str, out_dir: str) -> tuple:
    """The tensor-parallel run on this rank of the two-rank session:
    ``Trainer(cfg).run()`` with ``PARALLEL: {MODEL: 2}`` (class and
    objectness biases at 0) with ``nms_keep``'s count set to 0 just before
    and read just after; then ``nms_keep`` bit-exact on this rank's first
    val input, the replicated leaves' digests, what the rank holds and
    ``dp_f32_step`` laid out on the mesh (rank 0 writes it, weights
    gathered whole, as ``tp_f32.pt`` under ``out_dir``).  Returns the
    trainer, its state and the record."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from cvpytorch_tpu_torch.parallel import dist as dp

    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(setting), device=device,
                                  backend=backend)
    zero_class_biases(trainer.model)
    seen, restore = capture_nms_inputs()
    try:
        run = run_instrumented(trainer, trainer_mod)
    finally:
        restore()
    boxes, thr = seen[0]
    state = run["state"]
    out = {"mesh": trainer.mesh.shape, "launches": run["launches"],
           "val_batches": len(trainer.dataloaders["val"]), "step": state.step,
           "losses": [float(m["loss"]) for m in run["metrics"]], "val": run["val"],
           "run_s": run["run_s"],
           "save_dir": trainer.checkpoints.save_dir if trainer.checkpoints else None,
           "nms": {"shape": list(boxes.shape), "thr": thr,
                   "bit_exact": bool(torch.equal(nms_keep(boxes, thr),
                                                 nms_keep_plain(boxes, thr)))},
           "replicated": replicated_digests(state), "held": held_report(trainer, state)}
    f32 = dp_f32_step(trainer, range(TP_BATCH))
    out["f32_loss"] = f32["loss"]
    if dp.rank() == 0:
        torch.save(f32, Path(out_dir) / "tp_f32.pt")
    del f32
    torch.cuda.empty_cache()
    return trainer, state, out


def tp_rank_timings(trainer, state) -> dict:
    """With the card to the two ranks: ``spatial_apply`` on a Cityscapes
    frame, then the tensor-parallel AMP step and its split."""
    from cvpytorch_tpu_torch.train_state import make_train_step

    out = {"spatial": spatial_check(trainer.mesh, trainer.device)}
    step = make_train_step(amp=True, ema_decay=0.9999,
                           preprocess=trainer._device_aug_preprocess())
    out["split"] = tp_step_split(step, state, fixed_raw_batch(trainer, range(TP_BATCH)))
    return out


def tensor_parallel_checks(workdir: Path, card: str, tps: list, tp_f32: dict, one: dict,
                           setting: Path) -> dict:
    """The gates on the two ranks' tensor-parallel part: every step's loss
    finite; ``nms_keep`` launched once per val batch on each rank and
    bit-exact on its input; the replicated leaves bit-identical across
    the ranks; each rank holding only its blocks; rank 0 alone writing the
    checkpoint, which serves one batch through ``infer.main`` in this one
    process; the f32 step (``tp_f32``, its weights gathered whole) against
    one process's (``one``) on the same batch: the loss within 1e-4, the
    parameters and BN statistics after it within 1e-4 of the largest leaf,
    the update within 1e-2, as the data-parallel step is held; and
    ``spatial_apply``'s interior and seam rows within 1e-5 of the unsplit
    forward."""
    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep

    before = nms_keep.launches
    infer.main(["--setting", str(setting), "--checkpoint",
                str(Path(tps[0]["save_dir"]) / "last.pt"), "--out", str(workdir / "tp_served")])
    served = json.loads((workdir / "tp_served" / "predictions.json").read_text())
    param_rel, param_at = _max_rel(tp_f32["after"], one["after"])
    moved = lambda r: {k: r["after"][k] - r["before"][k] for k in r["params"]}
    update_rel, update_at = _max_rel(moved(tp_f32), moved(one))
    out = {
        "ranks": len(tps), "mesh": tps[0]["mesh"], "global_batch": TP_BATCH,
        "losses_by_rank": [t["losses"] for t in tps],
        "launches_by_rank": [t["launches"] for t in tps],
        "val_batches_by_rank": [t["val_batches"] for t in tps],
        "val_mAP_by_rank": [t["val"][-1]["mAP"] for t in tps],
        "run_s_by_rank": [t["run_s"] for t in tps],
        "nms_rank_inputs": [t["nms"] for t in tps],
        "replicated_leaves": len(tps[0]["replicated"]),
        "replicated_bit_identical": all(t["replicated"] == tps[0]["replicated"] for t in tps),
        "held_by_rank": [t["held"] for t in tps],
        "f32_loss_by_rank": [t["f32_loss"] for t in tps], "f32_loss_one_process": one["loss"],
        "f32_loss_rel": max(abs(t["f32_loss"] - one["loss"]) / abs(one["loss"]) for t in tps),
        "f32_param_rel": param_rel, "f32_param_rel_at": param_at,
        "f32_update_rel": update_rel, "f32_update_rel_at": update_at,
        "spatial_by_rank": [t["spatial"] for t in tps],
        "split_by_rank": [t["split"] for t in tps],
        "served_images": len(served), "served_launches": nms_keep.launches - before,
        "card": card}
    split, held = out["split_by_rank"], tps[0]["held"]
    print(f"tensor parallelism, YOLOv5-s 640, global bs{TP_BATCH} over model = {len(tps)} "
          f"gloo ranks sharing one card ({card}): AMP step "
          f"{max(t['amp_step_ms'] for t in split):.1f} ms, "
          f"{max(t['model_collectives_local_ms'] for t in split):.1f} ms with the model "
          f"group's collectives as local stand-ins (their share "
          f"{min(t['model_collectives_share'] for t in split):.2f}–"
          f"{max(t['model_collectives_share'] for t in split):.2f}); a rank holds "
          f"{held['params_mb_held']:.1f} of {held['params_mb_one_process']:.1f} MB of "
          f"parameters ({held['sharded_leaves']} of {held['leaves']} leaves as blocks); f32 "
          f"step vs one process: loss {out['f32_loss_rel']:.2e}, parameters {param_rel:.2e} "
          f"({param_at}), update {update_rel:.2e} ({update_at}); replicated leaves "
          f"bit-identical: {out['replicated_bit_identical']}", flush=True)
    for t in tps:
        if not (t["step"] == len(t["losses"]) == TP_STEPS and np.isfinite(t["losses"]).all()):
            raise AssertionError(f"tensor-parallel losses {t['losses']}, step {t['step']}")
        if t["launches"] != t["val_batches"] or not t["nms"]["bit_exact"]:
            raise AssertionError(f"tensor-parallel nms_keep: {t['launches']} launches for "
                                 f"{t['val_batches']} val batches, {t['nms']}")
        if not t["held"]["only_blocks"]:
            raise AssertionError(f"a rank holds more than its blocks: {t['held']}")
        for name, r in t["spatial"].items():
            if not (r["interior_max_abs_err"] <= 1e-5 and r["seam_max_abs_err"] <= 1e-5):
                raise AssertionError(f"spatial_apply {name} vs the unsplit forward: {r}")
    if not out["replicated_bit_identical"]:
        raise AssertionError("the ranks' replicated leaves differ: " + str(sorted(
            k for k, v in tps[0]["replicated"].items() if tps[1]["replicated"].get(k) != v)[:10]))
    if [t["save_dir"] is not None for t in tps] != [True] + [False] * (len(tps) - 1):
        raise AssertionError("a rank other than 0 wrote the tensor-parallel checkpoint")
    if not (len(served) == BATCH and out["served_launches"] == 1):
        raise AssertionError(f"the tensor-parallel checkpoint served {len(served)} images with "
                             f"{out['served_launches']} nms_keep launches")
    if not (out["f32_loss_rel"] <= 1e-4 and param_rel <= 1e-4 and update_rel <= 1e-2):
        raise AssertionError(f"tensor-parallel f32 step vs one process: {out}")
    return out


def torchrun(nproc: int, args: list, log: Path) -> subprocess.Popen:
    """``python -m torch.distributed.run --standalone`` of this script in a
    session of its own (so that a timeout can stop every process of it),
    its output in ``log``."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), str(Path(__file__).resolve()), *args],
        stdout=log.open("w"), stderr=subprocess.STDOUT, start_new_session=True)


def stop_session(proc: subprocess.Popen) -> None:
    """Kills the whole session of a ``torchrun`` that is still running."""
    import os
    import signal

    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def wait_for(name: str, proc: subprocess.Popen, log: Path, timeout: float,
             fatal: bool = True):
    """The exit code of a ``torchrun`` process; at the deadline its whole
    session is killed, and it raises (or, not ``fatal``, returns None)."""
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_session(proc)
        if fatal:
            raise AssertionError(f"{name} ran past {timeout} s:\n{log.read_text()[-3000:]}")
        return None


def same_val_records(merged: dict, one: dict) -> dict:
    """Whether the merged COCO records equal one process's, image by image
    in the same order (scores, matches, ignores and GT counts), and how
    many detections they hold."""
    equal, dets = True, 0
    for t, ev in one.items():
        for c, areas in enumerate(ev["records"]):
            for a, recs in areas.items():
                got = merged[t]["records"][c][a]
                equal &= len(got) == len(recs)
                for g, w in zip(got, recs):
                    equal &= all(np.array_equal(x, y) for x, y in zip(g[:4], w[:4]))
                    dets += len(w[0]) if a == "all" else 0
    return {"equal": bool(equal), "detections": dets}


def _max_rel(a: dict, b: dict) -> tuple[float, str]:
    """max over the tensors of max |a − b|, over the largest |b| of all of
    them (relative to the largest leaf), and where it is largest."""
    top = max(float(v.abs().max()) for v in b.values() if v.is_floating_point())
    err, at = max((float((a[k] - v).abs().max()), k) for k, v in b.items()
                  if v.is_floating_point())
    return err / top, at


def data_parallel_phase(workdir: Path, card: str) -> dict:
    """Full-width YOLOv5-s 640 trained over two ``torchrun`` ranks on the one
    card (gloo: NCCL refuses two ranks on one device) and over one NCCL
    rank, each through ``Trainer.run()``, beside this process's
    one-process reference; the two ranks then train it tensor-parallel;
    then the two-rank steps timed alone, and the checks against one
    process on the same global batch and the same val set."""
    workdir.mkdir()
    setting = dp_config(workdir / "two_ranks", "dp_two_ranks", DP_STEPS, DP_VAL_IMAGES)
    nccl_setting = dp_config(workdir / "nccl", "dp_nccl", DP_NCCL_STEPS, DP_NCCL_VAL_IMAGES)
    tp_setting = dp_config(workdir / "tensor_parallel", "tp", TP_STEPS, TP_VAL_IMAGES,
                           val_batch=TP_BATCH, batch=TP_BATCH, parallel={"MODEL": DP_RANKS})
    outs = {k: workdir / k for k in ("two_ranks", "nccl")}
    logs = {k: workdir / f"{k}.log" for k in ("nccl", "two_ranks")}
    go = workdir / "go"
    procs = {"two_ranks": torchrun(DP_RANKS, ["--dp-rank", str(outs["two_ranks"]),
                                              str(setting), "gloo", "cuda:0", str(go),
                                              str(tp_setting)],
                                   logs["two_ranks"]),
             "nccl": torchrun(1, ["--dp-rank", str(outs["nccl"]), str(nccl_setting), "nccl",
                                  "cuda", ""], logs["nccl"])}
    try:
        return _data_parallel_checks(workdir, card, outs, logs, procs, go, tp_setting)
    finally:  # a failed check leaves no rank running
        for proc in procs.values():
            stop_session(proc)


def _data_parallel_checks(workdir, card, outs, logs, procs, go, tp_setting) -> dict:
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.train_state import make_eval_step
    from cvpytorch_tpu_torch.utils.checkpoints import Checkpoints

    # one process, at a rank's val batch so that every image's forward is
    # the ranks' own: what the merged metrics must equal
    ref_setting = dp_config(workdir / "reference", "dp_reference", DP_STEPS, DP_VAL_IMAGES,
                            val_batch=BATCH // DP_RANKS)
    ref = trainer_mod.Trainer(CommonConfiguration.from_file(str(ref_setting)))
    one = dp_f32_step(ref, range(BATCH))
    one_tp = dp_f32_step(ref, range(TP_BATCH))  # the TP run's global batch
    if wait_for("the one-rank NCCL run", procs["nccl"], logs["nccl"], DP_TIMEOUT_S) != 0:
        raise AssertionError(f"the one-rank NCCL run failed:\n{logs['nccl'].read_text()[-4000:]}")
    nccl = json.loads((outs["nccl"] / "rank0.json").read_text())
    torch.cuda.synchronize()
    go.write_text("")  # nothing else of the phase runs on the card now
    if wait_for("the two-rank run", procs["two_ranks"], logs["two_ranks"],
                DP_TIMEOUT_S + TP_TIMEOUT_S) != 0:
        raise AssertionError(f"the two-rank run failed:\n"
                             f"{logs['two_ranks'].read_text()[-4000:]}")
    ranks = [json.loads((outs["two_ranks"] / f"rank{r}.json").read_text())
             for r in range(DP_RANKS)]
    f32 = torch.load(outs["two_ranks"] / "f32.pt")
    state = ref._build_train_state()
    Checkpoints.restore_into(state, str(Path(ranks[0]["save_dir"]) / "last.pt"))
    _, one_val = ref.val_epoch(0, state, make_eval_step(use_ema=True), None)
    records = same_val_records(torch.load(outs["two_ranks"] / "val_state.pt",
                                          weights_only=False), ref.evaluator.state_dict())
    del ref, state
    torch.cuda.empty_cache()

    loss_rel = abs(f32["loss"] - one["loss"]) / abs(one["loss"])
    param_rel, param_at = _max_rel(f32["after"], one["after"])
    moved = lambda r: {k: r["after"][k] - r["before"][k] for k in r["params"]}
    update_rel, update_at = _max_rel(moved(f32), moved(one))
    merged = ranks[0]["val"][-1]
    out = {
        "ranks": DP_RANKS, "backend": "gloo", "global_batch": BATCH,
        "rows_a_rank": [r["rows"] for r in ranks],
        "losses": ranks[0]["losses"], "launches_by_rank": [r["launches"] for r in ranks],
        "val_batches_by_rank": [r["val_batches"] for r in ranks],
        "amp_step_ms_by_rank": [r["amp_step_ms"] for r in ranks],
        "amp_step_split_by_rank": [r["amp_step_split"] for r in ranks],
        "tensor_parallel": tensor_parallel_checks(
            workdir, card, [r["tp"] for r in ranks],
            torch.load(outs["two_ranks"] / "tp_f32.pt"), one_tp, tp_setting),
        "run_s_by_rank": [r["run_s"] for r in ranks],
        "val_mAP": merged["mAP"], "val_records": records,
        "val_equal_one_process": (json.dumps(merged, sort_keys=True)
                                  == json.dumps(one_val, sort_keys=True)),
        "f32_loss_two_ranks": f32["loss"], "f32_loss_one_process": one["loss"],
        "f32_loss_rel": loss_rel, "f32_param_rel": param_rel, "f32_param_rel_at": param_at,
        "f32_update_rel": update_rel, "f32_update_rel_at": update_at,
        "nms_rank_inputs": [r["nms"] for r in ranks],
        "nccl_one_rank": {k: nccl[k] for k in ("backend", "launches", "val_batches", "losses",
                                               "run_s")},
        "card": card}
    print(f"data parallelism, YOLOv5-s 640, global bs{BATCH} over {DP_RANKS} gloo ranks "
          f"sharing one card ({card}): AMP step {max(out['amp_step_ms_by_rank']):.1f} ms a "
          f"{BATCH}-image global batch (BN's all-reduces as identities "
          f"{max(r['bn_collectives_off_ms'] for r in out['amp_step_split_by_rank']):.1f} ms); "
          f"two ranks on one card measure correctness, not "
          f"scaling (no multi-GPU speed can be measured on one H100). f32 step vs one "
          f"process: loss {loss_rel:.2e}, parameters {param_rel:.2e} ({param_at}), update "
          f"{update_rel:.2e} ({update_at}); merged val equal to one process's: "
          f"{out['val_equal_one_process']}", flush=True)
    for r in ranks + [nccl]:
        if not (r["step"] == len(r["losses"]) and np.isfinite(r["losses"]).all()):
            raise AssertionError(f"rank {r['rank']} ({r['backend']}): losses {r['losses']}, "
                                 f"step {r['step']}")
        if r["launches"] != r["val_batches"]:
            raise AssertionError(f"rank {r['rank']} ({r['backend']}) launched nms_keep "
                                 f"{r['launches']} times for {r['val_batches']} val batches")
    for r in ranks:
        if not r["nms"]["bit_exact"]:
            raise AssertionError(f"nms_keep differs from nms_keep_plain on rank "
                                 f"{r['rank']}'s {r['nms']['shape']} input")
    if ranks[0]["losses"] != ranks[1]["losses"] or ranks[0]["val"] != ranks[1]["val"]:
        raise AssertionError("the ranks logged other losses or val metrics")
    if [r["rows"] for r in ranks] != [BATCH // DP_RANKS] * DP_RANKS:
        raise AssertionError(f"rows a rank: {[r['rows'] for r in ranks]}")
    if ranks[1]["save_dir"] is not None or len(list((workdir / "two_ranks" / "checkpoints")
                                                    .iterdir())) != 1:
        raise AssertionError("a rank other than 0 wrote checkpoints")
    if not (out["val_equal_one_process"] and records["equal"] and records["detections"]):
        raise AssertionError(f"merged val {merged} ({records}) != one process's {one_val}")
    if not (loss_rel <= 1e-4 and param_rel <= 1e-4 and update_rel <= 1e-2):
        raise AssertionError(f"two-rank f32 step vs one process: {out}")
    return out


HOST_AUG_STEPS = 2  # one epoch
HOST_AUG_VAL_IMAGES = 32  # one val batch


def host_aug_config(workdir: Path, coco: dict) -> Path:
    """``conf/coco_yolov5_s.yml`` as written (``CocoDetection``, its host
    pipeline: mosaic + affine on LOAD_NUM = 4 groups, flip, ColorHSV, the
    rare blurs and grayscale, ToCXCYWH, ToTensor, Normalize; MAX_BOXES
    128, AMP, EMA, SGD, warmup, grad clip, batch 32, bbox evaluation) with
    only ``IMG_DIR``/``ANN_FILE`` pointed at the COCO directory of JPEG
    files (``write_coco_dir``); cut to one epoch of 2 steps validated on 64
    images.  The INFER stage (one batch of 32) serves the checkpoint
    afterwards."""
    from cvpytorch_tpu_torch.config import CommonConfiguration

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / "coco_yolov5_s.yml"))
    data = cfg.DATASET
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    for stage in ("TRAIN", "VAL"):
        img_dir, ann_file = coco[stage.lower()]
        data.get(stage).update({"IMG_DIR": img_dir, "ANN_FILE": ann_file})
    data.INFER = {**dict(data.VAL), "ANN_FILE": coco["infer"][1]}
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / "coco_yolov5_s_jpeg_files.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def host_aug_phase(workdir: Path, coco: dict) -> tuple[dict, object]:
    """``conf/coco_yolov5_s.yml``'s host-augmented recipe trained from JPEG
    files through ``Trainer.run()`` (no ``DEVICE_AUG``: the train batches
    are the host pipeline's 640² float images) with bbox validation
    through ``nms_keep`` (once per val batch, none in the train steps), and
    its checkpoint served through ``infer.main`` (once per served batch)."""
    import torch

    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep

    workdir.mkdir()
    setting = host_aug_config(workdir, coco)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    names = [type(t).__name__ for t in trainer.datasets["train"].transform.transforms]
    if trainer._device_aug_size is not None or names[0] != "RandomAffineWithMosaic":
        raise AssertionError(f"not the host mosaic path: {names}")
    sizes = {stage: len(trainer.datasets[stage]) for stage in ("train", "val")}
    if (type(trainer.datasets["train"]).__name__ != "CocoDetection"
            or sizes != {"train": BATCH * HOST_AUG_STEPS, "val": HOST_AUG_VAL_IMAGES}):
        raise AssertionError(f"not the COCO files: {type(trainer.datasets['train'])}, {sizes}")
    # the main path of this phase, counts read just around it
    run = run_instrumented(trainer, trainer_mod)
    state, metrics, times, run_s, launches = (
        run[k] for k in ("state", "metrics", "times", "run_s", "launches"))
    if len(metrics) != HOST_AUG_STEPS or state.step != HOST_AUG_STEPS:
        raise AssertionError(f"{len(metrics)} steps recorded, state at step {state.step}")
    losses = [float(m["loss"]) for m in metrics]
    if not np.isfinite(losses).all():
        raise AssertionError(f"train losses {losses}")
    val_batches = -(-HOST_AUG_VAL_IMAGES // BATCH)
    if launches != val_batches:
        raise AssertionError(f"nms_keep launched {launches} times for {val_batches} val batches")
    (val_metrics,) = run["val"]
    if not np.isfinite(val_metrics["mAP"]):
        raise AssertionError(f"val mAP {val_metrics['mAP']}")
    print(f"YOLOv5-s host augmentation from JPEG files, Trainer.run(): {HOST_AUG_STEPS} steps "
          f"in {run_s:.2f} s "
          f"(host clock, from model build to the last checkpoint), losses {losses}, nms_keep "
          f"launches {launches} for {val_batches} val batches, val mAP {val_metrics['mAP']}",
          flush=True)

    nms_keep.launches = 0
    infer.main(["--setting", str(setting), "--checkpoint",
                str(Path(trainer.checkpoints.save_dir) / "last.pt"),
                "--out", str(workdir / "served")])
    served_launches = nms_keep.launches
    if served_launches != 1:
        raise AssertionError(f"nms_keep launched {served_launches} times serving 1 batch")
    n_dets = check_predictions(workdir / "served" / "predictions.json", BATCH,
                               len(trainer.dictionary), min_dets=0)
    print(f"infer.main on the host-augmented checkpoint: {BATCH} images, {n_dets} detections",
          flush=True)
    torch.cuda.empty_cache()
    epoch_s = times["train_epoch"][0]
    return {
        "steps": HOST_AUG_STEPS,
        "launches": launches,
        "served_launches": served_launches,
        "losses": losses,
        "run_s": run_s,
        "train_epoch_s": epoch_s,
        "fed_images_per_s": BATCH * HOST_AUG_STEPS / epoch_s,
        "val_epoch_s": times["val_epoch"][0],
        "val_mAP": val_metrics["mAP"],
        "served_detections": n_dets,
    }, trainer


def host_aug_timing(trainer) -> dict:
    """The host side of the fed rate: the train loader's rate over its
    epoch (its worker threads), and on one thread per item over 8 items
    the load of a LOAD_NUM = 4 group split into its 4 JPEG decodes and the
    rest, then each transform of the train pipeline, with the three rare
    transforms also forced on (p = 1); then the AMP train step at batch 32 on a host
    batch already on the card (``train_step_timing``; the f32 step is the
    device-augmented path's, ``train_timing``), and ``nms_keep``
    against ``nms_keep_plain`` on the path's own val input
    (``val_nms_input``)."""
    import torch

    from cvpytorch_tpu_torch.data.datasets import coco as coco_mod
    from cvpytorch_tpu_torch.data.transforms import det_transforms as dt

    loader = trainer.dataloaders["train"]
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in loader)
    out = {"host_loader_images_per_s": n / (time.perf_counter() - t0),
           "loader_threads": loader.num_workers}
    ds = trainer.datasets["train"]
    n_items = min(8, len(ds))
    pipeline, ds.transform = ds.transform, None
    forced = {name: getattr(dt, name)(p=1.0)
              for name in ("GaussianBlur", "MedianBlur", "RandomGrayscale")}
    decode_s = [0.0]
    real_imread = coco_mod.imread

    def timed_imread(path):
        t0 = time.perf_counter()
        img = real_imread(path)
        decode_s[0] += time.perf_counter() - t0
        return img

    coco_mod.imread = timed_imread
    try:
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(n_items)]
        item_ms = (time.perf_counter() - t0) * 1e3 / n_items
        coco_mod.imread = real_imread
        ms = {"load_group_of_4": item_ms,
              "load_group_of_4_jpeg_decodes": decode_s[0] * 1e3 / n_items,
              "load_group_of_4_rest": item_ms - decode_s[0] * 1e3 / n_items}
        for t in pipeline.transforms:
            name = type(t).__name__
            if name in forced:
                t0 = time.perf_counter()
                for s in samples:
                    forced[name]({"image": s["image"].copy()})
                ms[f"{name}_forced_p1"] = (time.perf_counter() - t0) * 1e3 / n_items
            t0 = time.perf_counter()
            samples = [t(s) for s in samples]
            ms[name] = (time.perf_counter() - t0) * 1e3 / n_items
    finally:
        coco_mod.imread = real_imread
        ds.transform = pipeline
    ms["item_total"] = sum(v for k, v in ms.items()
                           if not k.startswith("load_group_of_4_") and "forced" not in k)
    out["host_train_item_ms_one_thread"] = ms

    batch = loader_batch(trainer, "train", BATCH)
    steps, state = train_step_timing(trainer, batch, BATCH, iters=5, ema_decay=0.9999,
                                     amp_only=True)
    out.update(steps)
    out["kept_boxes_per_image"] = float(batch["target"]["valid"].sum()) / BATCH
    out["nms_keep_on_val_input"], _ = val_nms_input(
        state, loader_batch(trainer, "val", BATCH), "YOLOv5-s host-aug")
    del state
    torch.cuda.empty_cache()
    return out


FIXTURES = ROOT / "tests" / "data" / "torch_jpeg"  # JPEG files and cv2.imread's sha256 of each
COCO_FRAME = "coco_640x427_420.jpg"  # a COCO-sized 4:2:0 baseline file
COCO_INFER_IMAGES = BATCH  # one served batch
NANODET_V1_BATCH = 160  # TRAIN and VAL BATCH_SIZE of conf/coco_nanodet.yml
NANODET_V1_STEPS = 2  # one epoch
NANODET_V1_VAL_IMAGES = 160  # one val batch: nms_keep at (160, 1024)
COCO_TRAIN_IMAGES = max(BATCH * HOST_AUG_STEPS, NANODET_V1_BATCH * NANODET_V1_STEPS)
COCO_VAL_IMAGES = max(HOST_AUG_VAL_IMAGES, NANODET_V1_VAL_IMAGES)
COCO_SEGM_IMAGES = 16  # one Mask R-CNN val batch
CLS_LOADER_ITEMS = 64  # one mini-imagenet train batch
PNG_FRAME = (1024, 2048)  # a Cityscapes frame


def fixture_manifest() -> dict:
    return json.loads((FIXTURES / "manifest.json").read_text())


def image_decode_phase() -> dict:
    """Host only.  Builds the host C library (JPEG, PNG unfilter, COCO RLE
    and matcher), decodes every committed JPEG fixture and holds its pixels
    to the sha256 of ``cv2.imread``'s in the manifest, times the decode of
    the 640×427 4:2:0 file on one thread (median of 50) and on 8 threads
    (img/s over 400), and the PNG decode of a 1024×2048 RGB frame whose
    rows are all Sub, Average or Paeth: the whole decode, its inflate, and
    its row unfilter in C beside the numpy plain version's."""
    import hashlib
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from cvpytorch_tpu_torch import native
    from cvpytorch_tpu_torch.data import image_io, jpeg, png

    t0 = time.perf_counter()
    native.load_library()
    load_s = time.perf_counter() - t0
    print(f"host library {native.library_path().name}: "
          f"{'built in ' if native.build_seconds is not None else 'loaded in '}{load_s:.2f} s",
          flush=True)
    manifest = fixture_manifest()
    for name, entry in sorted(manifest.items()):
        img = image_io.imread(str(FIXTURES / name))
        got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        if list(img.shape) != entry["cv2_imread_shape"] or got != entry["cv2_imread_sha256"]:
            raise AssertionError(f"{name}: decoded {img.shape} {got}, cv2.imread gave "
                                 f"{entry['cv2_imread_shape']} {entry['cv2_imread_sha256']}")
    data = (FIXTURES / COCO_FRAME).read_bytes()
    for _ in range(5):
        jpeg.decode(data)
    one = []
    for _ in range(50):
        t0 = time.perf_counter()
        jpeg.decode(data)
        one.append(time.perf_counter() - t0)
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(jpeg.decode, [data] * 16))
        t0 = time.perf_counter()
        list(pool.map(jpeg.decode, [data] * 400))
        threads_s = time.perf_counter() - t0
    out = {"host_library_load_s": load_s, "host_library_built": native.build_seconds is not None,
           "fixtures_equal_manifest": len(manifest),
           "jpeg_decode_640x427_420_ms_one_thread": float(np.median(one)) * 1e3,
           "jpeg_decode_640x427_420_images_per_s_8_threads": 400 / threads_s}
    h, w = PNG_FRAME
    y, x = np.mgrid[0:h, 0:w]
    frame = np.stack([x * 255 // w, y * 255 // h, (x ^ y) & 255], -1).astype(np.uint8)
    frame[::7] += np.random.RandomState(0).randint(0, 9, (frame[::7].shape)).astype(np.uint8)
    for name, f in (("sub", 1), ("average", 3), ("paeth", 4)):
        blob = _png_bytes(frame, f)
        t0 = time.perf_counter()
        pixels, _, _ = png.decode(blob)
        c_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        raw = np.frombuffer(zlib.decompress(b"".join(
            body for kind, body in png._read_chunks(blob) if kind == b"IDAT")), np.uint8)
        inflate_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        unfiltered = native.png_unfilter(raw, h, w * 3, 3)
        unfilter_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = png.unfilter_plain(raw, h, w * 3, 3)
        numpy_ms = (time.perf_counter() - t0) * 1e3
        if not (np.array_equal(pixels, frame) and np.array_equal(plain, unfiltered)):
            raise AssertionError(f"PNG decode of the {name} frame differs from its pixels")
        out[f"png_decode_1024x2048_rgb_{name}_ms"] = c_ms
        out[f"png_inflate_1024x2048_rgb_{name}_ms"] = inflate_ms
        out[f"png_unfilter_1024x2048_rgb_{name}_ms"] = unfilter_ms
        out[f"png_unfilter_1024x2048_rgb_{name}_numpy_ms"] = numpy_ms
    return out


def _star(rng, x, y, w, h, W, H) -> list:
    """A polygon around the box (x, y, w, h), clipped to [0, W] x [0, H]."""
    k = rng.randint(4, 13)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rng.uniform(0.3, 0.6, k)
    px = np.clip(x + w / 2 + r * w * np.cos(ang), 0, W)
    py = np.clip(y + h / 2 + r * h * np.sin(ang), 0, H)
    return np.stack([px, py], 1).reshape(-1).round(2).tolist()


def write_coco_dir(root: Path, dictionary) -> dict:
    """A COCO-format directory of copies of the committed JPEG fixtures
    (baseline 4:2:0 frames of both orientations, progressive, 4:4:4 with
    restarts, grey, CMYK, EXIF-rotated) under COCO's names, with 1-8
    seeded boxes and polygons per image over the dictionary's categories;
    the val split also holds a crowd RLE and a non-crowd compressed RLE.
    → {stage: (IMG_DIR, ANN_FILE)} for train (the first 128 of
    ``COCO_TRAIN_IMAGES``), val (the first 64 of ``COCO_VAL_IMAGES``),
    infer (the first 32 val images) and segm (the first 16), and
    ``all``: {split: (IMG_DIR, ANN_FILE of every image)}, from which
    ``coco_subset`` cuts other sizes."""
    import shutil

    from cvpytorch_tpu_torch import native

    manifest = fixture_manifest()
    names = sorted(manifest)
    rng = np.random.RandomState(0)
    cats = [{"id": i + 1, "name": next(iter(d))} for i, d in enumerate(dictionary)]
    out = {"all": {}}
    for split, n in (("train", COCO_TRAIN_IMAGES), ("val", COCO_VAL_IMAGES)):
        img_dir = root / split
        img_dir.mkdir(parents=True)
        images, anns = [], []
        for i in range(n):
            src = names[i % len(names)]
            h, w = manifest[src]["cv2_imread_shape"][:2]
            fname = f"{i + 1:012d}.jpg"
            shutil.copyfile(FIXTURES / src, img_dir / fname)
            images.append({"id": i + 1, "file_name": fname, "height": h, "width": w})
            for _ in range(rng.randint(1, 9)):
                bw, bh = rng.uniform(0.05, 0.6) * w, rng.uniform(0.05, 0.6) * h
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": int(rng.randint(len(cats))) + 1,
                             "bbox": [round(x, 2), round(y, 2), round(bw, 2), round(bh, 2)],
                             "area": bw * bh, "iscrowd": 0,
                             "segmentation": [_star(rng, x, y, bw, bh, w, h)]})
            if split == "val" and i < 2:
                mask = np.zeros((h, w), np.uint8)
                mask[h // 4:h // 2, w // 5:w // 2] = 1
                rle = {"size": [h, w],
                       "counts": native.rle_encode_string(native.rle_from_mask(mask))}
                anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                             "bbox": [w / 5, h / 4, w / 2 - w / 5, h / 4],
                             "area": float(mask.sum()), "iscrowd": i, "segmentation": rle})
        first = BATCH * HOST_AUG_STEPS if split == "train" else HOST_AUG_VAL_IMAGES
        for stage, count in ((split, first), (f"{split}_all", n)) + (
                (("infer", COCO_INFER_IMAGES), ("segm", COCO_SEGM_IMAGES))
                if split == "val" else ()):
            keep = {im["id"] for im in images[:count]}
            ann_file = root / f"instances_{stage}.json"
            ann_file.write_text(json.dumps({
                "images": images[:count], "categories": cats,
                "annotations": [a for a in anns if a["image_id"] in keep]}))
            out[stage] = (str(img_dir), str(ann_file))
        out["all"][split] = out.pop(f"{split}_all")
    return out


def coco_subset(coco: dict, split: str, n: int) -> tuple[str, str]:
    """(IMG_DIR, ANN_FILE) of the first ``n`` images of the COCO
    directory's ``split`` and their annotations."""
    img_dir, ann_file = coco["all"][split]
    full = json.loads(Path(ann_file).read_text())
    if len(full["images"]) < n:
        raise AssertionError(f"the COCO {split} split holds {len(full['images'])} images, "
                             f"not {n}")
    keep = {im["id"] for im in full["images"][:n]}
    path = Path(ann_file).with_name(f"instances_{split}_{n}.json")
    path.write_text(json.dumps({**full, "images": full["images"][:n],
                                "annotations": [a for a in full["annotations"]
                                                if a["image_id"] in keep]}))
    return img_dir, str(path)


def coco_segm_check(mrcnn_trainer, coco: dict, workdir: Path) -> dict:
    """``conf/coco_maskrcnn.yml``'s ``CocoSegmentation`` VAL stage as
    written (800² letterbox, MASK_SIZE 112) on 16 of the COCO directory's
    images (polygons, a crowd RLE, a non-crowd compressed RLE): one
    ``val_epoch`` of the trained Mask R-CNN, bbox + segm through the host C
    matcher and RLE IoU; ``nms_keep``'s count set to 0 just before and read
    just after (2 a val batch: proposals, detections)."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep
    from cvpytorch_tpu_torch.train_state import make_eval_step

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / "coco_maskrcnn.yml"))
    cfg.DATASET.DICTIONARY = str(ROOT / cfg.DATASET.DICTIONARY)
    img_dir, ann_file = coco["segm"]
    for stage in ("TRAIN", "VAL"):
        cfg.DATASET.get(stage).update({"IMG_DIR": img_dir, "ANN_FILE": ann_file})
    cfg.update({"CHECKPOINT_DIR": str(workdir / "checkpoints"), "TENSORBOARD": False})
    trainer = trainer_mod.Trainer(cfg)
    ds = trainer.datasets["val"]
    if type(ds).__name__ != "CocoSegmentation" or len(ds) != COCO_SEGM_IMAGES:
        raise AssertionError(f"val dataset {type(ds).__name__} of {len(ds)} images")
    masks = sum(int(ds[i]["target"]["masks"].any(axis=(1, 2)).sum()) for i in range(len(ds)))
    evaluator_s = [0.0]
    for name in ("update", "evaluate"):
        fn = getattr(trainer.evaluator, name)

        def timed(*args, fn=fn, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            evaluator_s[0] += time.perf_counter() - t0
            return out
        setattr(trainer.evaluator, name, timed)
    eval_step = make_eval_step(use_ema=False)
    nms_keep.launches = 0
    t0 = time.perf_counter()
    _, metrics = trainer.val_epoch(0, mrcnn_trainer.state, eval_step, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nms_keep.launches
    batches = -(-COCO_SEGM_IMAGES // MASKRCNN_BATCH)
    if launches != 2 * batches:
        raise AssertionError(f"nms_keep launched {launches} times for {batches} val batches")
    for key in ("bbox_mAP", "segm_mAP"):
        if not np.isfinite(metrics[key]):
            raise AssertionError(f"COCO segm check: {key} = {metrics[key]}")
    print(f"Mask R-CNN val_epoch on {COCO_SEGM_IMAGES} COCO JPEG files (CocoSegmentation, "
          f"{masks} rasterised instances): {wall:.2f} s, evaluator {evaluator_s[0]:.3f} s "
          f"({evaluator_s[0] / wall:.1%} of the wall), bbox_mAP {metrics['bbox_mAP']} "
          f"segm_mAP {metrics['segm_mAP']}, nms_keep launches {launches}", flush=True)
    return {"images": COCO_SEGM_IMAGES, "instances_with_mask": masks, "val_epoch_s": wall,
            "evaluator_s": evaluator_s[0], "evaluator_share": evaluator_s[0] / wall,
            "launches": launches, "bbox_mAP": metrics["bbox_mAP"],
            "segm_mAP": metrics["segm_mAP"]}


def cls_loader_check(workdir: Path) -> dict:
    """``MiniImageNetClassification`` over an ``INDICES`` file of the
    committed JPEG fixtures (64 items) through ``conf/mini-imagenet.yml``'s
    train transforms and its loader (batch 64, 8 threads): the loader's
    img/s over one pass."""
    from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
    from cvpytorch_tpu_torch.data import datasets  # noqa: F401  (registers the datasets)
    from cvpytorch_tpu_torch.data.loader import DataLoader, default_collate
    from cvpytorch_tpu_torch.data.transforms import build_transforms
    from cvpytorch_tpu_torch.registry import DATASETS

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / "mini-imagenet.yml"))
    names = sorted(fixture_manifest())
    index = workdir / "cls_train.txt"
    index.write_text("".join(f"{names[i % len(names)]} {i % 100}\n"
                             for i in range(CLS_LOADER_ITEMS)))
    train = cfg.DATASET.TRAIN
    train.update({"IMG_DIR": str(FIXTURES), "INDICES": str(index)})
    _, dictionary = load_dictionary(str(ROOT / cfg.DATASET.DICTIONARY),
                                    cfg.DATASET.DICTIONARY_NAME)
    ds = DATASETS.get(cfg.DATASET.CLASS)(
        data_cfg=train, dictionary=dictionary, stage="train",
        transform=build_transforms("CLS_CLASSES", train.TRANSFORMS, "train"))
    loader = DataLoader(ds, batch_size=int(train.BATCH_SIZE), shuffle=True,
                        num_workers=int(train.NUM_WORKER), collate_fn=default_collate)
    t0 = time.perf_counter()
    batches = list(loader)
    rate = CLS_LOADER_ITEMS / (time.perf_counter() - t0)
    shape = batches[0]["image"].shape
    if sum(len(b["image"]) for b in batches) != CLS_LOADER_ITEMS or shape[1:3] != (224, 224) \
            or not np.isfinite(batches[0]["image"]).all():
        raise AssertionError(f"classification loader gave {[b['image'].shape for b in batches]}")
    print(f"MiniImageNetClassification over {CLS_LOADER_ITEMS} JPEG files: loader "
          f"{rate:.1f} img/s with {loader.num_workers} threads", flush=True)
    return {"items": CLS_LOADER_ITEMS, "loader_images_per_s": rate,
            "loader_threads": loader.num_workers, "batch_shape": list(shape)}


MASKRCNN_BATCH = 16  # TRAIN and VAL BATCH_SIZE of conf/coco_maskrcnn.yml
MASKRCNN_STEPS = 2  # one epoch of 2 train steps
MASKRCNN_VAL_IMAGES = 16  # one val batch
MASK_SIZE = 112  # CocoSegmentation's default raster (cvpytorch_tpu/data/datasets/coco.py:176)
# the ROIAlign tap gathers (index_select: PyTorch's vectorized_gather_kernel,
# 8 calls a train step, 4 taps × 2 branches) and their backward (index_add_:
# indexFuncLargeIndex)
ROI_GROUPS = {"roi_gather": re.compile(r"vectorized_gather_kernel|indexSelect"),
              "roi_gather_backward": re.compile(r"indexFunc|index_add")}


def maskrcnn_config(workdir: Path) -> Path:
    """conf/coco_maskrcnn.yml as written (R50-FPN, 80 INS_CLASSES, AMP, no
    EMA, SGD 0.9 with weight decay 1e-4, MultiStepLR [16, 22], linear
    warmup of 500 iterations from 0.001, bbox + segm evaluation, batch 16,
    its 800² keep-ratio Resize, flip, ToTensor and Normalize) with the
    dataset swapped for SyntheticInstanceSegmentation at 800² and MASK_SIZE
    112; cut to one epoch of 4 steps validated on 16 images.  The INFER
    stage (one batch) serves the checkpoint afterwards."""
    from cvpytorch_tpu_torch.config import CommonConfiguration

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / "coco_maskrcnn.yml"))
    data = cfg.DATASET
    data.CLASS = "SyntheticInstanceSegmentation"
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    synthetic = {"SIZE": [800, 800], "MASK_SIZE": MASK_SIZE, "SEED": 0}
    data.TRAIN.update({**synthetic, "LENGTH": MASKRCNN_BATCH * MASKRCNN_STEPS})
    data.VAL.update({**synthetic, "LENGTH": MASKRCNN_VAL_IMAGES})
    data.INFER = {**dict(data.VAL), "LENGTH": MASKRCNN_BATCH}
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / "coco_maskrcnn_synthetic.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def capture_nms_inputs():
    """Wraps ``ops.nms.nms_keep`` so that every call's (boxes, thr) is kept;
    returns the list and a function that restores the wrapper."""
    from cvpytorch_tpu_torch.ops import nms as nms_mod
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep

    seen = []

    def capture(boxes, thr):
        seen.append((boxes.clone(), thr))
        return nms_keep(boxes, thr)

    nms_mod.nms_keep = capture
    return seen, lambda: setattr(nms_mod, "nms_keep", nms_keep)


def run_instrumented(trainer, trainer_mod) -> dict:
    """``trainer.run()`` with ``nms_keep``'s count set to 0 just before and
    read just after, every step's metrics recorded (tensors, read after the
    run, so no step waits for them), and the host-clock walls of each
    train epoch, each val epoch and the evaluator's calls.  The batches of
    the first train epoch and of the first val epoch, as the steps got them
    on the card, are kept in ``trainer.kept_batches`` for ``loader_batch``."""
    import torch

    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep

    metrics, times, val = [], {"train_epoch": [], "val_epoch": [], "evaluator": 0.0}, []
    kept = trainer.kept_batches = {"train": [], "val": []}
    real_make_train_step = trainer_mod.make_train_step
    real_make_eval_step = trainer_mod.make_eval_step
    real_prefetcher = trainer_mod.DevicePrefetcher
    feeds = []

    def keeping_prefetcher(*args, **kwargs):
        feed = real_prefetcher(*args, **kwargs)
        feeds.append(feed)
        return keep(feed) if len(feeds) == 1 else feed  # the first train epoch's

    def keep(feed):
        for batch in feed:
            kept["train"].append(batch)
            yield batch

    def keeping_make_eval_step(*args, **kwargs):
        step = real_make_eval_step(*args, **kwargs)

        def keeping(state, batch):
            if len(kept["val"]) < len(trainer.dataloaders["val"]):  # the first val epoch
                kept["val"].append(batch)
            return step(state, batch)
        return keeping

    def recording_make_train_step(*args, **kwargs):
        step = real_make_train_step(*args, **kwargs)

        def recorded(state, batch):
            state, m = step(state, batch)
            metrics.append(m)
            return state, m
        return recorded

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if key == "evaluator":
                times[key] += time.perf_counter() - t0
            else:
                times[key].append(time.perf_counter() - t0)
            if key == "val_epoch":
                val.append(out[1])
            return out
        return run

    trainer.train_epoch = timed(trainer.train_epoch, "train_epoch")
    trainer.val_epoch = timed(trainer.val_epoch, "val_epoch")
    if trainer.evaluator is not None:  # a run without validation has none
        trainer.evaluator.update = timed(trainer.evaluator.update, "evaluator")
        trainer.evaluator.evaluate = timed(trainer.evaluator.evaluate, "evaluator")
    trainer_mod.make_train_step = recording_make_train_step
    trainer_mod.make_eval_step = keeping_make_eval_step
    trainer_mod.DevicePrefetcher = keeping_prefetcher
    try:
        nms_keep.launches = 0
        t0 = time.perf_counter()
        state = trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = nms_keep.launches
    finally:
        trainer_mod.make_train_step = real_make_train_step
        trainer_mod.make_eval_step = real_make_eval_step
        trainer_mod.DevicePrefetcher = real_prefetcher
    return {"state": state, "metrics": metrics, "times": times, "val": val,
            "run_s": run_s, "launches": launches}


def maskrcnn_phase(workdir: Path) -> tuple[dict, object]:
    """Mask R-CNN R50-FPN at 800² trained through ``Trainer.run()`` (bbox
    and segm validation) and served through ``infer.main`` on the card."""
    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep

    workdir.mkdir()
    setting = maskrcnn_config(workdir)
    cfg = CommonConfiguration.from_file(str(setting))
    trainer = trainer_mod.Trainer(cfg)
    # the main path of this phase, counts read just around it
    run = run_instrumented(trainer, trainer_mod)
    state, metrics, times, run_s, launches = (
        run[k] for k in ("state", "metrics", "times", "run_s", "launches"))
    val = run["val"]
    names = ("rpn_obj_loss", "rpn_reg_loss", "cls_loss", "box_loss", "mask_loss", "loss")
    if len(metrics) != MASKRCNN_STEPS or state.step != MASKRCNN_STEPS:
        raise AssertionError(f"{len(metrics)} steps recorded, state at step {state.step}")
    losses = {k: [float(m[k]) for m in metrics] for k in names if all(k in m for m in metrics)}
    if set(losses) != set(names):
        raise AssertionError(f"train losses {sorted(metrics[0])}, expected {names}")
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite train loss: {losses}")
    val_batches = -(-MASKRCNN_VAL_IMAGES // MASKRCNN_BATCH)
    if launches != MASKRCNN_STEPS + 2 * val_batches:
        raise AssertionError(f"nms_keep launched {launches} times for {MASKRCNN_STEPS} "
                             f"steps and {val_batches} val batches")
    (val_metrics,) = val
    for key in ("bbox_mAP", "segm_mAP"):
        if not np.isfinite(val_metrics[key]):
            raise AssertionError(f"val {key} = {val_metrics[key]}")
    print(f"Mask R-CNN Trainer.run(): {MASKRCNN_STEPS} steps in {run_s:.2f} s (host "
          f"clock, from model build to the last checkpoint), losses {losses}, "
          f"nms_keep launches {launches} for {MASKRCNN_STEPS} steps and {val_batches} "
          f"val batches, val bbox_mAP {val_metrics['bbox_mAP']} segm_mAP "
          f"{val_metrics['segm_mAP']}", flush=True)

    # the last checkpoint serves one batch through the infer CLI
    nms_keep.launches = 0
    infer.main(["--setting", str(setting), "--checkpoint",
                str(Path(trainer.checkpoints.save_dir) / "last.pt"),
                "--out", str(workdir / "served")])
    if nms_keep.launches != 2:
        raise AssertionError(f"serving the checkpoint launched nms_keep "
                             f"{nms_keep.launches} times for 1 batch, not 2")
    n_dets = check_predictions(workdir / "served" / "predictions.json", MASKRCNN_BATCH,
                               len(trainer.dictionary), min_dets=0, size=800, max_dets=100)
    print(f"infer.main on the trained Mask R-CNN: {MASKRCNN_BATCH} images, {n_dets} "
          "detections, nms_keep launches 2", flush=True)
    return {
        "steps": MASKRCNN_STEPS,
        "launches": launches,
        "losses": losses,
        "run_s": run_s,
        "train_epoch_s": times["train_epoch"][0],
        "val_epoch_s": times["val_epoch"][0],
        "val_evaluator_s": times["evaluator"],
        "val_evaluator_share": times["evaluator"] / times["val_epoch"][0],
        "val_bbox_mAP": val_metrics["bbox_mAP"],
        "val_segm_mAP": val_metrics["segm_mAP"],
        "served_detections": n_dets,
    }, trainer


def step_tflop(fn) -> float:
    """TFLOP of one call of ``fn`` as torch's FLOP counter counts them:
    matmuls and convolutions, forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() / 1e12


def train_step_timing(trainer, batch, n: int, iters: int,
                      ema_decay: float = 0.0, amp_only: bool = False) -> tuple[dict, object]:
    """The AMP and f32 train steps on ``batch`` (``n`` images, already on
    the card) from the same seeded weights, by CUDA events over ``iters``
    steps after 1 warm-up step, and the peak memory of each; an f32 step
    that does not fit is reported and skipped, an AMP step that does not
    fit fails.  ``ema_decay`` > 0 keeps an EMA copy, as the recipe does;
    ``amp_only`` leaves the f32 step out.  Returns the numbers and the AMP
    run's state."""
    import torch

    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step

    def fresh_state():
        torch.manual_seed(0)
        model = build_model(trainer.cfg, trainer.dictionary, trainer.datasets["train"]).to(
            "cuda", memory_format=torch.channels_last)
        return create_train_state(model, build_optimizer(trainer.cfg, model,
                                                         trainer.lr_schedule),
                                  use_ema=ema_decay > 0)

    out = {"batch": n}
    for name, amp in (("amp", True),) + ((("f32", False),) if not amp_only else ()):
        torch.cuda.empty_cache()
        state = fresh_state()
        step = make_train_step(amp=amp, ema_decay=ema_decay)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            ms = cuda_time_ms(lambda: step(state, batch), iters=iters, warmup=1)
        except torch.OutOfMemoryError:
            out[f"{name}_step_ms"] = None
            out[f"{name}_out_of_memory_at_gb"] = torch.cuda.max_memory_allocated() / 1e9
            print(f"{name} train step at batch {n}: out of memory at "
                  f"{out[f'{name}_out_of_memory_at_gb']:.2f} GB", flush=True)
            del state, step
            continue
        out[f"{name}_step_ms"] = ms
        out[f"{name}_images_per_s"] = n / ms * 1e3
        out[f"{name}_max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if amp:
            amp_state = state
        del state, step
    if out["amp_step_ms"] is None:
        raise AssertionError(f"the AMP train step does not fit at batch {n}")
    return out, amp_state


def maskrcnn_timing(trainer, batches) -> tuple[dict, dict]:
    """The AMP train step at batch 16 on one batch already on the card, by
    CUDA events over 3 steps after 1 warm-up step, and its peak memory;
    the same for an f32 step where batch 16 fits; the f32 val step and the
    serving predict step at batch 16; ``nms_keep`` against
    ``nms_keep_plain`` on the path's own inputs, the RPN's (16, 1000)
    boxes of a train step and the (16, 256) detection boxes of a val
    step: bit-exact, and each timed."""
    import torch

    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from cvpytorch_tpu_torch.train_state import (
        make_eval_step, make_predict_step, make_train_step)

    train_b, val_b = batches["train"], batches["val"]
    out, amp_state = train_step_timing(trainer, train_b, MASKRCNN_BATCH, iters=3)

    # the path's own NMS inputs: the RPN's of a train step, the detections'
    # of a val step
    seen, restore = capture_nms_inputs()
    try:
        make_train_step(amp=True)(amp_state, train_b)
        (rpn_boxes, rpn_thr), = seen
        seen.clear()
        eval_step = make_eval_step()
        eval_step(amp_state, val_b)
        (prop_boxes, prop_thr), (det_boxes, det_thr) = seen
    finally:
        restore()
    torch.cuda.synchronize()
    model = amp_state.model
    if (tuple(rpn_boxes.shape) != (MASKRCNN_BATCH, model.pre_nms_topk, 4)
            or rpn_thr != model.rpn_nms_thresh):
        raise AssertionError(f"RPN NMS input {tuple(rpn_boxes.shape)} thr {rpn_thr}")
    if float(rpn_boxes.max()) > 800:  # class-agnostic: no class offsets
        raise AssertionError("the RPN's NMS input carries class offsets")
    if (tuple(det_boxes.shape) != (MASKRCNN_BATCH, model.num_proposals, 4)
            or det_thr != model.iou_threshold):
        raise AssertionError(f"detection NMS input {tuple(det_boxes.shape)} thr {det_thr}")
    launches_before = nms_keep.launches
    nms = {}
    for name, (boxes, thr) in (("rpn", (rpn_boxes, rpn_thr)), ("det", (det_boxes, det_thr))):
        got, want = nms_keep(boxes, thr), nms_keep_plain(boxes, thr)
        if not torch.equal(got, want):
            raise AssertionError(f"nms_keep != nms_keep_plain on the {name} input: "
                                 f"{int((got != want).sum())} flags differ")
        nms[name] = {"shape": list(boxes.shape), "thr": thr,
                     "kept": int(got.sum()), "bit_exact": True,
                     "ms": nms_event_ms(boxes, thr),
                     "plain_ms": cuda_time_ms(lambda: nms_keep_plain(boxes, thr),
                                              iters=3, warmup=1)}
    nms_keep.launches = launches_before  # comparison launches do not count
    print(f"nms_keep on the Mask R-CNN path's inputs: {json.dumps(nms)}", flush=True)

    eval_step = make_eval_step()
    out["val_step_ms"] = cuda_time_ms(lambda: eval_step(amp_state, val_b), iters=3, warmup=1)
    predict = make_predict_step(amp_state.model)
    out["bs16_predict_ms"] = cuda_time_ms(lambda: predict(val_b["image"]), iters=3, warmup=1)
    out["bs16_predict_images_per_s"] = MASKRCNN_BATCH / out["bs16_predict_ms"] * 1e3
    return out, {"nms": nms, "inputs": {"rpn": (rpn_boxes, rpn_thr),
                                        "det": (det_boxes, det_thr)}, "state": amp_state}


def maskrcnn_card_vs_cpu(trainer, batches) -> dict:
    """R50-FPN at 800², B = 1, f32 with TF32 off, from the same seeded
    weights on the card and on the CPU.  BN on its running statistics
    (eval mode): the FPN features and the RPN's logits and deltas within
    1e-4 of their largest value.  The proposal stage is held on the same
    inputs on both sides, since with random weights many RPN scores lie
    within the maps' own f32 difference of each other and the top-1000 and
    NMS order them apart: from the CPU's RPN maps, every anchor's score
    within 1e-6 and its decoded, clipped box within 1e-2 px; from the
    CPU's candidates, the 256 proposals (top-k, then ``nms_keep``) equal
    bit for bit.  The slots in which the two devices' own end-to-end
    proposals differ are reported, not held.  Then the losses of one
    train-mode forward (BN on the statistics of the one image) within 1e-3
    relative: there, f32 itself is the limit; on the CPU the same forward's
    FPN maps lie 2.5e-4 to 7.5e-4 (of the largest value) from float64, and
    1e-6 in eval mode."""
    import copy

    import torch

    from cvpytorch_tpu_torch.infer import build_model

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the step makers turn it off")
    image = batches["train"]["image"][:1]
    target = {k: v[:1] for k, v in batches["train"]["target"].items()}
    size = tuple(image.shape[1:3])

    def rel_err(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-12)
                   for x, y in zip(a, b))

    torch.manual_seed(0)
    base = build_model(trainer.cfg, trainer.dictionary, trainer.datasets["train"])
    seen = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device, memory_format=torch.channels_last)
        x = image.to(device)
        with torch.no_grad():
            model.eval()
            feats = model.fpn(model.backbone(x.permute(0, 3, 1, 2)))
            obj, reg, anchors, boxes, valid = model._rpn_proposals(feats, x)
            _, losses = model.train()(x, {k: v.to(device) for k, v in target.items()},
                                      mode="train")
        seen[device] = {"model": model, "fpn": [f.cpu() for f in feats],
                        "rpn": [obj.cpu(), reg.cpu()], "anchors": anchors.cpu(),
                        "boxes": boxes.cpu(), "valid": valid.cpu(),
                        "losses": {k: float(v) for k, v in losses.items()}}
    cpu, card = seen["cpu"], seen["cuda"]
    with torch.no_grad():
        # the proposal stage on the same inputs: the CPU's maps, then the
        # CPU's candidates
        cand_cpu = cpu["model"]._rpn_candidates(*cpu["rpn"], cpu["anchors"], size)
        cand_card = card["model"]._rpn_candidates(
            *(t.cuda() for t in (*cpu["rpn"], cpu["anchors"])), size)
        sel_cpu = cpu["model"]._select_proposals(*cand_cpu)
        sel_card = card["model"]._select_proposals(*(t.cuda() for t in cand_cpu))
    sel_card = [t.cpu() for t in sel_card]
    result = {
        "seed": 0, "fpn_max_rel_err": rel_err(card["fpn"], cpu["fpn"]),
        "rpn_max_rel_err": rel_err(card["rpn"], cpu["rpn"]),
        "candidate_score_max_abs_err": float((cand_card[0].cpu() - cand_cpu[0]).abs().max()),
        "candidate_box_max_abs_err": float((cand_card[1].cpu() - cand_cpu[1]).abs().max()),
        "proposals_equal_on_same_candidates": bool(
            torch.equal(sel_card[0], sel_cpu[0]) and torch.equal(sel_card[1], sel_cpu[1])),
        "end_to_end_proposal_slots_differing": int(
            ((card["boxes"] - cpu["boxes"]).abs().amax(-1) > 1e-2).sum()
            + (card["valid"] != cpu["valid"]).sum()),
        "train_loss_rel": {k: abs(card["losses"][k] - v) / max(abs(v), 1e-12)
                           for k, v in cpu["losses"].items()},
        "train_loss_cpu": cpu["losses"], "train_loss_card": card["losses"]}
    print(f"Mask R-CNN card vs CPU, f32, B=1, 800²: {json.dumps(result)}", flush=True)
    if not (result["fpn_max_rel_err"] <= 1e-4 and result["rpn_max_rel_err"] <= 1e-4):
        raise AssertionError(f"FPN or RPN maps differ, card vs CPU: {result}")
    if not (result["candidate_score_max_abs_err"] <= 1e-6
            and result["candidate_box_max_abs_err"] <= 1e-2):
        raise AssertionError(f"RPN candidates differ, card vs CPU, on the same maps: {result}")
    if not result["proposals_equal_on_same_candidates"]:
        raise AssertionError(f"proposals differ, card vs CPU, on the same candidates: {result}")
    if not max(result["train_loss_rel"].values()) <= 1e-3:
        raise AssertionError(f"train losses differ card vs CPU: {result}")
    return result


SEG_BATCH = {"deeplabv3plus": 8, "unet": 8, "segformer_b2": 8,  # each config's TRAIN and
             "sfnet_r18": 16, "segnext_b": 8, "incepformer_t": 8,  # VAL BATCH_SIZE
             "topformer_b": 16, "regseg": 16, "stdc": 16, "ppliteseg": 16, "sgcpnet": 16,
             "enet": 8, "segnet": 8, "icnet": 16, "lednet": 8, "lspnet": 16}
SEG_FRAME = [1024, 2048]  # a Cityscapes frame: RandomScaleCrop and Resize work on it
# the val: one batch of the config's
SEG_SERVED = 4  # images served through infer.main, a partial batch
# the card-vs-CPU check's input: the first train image at every second
# pixel, 256×512 (at 512×1024 the CPU's forwards held the run's time
# limit)
SEG_CHECK_STRIDE = 2
SEG_STEPS = 1  # one epoch of each config
# the paths that run once on the card and are not timed or profiled, and
# those whose f32 step is not timed (since PR 16 all but DeepLabV3+'s)
SEG_UNTIMED = ("icnet", "lednet", "lspnet")
SEG_AMP_ONLY = ("unet", "segformer_b2", "sfnet_r18", "segnext_b", "incepformer_t",
                "topformer_b", "regseg", "stdc", "ppliteseg", "sgcpnet", "enet", "segnet")
# achieved TFLOP/s (counted by torch.utils.flop_counter, a few seconds a
# path of the run's time limit): STDC
SEG_COUNT_FLOPS = ("stdc",)
SEG_CARD_VS_CPU = {"deeplabv3plus": "DeepLabV3+ R50", "segformer_b2": "SegFormer MiT-B2",
                   "sfnet_r18": "SFNet R18", "segnext_b": "SegNeXt MSCAN-B",
                   "incepformer_t": "IncepFormer IPT-T", "stdc": "STDC STDCNet-1",
                   "enet": "ENet", "segnet": "SegNet"}
# the EMA of the configs that set it, in their timed and profiled steps
# (the DeepLabV3+ and UNet phases time theirs without, as before)
SEG_EMA = {name: 0.9999 for name in ("segformer_b2", "sfnet_r18", "segnext_b",
                                     "incepformer_t", "topformer_b", "regseg", "stdc",
                                     "ppliteseg", "sgcpnet", "enet", "segnet")}
# no seg path is profiled (SegNeXt-B's session, the last one, left for the
# run's time limit: PERF.md §5 keeps its readings)


def incepformer_logits_gb(model, images) -> float:
    """GB of one stage-1 block's float32 attention logits (B, heads, N, M)
    at these images: N the /4 map's tokens, M the three poolings' (two
    of ⌈·/r⌉², one of ⌊·/r⌋²)."""
    attn = model.backbone.block1_0.attn
    B, H, W = images.shape[:3]
    h, w, r = -(-H // 4), -(-W // 4), attn.down_ratio
    m = 2 * -(-h // r) * -(-w // r) + (h // r) * (w // r)
    return B * attn.heads * h * w * m * 4 / 1e9


def seg_config(workdir: Path, name: str) -> Path:
    """``conf/cityscapes_<name>.yml`` as written (its model, 19 SEG_CLASSES
    from ``conf/dicts/cityscapes_dict.yml``, AMP, SGD, PolyLR 0.9, linear
    warmup, its batch (``SEG_BATCH``), its 512×1024 crop, flip,
    photometric distortion, Resize, ToTensor and Normalize, mIoU
    evaluation; SegFormer and SFNet also EMA and grad clip 10) with the
    dataset swapped for SyntheticSegmentation at the 1024×2048 Cityscapes
    frame; cut to one epoch of ``SEG_STEPS`` steps validated on one
    batch.  The INFER stage (``SEG_SERVED`` images) serves the checkpoint
    afterwards."""
    from cvpytorch_tpu_torch.config import CommonConfiguration

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / f"cityscapes_{name}.yml"))
    data = cfg.DATASET
    data.CLASS = "SyntheticSegmentation"
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    synthetic = {"SIZE": SEG_FRAME, "SEED": 0}
    if data.TRAIN.BATCH_SIZE != SEG_BATCH[name] or data.VAL.BATCH_SIZE != SEG_BATCH[name]:
        raise AssertionError(f"cityscapes_{name}: BATCH_SIZE {data.TRAIN.BATCH_SIZE}")
    data.TRAIN.update({**synthetic, "LENGTH": SEG_BATCH[name] * SEG_STEPS})
    data.VAL.update({**synthetic, "LENGTH": SEG_BATCH[name]})
    data.INFER = {**dict(data.VAL), "LENGTH": SEG_SERVED}
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / f"cityscapes_{name}_synthetic.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def seg_phase(workdir: Path, name: str) -> tuple[dict, object]:
    """``conf/cityscapes_<name>.yml`` trained through ``Trainer.run()``
    (mIoU validation) and served through ``infer.main`` on the card."""
    import torch

    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.data.loader import DataLoader
    from cvpytorch_tpu_torch.data.png import decode
    from cvpytorch_tpu_torch.data.transforms import build_transforms
    from cvpytorch_tpu_torch.registry import DATASETS
    from cvpytorch_tpu_torch.train_state import make_predict_step

    steps, batch = SEG_STEPS, SEG_BATCH[name]
    n_served = SEG_SERVED
    workdir.mkdir()
    setting = seg_config(workdir, name)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    # the main path of this phase, counts read just around it
    run = run_instrumented(trainer, trainer_mod)
    state, metrics, times, run_s, launches = (
        run[k] for k in ("state", "metrics", "times", "run_s", "launches"))
    val = run["val"]
    if len(metrics) != steps or state.step != steps:
        raise AssertionError(f"{len(metrics)} steps recorded, state at step {state.step}")
    losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite train loss: {losses}")
    if launches:  # the segmentation path runs no NMS
        raise AssertionError(f"nms_keep launched {launches} times on the {name} path")
    (val_metrics,) = val
    if not 0 <= val_metrics["mIoU"] <= 1 or val_metrics["performance"] != val_metrics["mIoU"]:
        raise AssertionError(f"val mIoU {val_metrics['mIoU']}")
    print(f"{name} Trainer.run(): {steps} steps in {run_s:.2f} s (host clock, from model "
          f"build to the last checkpoint), losses {losses}, val mIoU {val_metrics['mIoU']} "
          f"PA {val_metrics['PA']}", flush=True)

    # the last checkpoint serves one batch through the infer CLI: palette
    # PNGs of the argmax the predict step gives on the same images
    out_dir = workdir / "served"
    infer.main(["--setting", str(setting), "--checkpoint",
                str(Path(trainer.checkpoints.save_dir) / "last.pt"), "--out", str(out_dir)])
    files = sorted(out_dir.iterdir())
    if [f.name for f in files] != [f"{i:06d}.png" for i in range(n_served)]:
        raise AssertionError(f"served files {[f.name for f in files]}")
    infer_cfg = trainer.cfg.DATASET.INFER
    infer_ds = DATASETS.get(trainer.cfg.DATASET.CLASS)(
        data_cfg=infer_cfg, dictionary=trainer.dictionary, stage="infer",
        transform=build_transforms("SEG_CLASSES", infer_cfg.get("TRANSFORMS"), "infer"))
    images = torch.from_numpy(next(iter(DataLoader(infer_ds, n_served)))["image"]).cuda()
    served = state.ema if state.ema is not None else state.model  # what the checkpoint serves
    want = make_predict_step(served)(images).cpu().numpy()
    palette = bytes(infer.CITYSCAPES_PALETTE)
    for f, w in zip(files, want):
        index, ctype, plte = decode(f.read_bytes())
        if ctype != 3 or plte != palette or index.shape != (*w.shape, 1):
            raise AssertionError(f"{f.name}: colour type {ctype}, shape {index.shape}")
        if not np.array_equal(index[..., 0], w):
            raise AssertionError(f"{f.name}: {int((index[..., 0] != w).sum())} pixels "
                                 "differ from the predict step's argmax")
    classes = len(np.unique(want))
    print(f"infer.main on the trained {name}: {n_served} palette PNGs of {want.shape[1:]} "
          f"equal to the predict step's argmax ({classes} classes present)", flush=True)
    return {
        "steps": steps,
        "nms_keep_launches": launches,
        "losses": losses,
        "run_s": run_s,
        "train_epoch_s": times["train_epoch"][0],
        "batch": batch,
        "fed_images_per_s": batch * steps / times["train_epoch"][0],
        "val_epoch_s": times["val_epoch"][0],
        "val_evaluator_s": times["evaluator"],
        "val_evaluator_share": times["evaluator"] / times["val_epoch"][0],
        "val_mIoU": val_metrics["mIoU"],
        "served_images": n_served,
        "served_classes_present": classes,
    }, trainer


def _png_bytes(pixels: np.ndarray, row_filter: int) -> bytes:
    """An RGB PNG of ``pixels`` (H, W, 3) whose every row carries
    ``row_filter`` (1 Sub, 3 Average or 4 Paeth), for timing the decoder."""
    import struct
    import zlib

    h, w, _ = pixels.shape
    x = pixels.reshape(h, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if row_filter == 1:
        pred = a
    elif row_filter == 3:
        pred = (a + b) >> 1
    else:
        c = np.zeros_like(x)
        c[1:, 3:] = x[:-1, :-3]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), row_filter, np.uint8),
                           ((x - pred) % 256).astype(np.uint8)], 1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def host_pipeline_timing(trainer, n_items: int = 4) -> dict:
    """The host's side of the fed rate, with no device work: the train
    loader's rate over its epoch (its worker threads), and on one thread
    the draw of one synthetic frame and each transform of the train and
    val pipelines on it, over ``n_items`` items."""
    loader = trainer.dataloaders["train"]
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in loader)
    out = {"host_loader_images_per_s": n / (time.perf_counter() - t0)}
    for stage in ("train", "val"):
        ds = trainer.datasets[stage]
        pipeline, ds.transform = ds.transform, None
        try:
            t0 = time.perf_counter()
            samples = [ds[i] for i in range(n_items)]
            h, w = samples[0]["image"].shape[:2]
            ms = {f"draw_{h}x{w}": (time.perf_counter() - t0) * 1e3 / n_items}
            for t in pipeline.transforms:
                t0 = time.perf_counter()
                samples = [t(s) for s in samples]
                ms[type(t).__name__] = (time.perf_counter() - t0) * 1e3 / n_items
        finally:
            ds.transform = pipeline
        out[f"host_{stage}_item_ms_one_thread"] = ms
    return out


def window_gaps(x, kernel: int, stride: int, padding: int, where) -> "torch.Tensor":
    """The gap between the two largest taps of the pooling windows at
    ``where`` (a bool mask of the pooled map) of ``x``, padded taps −inf."""
    import torch
    import torch.nn.functional as F

    Ho, Wo = where.shape[-2:]
    xp = F.pad(x, (padding,) * 4, value=float("-inf")) if padding else x
    taps = torch.stack([xp[:, :, dy:dy + stride * (Ho - 1) + 1:stride,
                           dx:dx + stride * (Wo - 1) + 1:stride]
                        for dy in range(kernel) for dx in range(kernel)], -1)
    top2 = taps[where].topk(2, -1).values
    return top2[:, 0] - top2[:, 1]


class SharedPools:
    """Records the pools and unpools of ``models.segnet_enet`` on one
    device, and replays the recorded pool indices on another: there each
    pool computes its own values and indices, keeps its indices for the
    comparison, and hands the model the recorded ones.  Near-equal window
    maxima (ties within the two devices' rounding) then cannot move whole
    unpooled values between the two runs."""

    def __init__(self, replay=None):
        self.replay = replay
        self.pools, self.unpools = [], []

    def __enter__(self):
        from cvpytorch_tpu_torch.models import segnet_enet
        from cvpytorch_tpu_torch.ops import pool

        def max_pool_argmax(x, kernel, stride, padding):
            values, idx = pool.max_pool_argmax(x, kernel, stride, padding)
            self.pools.append((x.detach().float().cpu(), (kernel, stride, padding),
                               idx.cpu()))
            if self.replay is not None:
                idx = self.replay.pools[len(self.pools) - 1][2].to(x.device)
            return values, idx

        def max_unpool(values, indices, out_hw):
            out = pool.max_unpool(values, indices, out_hw)
            self.unpools.append((values.detach().cpu(), indices.cpu(), tuple(out_hw),
                                 out.detach().cpu()))
            return out

        self.module = segnet_enet
        self.saved = segnet_enet.max_pool_argmax, segnet_enet.max_unpool
        segnet_enet.max_pool_argmax, segnet_enet.max_unpool = max_pool_argmax, max_unpool
        return self

    def __exit__(self, *exc):
        self.module.max_pool_argmax, self.module.max_unpool = self.saved


def shared_pool_check(cpu: SharedPools, card: SharedPools) -> dict:
    """The card's own pool indices against the CPU's: their share that
    differs, and ``near_ties_only``: each differing index in a window
    whose two largest taps (on the CPU's input) lie within 1e-5 of the
    map's largest |value| of each other, or within twice the map's largest
    card-vs-CPU difference (a train-mode BN over a near-constant channel
    of the synthetic frames amplifies the rounding: SegNet's train-mode
    pool inputs lie 2e-4 to 5e-3 of the map's largest value apart on the
    H100, its eval-mode ones ~1e-6); and the card's
    ``max_unpool`` on the CPU's values and indices equal to the CPU's bit
    for bit."""
    import torch

    differ, total, near_ties_only, calls = 0, 0, True, []
    for (x, args, want), (x_card, _, got) in zip(cpu.pools, card.pools):
        where = got != want
        total += want.numel()
        scale = float(x.abs().max())
        call = {"shape": list(x.shape), "differing": int(where.sum()),
                "input_max_rel_err": float((x_card - x).abs().max()) / scale}
        if where.any():
            differ += call["differing"]
            call["max_gap_over_map_max"] = float(window_gaps(x, *args, where).max()) / scale
            near_ties_only &= call["max_gap_over_map_max"] <= max(
                1e-5, 2 * call["input_max_rel_err"])
        calls.append(call)
    if len(cpu.pools) != len(card.pools) or not cpu.unpools:
        raise AssertionError(f"{len(cpu.pools)} pools on the CPU, {len(card.pools)} on the "
                             f"card, {len(cpu.unpools)} unpools")
    out = {"pool_calls": calls, "pool_indices": total,
           "pool_indices_differing": differ, "pool_indices_differing_share": differ / total,
           "near_ties_only": near_ties_only, "unpool_calls": len(cpu.unpools)}
    for values, indices, out_hw, want in cpu.unpools:
        from cvpytorch_tpu_torch.ops.pool import max_unpool

        got = max_unpool(values.cuda(), indices.cuda(), out_hw).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"max_unpool on shared inputs differs card vs CPU at "
                                 f"{tuple(values.shape)} -> {out_hw}")
    out["unpool_on_shared_inputs_bit_exact"] = True
    return out


def seg_card_vs_cpu(trainer, batches, label: str) -> dict:
    """The config's model (``label``) at 256×512 (the first train image at
    every ``SEG_CHECK_STRIDE``-th pixel), B = 1, f32 with TF32
    off, from the same seeded weights on the card and on the CPU, dropout
    and DropPath off: in eval mode the logits (``model.logits``, what the
    infer argmax takes) within 1e-4 of their largest value and the argmax
    equal on at least 99.9 % of the pixels; the losses of a train-mode
    forward (BN on the statistics of the one image) within 1e-3 relative.
    SegNet and ENet run the card with the CPU's pool indices
    (``SharedPools``); their own indices are held to the CPU's up to
    near-ties, and the unpool on shared inputs bit for bit."""
    import copy

    import torch

    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.models import segnet_enet
    from cvpytorch_tpu_torch.models.bricks import DropPath

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the step makers turn it off")
    image = batches["train"]["image"][:1, ::SEG_CHECK_STRIDE, ::SEG_CHECK_STRIDE].contiguous()
    target = batches["train"]["target"][:1, ::SEG_CHECK_STRIDE, ::SEG_CHECK_STRIDE].contiguous()
    torch.manual_seed(0)
    base = build_model(trainer.cfg, trainer.dictionary)
    pools = isinstance(base, (segnet_enet.SegNet, segnet_enet.ENet))
    for m in base.modules():
        if isinstance(m, torch.nn.modules.dropout._DropoutNd):
            m.p = 0.0
        elif isinstance(m, DropPath):
            m.rate = 0.0
    seen, recorded = {}, {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device, memory_format=torch.channels_last)
        x = image.to(device)
        with torch.no_grad():
            with SharedPools(recorded.get(("cpu", "eval"))) if pools else \
                    contextlib.nullcontext() as eval_pools:
                logits = model.eval().logits(x)
            with SharedPools(recorded.get(("cpu", "train"))) if pools else \
                    contextlib.nullcontext() as train_pools:
                _, losses = model.train()(x, target.to(device), mode="train")
        recorded[device, "eval"], recorded[device, "train"] = eval_pools, train_pools
        seen[device] = {"logits": logits.cpu(), "losses": {k: float(v) for k, v in losses.items()}}
    cpu, card = seen["cpu"], seen["cuda"]
    out = {
        "logits_max_rel_err": float((card["logits"] - cpu["logits"]).abs().max()
                                    / cpu["logits"].abs().max()),
        "argmax_equal_share": float((card["logits"].argmax(1) == cpu["logits"].argmax(1))
                                    .float().mean()),
        "train_loss_rel": {k: abs(card["losses"][k] - v) / max(abs(v), 1e-12)
                           for k, v in cpu["losses"].items()},
        "train_loss_cpu": cpu["losses"], "train_loss_card": card["losses"]}
    if pools:
        out["shared_pools_eval"] = shared_pool_check(recorded["cpu", "eval"],
                                                     recorded["cuda", "eval"])
        out["shared_pools_train"] = shared_pool_check(recorded["cpu", "train"],
                                                      recorded["cuda", "train"])
    print(f"{label} card vs CPU, f32, B=1, {image.shape[1]}x{image.shape[2]}: "
          f"{json.dumps(out)}", flush=True)
    if pools and not (out["shared_pools_eval"]["near_ties_only"]
                      and out["shared_pools_train"]["near_ties_only"]):
        raise AssertionError(f"a pool index differs card vs CPU off a near-tie: {out}")
    if not (out["logits_max_rel_err"] <= 1e-4 and out["argmax_equal_share"] >= 0.999):
        raise AssertionError(f"eval-mode logits differ, card vs CPU: {out}")
    if not max(out["train_loss_rel"].values()) <= 1e-3:
        raise AssertionError(f"train losses differ card vs CPU: {out}")
    return out


LAYOUT_STEPS = 2  # one epoch of each dataset layout's config
LAYOUT_IMAGES = {  # config: (train images, val images) at its BATCH_SIZE
    "pennfudan_maskrcnn": (8, 8),  # batch 4; TRAIN and VAL read one folder, as written
    "voc_deeplabv3plus": (32, 16),  # batch 16
    "visdrone_yolov5": (32, 16),  # batch 16
}
LAYOUT_NMS = {  # nms_keep launches of one epoch and its val: none in the seg
    "pennfudan_maskrcnn": LAYOUT_STEPS + 2 * 2,  # RPN each step, 2 a val batch
    "voc_deeplabv3plus": 0,
    "visdrone_yolov5": 1,  # one val batch
}


def layout_config(workdir: Path, name: str) -> Path:
    """``conf/<name>.yml`` as written, its dataset class reading a
    directory in the dataset's own layout (``data/layouts.py``: PennFudanPed
    PNG images and palette instance masks; VOCdevkit JPEG copies of the
    fixtures, palette masks with 255 borders and ImageSets split files;
    VisDrone-DET JPEG copies with txt annotations of categories 0–11);
    only ``IMG_DIR``/``INDICES`` changed; cut to one epoch of
    ``LAYOUT_STEPS`` steps and one val epoch."""
    from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
    from cvpytorch_tpu_torch.data import layouts

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / f"{name}.yml"))
    data = cfg.DATASET
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    n_train, n_val = LAYOUT_IMAGES[name]
    jpegs = [str(FIXTURES / f) for f in sorted(fixture_manifest())]
    root = workdir / "data"
    if name == "pennfudan_maskrcnn":
        img_dir = layouts.write_pennfudan(str(root / "PennFudanPed"), n_train)
        stages = {"TRAIN": {"IMG_DIR": img_dir}, "VAL": {"IMG_DIR": img_dir}}
    elif name == "voc_deeplabv3plus":
        names = [next(iter(d)) for d in load_dictionary(data.DICTIONARY, "SEG_CLASSES")[1]][1:]
        out = layouts.write_voc(str(root / "VOCdevkit" / "VOC2012"), jpegs, names,
                                1 + n_train + n_val, n_train)
        stages = {"TRAIN": {"IMG_DIR": out["IMG_DIR"], "INDICES": out["train"]},
                  "VAL": {"IMG_DIR": out["IMG_DIR"], "INDICES": out["val"]}}
    else:
        stages = {"TRAIN": {"IMG_DIR": layouts.write_visdrone(
                      str(root / "VisDrone2019-DET-train"), jpegs, n_train, seed=1)},
                  "VAL": {"IMG_DIR": layouts.write_visdrone(
                      str(root / "VisDrone2019-DET-val"), jpegs, n_val, seed=2)}}
    for stage, update in stages.items():
        data.get(stage).update(update)
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / f"{name}_layout.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def layout_run(workdir: Path, name: str) -> dict:
    """One dataset layout's config through ``Trainer.run()`` on the card,
    every ``nms_keep`` input kept (count set to 0 just before the run and
    read just after); checks the dataset classes and sizes, finite losses
    and val metrics and the launches; then holds ``nms_keep`` to
    ``nms_keep_plain`` bit for bit on the inputs the path gave it (these
    launches not counted) and times one pass of the train loader."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    workdir.mkdir(parents=True)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(layout_config(workdir, name))))
    want_cls = trainer.cfg.DATASET.CLASS.split(".")[-1]
    sizes = {stage: len(trainer.datasets[stage]) for stage in ("train", "val")}
    if (type(trainer.datasets["train"]).__name__ != want_cls
            or (sizes["train"], sizes["val"]) != LAYOUT_IMAGES[name]):
        raise AssertionError(f"{name}: {type(trainer.datasets['train']).__name__} of {sizes}")
    seen, restore = capture_nms_inputs()
    try:
        run = run_instrumented(trainer, trainer_mod)
    finally:
        restore()
    state, metrics, launches = run["state"], run["metrics"], run["launches"]
    if len(metrics) != LAYOUT_STEPS or state.step != LAYOUT_STEPS:
        raise AssertionError(f"{name}: {len(metrics)} steps, state at step {state.step}")
    losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"{name}: non-finite train loss {losses}")
    if launches != LAYOUT_NMS[name] or len(seen) != launches:
        raise AssertionError(f"{name}: nms_keep launched {launches} times ({len(seen)} "
                             f"inputs kept), not {LAYOUT_NMS[name]}")
    (val_metrics,) = run["val"]
    val = {k: float(v) for k, v in val_metrics.items()
           if k in ("performance", "mAP", "bbox_mAP", "segm_mAP", "mIoU")}
    if not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f"{name}: val metrics {val_metrics}")
    nms_inputs = {}
    before = nms_keep.launches
    for boxes, thr in seen:
        got, want = nms_keep(boxes, thr), nms_keep_plain(boxes, thr)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: nms_keep != nms_keep_plain on a path input of "
                                 f"{tuple(boxes.shape)}: {int((got != want).sum())} flags")
        key = "x".join(map(str, boxes.shape[:2]))
        nms_inputs[key] = nms_inputs.get(key, 0) + 1
    nms_keep.launches = before  # comparison launches do not count
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in trainer.dataloaders["train"])
    loader_rate = n / (time.perf_counter() - t0)
    epoch_s = run["times"]["train_epoch"][0]
    out = {"dataset": want_cls, "images": sizes, "steps": LAYOUT_STEPS, "launches": launches,
           "nms_inputs": ({"bit_exact": True, "inputs_by_shape": nms_inputs}
                          if nms_inputs else None),
           "losses": losses, "val": val, "run_s": run["run_s"], "train_epoch_s": epoch_s,
           "fed_images_per_s": sizes["train"] / epoch_s,
           "val_epoch_s": run["times"]["val_epoch"][0],
           "host_loader_images_per_s": loader_rate,
           "loader_threads": trainer.dataloaders["train"].num_workers}
    print(f"{name} on its own layout ({want_cls}, {sizes}): {json.dumps(out)}", flush=True)
    return out


def dataset_layouts_phase(workdir: Path) -> dict:
    """PennFudan Mask R-CNN, VOC DeepLabV3+ and VisDrone YOLOv5, each on a
    directory in its dataset's layout (``layout_run``)."""
    import torch

    out = {}
    for name in LAYOUT_IMAGES:
        torch.cuda.empty_cache()
        out[name] = layout_run(workdir / name, name)
    return out


CLS_BATCH = 64  # TRAIN and VAL BATCH_SIZE of conf/mini-imagenet.yml
CLS_MILESTONE_BATCH = 256  # bench.py's case_cls
CLS_FRAME = [375, 500]  # ImageNet's typical frame: the crop and resize do real work
CLS_STEPS = 4  # one epoch
CLS_VAL_IMAGES = 64  # one val batch


def cls_config(workdir: Path) -> Path:
    """``conf/mini-imagenet.yml`` as written (MobileNetV2 classifier, 100
    CLS_CLASSES from ``conf/dicts/mini-imagenet_dict.yml``, RandomResizedCrop
    224, flip, ColorJitter, AdamW with weight decay 0.01, cosine schedule,
    linear warmup, AMP, batch 64, mAcc evaluation) with the dataset swapped
    for SyntheticClassification at 375×500; cut to one epoch of 4 steps
    validated on 64 images.  The INFER stage (one batch) serves the
    checkpoint afterwards."""
    from cvpytorch_tpu_torch.config import CommonConfiguration

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / "mini-imagenet.yml"))
    data = cfg.DATASET
    data.CLASS = "SyntheticClassification"
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    synthetic = {"SIZE": CLS_FRAME, "SEED": 0}
    data.TRAIN.update({**synthetic, "LENGTH": CLS_BATCH * CLS_STEPS})
    data.VAL.update({**synthetic, "LENGTH": CLS_VAL_IMAGES})
    data.INFER = {**dict(data.VAL), "LENGTH": CLS_BATCH}
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / "mini_imagenet_synthetic.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def infer_batch(trainer, n: int):
    """The first ``n`` images of the config's INFER stage, as ``infer.main``
    reads them, on the card, with the stage's letterbox ``pads``/``scales``
    when it records them."""
    import torch

    from cvpytorch_tpu_torch.data.loader import DataLoader
    from cvpytorch_tpu_torch.data.transforms import build_transforms
    from cvpytorch_tpu_torch.infer import LETTERBOX_KEYS
    from cvpytorch_tpu_torch.registry import DATASETS

    stage = trainer.cfg.DATASET.INFER
    ds = DATASETS.get(trainer.cfg.DATASET.CLASS)(
        data_cfg=stage, dictionary=trainer.dictionary, stage="infer",
        transform=build_transforms(trainer.dictionary_name, stage.get("TRANSFORMS"), "infer"))
    batch = next(iter(DataLoader(ds, n, num_workers=8)))
    extra = {k: torch.from_numpy(np.stack(batch[k])).cuda()
             for k in LETTERBOX_KEYS if k in batch}
    return torch.from_numpy(batch["image"]).cuda(), extra


def cls_phase(workdir: Path) -> tuple[dict, object]:
    """``conf/mini-imagenet.yml`` trained through ``Trainer.run()`` (mAcc
    validation) and served through ``infer.main`` on the card: the served
    class ids equal the predict step's argmax; no NMS on this path."""
    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.train_state import make_predict_step

    workdir.mkdir()
    setting = cls_config(workdir)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    # the main path of this phase, counts read just around it
    run = run_instrumented(trainer, trainer_mod)
    state, metrics, times, run_s, launches = (
        run[k] for k in ("state", "metrics", "times", "run_s", "launches"))
    if len(metrics) != CLS_STEPS or state.step != CLS_STEPS:
        raise AssertionError(f"{len(metrics)} steps recorded, state at step {state.step}")
    losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    if set(losses) != {"loss", "ce_loss"} or not all(np.isfinite(v).all()
                                                      for v in losses.values()):
        raise AssertionError(f"train losses {losses}")
    if launches:  # classification runs no NMS
        raise AssertionError(f"nms_keep launched {launches} times on the classification path")
    (val_metrics,) = run["val"]
    if not (0 <= val_metrics["mAcc"] <= 1 and val_metrics["performance"] == val_metrics["mAcc"]):
        raise AssertionError(f"val mAcc {val_metrics['mAcc']}")
    print(f"MobileNetV2 Trainer.run(): {CLS_STEPS} steps in {run_s:.2f} s (host clock, from "
          f"model build to the last checkpoint), losses {losses}, val mAcc "
          f"{val_metrics['mAcc']} Acc {val_metrics['Acc']}, nms_keep launches 0", flush=True)

    out_dir = workdir / "served"
    infer.main(["--setting", str(setting), "--checkpoint",
                str(Path(trainer.checkpoints.save_dir) / "last.pt"), "--out", str(out_dir)])
    served = json.loads((out_dir / "predictions.json").read_text())
    images, _ = infer_batch(trainer, CLS_BATCH)
    want = make_predict_step(state.model)(images).cpu().tolist()
    if served != want:
        raise AssertionError(f"served class ids differ from the predict step's argmax at "
                             f"{sum(a != b for a, b in zip(served, want))} of {len(want)}")
    print(f"infer.main on the trained MobileNetV2: {len(served)} class ids equal to the predict "
          f"step's argmax ({len(set(served))} distinct)", flush=True)
    return {
        "steps": CLS_STEPS,
        "nms_keep_launches": launches,
        "losses": losses,
        "run_s": run_s,
        "train_epoch_s": times["train_epoch"][0],
        "fed_images_per_s": CLS_BATCH * CLS_STEPS / times["train_epoch"][0],
        "val_epoch_s": times["val_epoch"][0],
        "val_evaluator_s": times["evaluator"],
        "val_evaluator_share": times["evaluator"] / times["val_epoch"][0],
        "val_mAcc": val_metrics["mAcc"],
        "served_images": len(served),
    }, trainer


def loader_batch(trainer, stage: str, n: int) -> dict:
    """``n`` images and their targets from the ``stage`` loader's first
    batches, concatenated, on the card: those ``run_instrumented`` kept
    from the run when they hold ``n`` images (loading them again cost the
    run's time limit ~30 s), else loaded anew."""
    import torch

    kept = getattr(trainer, "kept_batches", {}).get(stage, [])
    if sum(len(b["image"]) for b in kept) >= n:
        def cat(*xs):
            return torch.cat(xs)[:n]

        target = kept[0]["target"]
        if isinstance(target, dict):  # the loader's arrays, not the loop's epoch and step
            target = {k: cat(*(b["target"][k] for b in kept)) for k, v in target.items()
                      if isinstance(v, torch.Tensor) and v.dim()}
        else:
            target = cat(*(b["target"] for b in kept))
        return {"image": cat(*(b["image"] for b in kept)), "target": target}
    parts, have = [], 0
    for batch in trainer.dataloaders[stage]:
        parts.append(batch)
        have += len(batch["image"])
        if have >= n:
            break
    if have < n:
        raise AssertionError(f"the {stage} loader holds {have} images, not {n}")

    def cat(*xs):
        return torch.from_numpy(np.concatenate(xs)[:n]).cuda()

    target = parts[0]["target"]
    if isinstance(target, dict):
        target = {k: cat(*(p["target"][k] for p in parts)) for k in target}
    else:
        target = cat(*(p["target"] for p in parts))
    return {"image": cat(*(p["image"] for p in parts)), "target": target}


def milestone_timing(trainer, n: int, milestone: int | None, iters: int,
                     ema_decay: float = 0.0, amp_only: bool = False) -> tuple[dict, dict, dict]:
    """The AMP and f32 train steps at the config's batch ``n`` and, unless
    None, at the bench milestone's batch ``milestone``
    (``train_step_timing``), the f32 val step and the serving predict step
    at ``n``.  Returns the numbers, the AMP states and the batches they
    ran on: ``train`` and ``val`` (the first ``n`` images of each loader)
    and ``milestone`` (its first ``milestone`` train images)."""
    import torch

    from cvpytorch_tpu_torch.train_state import make_eval_step, make_predict_step

    batches = {"train": loader_batch(trainer, "train", n), "val": loader_batch(trainer, "val", n)}
    out, amp_state = train_step_timing(trainer, batches["train"], n, iters, ema_decay, amp_only)
    states = {"train": amp_state}
    torch.cuda.empty_cache()
    if milestone:
        batches["milestone"] = loader_batch(trainer, "train", milestone)
        out[f"milestone_bs{milestone}"], states["milestone"] = train_step_timing(
            trainer, batches["milestone"], milestone, iters, ema_decay, amp_only=True)
        torch.cuda.empty_cache()
    eval_step = make_eval_step()
    out["val_step_ms"] = cuda_time_ms(lambda: eval_step(amp_state, batches["val"]),
                                      iters=2, warmup=1)
    predict = make_predict_step(amp_state.model)
    out[f"bs{n}_predict_ms"] = cuda_time_ms(lambda: predict(batches["val"]["image"]),
                                            iters=2, warmup=1)
    out[f"bs{n}_predict_images_per_s"] = n / out[f"bs{n}_predict_ms"] * 1e3
    return out, states, batches


def card_vs_cpu(trainer, batches, forward, check) -> dict:
    """``forward(model, batch)`` (a dict of tensors) on the card and on the
    CPU at B = 2, f32 with TF32 off, from the same seeded weights with
    dropout and stochastic depth off; ``check(cpu, card)`` compares the
    two and raises."""
    import copy

    import torch

    from cvpytorch_tpu_torch.infer import build_model

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the step makers turn it off")
    two = _tree(batches["train"], lambda t: t[:2])
    from cvpytorch_tpu_torch.models.bricks import DropPath

    torch.manual_seed(0)
    base = build_model(trainer.cfg, trainer.dictionary, trainer.datasets["train"])
    for m in base.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, DropPath):  # EfficientNet's stochastic depth
            m.rate = 0.0
    seen = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device, memory_format=torch.channels_last)
        seen[device] = _tree(forward(model, _tree(two, lambda t: t.to(device))),
                             lambda t: t.detach().cpu())
    return check(seen["cpu"], seen["cuda"])


def max_rel_err(a, b) -> float:
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))


def cls_card_vs_cpu(trainer, batches) -> dict:
    """MobileNetV2 at 224², B = 2: eval-mode logits within 1e-4 of their
    largest value, the train-mode loss within 1e-4 relative."""
    import torch

    def forward(model, batch):
        x = batch["image"]
        with torch.no_grad():
            logits = model.eval().backbone(x.permute(0, 3, 1, 2))
            loss, _ = model.train()(x, batch["target"], mode="train")
        return {"logits": logits, "loss": loss}

    def check(cpu, card):
        out = {"logits_max_rel_err": max_rel_err(card["logits"], cpu["logits"]),
               "argmax_equal": bool(torch.equal(card["logits"].argmax(-1),
                                                cpu["logits"].argmax(-1))),
               "loss_cpu": float(cpu["loss"]), "loss_card": float(card["loss"]),
               "loss_rel": abs(float(card["loss"]) - float(cpu["loss"])) / abs(float(cpu["loss"]))}
        print(f"MobileNetV2 card vs CPU, f32, B=2, 224²: {json.dumps(out)}", flush=True)
        if not (out["logits_max_rel_err"] <= 1e-4 and out["loss_rel"] <= 1e-4):
            raise AssertionError(f"MobileNetV2 card vs CPU: {out}")
        return out

    return card_vs_cpu(trainer, batches, forward, check)


NANODET_BATCH = 96  # TRAIN and VAL BATCH_SIZE of conf/coco_nanodetplus.yml
NANODET_MILESTONE_BATCH = 128  # bench.py's case_nanodet
NANODET_FRAME = [427, 640]  # a common COCO frame; 320/640 is not an exact half of 427
NANODET_STEPS = 2  # one epoch
# images NanoDet-Plus and NanoDet v1 serve through infer.main, a partial
# batch
DET_SERVED = 16
NANODET_VAL_IMAGES = 96  # one val epoch of 1 batch


def nanodet_config(workdir: Path) -> Path:
    """``conf/coco_nanodetplus.yml`` as written (ShuffleNetV2 x1.0 with
    leaky ReLU, GhostPAN 96 with 4 levels, 80 DET_CLASSES, MAX_BOXES 64,
    letterbox 320, flip, ColorHSV p=1, AdamW with weight decay 0.05,
    cosine schedule, linear warmup of 500 iterations, AMP, EMA, batch 96,
    bbox evaluation) with the dataset swapped for SyntheticDetection at
    427×640; cut to one epoch of ``NANODET_STEPS`` steps validated on 96 images.  The
    INFER stage (one batch) serves the checkpoint afterwards."""
    from cvpytorch_tpu_torch.config import CommonConfiguration

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / "coco_nanodetplus.yml"))
    data = cfg.DATASET
    data.CLASS = "SyntheticDetection"
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    synthetic = {"SIZE": NANODET_FRAME, "SEED": 0}
    data.TRAIN.update({**synthetic, "LENGTH": NANODET_BATCH * NANODET_STEPS})
    data.VAL.update({**synthetic, "LENGTH": NANODET_VAL_IMAGES})
    data.INFER = {**dict(data.VAL), "LENGTH": DET_SERVED}
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / "coco_nanodetplus_synthetic.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def det_run(trainer, trainer_mod, label: str, steps: int, names, val_batches: int) -> dict:
    """``run_instrumented`` with the checks every detection path shares:
    ``steps`` train steps of finite losses ``names``, ``nms_keep`` launched
    once per val batch and a finite val mAP."""
    run = run_instrumented(trainer, trainer_mod)
    state, metrics, launches = run["state"], run["metrics"], run["launches"]
    if len(metrics) != steps or state.step != steps:
        raise AssertionError(f"{label}: {len(metrics)} steps recorded, state at step "
                             f"{state.step}")
    losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    if set(losses) != set(names) or not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"{label}: train losses {losses}")
    if launches != val_batches:
        raise AssertionError(f"{label}: nms_keep launched {launches} times for {val_batches} "
                             "val batches")
    (val_metrics,) = run["val"]
    if not np.isfinite(val_metrics["mAP"]):
        raise AssertionError(f"{label}: val mAP {val_metrics['mAP']}")
    return {**run, "losses": losses, "val_mAP": float(val_metrics["mAP"])}


def serve_checkpoint(workdir: Path, setting: Path, trainer, state, n: int, label: str) -> dict:
    """``infer.main`` on the last checkpoint (its EMA weights): one served
    batch of ``n`` images, ``nms_keep`` once; the served detections are the
    predict step's on the same images, un-letterboxed to each image's
    pixels (labels equal, boxes within 1e-3 px)."""
    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep
    from cvpytorch_tpu_torch.train_state import make_predict_step

    before = nms_keep.launches
    t0 = time.perf_counter()
    infer.main(["--setting", str(setting), "--checkpoint",
                str(Path(trainer.checkpoints.save_dir) / "last.pt"),
                "--out", str(workdir / "served")])
    cli_s = time.perf_counter() - t0
    served_launches = nms_keep.launches - before
    if served_launches != 1:
        raise AssertionError(f"{label}: nms_keep launched {served_launches} times serving "
                             "1 batch")
    served = json.loads((workdir / "served" / "predictions.json").read_text())
    images, letterbox = infer_batch(trainer, n)
    net = make_predict_step(state.ema)(images)
    pads, scales = (letterbox[k].cpu().numpy() for k in ("pads", "scales"))
    if len(served) != n:
        raise AssertionError(f"{label}: {len(served)} predictions for {n} images")
    n_dets = 0
    for i, p in enumerate(served):
        v = net["valid"][i].cpu().numpy()
        boxes = net["boxes"][i].cpu().numpy()[v]
        want = (boxes - np.tile(pads[i], 2)) / np.tile(scales[i], 2)
        if p["labels"] != net["labels"][i][net["valid"][i]].tolist() or not np.allclose(
                np.reshape(p["boxes"], (-1, 4)), want, atol=1e-3, rtol=1e-5):
            raise AssertionError(f"{label}: served image {i} differs from the predict step "
                                 "un-letterboxed")
        n_dets += len(p["labels"])
    return {"served_launches": served_launches, "infer_cli_s": cli_s,
            "served_images": n, "served_detections": n_dets,
            "first_pads": pads[0].tolist(), "first_scale": float(scales[0][0])}


def nanodet_phase(workdir: Path) -> tuple[dict, object]:
    """``conf/coco_nanodetplus.yml`` trained through ``Trainer.run()`` (bbox
    validation through ``nms_keep``) and served through ``infer.main`` on
    the card: ``nms_keep`` once per val batch, then once per served batch;
    the served boxes are the predict step's, un-letterboxed to the
    427×640 frame."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration

    workdir.mkdir()
    setting = nanodet_config(workdir)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    # the main path of this phase, counts read just around it
    run = det_run(trainer, trainer_mod, "NanoDet-Plus", NANODET_STEPS,
                  ("qfl_loss", "bbox_loss", "dfl_loss", "loss"),
                  -(-NANODET_VAL_IMAGES // NANODET_BATCH))
    times = run["times"]
    print(f"NanoDet-Plus Trainer.run(): {NANODET_STEPS} steps in {run['run_s']:.2f} s (host "
          f"clock, from model build to the last checkpoint), losses {run['losses']}, nms_keep "
          f"launches {run['launches']}, val mAP {run['val_mAP']}", flush=True)
    served = serve_checkpoint(workdir, setting, trainer, run["state"], DET_SERVED,
                              "NanoDet-Plus")
    print(f"infer.main on the trained NanoDet-Plus: {json.dumps(served)} in the "
          f"{NANODET_FRAME[0]}×{NANODET_FRAME[1]} frame's pixels", flush=True)
    torch.cuda.empty_cache()
    return {
        "steps": NANODET_STEPS,
        "launches": run["launches"],
        "losses": run["losses"],
        "run_s": run["run_s"],
        "train_epoch_s": times["train_epoch"][0],
        "fed_images_per_s": NANODET_BATCH * NANODET_STEPS / times["train_epoch"][0],
        "val_epoch_s": times["val_epoch"][0],
        "val_evaluator_s": times["evaluator"],
        "val_evaluator_share": times["evaluator"] / times["val_epoch"][0],
        "val_mAP": run["val_mAP"],
        **served,
    }, trainer


def val_nms_input(state, val_batch, label: str) -> tuple[dict, tuple]:
    """``nms_keep`` against ``nms_keep_plain`` on a detection path's own
    input, the (B, 1024) class-offset boxes of a val step on ``val_batch``:
    bit-exact, and timed.  Returns the record and the (boxes, thr) input."""
    import torch

    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from cvpytorch_tpu_torch.train_state import make_eval_step

    seen, restore = capture_nms_inputs()
    try:
        make_eval_step(use_ema=True)(state, val_batch)
    finally:
        restore()
    (boxes, thr), = seen
    want_shape = (len(val_batch["image"]), 1024, 4)
    if tuple(boxes.shape) != want_shape or thr != state.model.iou_threshold:
        raise AssertionError(f"{label} NMS input {tuple(boxes.shape)} thr {thr}")
    launches_before = nms_keep.launches
    got, want = nms_keep(boxes, thr), nms_keep_plain(boxes, thr)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"nms_keep != nms_keep_plain on the {label} val input: "
                             f"{int((got != want).sum())} flags differ")
    out = {"shape": list(boxes.shape), "thr": thr, "kept": int(got.sum()), "bit_exact": True,
           "ms": nms_event_ms(boxes, thr),
           "plain_ms": cuda_time_ms(lambda: nms_keep_plain(boxes, thr), iters=3, warmup=1)}
    nms_keep.launches = launches_before  # comparison launches do not count
    print(f"nms_keep on the {label} val input: {json.dumps(out)}", flush=True)
    return out, (boxes, thr)


def nanodet_card_vs_cpu(trainer, batches) -> dict:
    """NanoDet-Plus at 320², B = 2: eval-mode head outputs within 1e-4 of
    their largest value; in train mode the DSL assignment of the CPU's
    predictions equal on the card (``matched_gt``) and the losses within
    1e-4 relative."""
    import torch

    from cvpytorch_tpu_torch.models.assigners.dsl_assigner import dsl_assign
    from cvpytorch_tpu_torch.models.heads.nanodet_head import decode_nanodet

    def forward(model, batch):
        x, t = batch["image"], batch["target"]
        with torch.no_grad():
            head, _, priors = model.eval()._forward(x, train=False)
            _, losses = model.train()(x, t, mode="train")
            preds, _, _ = model._forward(x, train=True)
        return {"head": head, "priors": priors, "train_preds": preds,
                "losses": losses, "target": t}

    def check(cpu, card):
        model = trainer.model
        # the assigner on one input (the CPU's train-mode predictions) on both devices
        matched = {}
        for device in ("cpu", "cuda"):
            cls, dec, _ = decode_nanodet(cpu["train_preds"].to(device), cpu["priors"].to(device),
                                         model.num_classes, model.reg_max)
            t = {k: v.to(device) for k, v in cpu["target"].items()}
            matched[device] = dsl_assign(cls, cpu["priors"].to(device), dec, t["boxes"],
                                         t["labels"], t["valid"])["matched_gt"].cpu()
        out = {"head_max_rel_err": max_rel_err(card["head"], cpu["head"]),
               "dsl_matched_gt_equal": bool(torch.equal(matched["cpu"], matched["cuda"])),
               "dsl_positives": int((matched["cpu"] >= 0).sum()),
               "train_loss_rel": {k: abs(float(card["losses"][k]) - float(v)) / max(abs(float(v)),
                                                                                    1e-12)
                                  for k, v in cpu["losses"].items()},
               "train_loss_cpu": {k: float(v) for k, v in cpu["losses"].items()}}
        print(f"NanoDet-Plus card vs CPU, f32, B=2, 320²: {json.dumps(out)}", flush=True)
        if not (out["head_max_rel_err"] <= 1e-4 and out["dsl_matched_gt_equal"]
                and max(out["train_loss_rel"].values()) <= 1e-4):
            raise AssertionError(f"NanoDet-Plus card vs CPU: {out}")
        return out

    return card_vs_cpu(trainer, batches, forward, check)


def dsl_timing(state, batch) -> dict:
    """The DSL assigner alone on one train batch's predictions (the model
    in eval mode, bf16 autocast, as in the AMP step): CUDA events over 3
    calls after 1, and its peak memory above what was allocated before."""
    import torch

    from cvpytorch_tpu_torch.models.assigners.dsl_assigner import dsl_assign
    from cvpytorch_tpu_torch.models.heads.nanodet_head import decode_nanodet
    from cvpytorch_tpu_torch.train_state import prepare_images

    model, t = state.model, batch["target"]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        preds, _, priors = model.eval()._forward(prepare_images(batch["image"]), train=False)
    cls, dec, _ = decode_nanodet(preds.float(), priors, model.num_classes, model.reg_max)

    def call():
        return dsl_assign(cls, priors, dec, t["boxes"], t["labels"], t["valid"])

    positives = int((call()["matched_gt"] >= 0).sum())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(call, iters=3, warmup=1)
    out = {"B_P_M_C": [*cls.shape[:2], t["boxes"].shape[1], cls.shape[2]], "ms": ms,
           "peak_above_inputs_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "positives": positives}
    print(f"DSL assigner alone: {json.dumps(out)}", flush=True)
    return out


YOLOV6_BATCH = 32  # TRAIN and VAL BATCH_SIZE of conf/coco_yolov6_s.yml
YOLOV6_EPOCHS = 5  # one step an epoch: epochs 0-3 assign with ATSS, epoch 4 with TAL
YOLOV6_VAL_IMAGES = 64  # one val epoch of 2 batches, after epoch 4
# NanoDet v1's other configs, one train step and one val batch each at their
# batch: COCO ones on the COCO directory, voc_nanodet on a VOCdevkit
ONE_STEP_CONFIGS = {"coco_nanodet_t": 160, "coco_nanodet_g": 128, "coco_nanodet_repvgg": 128,
                    "coco_nanodet_efficientnet_lite": 160, "coco_nanodet_416": 128,
                    "voc_nanodet": 64}
# the one-step configs on the COCO directory validate at most this many
# images, one (partial) batch
ONE_STEP_VAL = 32


def coco_det_config(workdir: Path, name: str, coco: dict, n_train: int, n_val: int,
                    n_infer: int, epochs: int = 1) -> Path:
    """``conf/<name>.yml`` as written (its ``CocoDetection``, transforms,
    model, recipe and batch), only ``IMG_DIR``/``ANN_FILE`` pointed at the
    first ``n_train``/``n_val`` images of the COCO directory of JPEG files;
    ``epochs`` epochs, validated after the last; the INFER stage (the
    first ``n_infer`` val images) serves the checkpoint afterwards."""
    from cvpytorch_tpu_torch.config import CommonConfiguration

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / f"{name}.yml"))
    data = cfg.DATASET
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    for stage, n in (("TRAIN", n_train), ("VAL", n_val)):
        img_dir, ann_file = coco_subset(coco, stage.lower(), n)
        data.get(stage).update({"IMG_DIR": img_dir, "ANN_FILE": ann_file})
    data.INFER = {**dict(data.VAL), "ANN_FILE": coco_subset(coco, "val", n_infer)[1]}
    cfg.EVALUATOR.EVAL_INTERVALS = epochs
    cfg.update({"N_MAX_EPOCHS": epochs, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / f"{name}_jpeg_files.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def nanodet_v1_phase(workdir: Path, coco: dict) -> tuple[dict, object]:
    """``conf/coco_nanodet.yml`` as written (ShuffleNetV2-1.0 with leaky
    ReLU, PAN 96, 3×3 head stacks, strides 8-32, ATSS-assigned GFL loss,
    80 classes, letterbox 320, RandomAffine, flip, ColorHSV, SGD 0.937,
    cosine, warmup, grad clip 10, AMP, EMA, batch 160, bbox evaluation) on
    the COCO directory's JPEG files: ``Trainer.run()`` for 2 steps, bbox
    validation of 160 images (``nms_keep`` once, at (160, 1024)), the
    checkpoint served through ``infer.main`` (once more)."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration

    workdir.mkdir()
    n_train = NANODET_V1_BATCH * NANODET_V1_STEPS
    setting = coco_det_config(workdir, "coco_nanodet", coco, n_train, NANODET_V1_VAL_IMAGES,
                              DET_SERVED)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    model = trainer.model
    if not (model.v1 and type(model.neck).__name__ == "PAN" and model.strides == (8, 16, 32)):
        raise AssertionError(f"coco_nanodet built {type(model.neck).__name__}, v1 {model.v1}, "
                             f"strides {model.strides}")
    # the main path of this phase, counts read just around it
    run = det_run(trainer, trainer_mod, "NanoDet v1", NANODET_V1_STEPS,
                  ("qfl_loss", "bbox_loss", "dfl_loss", "loss"),
                  -(-NANODET_V1_VAL_IMAGES // NANODET_V1_BATCH))
    served = serve_checkpoint(workdir, setting, trainer, run["state"], DET_SERVED,
                              "NanoDet v1")
    times = run["times"]
    out = {"steps": NANODET_V1_STEPS, "launches": run["launches"], "losses": run["losses"],
           "val_mAP": run["val_mAP"], "run_s": run["run_s"],
           "train_epoch_s": times["train_epoch"][0],
           "fed_images_per_s": n_train / times["train_epoch"][0],
           "val_epoch_s": times["val_epoch"][0],
           "val_evaluator_share": times["evaluator"] / times["val_epoch"][0], **served}
    print(f"NanoDet v1 (coco_nanodet) Trainer.run() on {n_train} JPEG files: "
          f"{json.dumps(out)}", flush=True)
    torch.cuda.empty_cache()
    return out, trainer


def atss_timing(state, batch) -> dict:
    """The ATSS assignment of NanoDet v1's loss alone on one train batch's
    targets (the octave cells of the (i + 0.5)·stride priors): CUDA events
    over 3 calls after 1, and its peak memory above its inputs."""
    import torch

    from cvpytorch_tpu_torch.models.assigners.atss_assigner import atss_assign, grid_cells
    from cvpytorch_tpu_torch.train_state import prepare_images

    model, t = state.model, batch["target"]
    with torch.no_grad():
        _, _, priors, level_priors = model.eval()._forward_levels(
            prepare_images(batch["image"]), train=False)
    cells = grid_cells(priors, model.octave_base_scale)

    def call():
        return atss_assign(priors, level_priors, cells, t["boxes"], t["valid"],
                           model.atss_topk)

    positives = int((call()["matched_gt"] >= 0).sum())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(call, iters=3, warmup=1)
    out = {"B_P_M": [t["boxes"].shape[0], priors.shape[0], t["boxes"].shape[1]], "ms": ms,
           "peak_above_inputs_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "positives": positives}
    print(f"ATSS assigner alone: {json.dumps(out)}", flush=True)
    return out


def nanodet_v1_card_vs_cpu(trainer, batches) -> dict:
    """NanoDet v1 (coco_nanodet) at 320², B = 2, f32: eval-mode head
    outputs within 1e-4 of their largest value; the ATSS assignment of the
    CPU's priors and targets equal on the card (``matched_gt``: the
    distance ties of grid priors resolved alike); the train-mode losses
    within 1e-4 relative."""
    import torch

    from cvpytorch_tpu_torch.models.assigners.atss_assigner import atss_assign, grid_cells

    def forward(model, batch):
        x, t = batch["image"], batch["target"]
        with torch.no_grad():
            head, _, priors, level_priors = model.eval()._forward_levels(x, train=False)
            _, losses = model.train()(x, t, mode="train")
        return {"head": head, "priors": priors, "losses": losses, "target": t,
                "level_priors": torch.tensor(level_priors)}

    def check(cpu, card):
        model = trainer.model
        matched = {}
        for device in ("cpu", "cuda"):
            priors = cpu["priors"].to(device)
            t = {k: v.to(device) for k, v in cpu["target"].items()}
            matched[device] = atss_assign(
                priors, tuple(cpu["level_priors"].tolist()),
                grid_cells(priors, model.octave_base_scale), t["boxes"], t["valid"],
                model.atss_topk)["matched_gt"].cpu()
        out = {"head_max_rel_err": max_rel_err(card["head"], cpu["head"]),
               "atss_matched_gt_equal": bool(torch.equal(matched["cpu"], matched["cuda"])),
               "atss_positives": int((matched["cpu"] >= 0).sum()),
               "train_loss_rel": {k: abs(float(card["losses"][k]) - float(v))
                                  / max(abs(float(v)), 1e-12)
                                  for k, v in cpu["losses"].items()},
               "train_loss_cpu": {k: float(v) for k, v in cpu["losses"].items()}}
        print(f"NanoDet v1 card vs CPU, f32, B=2, 320²: {json.dumps(out)}", flush=True)
        if not (out["head_max_rel_err"] <= 1e-4 and out["atss_matched_gt_equal"]
                and max(out["train_loss_rel"].values()) <= 1e-4):
            raise AssertionError(f"NanoDet v1 card vs CPU: {out}")
        return out

    return card_vs_cpu(trainer, batches, forward, check)


@contextlib.contextmanager
def yolov6_branches():
    """Records the epoch each ``yolov6_loss`` call gets and which assigner
    it runs (``atss``, ``tal``)."""
    from cvpytorch_tpu_torch.models import yolov6

    seen = {"epochs": [], "assigners": []}
    real = {k: getattr(yolov6, k) for k in ("yolov6_loss", "atss_assign", "tal_assign")}

    def loss(*args, **kwargs):
        epoch = args[5] if len(args) > 5 else kwargs.get("epoch")
        if epoch is not None and type(epoch) is not int:
            raise AssertionError(f"yolov6_loss got the epoch as {type(epoch).__name__}, "
                                 "not the host integer")
        seen["epochs"].append(epoch)
        return real["yolov6_loss"](*args, **kwargs)

    def recorded(name):
        def call(*args, **kwargs):
            seen["assigners"].append(name.split("_")[0])
            return real[name](*args, **kwargs)
        return call

    yolov6.yolov6_loss = loss
    yolov6.atss_assign, yolov6.tal_assign = recorded("atss_assign"), recorded("tal_assign")
    try:
        yield seen
    finally:
        for k, v in real.items():
            setattr(yolov6, k, v)


def yolov6_phase(workdir: Path, coco: dict) -> tuple[dict, object]:
    """``conf/coco_yolov6_s.yml`` as written (EfficientRep + RepBiPAN +
    Effidehead at s's multipliers, 80 classes, mosaic + affine at 640² on
    LOAD_NUM = 4 groups, flip, ColorHSV, SGD 0.937, cosine, warmup, grad
    clip 10, AMP, EMA, batch 32, bbox evaluation) on the COCO directory's
    JPEG files: ``Trainer.run()`` for 5 epochs of one step, epochs 0-3
    assigned with ATSS and epoch 4 with TAL, the epoch the host integer
    the trainer puts in the targets; bbox validation of 64 images after
    epoch 4 (TAL; ``nms_keep`` once a batch) and one served batch (once
    more)."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration

    workdir.mkdir()
    setting = coco_det_config(workdir, "coco_yolov6_s", coco, YOLOV6_BATCH, YOLOV6_VAL_IMAGES,
                              YOLOV6_BATCH, epochs=YOLOV6_EPOCHS)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    if type(trainer.model).__name__ != "YOLOv6" or trainer.model.neck.out_channels != [
            64, 128, 256]:
        raise AssertionError(f"coco_yolov6_s built {type(trainer.model).__name__}")
    # class logits' biases at 0 instead of −log 99, so that the few steps'
    # random-weight model scores above the 0.03 threshold and the val and
    # served batches hold detections
    with torch.no_grad():
        for i in range(trainer.model.head.n_levels):
            getattr(trainer.model.head, f"cls_out{i}").bias.zero_()
    val_batches = -(-YOLOV6_VAL_IMAGES // YOLOV6_BATCH)
    with yolov6_branches() as seen:  # the main path of this phase
        run = det_run(trainer, trainer_mod, "YOLOv6-s", YOLOV6_EPOCHS,
                      ("cls_loss", "box_loss", "loss"), val_batches)
    want = {"epochs": list(range(YOLOV6_EPOCHS)) + [YOLOV6_EPOCHS - 1] * val_batches,
            "assigners": ["atss"] * 4 + ["tal"] * (YOLOV6_EPOCHS - 4 + val_batches)}
    if seen != want:
        raise AssertionError(f"YOLOv6 loss calls {seen}, not {want}")
    served = serve_checkpoint(workdir, setting, trainer, run["state"], YOLOV6_BATCH, "YOLOv6-s")
    times = run["times"]
    out = {"epochs": YOLOV6_EPOCHS, "steps": YOLOV6_EPOCHS, "launches": run["launches"],
           "loss_calls": seen, "losses": run["losses"], "val_mAP": run["val_mAP"],
           "run_s": run["run_s"], "train_epoch_s": times["train_epoch"],
           "val_epoch_s": times["val_epoch"][0], **served}
    print(f"YOLOv6-s (coco_yolov6_s) Trainer.run() across the ATSS → TAL switch: "
          f"{json.dumps(out)}", flush=True)
    torch.cuda.empty_cache()
    return out, trainer


def yolov6_timing(trainer) -> tuple[dict, dict, dict]:
    """YOLOv6-s's AMP train step at batch 32 on a host-augmented batch
    already on the card, with the TAL assignment (no epoch in the targets)
    and with ATSS (epoch 3), by CUDA events over 3 steps after 1, peak
    memory; the val and predict steps.  Returns the numbers, the AMP
    states and the batches."""
    import torch

    timed, states, batches = milestone_timing(trainer, YOLOV6_BATCH, None, iters=3,
                                              ema_decay=0.9999, amp_only=True)
    atss_batch = {**batches["train"], "target": {**batches["train"]["target"], "epoch": 3}}
    timed["atss_epoch_3"], states["atss"] = train_step_timing(
        trainer, atss_batch, YOLOV6_BATCH, iters=3, ema_decay=0.9999, amp_only=True)
    batches["atss"] = atss_batch
    torch.cuda.empty_cache()
    print(f"YOLOv6-s steps at bs{YOLOV6_BATCH}: {json.dumps(timed)}", flush=True)
    return timed, states, batches


def yolov6_card_vs_cpu(trainer, batches) -> dict:
    """YOLOv6-s at 640², B = 2, in both branches (epoch 3: ATSS, 4: TAL):
    eval-mode head outputs within 1e-4 of their largest value; the
    assignment of the CPU's inputs (ATSS: priors and targets; TAL: the
    CPU's train-mode predictions too) equal on the card; the eval-mode
    (val) losses in float32 and the train-mode losses in float64 within
    1e-4 relative (a term under 1e-3 of the total: of 1e-3 of the total).
    The float32 train-mode losses are reported beside them: BN on the
    batch's statistics in this deep random-weight network puts one
    device's own float32 losses up to 3e-4 off its float64 ones."""
    import copy

    import torch

    from cvpytorch_tpu_torch.models.assigners.atss_assigner import atss_assign, grid_cells
    from cvpytorch_tpu_torch.models.assigners.tal_assigner import tal_assign
    from cvpytorch_tpu_torch.models.yolov6 import decode_yolov6

    def forward(model, batch):
        x, t = batch["image"], batch["target"]
        out = {"target": t}
        with torch.no_grad():
            out["head"], out["priors"], level_priors = model.eval()._forward(x)
            out["level_priors"] = torch.tensor(level_priors)
            model64 = copy.deepcopy(model).double()
            t64 = {**t, "boxes": t["boxes"].double()}
            for epoch in (3, 4):
                out[f"val_epoch{epoch}"] = model.eval()(x, {**t, "epoch": epoch}, mode="val")[0]
                out[f"train_epoch{epoch}"] = model.train()(x, {**t, "epoch": epoch},
                                                           mode="train")[1]
                out[f"train_f64_epoch{epoch}"] = model64.train()(
                    x.double(), {**t64, "epoch": epoch}, mode="train")[1]
            out["train_preds"], _, _ = model._forward(x)
        return out

    def check(cpu, card):
        matched = {}
        for device in ("cpu", "cuda"):
            priors = cpu["priors"].to(device)
            t = {k: v.to(device) for k, v in cpu["target"].items()}
            preds = cpu["train_preds"].to(device)
            matched[f"atss_{device}"] = atss_assign(
                priors, tuple(cpu["level_priors"].tolist()), grid_cells(priors, 5), t["boxes"],
                t["valid"], topk=9, center_eps=1e-9, strict_thr=True,
                dedup_unmasked=True)["matched_gt"].cpu()
            matched[f"tal_{device}"] = tal_assign(
                torch.sigmoid(preds[..., 4:]), priors, decode_yolov6(preds, priors), t["boxes"],
                t["labels"], t["valid"])["matched_gt"].cpu()
        out = {"head_max_rel_err": max_rel_err(card["head"], cpu["head"])}
        for name in ("atss", "tal"):
            out[f"{name}_matched_gt_equal"] = bool(torch.equal(matched[f"{name}_cpu"],
                                                               matched[f"{name}_cuda"]))
            out[f"{name}_positives"] = int((matched[f"{name}_cpu"] >= 0).sum())
        gated = []
        for epoch in (3, 4):
            for key in (f"val_epoch{epoch}", f"train_f64_epoch{epoch}", f"train_epoch{epoch}"):
                out[f"{key}_loss_rel"] = _rel_losses(card[key], cpu[key])
                if not key.startswith("train_epoch"):
                    gated.append(max(out[f"{key}_loss_rel"].values()))
            out[f"train_epoch{epoch}_cpu_f32_vs_f64"] = _rel_losses(
                cpu[f"train_epoch{epoch}"], cpu[f"train_f64_epoch{epoch}"])
        print(f"YOLOv6-s card vs CPU, B=2, 640²: {json.dumps(out)}", flush=True)
        if not (out["head_max_rel_err"] <= 1e-4 and out["atss_matched_gt_equal"]
                and out["tal_matched_gt_equal"] and max(gated) <= 1e-4):
            raise AssertionError(f"YOLOv6-s card vs CPU: {out}")
        return out

    return card_vs_cpu(trainer, batches, forward, check)


def voc_det_config(workdir: Path, name: str, n: int) -> Path:
    """``conf/<name>.yml`` as written (``VOCDetection``), ``IMG_DIR``
    pointed at a VOCdevkit of ``n`` ids (``data/layouts.write_voc``: JPEG
    copies of the fixtures and a PNG, XML annotations with difficult
    flags and a name in no dictionary); TRAIN and VAL read every id, as
    written; one epoch."""
    from cvpytorch_tpu_torch.config import CommonConfiguration, load_dictionary
    from cvpytorch_tpu_torch.data import layouts

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / f"{name}.yml"))
    data = cfg.DATASET
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    names = [next(iter(d)) for d in load_dictionary(data.DICTIONARY, data.DICTIONARY_NAME)[1]]
    jpegs = [str(FIXTURES / f) for f in sorted(fixture_manifest())]
    root = layouts.write_voc(str(workdir / "data" / "VOCdevkit" / "VOC2012"), jpegs, names, n,
                             n // 2)["IMG_DIR"]
    for stage in ("TRAIN", "VAL"):
        data.get(stage).update({"IMG_DIR": root})
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / f"{name}_voc_layout.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def one_step_run(workdir: Path, name: str, coco: dict) -> dict:
    """``conf/<name>.yml`` as written on its dataset (the COCO directory's
    JPEG files; for ``voc_nanodet`` a VOCdevkit through the
    ``voc_detection`` evaluator; for ``widerface_faceboxes`` and
    ``pennfudan_retinanet`` directories in their layouts, ``layout_det_config``;
    YOLOX's class biases at 0): one train step at the config's batch and
    one val batch (on the COCO directory of at most ``ONE_STEP_VAL``
    images) through ``Trainer.run()`` (``nms_keep`` once), finite
    losses and metric, ``nms_keep`` bit-exact against ``nms_keep_plain``
    on the val input the path gave it, and timed by CUDA events.  The
    steps are not timed."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    workdir.mkdir(parents=True)
    n = {**ONE_STEP_CONFIGS, **OTA_FCOS_ONE_STEP, **SLICE14_ONE_STEP}[name]
    n_val = n
    if name.startswith("voc"):
        setting = voc_det_config(workdir, name, n)
    elif name in ("widerface_faceboxes", "pennfudan_retinanet"):
        setting = layout_det_config(workdir, name, n)
    else:
        n_val = min(n, ONE_STEP_VAL)
        setting = coco_det_config(workdir, name, coco, n, n_val, n)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    kind = type(trainer.model).__name__
    sizes = {stage: len(trainer.datasets[stage]) for stage in ("train", "val")}
    if sizes != {"train": n, "val": n_val} \
            or (kind == "NanoDetPlus") != (name in ONE_STEP_CONFIGS) \
            or kind == "NanoDetPlus" and not trainer.model.v1:
        raise AssertionError(f"{name}: {sizes}, {kind}")
    zero_class_biases(trainer.model)
    seen, restore = capture_nms_inputs()
    try:
        run = det_run(trainer, trainer_mod, name, 1, LOSS_NAMES[kind], 1)
    finally:
        restore()
    (boxes, thr), = seen
    before = nms_keep.launches
    if not torch.equal(nms_keep(boxes, thr), nms_keep_plain(boxes, thr)):
        raise AssertionError(f"{name}: nms_keep != nms_keep_plain on its val input")
    model = trainer.model
    out = {"dataset": type(trainer.datasets["train"]).__name__, "batch": n, "model": kind,
           "backbone": type(getattr(model, "backbone", None)).__name__,
           "neck": type(getattr(model, "neck", getattr(model, "fpn", None))).__name__,
           "launches": run["launches"], "losses": run["losses"], "val_mAP": run["val_mAP"],
           "val_nms_input": {"shape": list(boxes.shape), "bit_exact": True,
                             "ms": nms_event_ms(boxes, thr),
                             "bound_ms": nms_bound_ms(*boxes.shape[:2])[0]},
           "run_s": run["run_s"]}
    nms_keep.launches = before  # comparison and timing launches do not count
    print(f"{name}: one step and one val batch on the card: {json.dumps(out)}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


# -- slice 13: YOLOX, PAI-YOLOX, YOLOv7, FCOS, LFD, RetinaNet -------------------------
YOLOX_BATCH = 32  # TRAIN and VAL BATCH_SIZE of conf/coco_yolox_s.yml
YOLOX_EPOCHS = 1
YOLOX_STEPS = 2  # an epoch: 64 of the COCO directory's train images
YOLOX_VAL_IMAGES = 32  # one val batch after the epoch
YOLOV7_BATCH = 16  # TRAIN and VAL BATCH_SIZE of conf/coco_yolov7.yml
YOLOV7_STEPS = 2
FCOS_BATCH = 16  # TRAIN and VAL BATCH_SIZE of conf/coco_fcos.yml
FCOS_STEPS = 2
# the slice's other configs, one train step and one val batch each at their
# batch: COCO ones on the COCO directory, widerface_faceboxes and
# pennfudan_retinanet on directories in their datasets' layouts
OTA_FCOS_ONE_STEP = {"coco_yolox_n": 32, "coco_pai_yolox": 32, "coco_pai_yolox_s": 32,
                     "coco_yolov7x": 12, "coco_lfd": 32, "widerface_faceboxes": 32,
                     "pennfudan_retinanet": 4}
LOSS_NAMES = {"NanoDetPlus": ("qfl_loss", "bbox_loss", "dfl_loss", "loss"),
              "YOLOX": ("obj_loss", "cls_loss", "iou_loss", "loss"),
              "YOLOv7": ("box_loss", "obj_loss", "cls_loss", "loss"),
              "FCOS": ("cls_loss", "cnt_loss", "reg_loss", "loss"),
              "LFD": ("cls_loss", "cnt_loss", "reg_loss", "loss"),
              "RetinaNet": ("cls_loss", "reg_loss", "loss"),
              "EfficientDet": ("cls_loss", "box_loss", "loss"),
              "AIRDet": ("qfl_loss", "bbox_loss", "dfl_loss", "loss"),
              "GiraffeDet": ("qfl_loss", "bbox_loss", "dfl_loss", "loss"),
              "ObjectBox": ("box_loss", "obj_loss", "cls_loss", "loss"),
              "YOLOP": ("box_loss", "obj_loss", "cls_loss", "loss"),
              "FastestDet": ("box_loss", "obj_loss", "cls_loss", "loss")}


def zero_class_biases(model) -> None:
    """The class and objectness biases at 0 instead of their priors
    (YOLOX's and GFLv2's −log 99; the YOLOv5 detect layer's of YOLOv5,
    ObjectBox and YOLOP), so that a few steps' random-weight model scores above the
    threshold and the val and served batches hold detections (as the
    YOLOv6 phase).  Other models are left as built."""
    import torch

    kind = type(model).__name__
    with torch.no_grad():
        if kind == "YOLOX":
            for i in range(model.head.n_levels):
                for name in ("cls_out", "obj_out"):
                    getattr(model.head, f"{name}{i}").bias.zero_()
        elif kind in ("AIRDet", "GiraffeDet"):
            for i in range(model.head.n_levels):
                getattr(model.head, f"gfl_cls{i}").bias.zero_()
        elif kind in ("ObjectBox", "YOLOP", "YOLOv5"):
            for i in range(model.detect.n_levels):
                getattr(model.detect, f"m{i}").bias.view(model.detect.num_anchors, -1)[
                    :, 4:].zero_()


def layout_det_config(workdir: Path, name: str, n: int) -> Path:
    """``conf/<name>.yml`` as written on a directory in its dataset's layout
    (``data/layouts.py``): WIDER FACE (JPEG copies of the fixtures and the
    ``wider_face_train_bbx_gt.txt`` list, a train and a val directory) or
    PennFudanPed (PNG images and palette instance masks; TRAIN and VAL read
    one folder, as written); only ``IMG_DIR``/``ANN_FILE`` changed, ``n``
    images a stage, one epoch."""
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.data import layouts

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / f"{name}.yml"))
    data = cfg.DATASET
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    root = workdir / "data"
    if name == "widerface_faceboxes":
        jpegs = [str(FIXTURES / f) for f in sorted(fixture_manifest())]
        for stage, seed in (("TRAIN", 1), ("VAL", 2)):
            data.get(stage).update(layouts.write_widerface(
                str(root / f"WIDER_{stage.lower()}"), jpegs, n, seed=seed))
    else:
        img_dir = layouts.write_pennfudan(str(root / "PennFudanPed"), n)
        for stage in ("TRAIN", "VAL"):
            data.get(stage).update({"IMG_DIR": img_dir})
    cfg.EVALUATOR.EVAL_INTERVALS = 1
    cfg.update({"N_MAX_EPOCHS": 1, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / f"{name}_layout.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def det_phase(workdir: Path, name: str, coco: dict, batch: int, steps: int, epochs: int,
              n_val: int, serve: bool) -> tuple[dict, object]:
    """``conf/<name>.yml`` as written on the COCO directory's JPEG files
    (``coco_det_config``): ``Trainer.run()`` for ``epochs`` epochs of
    ``steps`` steps, validated on ``n_val`` images after the last
    (``nms_keep`` once a val batch), and with ``serve`` one served batch
    through ``infer.main`` (once more)."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration

    workdir.mkdir(parents=True)
    setting = coco_det_config(workdir, name, coco, batch * steps, n_val, batch, epochs=epochs)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    kind = type(trainer.model).__name__
    zero_class_biases(trainer.model)
    run = det_run(trainer, trainer_mod, name, steps * epochs, LOSS_NAMES[kind],
                  -(-n_val // batch))  # the main path of this phase
    served = (serve_checkpoint(workdir, setting, trainer, run["state"], batch, name)
              if serve else {})
    times = run["times"]
    out = {"model": kind, "epochs": epochs, "steps": steps * epochs, "batch": batch,
           "launches": run["launches"], "losses": run["losses"], "val_mAP": run["val_mAP"],
           "run_s": run["run_s"], "train_epoch_s": times["train_epoch"],
           "fed_images_per_s": batch * steps / times["train_epoch"][-1],
           "val_epoch_s": times["val_epoch"][0],
           "val_evaluator_share": times["evaluator"] / times["val_epoch"][0], **served}
    print(f"{name} Trainer.run() on the COCO JPEG files: {json.dumps(out)}", flush=True)
    torch.cuda.empty_cache()
    return out, trainer


def assigner_range_profile(state, batch, amp_ms: float, span: str) -> dict:
    """One profiled AMP step (EMA on, as the recipe): the busy and idle
    share and the ``span`` range's share of the busy time."""
    import torch

    from cvpytorch_tpu_torch.train_state import make_train_step

    torch.cuda.empty_cache()
    step = make_train_step(amp=True, ema_decay=0.9999)
    prof = profile_device(lambda: step(state, batch), top=15)
    prof["device_idle_share_unprofiled"] = 1 - prof["device_busy_ms"] / amp_ms
    ms = prof["annotated_ms"].get(span)
    prof[f"{span}_share_of_busy"] = None if ms is None else ms / prof["device_busy_ms"]
    return prof


def _rel_losses(card, cpu) -> dict:
    """Each loss term's relative difference (a term under 1e-3 of the
    total: relative to 1e-3 of the total)."""
    total = abs(float(cpu["loss"]))
    return {k: abs(float(card[k]) - float(v)) / max(abs(float(v)), 1e-3 * total)
            for k, v in cpu.items()}


def yolox_card_vs_cpu(trainer, batches) -> dict:
    """YOLOX-s at 640², B = 2: eval-mode head outputs within 1e-4 of their
    largest value (f32); on shared inputs, float64 on both devices, SimOTA
    on the CPU's train-mode predictions (``matched_gt`` equal) and the loss
    on the CPU's eval-mode predictions (val losses within 1e-4 relative);
    the train-mode losses of the whole model in float64 within 1e-4.  In
    float32 the assignment is reported, not gated: 1e8 added to a cost
    rounds it to a multiple of 8, and a 1-ulp difference between the
    devices' class-cost sums moves a cost across a rounding boundary, and
    so the stable rank (the float32 losses of each device's own
    predictions are not taken: the run's time limit)."""
    import copy

    import torch

    from cvpytorch_tpu_torch.models.assigners.ota_assigner import simota_assign
    from cvpytorch_tpu_torch.models.yolox import decode_yolox, yolox_loss

    def forward(model, batch):
        x, t = batch["image"], batch["target"]
        out = {"target": t}
        with torch.no_grad():
            out["head"], out["priors"] = model.eval()._forward(x)
            out["train_preds"], _ = model.train()._forward(x)
            out["train_f64"] = copy.deepcopy(model).double().train()(
                x.double(), {**t, "boxes": t["boxes"].double()}, mode="train")[1]
        return out

    def check(cpu, card):
        num_classes = trainer.model.num_classes
        matched, val64 = {}, {}
        for device in ("cpu", "cuda"):
            t = {k: v.to(device) for k, v in cpu["target"].items()}
            for dtype in (torch.float32, torch.float64):
                p = cpu["train_preds"].to(device, dtype)
                priors = cpu["priors"].to(device, dtype)
                matched[device, dtype] = simota_assign(
                    torch.sigmoid(p[..., 5:]), torch.sigmoid(p[..., 4]), priors,
                    decode_yolox(p, priors), t["boxes"].to(dtype), t["labels"],
                    t["valid"])["matched_gt"].cpu()
            total, parts = yolox_loss(cpu["head"].to(device, torch.float64),
                                      cpu["priors"].to(device, torch.float64),
                                      {**t, "boxes": t["boxes"].double()}, num_classes)
            val64[device] = {**parts, "loss": total}
        f64, f32 = torch.float64, torch.float32
        out = {"head_max_rel_err": max_rel_err(card["head"], cpu["head"]),
               "simota_f64_matched_gt_equal": bool(torch.equal(matched["cpu", f64],
                                                               matched["cuda", f64])),
               "simota_f32_matched_gt_differing": int((matched["cpu", f32]
                                                       != matched["cuda", f32]).sum()),
               "simota_positives": int((matched["cpu", f64] >= 0).sum()),
               "val_f64_shared_loss_rel": _rel_losses(val64["cuda"], val64["cpu"]),
               "train_f64_loss_rel": _rel_losses(card["train_f64"], cpu["train_f64"])}
        print(f"YOLOX-s card vs CPU, B=2, 640²: {json.dumps(out)}", flush=True)
        if not (out["head_max_rel_err"] <= 1e-4 and out["simota_f64_matched_gt_equal"]
                and max(out["val_f64_shared_loss_rel"].values()) <= 1e-4
                and max(out["train_f64_loss_rel"].values()) <= 1e-4):
            raise AssertionError(f"YOLOX-s card vs CPU: {out}")
        return out

    return card_vs_cpu(trainer, batches, forward, check)


def yolov7_card_vs_cpu(trainer, batches) -> dict:
    """YOLOv7-l at 640², B = 2: eval-mode raw maps within 1e-4 of their
    largest value (f32); on shared inputs, float64 on both devices, the
    OTA stage of the loss (its selection and matched gts) on the CPU's
    train-mode raw maps equal, and the loss on the CPU's eval-mode raw
    maps (val losses within 1e-4 relative); the float32 matches reported
    (the 1e8 cost terms, as YOLOX's; the float32 losses of each device's
    own maps are not taken: the run's time limit)."""
    import torch

    def forward(model, batch):
        x, t = batch["image"], batch["target"]
        with torch.no_grad():
            raw = model.eval()._raw(x)
            train_raw = model.train()._raw(x)
        return {"target": t, "image": x,
                **{f"raw{i}": r for i, r in enumerate(raw)},
                **{f"train_raw{i}": r for i, r in enumerate(train_raw)}}

    def check(cpu, card):
        model, img_size = trainer.model, float(cpu["image"].shape[1])
        matched, val64 = {}, {}
        for device in ("cpu", "cuda"):
            t = model._normalized_targets(cpu["image"].to(device),
                                          {k: v.to(device) for k, v in cpu["target"].items()})
            for dtype in (torch.float32, torch.float64):
                td = {**t, "boxes": t["boxes"].to(dtype)}
                raw = [cpu[f"train_raw{i}"].to(device, dtype) for i in range(3)]
                sel, mg = model.loss.ota_match(model.loss.candidates(raw, td), td, img_size)
                matched[device, dtype] = torch.where(sel, mg, -1).cpu()
            t64 = {**t, "boxes": t["boxes"].double()}
            val64[device] = model.loss([cpu[f"raw{i}"].to(device, torch.float64)
                                        for i in range(3)], t64, img_size)
        f64, f32 = torch.float64, torch.float32
        raw_card = torch.cat([card[f"raw{i}"].flatten(1) for i in range(3)], 1)
        raw_cpu = torch.cat([cpu[f"raw{i}"].flatten(1) for i in range(3)], 1)
        shared = {device: {**parts, "loss": total} for device, (total, parts) in val64.items()}
        out = {"raw_max_rel_err": max_rel_err(raw_card, raw_cpu),
               "ota_f64_matches_equal": bool(torch.equal(matched["cpu", f64],
                                                         matched["cuda", f64])),
               "ota_f32_matches_differing": int((matched["cpu", f32]
                                                 != matched["cuda", f32]).sum()),
               "ota_selected": int((matched["cpu", f64] >= 0).sum()),
               "val_f64_shared_loss_rel": _rel_losses(shared["cuda"], shared["cpu"])}
        print(f"YOLOv7-l card vs CPU, B=2, 640²: {json.dumps(out)}", flush=True)
        if not (out["raw_max_rel_err"] <= 1e-4 and out["ota_f64_matches_equal"]
                and max(out["val_f64_shared_loss_rel"].values()) <= 1e-4):
            raise AssertionError(f"YOLOv7-l card vs CPU: {out}")
        return out

    return card_vs_cpu(trainer, batches, forward, check)


def slice13_phases(workdir: Path, coco: dict, card: str) -> tuple[dict, dict]:
    """YOLOX-s (one epoch of 2 steps at bs32, 64 val, one served batch, AMP
    and f32 steps, card vs CPU), YOLOv7-l (2 steps at bs16, one val and one
    served batch, the AMP step, card vs CPU) and FCOS-R50 800² (2 steps at
    bs16, one val batch, the AMP step), each ``nms_keep`` bit-exact on its
    val input; then the other configs of the slice, one step and one val
    batch each.  Returns every record, and the states and batches the
    profiles take at the end of the run."""
    import torch

    out, later = {}, {}
    for key, name, batch, steps, epochs, n_val, serve in (
            ("yolox_s", "coco_yolox_s", YOLOX_BATCH, YOLOX_STEPS, YOLOX_EPOCHS,
             YOLOX_VAL_IMAGES, True),
            ("yolov7_l", "coco_yolov7", YOLOV7_BATCH, YOLOV7_STEPS, 1, YOLOV7_BATCH, True),
            ("fcos_r50", "coco_fcos", FCOS_BATCH, FCOS_STEPS, 1, FCOS_BATCH, False)):
        torch.cuda.empty_cache()
        run, trainer = det_phase(workdir / key, name, coco, batch, steps, epochs, n_val, serve)
        print(json.dumps({key: run, "card": card}), flush=True)
        timed, states, batches = milestone_timing(trainer, batch, None, iters=3,
                                                  ema_decay=0.9999, amp_only=True)
        print(json.dumps({f"{key}_timing": timed, "card": card}), flush=True)
        nms, nms_input = val_nms_input(states["train"], batches["val"], key)
        if key == "yolox_s":
            check = yolox_card_vs_cpu(trainer, batches)
        elif key == "yolov7_l":
            check = yolov7_card_vs_cpu(trainer, batches)
        else:
            check = None
        if check is not None:
            print(json.dumps({f"{key}_card_vs_cpu": check, "card": card}), flush=True)
        out[key] = {"run": run, "timing": timed, "nms": nms, "card_vs_cpu": check}
        later[key] = {"state": states["train"], "batch": batches["train"],
                      "amp_ms": timed["amp_step_ms"], "nms_input": nms_input}
        del trainer
        mark(key)
    out["one_step"] = {}
    for name in OTA_FCOS_ONE_STEP:
        torch.cuda.empty_cache()
        out["one_step"][name] = one_step_run(workdir / name, name, coco)
        mark(name)
    return out, later


# -- slice 14: EfficientDet, AIRDet, GiraffeDet, ObjectBox, YOLOP, FastestDet, NAS-FPN, RFP --
EFFDET_BATCH = 32  # TRAIN and VAL BATCH_SIZE of conf/coco_efficientdet.yml (512²)
EFFDET_EPOCHS = 1
EFFDET_STEPS = 2  # an epoch: 64 of the COCO directory's train images
EFFDET_VAL_IMAGES = 32  # one val batch after the epoch
AIRDET_BATCH = 32  # TRAIN and VAL BATCH_SIZE of conf/coco_airdet.yml (640²)
AIRDET_STEPS = 2
# the slice's other configs, one train step and one val batch each at their
# batch on the COCO directory (FastestDet's NMS input is (64, 484): 22² cells
# at 352²)
SLICE14_ONE_STEP = {"coco_giraffedet": 24, "coco_objectbox": 32, "coco_yolop": 24,
                    "coco_fastestdet": 64}
NECK_CHECK_HW = 256  # NAS-FPN's and RFP's card-vs-CPU input (ResNet-18 inside RFP)


def effdet_card_vs_cpu(trainer, batches) -> dict:
    """EfficientDet-D0 at 512², B = 2: eval-mode class probabilities and
    regressions within 1e-4 of their largest value (f32); on shared
    inputs, float64 on both devices, the loss's targets (positive,
    negative and ignored anchors, each anchor's best gt) equal and the
    loss on the CPU's eval-mode outputs within 1e-4 relative; the
    train-mode losses of the whole model in float64 within 1e-4
    (stochastic depth off).  The float32 losses of each device's own
    outputs are not taken (the run's time limit)."""
    import copy

    import torch

    from cvpytorch_tpu_torch.models.efficientdet import effdet_targets, efficientdet_loss

    def forward(model, batch):
        x, t = batch["image"], batch["target"]
        t64 = {**t, "boxes": t["boxes"].double()}
        with torch.no_grad():
            cls, reg, anchors = model.eval()._forward(x)
            train_f64 = copy.deepcopy(model).double().train()(x.double(), t64, mode="train")[1]
        return {"target": t, "cls": cls, "reg": reg, "anchors": anchors,
                "train_f64": train_f64}

    def check(cpu, card):
        f64 = torch.float64
        assigned, val64 = {}, {}
        for device in ("cpu", "cuda"):
            t = {k: v.to(device) for k, v in cpu["target"].items()}
            t64 = {**t, "boxes": t["boxes"].double()}
            anchors = cpu["anchors"].to(device)
            iou, arg = effdet_targets(anchors, t64["boxes"], t64["valid"])
            assigned[device] = {"positive": iou >= 0.5, "negative": iou < 0.4,
                                "ignored": (iou >= 0.4) & (iou < 0.5), "best_gt": arg}
            assigned[device] = {k: v.cpu() for k, v in assigned[device].items()}
            cls_l, box_l = efficientdet_loss(cpu["cls"].to(device, f64),
                                             cpu["reg"].to(device, f64), anchors, t64)
            val64[device] = {"cls_loss": cls_l, "box_loss": box_l, "loss": cls_l + box_l}
        out = {"head_cls_max_rel_err": max_rel_err(card["cls"], cpu["cls"]),
               "head_reg_max_rel_err": max_rel_err(card["reg"], cpu["reg"]),
               "targets_f64_equal": {k: bool(torch.equal(v, assigned["cuda"][k]))
                                     for k, v in assigned["cpu"].items()},
               "positive_anchors": int(assigned["cpu"]["positive"].sum()),
               "ignored_anchors": int(assigned["cpu"]["ignored"].sum()),
               "val_f64_shared_loss_rel": _rel_losses(val64["cuda"], val64["cpu"]),
               "train_f64_loss_rel": _rel_losses(card["train_f64"], cpu["train_f64"])}
        print(f"EfficientDet-D0 card vs CPU, B=2, 512²: {json.dumps(out)}", flush=True)
        if not (out["head_cls_max_rel_err"] <= 1e-4 and out["head_reg_max_rel_err"] <= 1e-4
                and all(out["targets_f64_equal"].values()) and out["positive_anchors"] > 0
                and max(out["val_f64_shared_loss_rel"].values()) <= 1e-4
                and max(out["train_f64_loss_rel"].values()) <= 1e-4):
            raise AssertionError(f"EfficientDet-D0 card vs CPU: {out}")
        return out

    return card_vs_cpu(trainer, batches, forward, check)


def airdet_card_vs_cpu(trainer, batches) -> dict:
    """AIRDet-s at 640², B = 2: eval-mode class probabilities and
    regression logits within 1e-4 of their largest value (f32); on shared
    inputs, float64 on both devices, SimOTA (soft-label costs) on the
    CPU's train-mode outputs (``matched_gt`` equal) and the loss on the
    CPU's eval-mode outputs (within 1e-4 relative); the train-mode losses
    of the whole model in float64 within 1e-4.  The float32 assignment is
    reported (the 1e8 cost terms, as YOLOX's; the float32 losses are not
    taken: the run's time limit)."""
    import copy

    import torch

    from cvpytorch_tpu_torch.models.assigners.ota_assigner import simota_assign
    from cvpytorch_tpu_torch.models.heads.gflv2_head import gflv2_decode, gflv2_loss

    def forward(model, batch):
        x, t = batch["image"], batch["target"]
        t64 = {**t, "boxes": t["boxes"].double()}
        with torch.no_grad():
            cls, reg, priors = model.eval()._outs(x)
            train_cls, train_reg, _ = model.train()._outs(x)
            train_f64 = copy.deepcopy(model).double().train()(x.double(), t64, mode="train")[1]
        return {"target": t, "cls": cls, "reg": reg, "priors": priors,
                "train_cls": train_cls, "train_reg": train_reg, "train_f64": train_f64}

    def check(cpu, card):
        model = trainer.model
        matched, val64 = {}, {}
        for device in ("cpu", "cuda"):
            t = {k: v.to(device) for k, v in cpu["target"].items()}
            for dtype in (torch.float32, torch.float64):
                c, r = cpu["train_cls"].to(device, dtype), cpu["train_reg"].to(device, dtype)
                priors = cpu["priors"].to(device, dtype)
                matched[device, dtype] = simota_assign(
                    c, torch.ones_like(c[..., 0]), priors, gflv2_decode(c, r, priors),
                    t["boxes"].to(dtype), t["labels"], t["valid"], topk=10, center_radius=2.5,
                    soft_label=True)["matched_gt"].cpu()
            f64 = torch.float64
            total, parts = gflv2_loss(cpu["cls"].to(device, f64), cpu["reg"].to(device, f64),
                                      cpu["priors"].to(device, f64),
                                      {**t, "boxes": t["boxes"].double()}, model.num_classes,
                                      model.reg_max)
            val64[device] = {**parts, "loss": total}
        f64, f32 = torch.float64, torch.float32
        out = {"head_cls_max_rel_err": max_rel_err(card["cls"], cpu["cls"]),
               "head_reg_max_rel_err": max_rel_err(card["reg"], cpu["reg"]),
               "simota_f64_matched_gt_equal": bool(torch.equal(matched["cpu", f64],
                                                               matched["cuda", f64])),
               "simota_f32_matched_gt_differing": int((matched["cpu", f32]
                                                       != matched["cuda", f32]).sum()),
               "simota_positives": int((matched["cpu", f64] >= 0).sum()),
               "val_f64_shared_loss_rel": _rel_losses(val64["cuda"], val64["cpu"]),
               "train_f64_loss_rel": _rel_losses(card["train_f64"], cpu["train_f64"])}
        print(f"AIRDet-s card vs CPU, B=2, 640²: {json.dumps(out)}", flush=True)
        if not (out["head_cls_max_rel_err"] <= 1e-4 and out["head_reg_max_rel_err"] <= 1e-4
                and out["simota_f64_matched_gt_equal"] and out["simota_positives"] > 0
                and max(out["val_f64_shared_loss_rel"].values()) <= 1e-4
                and max(out["train_f64_loss_rel"].values()) <= 1e-4):
            raise AssertionError(f"AIRDet-s card vs CPU: {out}")
        return out

    return card_vs_cpu(trainer, batches, forward, check)


def necks_card_vs_cpu() -> dict:
    """NAS-FPN (3 stacks, 64 channels) on seeded C3–C5 and RFP (2 steps,
    ResNet-18 inside, 64 channels) on a seeded 256² image and a first
    ResNet-18's C3–C5 of it, B = 2, TF32 off, train mode: one forward and
    the backward of Σ outputs · w (w seeded) on the card and on the CPU
    from the same seeded weights.  Gates: the f32 outputs within 1e-4 of
    their largest value; in float64 the outputs and every parameter's
    gradient within 1e-6 of max(its largest value, 1e-3 of the largest
    gradient of the model).  The f32 gradients are reported: a BN
    parameter whose gradient cancels to ~1e-5 of the others' sits at f32
    rounding (1.4e-2 and 5.7e-2 of such leaves' own scale on an H100)."""
    import copy

    import torch

    from cvpytorch_tpu_torch.models.backbones.resnet import ResNet
    from cvpytorch_tpu_torch.models.necks.nas_fpn import NASFPN
    from cvpytorch_tpu_torch.models.necks.rfp import RFP

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the step makers turn it off")
    g = torch.Generator().manual_seed(0)
    hw = NECK_CHECK_HW
    r18 = {"name": "ResNet", "subtype": "resnet18"}
    torch.manual_seed(0)
    img = torch.rand(2, 3, hw, hw, generator=g)
    with torch.no_grad():
        cs = ResNet("resnet18").eval()(img)
    cases = {"nas_fpn": (NASFPN((128, 256, 512), 64, stack_times=3), tuple(cs)),
             "rfp": (RFP((128, 256, 512), 2, r18, 16, out_channels=64), (img, *cs))}

    def leaf_err(card, cpu):
        scale = 1e-3 * max(float(v.abs().max()) for v in cpu.values())
        return max(float((card[n] - v).abs().max()) / max(float(v.abs().max()), scale, 1e-30)
                   for n, v in cpu.items())

    out = {}
    for name, (base, feats) in cases.items():
        with torch.no_grad():  # every gate and hook away from its zero init
            for p in base.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
        out[name] = {"params": sum(1 for _ in base.parameters())}
        for dtype in (torch.float32, torch.float64):
            seen = {}
            for device in ("cpu", "cuda"):
                model = copy.deepcopy(base).to(device, dtype).train()
                outs = model(tuple(f.to(device, dtype) for f in feats))
                ws = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i)).to(
                    device, dtype) for i, o in enumerate(outs)]
                sum((o * w).sum() for o, w in zip(outs, ws)).backward()
                seen[device] = ([o.detach().cpu() for o in outs],
                                {n: p.grad.cpu() for n, p in model.named_parameters()})
            (o_cpu, g_cpu), (o_card, g_card) = seen["cpu"], seen["cuda"]
            tag = "f32" if dtype == torch.float32 else "f64"
            out[name]["levels"] = [list(o.shape[-2:]) for o in o_cpu]
            out[name][f"{tag}_outputs_max_rel_err"] = max(max_rel_err(a, b)
                                                          for a, b in zip(o_card, o_cpu))
            out[name][f"{tag}_grad_leaf_max_err"] = leaf_err(g_card, g_cpu)
    print(f"NAS-FPN and RFP card vs CPU, train mode, B=2: {json.dumps(out)}", flush=True)
    if not all(v["f32_outputs_max_rel_err"] <= 1e-4 and v["f64_outputs_max_rel_err"] <= 1e-6
               and v["f64_grad_leaf_max_err"] <= 1e-6 for v in out.values()):
        raise AssertionError(f"NAS-FPN / RFP card vs CPU: {out}")
    return out


def slice14_phases(workdir: Path, coco: dict, card: str) -> tuple[dict, dict]:
    """EfficientDet-D0 (one epoch of 2 steps at bs32 on 512², 64 val, one
    served batch, the AMP step, card vs CPU) and AIRDet-s (2 steps at
    bs32 on 640², one val and one served batch, the AMP step, card vs
    CPU), each ``nms_keep`` bit-exact on its (32, 1024) val input; then
    one step and one val batch each of ``coco_giraffedet``,
    ``coco_objectbox``, ``coco_yolop`` and ``coco_fastestdet`` (its NMS
    input (64, 484)); then NAS-FPN and RFP card vs CPU.  Returns every
    record, and the states and batches the profiles take at the end of
    the run."""
    import torch

    out, later = {}, {}
    for key, name, batch, steps, epochs, n_val, check in (
            ("efficientdet_d0", "coco_efficientdet", EFFDET_BATCH, EFFDET_STEPS, EFFDET_EPOCHS,
             EFFDET_VAL_IMAGES, effdet_card_vs_cpu),
            ("airdet_s", "coco_airdet", AIRDET_BATCH, AIRDET_STEPS, 1, AIRDET_BATCH,
             airdet_card_vs_cpu)):
        torch.cuda.empty_cache()
        run, trainer = det_phase(workdir / key, name, coco, batch, steps, epochs, n_val, True)
        print(json.dumps({key: run, "card": card}), flush=True)
        timed, states, batches = milestone_timing(trainer, batch, None, iters=3,
                                                  ema_decay=0.9999, amp_only=True)
        print(json.dumps({f"{key}_timing": timed, "card": card}), flush=True)
        nms, nms_input = val_nms_input(states["train"], batches["val"], key)
        result = check(trainer, batches)
        print(json.dumps({f"{key}_card_vs_cpu": result, "card": card}), flush=True)
        out[key] = {"run": run, "timing": timed, "nms": nms, "card_vs_cpu": result}
        later[key] = {"state": states["train"], "batch": batches["train"],
                      "amp_ms": timed["amp_step_ms"], "nms_input": nms_input}
        del trainer
        mark(key)
    out["one_step"] = {}
    for name in SLICE14_ONE_STEP:
        torch.cuda.empty_cache()
        out["one_step"][name] = one_step_run(workdir / name, name, coco)
        mark(name)
    torch.cuda.empty_cache()
    out["necks"] = necks_card_vs_cpu()
    print(json.dumps({"nas_fpn_rfp_card_vs_cpu": out["necks"], "card": card}), flush=True)
    mark("nas_fpn, rfp")
    return out, later


# -- slice 15: the keypoint task (OpenPose, LitePose, SimplePose) and the optimizer rules --------
KEYPOINT_BATCH = 32  # TRAIN and VAL BATCH_SIZE of conf/coco_openpose.yml and coco_litepose.yml
OPENPOSE_EPOCHS = 2
OPENPOSE_STEPS = 2  # an epoch: 64 of the keypoint directory's train images
KEYPOINT_TRAIN_IMAGES = KEYPOINT_BATCH * OPENPOSE_STEPS
KEYPOINT_VAL_IMAGES = 64  # one val epoch of 2 batches, after epoch 2
SIMPLEPOSE_CHECK_HW = 256  # SimplePose's card-vs-CPU input (ResNet-18)
LITEPOSE_HW = 384  # 368 (the config's) rounded up to a multiple of 32, which LitePose needs
# a COCO skeleton, 17 joints around its centre, at a height of 162 units
SKELETON = np.array([
    [0, -60], [-6, -66], [6, -66], [-14, -62], [14, -62], [-22, -40], [22, -40],
    [-32, -10], [32, -10], [-36, 18], [36, 18], [-14, 20], [14, 20], [-16, 60],
    [16, 60], [-18, 96], [18, 96]], np.float64)


def write_keypoint_dir(root: Path) -> dict:
    """A COCO ``person_keypoints`` directory of copies of the committed
    JPEG fixtures (COCO's names): 1–6 seeded skeletons an image (17
    keypoints, each labelled visible, occluded or not at all, COCO's
    (0, 0, 0) for the last), their boxes over the labelled joints and
    annotation areas.  → {split: (IMG_DIR, ANN_FILE)} for train
    (``KEYPOINT_TRAIN_IMAGES``) and val (``KEYPOINT_VAL_IMAGES``), and
    infer (the first ``KEYPOINT_BATCH`` val images)."""
    import shutil

    manifest = fixture_manifest()
    names = sorted(manifest)
    rng = np.random.RandomState(15)
    out = {}
    for split, n in (("train", KEYPOINT_TRAIN_IMAGES), ("val", KEYPOINT_VAL_IMAGES)):
        img_dir = root / split
        img_dir.mkdir(parents=True)
        images, anns = [], []
        for i in range(n):
            src = names[(i + 3) % len(names)]
            h, w = manifest[src]["cv2_imread_shape"][:2]
            fname = f"{i + 1:012d}.jpg"
            shutil.copyfile(FIXTURES / src, img_dir / fname)
            images.append({"id": i + 1, "file_name": fname, "height": h, "width": w})
            for _ in range(rng.randint(1, 7)):
                scale = rng.uniform(0.2, 0.8) * h / 162
                k = np.zeros((17, 3))
                k[:, :2] = SKELETON * scale + [rng.uniform(0.15, 0.85) * w,
                                              rng.uniform(0.3, 0.6) * h]
                k[:, :2] += rng.uniform(-3, 3, (17, 2)) * scale
                k[:, 2] = rng.choice([0, 1, 2], 17, p=[0.1, 0.2, 0.7])
                k[k[:, 2] == 0] = 0
                lab = k[k[:, 2] > 0, :2]
                if not len(lab):
                    continue
                (x1, y1), (x2, y2) = lab.min(0) - 4, lab.max(0) + 4
                anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                             "bbox": [round(x1, 2), round(y1, 2), round(x2 - x1, 2),
                                      round(y2 - y1, 2)],
                             "area": round(0.55 * (x2 - x1) * (y2 - y1), 2), "iscrowd": 0,
                             "num_keypoints": int((k[:, 2] > 0).sum()),
                             "keypoints": k.reshape(-1).round(2).tolist()})
        for stage, count in ((split, n),) + ((("infer", KEYPOINT_BATCH),) if split == "val"
                                             else ()):
            keep = {im["id"] for im in images[:count]}
            ann_file = root / f"person_keypoints_{stage}.json"
            ann_file.write_text(json.dumps({
                "images": images[:count], "categories": [{"id": 1, "name": "person"}],
                "annotations": [a for a in anns if a["image_id"] in keep]}))
            out[stage] = (str(img_dir), str(ann_file))
    return out


def keypoint_config(workdir: Path, name: str, kdir: dict, epochs: int,
                    size: int | None = None) -> Path:
    """``conf/<name>.yml`` as written (its ``CocoKeypoint``, transforms,
    model, recipe and batch), only ``IMG_DIR``/``ANN_FILE`` pointed at the
    keypoint directory and ``EVALUATOR.NAME`` swapped to ``coco_keypoints``
    (bbox and OKS keypoints: the configs' ``keypoint`` evaluator takes
    neither model's val output, in JAX either); ``epochs`` epochs,
    validated after the last; the INFER stage serves afterwards.  ``size``
    replaces the transforms' 368 (LitePose fuses sides of multiples of 32
    only)."""
    from cvpytorch_tpu_torch.config import CommonConfiguration

    cfg = CommonConfiguration.from_file(str(ROOT / "conf" / f"{name}.yml"))
    data = cfg.DATASET
    data.DICTIONARY = str(ROOT / data.DICTIONARY)
    for stage in ("TRAIN", "VAL"):
        img_dir, ann_file = kdir[stage.lower()]
        data.get(stage).update({"IMG_DIR": img_dir, "ANN_FILE": ann_file})
    for stage in (data.TRAIN, data.VAL):
        for t in ("Resize", "RandomResizedCrop"):
            if size and t in stage.TRANSFORMS:
                stage.TRANSFORMS[t]["size"] = [size, size]
    data.INFER = {**dict(data.VAL), "ANN_FILE": kdir["infer"][1]}
    cfg.EVALUATOR.NAME = "coco_keypoints"
    cfg.EVALUATOR.EVAL_INTERVALS = epochs
    cfg.update({"N_MAX_EPOCHS": epochs, "CHECKPOINT_DIR": str(workdir / "checkpoints"),
                "TENSORBOARD": False, "N_ITERS_TO_DISPLAY_STATUS": 1, "SEED": 0})
    path = workdir / f"{name}_{size or 'as_written'}.json"
    path.write_text(json.dumps(cfg, default=lambda c: c.data))
    return path


def served_keypoints(workdir: Path, setting: Path, trainer, checkpoint: Path, label: str):
    """``infer.main`` on ``checkpoint`` over the INFER stage (one batch):
    ``nms_keep`` never launched; the served entries are what the predict
    step of the same weights gives on the same images
    (``infer.keypoint_results``: the flattened decode, or OpenPose's
    people)."""
    import torch

    from cvpytorch_tpu_torch import infer
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep
    from cvpytorch_tpu_torch.train_state import make_predict_step
    from cvpytorch_tpu_torch.utils.checkpoints import Checkpoints

    before = nms_keep.launches
    t0 = time.perf_counter()
    infer.main(["--setting", str(setting), "--checkpoint", str(checkpoint),
                "--out", str(workdir / "served")])
    cli_s = time.perf_counter() - t0
    served_launches = nms_keep.launches - before
    served = json.loads((workdir / "served" / "predictions.json").read_text())
    model = infer.build_model(trainer.cfg, trainer.dictionary)
    Checkpoints.load_weights_into(model, str(checkpoint))
    model.to("cuda", memory_format=torch.channels_last)  # as infer.main places it
    images, letterbox = infer_batch(trainer, KEYPOINT_BATCH)
    want = infer.keypoint_results(make_predict_step(model)(images), images, letterbox)
    if served_launches or len(served) != len(want):
        raise AssertionError(f"{label}: {served_launches} nms_keep launches serving, "
                             f"{len(served)} entries for {len(want)}")
    if isinstance(want[0], dict):
        for i, (g, w) in enumerate(zip(served, want)):
            if len(g["scores"]) != len(w["scores"]) or not all(
                    np.allclose(g[k], w[k], atol=1e-3) for k in w):
                raise AssertionError(f"{label}: served image {i} differs from the predict step")
        n_people = sum(len(w["scores"]) for w in want)
        return {"served_launches": served_launches, "infer_cli_s": cli_s,
                "served_images": len(want), "served_people": n_people}
    if not np.allclose(served, want, atol=1e-4):
        raise AssertionError(f"{label}: served decode differs from the predict step")
    return {"served_launches": served_launches, "infer_cli_s": cli_s,
            "served_values": len(want), "served_finite": bool(np.isfinite(served).all())}


def openpose_phase(workdir: Path, kdir: dict) -> tuple[dict, object]:
    """``conf/coco_openpose.yml`` (VGG16-bn to conv4_3, 3 stages, 368²,
    bs32, SGD, PolyLR, warmup, AMP, EMA, clip 10) through ``Trainer.run()``:
    2 epochs of 2 steps with the targets rendered on the card (the
    ``openpose_targets`` range), one val epoch of 64 images (peaks, pair
    scores and the ``limb_match`` greedy on the card, people and OKS on
    the host), ``nms_keep`` never launched; then one served batch through
    ``infer.main``."""
    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration

    workdir.mkdir(parents=True)
    setting = keypoint_config(workdir, "coco_openpose", kdir, OPENPOSE_EPOCHS)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    run = run_instrumented(trainer, trainer_mod)  # the main path of this phase
    state, metrics = run["state"], run["metrics"]
    steps = OPENPOSE_EPOCHS * OPENPOSE_STEPS
    losses = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
    (val,) = run["val"]
    if (len(metrics) != steps or state.step != steps or run["launches"]
            or set(losses) != {"heatmap_loss", "paf_loss", "loss"}
            or not all(np.isfinite(v).all() for v in losses.values())
            or not np.isfinite(val["keypoints_mAP"])):
        raise AssertionError(f"openpose: {len(metrics)} steps, {run['launches']} nms_keep "
                             f"launches, losses {losses}, val {val}")
    served = served_keypoints(workdir, setting, trainer,
                              Path(trainer.checkpoints.save_dir) / "last.pt", "openpose")
    times = run["times"]
    out = {"model": type(trainer.model).__name__,
           "backbone": type(trainer.model.backbone).__name__, "stages": trainer.model.num_stages,
           "epochs": OPENPOSE_EPOCHS, "steps": steps, "batch": KEYPOINT_BATCH,
           "launches": run["launches"], "losses": losses,
           "val_keypoints_mAP": float(val["keypoints_mAP"]), "val_bbox_mAP": float(val["mAP"]),
           "run_s": run["run_s"], "train_epoch_s": times["train_epoch"],
           "fed_images_per_s": KEYPOINT_BATCH * OPENPOSE_STEPS / times["train_epoch"][-1],
           "val_epoch_s": times["val_epoch"][0],
           "val_evaluator_share": times["evaluator"] / times["val_epoch"][0], **served}
    return out, trainer


def limb_match_timing(state, batch) -> tuple[dict, dict]:
    """The val decode on the val batch's maps alone, by CUDA events: the
    peaks, the pair scores and the greedy matching (``limb_match``: one
    vectorised step of ~8 launches for each order position up to the last
    finite score).  Returns the times and the maps."""
    import torch

    from cvpytorch_tpu_torch.ops import paf
    from cvpytorch_tpu_torch.train_state import make_predict_step

    maps = make_predict_step(state.model)(batch["image"])
    hm = maps["heatmaps"][..., :paf.NUM_JOINTS]
    xy, score, valid = paf.find_peaks(hm)
    scores, ok = paf.score_limb_pairs(xy, valid, maps["pafs"])
    positions = int(ok.reshape(*ok.shape[:2], -1).sum(-1).max())
    return {"find_peaks_ms": cuda_time_ms(lambda: paf.find_peaks(hm), iters=5, warmup=1),
            "score_limb_pairs_ms": cuda_time_ms(
                lambda: paf.score_limb_pairs(xy, valid, maps["pafs"]), iters=5, warmup=1),
            "limb_match_ms": cuda_time_ms(lambda: paf.greedy_limb_match(scores, ok),
                                          iters=3, warmup=1),
            "limb_match_positions": positions, "ok_pairs": int(ok.sum()),
            "peaks": int(valid.sum())}, maps


def openpose_card_vs_cpu(trainer, batches, maps) -> dict:
    """OpenPose (VGG16-bn, 3 stages) at 368², B = 2, f32 with TF32 off,
    the same seeded weights on both devices.  Gates: eval-mode heatmaps
    and PAFs within 1e-4 of their largest value; the targets rendered in
    float64 from the same keypoints within 1e-12 (a boundary test that
    flipped would move a value by 1e-2 or more; the sums over persons
    differ in the last bit), the gaussians' support equal; the train-mode
    losses, each device's f32 stage outputs against the float64 targets in
    float64, within 1e-4 relative.  The decode, stage by stage on shared
    inputs, from ``maps`` (the trained model's val maps, which hold peaks
    and pairs): the peaks' validity and scores equal, and in float64 their
    sub-pixel positions within 1e-6 (in float32 they are reported: the
    parabola divides by the second difference of the log intensities,
    which on a flat peak magnifies the devices' last-bit ``log``
    differences, up to 0.067 grid pixels on an H100); on the CPU's peaks the pairs' ``ok`` equal and scores
    within 1e-5; on the CPU's pairs the greedy's matched slots equal and
    their scores within 1e-5."""
    import copy

    import torch

    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.ops import paf

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the step makers turn it off")
    two = _tree(batches["train"], lambda t: t[:2])
    torch.manual_seed(0)
    base = build_model(trainer.cfg, trainer.dictionary, trainer.datasets["train"])
    kp, valid = two["target"]["keypoints"].double(), two["target"]["valid"].double()
    hw = tuple(two["image"].shape[1:3])
    seen = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device, memory_format=torch.channels_last)
        images = two["image"].to(device)
        with torch.no_grad():
            out_maps = model.eval()(images, mode="infer")
            hms, pafs = model.train().stages(images)
            t_hm, t_paf = paf.render_openpose_targets(kp.to(device), valid.to(device), hw)
        seen[device] = {"maps": {k: v.cpu() for k, v in out_maps.items()},
                        "stages": ([h.cpu() for h in hms], [p.cpu() for p in pafs]),
                        "targets": (t_hm.cpu(), t_paf.cpu())}
    cpu, card = seen["cpu"], seen["cuda"]
    out = {"maps_max_rel_err": {k: max_rel_err(card["maps"][k], v)
                                for k, v in cpu["maps"].items()}}
    (hm_cpu, paf_cpu), (hm_card, paf_card) = cpu["targets"], card["targets"]
    out["targets_f64_pafs_max_abs_err"] = float((paf_card - paf_cpu).abs().max())
    out["targets_f64_heatmaps_max_abs_err"] = float((hm_card - hm_cpu).abs().max())
    out["targets_f64_support_equal"] = bool(torch.equal(hm_card[..., :18] > 0,
                                                        hm_cpu[..., :18] > 0))
    out["targets_nonzero"] = {"heatmaps": int((hm_cpu[..., :18] > 0).sum()),
                              "pafs": int((paf_cpu != 0).sum())}

    def losses(stages):
        hms, pafs = stages
        nhwc = [[t.permute(0, 2, 3, 1).double() for t in ts] for ts in (hms, pafs)]
        return {"heatmap_loss": float(sum(((h - hm_cpu) ** 2).mean() for h in nhwc[0])),
                "paf_loss": float(sum(((p - paf_cpu) ** 2).mean() for p in nhwc[1]))}

    lc, ld = losses(cpu["stages"]), losses(card["stages"])
    out["train_losses_f64_rel_err"] = {k: abs(ld[k] - v) / abs(v) for k, v in lc.items()}
    # the decode, stage by stage on shared inputs
    shared = {k: v.detach().cpu() for k, v in maps.items()}
    hm = shared["heatmaps"][..., :paf.NUM_JOINTS]
    (xy, sc, ok_peak), (xy_d, sc_d, ok_peak_d) = (
        [t.cpu() for t in paf.find_peaks(hm.to(d))] for d in ("cpu", "cuda"))
    out["peaks"] = int(ok_peak.sum())
    out["peaks_equal"] = bool(torch.equal(ok_peak, ok_peak_d) and torch.equal(sc, sc_d))
    out["peaks_xy_f32_max_abs_err"] = float((xy - xy_d)[ok_peak].abs().max()) \
        if ok_peak.any() else 0.0
    (xy64, sc64, ok64), (xy64_d, sc64_d, ok64_d) = (
        [t.cpu() for t in paf.find_peaks(hm.double().to(d))] for d in ("cpu", "cuda"))
    out["peaks_f64_equal"] = bool(torch.equal(ok64, ok64_d) and torch.equal(sc64, sc64_d)
                                  and torch.equal(ok64, ok_peak))
    out["peaks_xy_f64_max_abs_err"] = float((xy64 - xy64_d)[ok64].abs().max()) \
        if ok64.any() else 0.0
    (s, ok), (s_d, ok_d) = ([t.cpu() for t in paf.score_limb_pairs(
        xy.to(d), ok_peak.to(d), shared["pafs"].to(d))] for d in ("cpu", "cuda"))
    out["pairs_ok"] = int(ok.sum())
    out["pairs_ok_equal"] = bool(torch.equal(ok, ok_d))
    out["pair_scores_max_abs_err"] = float((s - s_d)[ok].abs().max()) if ok.any() else 0.0
    c, c_d = (paf.greedy_limb_match(s.to(d), ok.to(d)).cpu() for d in ("cpu", "cuda"))
    out["conns"] = int((c[..., 0] >= 0).sum())
    out["conn_slots_equal"] = bool(torch.equal(c[..., :2], c_d[..., :2]))
    out["conn_scores_max_abs_err"] = float((c[..., 2] - c_d[..., 2]).abs().max())
    print(f"OpenPose card vs CPU, f32, B=2, 368²: {json.dumps(out)}", flush=True)
    if not (max(out["maps_max_rel_err"].values()) <= 1e-4
            and out["targets_f64_pafs_max_abs_err"] <= 1e-12
            and out["targets_f64_heatmaps_max_abs_err"] <= 1e-12
            and out["targets_f64_support_equal"]
            and max(out["train_losses_f64_rel_err"].values()) <= 1e-4 and out["peaks_equal"]
            and out["peaks_f64_equal"] and out["peaks_xy_f64_max_abs_err"] <= 1e-6
            and out["pairs_ok_equal"]
            and out["pair_scores_max_abs_err"] <= 1e-5 and out["conn_slots_equal"]
            and out["conn_scores_max_abs_err"] <= 1e-5):
        raise AssertionError(f"OpenPose card vs CPU: {out}")
    return out


def single_instance(batch) -> dict:
    """LitePose's JAX contract: (B, 17, 3) keypoints, each image's first
    person of the collated (B, M, 17, 3)."""
    return {"image": batch["image"], "target": {"keypoints": batch["target"]["keypoints"][:, 0]}}


def litepose_phase(workdir: Path, kdir: dict, card: str) -> dict:
    """``conf/coco_litepose.yml`` (MobileNetV2, fusion deconvs, bs32,
    AdamW, cosine, warmup, AMP, EMA, clip 10) as far as JAX runs it.
    The config's 368² fails at the first forward (not a multiple of 32:
    the fusion does not broadcast, in JAX either), and through
    ``Trainer.run()`` at ``LITEPOSE_HW`` the first loss fails (the
    collated keypoints, as JAX's).  So at ``LITEPOSE_HW`` the AMP train
    step runs on single-instance (B, 17, 3) targets of the loader's batch,
    then one val step's decode, one served batch of the trained weights
    through ``infer.main``, and the card against the CPU on the heatmaps;
    ``nms_keep`` never launched."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep
    from cvpytorch_tpu_torch.train_state import (make_eval_step, make_predict_step,
                                                 make_train_step)

    workdir.mkdir(parents=True)
    refused = {}
    nms_keep.launches = 0
    setting = keypoint_config(workdir, "coco_litepose", kdir, 1, LITEPOSE_HW)
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    for hw, cause, fn in ((368, "multiple of 32", lambda: trainer.model.cuda()(
            torch.zeros(2, 368, 368, 3).cuda(), mode="infer")),
                          (LITEPOSE_HW, "single-instance keypoints", trainer.run)):
        try:
            fn()
        except ValueError as e:
            if cause not in str(e):
                raise
            refused[hw] = str(e)
        else:
            raise AssertionError(f"litepose at {hw}²: no refusal ({cause})")
    batches = {s: single_instance(loader_batch(trainer, s, KEYPOINT_BATCH))
               for s in ("train", "val")}
    timed, state = train_step_timing(trainer, batches["train"], KEYPOINT_BATCH, iters=3,
                                     ema_decay=0.9999, amp_only=True)
    step = make_train_step(amp=True, ema_decay=0.9999)
    losses = [float(step(state, batches["train"])[1]["loss"]) for _ in range(2)]
    val_losses, decoded = make_eval_step(use_ema=True)(state, batches["val"])
    if not (np.isfinite(losses).all() and np.isfinite(float(val_losses["loss"]))
            and decoded.shape == (KEYPOINT_BATCH, 17, 3) and torch.isfinite(decoded).all()):
        raise AssertionError(f"litepose: losses {losses}, val {val_losses}, {decoded.shape}")
    ckpt = workdir / "litepose_ema.pt"
    torch.save(state.ema.state_dict(), ckpt)
    served = served_keypoints(workdir, setting, trainer, ckpt, "litepose")
    launches = nms_keep.launches
    predict = make_predict_step(state.ema)
    timed[f"bs{KEYPOINT_BATCH}_predict_ms"] = cuda_time_ms(
        lambda: predict(batches["val"]["image"]), iters=5, warmup=1)
    one = batches["val"]["image"][:1]
    timed["bs1_predict_p50_ms"] = float(np.median(call_ms(lambda: predict(one))))

    def heatmaps(model, batch):
        with torch.no_grad():
            return {f"scale{i}": h for i, h in enumerate(model.eval().heatmap_pyramid(
                batch["image"]))}

    check = card_vs_cpu(trainer, batches, heatmaps, lambda cpu, cuda: {
        k: max_rel_err(cuda[k], v) for k, v in cpu.items()})
    if max(check.values()) > 1e-4:
        raise AssertionError(f"LitePose card vs CPU: {check}")
    out = {"hw": LITEPOSE_HW, "refused": refused, "train_losses": losses,
           "val_loss": float(val_losses["loss"]), "launches": launches, "timing": timed,
           "heatmaps_card_vs_cpu_max_rel_err": check, **served}
    print(json.dumps({"litepose": out, "card": card}), flush=True)
    return out


def simplepose_card_vs_cpu() -> dict:
    """SimplePose (ResNet-18, three ``ConvTranspose4x2``) at 256², B = 2,
    TF32 off: eval-mode heatmaps within 1e-4 of their largest value and
    the train-mode loss on seeded targets within 1e-4 relative; the
    card's decode equal over two calls (no atomics in the transposed
    convolutions)."""
    import copy

    import torch

    from cvpytorch_tpu_torch.models.keypoint import SimplePose

    g = torch.Generator().manual_seed(1)
    images = torch.rand(2, SIMPLEPOSE_CHECK_HW, SIMPLEPOSE_CHECK_HW, 3, generator=g)
    side = SIMPLEPOSE_CHECK_HW // 4
    t = {"heatmaps": torch.rand(2, side, side, 17, generator=g),
         "valid": torch.rand(2, 17, generator=g) < 0.8}
    torch.manual_seed(0)
    base = SimplePose()
    seen = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(device, memory_format=torch.channels_last)
        x, td = images.to(device), {k: v.to(device) for k, v in t.items()}
        with torch.no_grad():
            hm = model.eval().heatmaps(x)
            dec = [model(x, mode="infer") for _ in range(2)]
            loss = model.train()(x, td, mode="train")[0]
        seen[device] = (hm.cpu(), [d.cpu() for d in dec], float(loss))
    out = {"heatmaps_max_rel_err": max_rel_err(seen["cuda"][0], seen["cpu"][0]),
           "train_loss_rel_err": abs(seen["cuda"][2] - seen["cpu"][2]) / abs(seen["cpu"][2]),
           "card_decode_repeatable": bool(torch.equal(*seen["cuda"][1]))}
    print(f"SimplePose card vs CPU, B=2, {SIMPLEPOSE_CHECK_HW}²: {json.dumps(out)}", flush=True)
    if not (out["heatmaps_max_rel_err"] <= 1e-4 and out["train_loss_rel_err"] <= 1e-4
            and out["card_decode_repeatable"]):
        raise AssertionError(f"SimplePose card vs CPU: {out}")
    return out


OPTIMIZER_RULES = {  # each hand-written optax rule, in the port's groups
    "Adadelta": {"WEIGHT_DECAY": 1e-3},
    "RMSprop": {"MOMENTUM": 0.9, "WEIGHT_PARAMS": {"weight_decay": 5e-4}},
    "RAdam": {"BETAS": [0.8, 0.99], "WEIGHT_DECAY": 1e-3},
    "AdaBelief": {"BIAS_LR_MULTIPLIER": 2, "WEIGHT_DECAY": 1e-3},
    "Ranger": {"WEIGHT_DECAY": 1e-3},
}


def optimizers_card_vs_cpu() -> dict:
    """The five hand-written optimizers on a small conv-BN-linear model in
    float64: 7 updates of the same seeded gradients (across the warmup and
    RAdam's rectification at step 6) on the card and on the CPU, from the
    same parameters; every parameter within 1e-12 of the CPU's after every
    update."""
    import copy

    import torch
    from torch import nn

    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.optim.schedules import build_lr_scheduler

    torch.manual_seed(0)
    base = nn.Sequential(nn.Conv2d(3, 8, 3), nn.BatchNorm2d(8), nn.Flatten(),
                         nn.Linear(8 * 6 * 6, 5)).double()
    out = {}
    for name, extra in OPTIMIZER_RULES.items():
        body = {"INIT_LR": 0.01, "N_MAX_EPOCHS": 4, "LR_SCHEDULER": {"TYPE": "CosineAnnealingLR"},
                "WARMUP": {"NAME": "linear", "ITERS": 2, "FACTOR": 0.1},
                "GRAD_CLIP": {"TYPE": "norm", "VALUE": 3.0},
                "OPTIMIZER": {"TYPE": name, **extra}}
        cfg = CommonConfiguration(body)
        models = {d: copy.deepcopy(base).to(d) for d in ("cpu", "cuda")}
        opts = {d: build_optimizer(cfg, m, build_lr_scheduler(cfg, 2)) for d, m in models.items()}
        g = torch.Generator().manual_seed(2)
        err = 0.0
        for _ in range(7):
            grads = [torch.randn(p.shape, generator=g, dtype=torch.float64) * 2
                     for p in base.parameters()]
            for d, m in models.items():
                for p, gr in zip(m.parameters(), grads):
                    p.grad = gr.to(d)
                opts[d].step()
            err = max(err, max(float((pc - pd.cpu()).abs().max().detach()) for pc, pd in zip(
                models["cpu"].parameters(), models["cuda"].parameters())))
        out[name] = {"class": type(opts["cuda"]).__name__, "max_abs_err": err}
    print(f"optimizer rules card vs CPU, float64, 7 updates: {json.dumps(out)}", flush=True)
    if any(v["max_abs_err"] > 1e-12 or v["class"] != k for k, v in out.items()):
        raise AssertionError(f"optimizers card vs CPU: {out}")
    return out


def slice15_phases(workdir: Path, card: str) -> tuple[dict, dict]:
    """The keypoint task on a COCO ``person_keypoints`` directory of the
    JPEG fixtures: ``coco_openpose`` at full width (2 epochs of 2 steps,
    64 val, one served batch, AMP and f32 steps, bs1 p50 and bs32 predict,
    the decode's stages alone, card vs CPU), ``coco_litepose`` as far as
    JAX runs it, SimplePose and the five optimizer rules card vs CPU.
    ``nms_keep`` is launched on none of them.  Returns every record, and
    the state and batches the profiles take at the end of the run."""
    import torch

    from cvpytorch_tpu_torch.train_state import make_predict_step

    kdir = write_keypoint_dir(workdir / "person_keypoints")
    torch.cuda.empty_cache()
    run, trainer = openpose_phase(workdir / "openpose", kdir)
    print(json.dumps({"openpose": run, "card": card}), flush=True)
    timed, states, batches = milestone_timing(trainer, KEYPOINT_BATCH, None, iters=3,
                                              ema_decay=0.9999)
    predict, one = make_predict_step(states["train"].model), batches["val"]["image"][:1]
    timed["bs1_predict_p50_ms"] = float(np.median(call_ms(lambda: predict(one))))
    timed["decode"], maps = limb_match_timing(states["train"], batches["val"])
    timed["decode"]["limb_match_share_of_val_step"] = \
        timed["decode"]["limb_match_ms"] / timed["val_step_ms"]
    print(json.dumps({"openpose_timing": timed, "card": card}), flush=True)
    check = openpose_card_vs_cpu(trainer, batches, maps)
    out = {"openpose": {"run": run, "timing": timed, "card_vs_cpu": check}}
    later = {"state": states["train"], "batch": batches["train"], "amp_ms": timed["amp_step_ms"]}
    del trainer
    mark("openpose")
    torch.cuda.empty_cache()
    out["litepose"] = litepose_phase(workdir / "litepose", kdir, card)
    mark("litepose")
    out["simplepose"] = simplepose_card_vs_cpu()
    out["optimizers"] = optimizers_card_vs_cpu()
    mark("simplepose, optimizers")
    return out, later


# -- slice 16: YOLOv5-s export and serving, the trainer's profiler and bf16 BN moments, PTQ, ----
# -- precise BN, the summary, the seven backbones, the attentions and RandAugment ----------------
SLICE16_STEPS = 3  # one epoch
SLICE16_EXPORTS = ((BATCH, False), (BATCH, True), (1, False), (1, True))  # (batch, --fuse)
SLICE16_BACKBONES = ("ConvNeXt", "RegNet", "MobileNetV3", "TinyNet", "SqueezeNet", "DenseNet",
                     "ViT")  # each at its default subtype
BACKBONE_BATCH = 64
BACKBONE_HW = 224
RANDAUG_FRAME = (512, 1024)


def slice16_config(workdir: Path) -> Path:
    """``train_config``'s recipe (conf/coco_yolov5_s.yml with the device
    augmentation, AMP, EMA) cut to one epoch of 3 steps and no validation,
    with ``AMP_BN_BF16_STATS: true`` and ``PROFILER`` tracing step 1."""
    path = train_config(workdir)
    cfg = json.loads(path.read_text())
    cfg["EXPERIMENT_NAME"] = "chip_smoke_slice16"
    cfg["DATASET"]["TRAIN"]["LENGTH"] = BATCH * SLICE16_STEPS
    del cfg["DATASET"]["VAL"], cfg["EVALUATOR"]
    cfg.update(N_MAX_EPOCHS=1, AMP=True, AMP_BN_BF16_STATS=True,
               PROFILER={"DIR": str(workdir / "traces"), "START_STEP": 1, "NUM_STEPS": 1})
    path.write_text(json.dumps(cfg))
    return path


def trace_kernels(path: str) -> dict:
    """The Chrome trace's profiled step ranges and its CUDA kernel events."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    steps = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("train_step_")})
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"file": Path(path).name, "steps": steps, "kernel_events": len(kernels),
            "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3,
            "bytes": Path(path).stat().st_size}


def bn_stats_timing(trainer, batch) -> dict:
    """The AMP train step on one augmented batch with the BN moments in
    bfloat16 and in float32, the same seeded weights, by CUDA events over
    5 steps after 1 warm-up step."""
    import torch

    from cvpytorch_tpu_torch.infer import build_model
    from cvpytorch_tpu_torch.models.bricks import set_bn_bf16_stats
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step

    out = {}
    for name, on in (("amp_step_ms_bn_bf16_stats", True), ("amp_step_ms_bn_f32_stats", False)):
        torch.manual_seed(0)
        model = build_model(trainer.cfg, trainer.dictionary).to(
            "cuda", memory_format=torch.channels_last)
        set_bn_bf16_stats(model, on)
        state = create_train_state(model, build_optimizer(trainer.cfg, model,
                                                          trainer.lr_schedule), use_ema=True)
        step = make_train_step(amp=True, ema_decay=0.9999)
        out[name] = cuda_time_ms(lambda: step(state, batch), iters=5, warmup=1)
        del state, step, model
    return out


def exported_serving(workdir: Path, setting: Path, ckpt: Path, trainer, state) -> dict:
    """``exports.main`` without and with ``--fuse`` at bs32 and bs1 on the
    trained checkpoint, the programs loaded back and served a letterboxed
    batch on the card (the main path: ``nms_keep``'s count set to 0 just
    before the four serving calls and read just after).  The unfused
    program's detections equal the predict step's on the EMA model; the
    fused model's raw maps are within 1e-3 of their largest value of the
    unfused one's, and the detections that differ are counted.  Then the
    bs32 ms and bs1 p50 of each program beside the eager predict step."""
    import copy

    import torch

    from cvpytorch_tpu_torch import exports
    from cvpytorch_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from cvpytorch_tpu_torch.train_state import make_predict_step
    from cvpytorch_tpu_torch.utils.model_utils import fuse_model_conv_bn

    out, programs = {"exports": {}}, {}
    for batch, fuse in SLICE16_EXPORTS:
        name = f"bs{batch}{'_fused' if fuse else ''}"
        t0 = time.perf_counter()
        path = exports.main(["--setting", str(setting), "--checkpoint", str(ckpt),
                             "--out", str(workdir / f"yolov5_s_{name}"),
                             "--batch", str(batch)] + (["--fuse"] if fuse else []))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = torch.export.load(path)  # what exports.load_exported does
        programs[name] = program.module()
        nodes = [n for n in program.graph.nodes if "cvt.nms_keep" in str(n.target)]
        if len(nodes) != 1:
            raise AssertionError(f"the {name} program calls cvt.nms_keep {len(nodes)} times")
        out["exports"][name] = {"export_s": export_s, "load_s": time.perf_counter() - t0,
                                "pt2_mb": Path(path).stat().st_size / 1e6}
    images, _ = infer_batch(trainer, BATCH)  # letterboxed 640², as infer.main reads them
    one = images[:1].contiguous()
    eager = copy.deepcopy(state.ema).to("cuda", memory_format=torch.channels_last).eval()
    predict = make_predict_step(eager)  # TF32 off for the process
    want, want1 = predict(images), predict(one)
    # the main path: the exported programs serve, counts read just around it
    nms_keep.launches = 0
    big = f"bs{BATCH}"
    with torch.inference_mode():
        got = {name: programs[name](images if name.startswith(big) else one)
               for name in programs}
    torch.cuda.synchronize()
    launches = nms_keep.launches
    if launches != len(programs):
        raise AssertionError(f"the exported programs launched nms_keep {launches} times for "
                             f"{len(programs)} calls")
    for name, ref in ((big, want), ("bs1", want1)):
        for key in ("boxes", "scores", "labels", "valid", "num"):
            if not torch.equal(got[name][key], ref[key]):
                raise AssertionError(f"the {name} program's {key} differ from the predict step's")
    if int(want["num"].sum()) == 0:
        raise AssertionError("the served batch holds no detections")
    fused = fuse_model_conv_bn(copy.deepcopy(eager))
    with torch.inference_mode():
        raw, raw_fused = eager._raw(images), fused._raw(images)
    raw_err = max(max_rel_err(b, a) for a, b in zip(raw, raw_fused))
    if not raw_err <= 1e-3:
        raise AssertionError(f"fused raw maps differ by {raw_err} of their scale")
    differing = {}
    for name, ref in ((f"{big}_fused", want), ("bs1_fused", want1)):
        g = got[name]
        same = (g["labels"] == ref["labels"]) & ((g["boxes"] - ref["boxes"]).abs().amax(-1) < 1e-2)
        differing[name] = int((~same & (g["valid"] | ref["valid"])).sum())
    out.update(launches=launches, detections=int(want["num"].sum()),
               fused_raw_maps_max_rel_err=raw_err, fused_detections_differing=differing)
    print(f"exported YOLOv5-s served on the card: nms_keep launches {launches} for "
          f"{len(programs)} calls, unfused == predict step ({out['detections']} detections), "
          f"fused raw maps within {raw_err:.3g} of scale, differing detections {differing}",
          flush=True)
    # the path's own NMS input through the eager model, and the timings
    seen, restore = capture_nms_inputs()
    try:
        predict(images)
    finally:
        restore()
    (boxes, thr), = seen
    # the exported programs' route, the cvt::nms_keep op, against the plain
    # version on that input: bit-exact
    got, plain = torch.ops.cvt.nms_keep(boxes, thr), nms_keep_plain(boxes, thr)
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        raise AssertionError(f"cvt::nms_keep != nms_keep_plain on the exported path's input: "
                             f"{int((got != plain).sum())} flags differ")
    out["nms_keep_op_on_path_input"] = {"kept": int(got.sum()), "bit_exact": True}
    out["nms_keep_plain_on_path_input_ms"] = cuda_time_ms(lambda: nms_keep_plain(boxes, thr),
                                                          iters=3, warmup=1)
    # the op's dispatcher (the exported programs' route) against the eager
    # wrapper (straight to the kernels), 200 calls back to back each, in
    # turns: op, direct, direct, op
    turns = [cuda_time_ms((lambda: nms_keep(boxes, thr)) if kind == "direct" else
                          (lambda: torch.ops.cvt.nms_keep(boxes, thr)), iters=200)
             for kind in ("op", "direct", "direct", "op")]
    out["nms_keep_direct_vs_op_ms"] = {"op": [turns[0], turns[3]], "direct": turns[1:3]}
    out["nms_keep_op_on_path_input_ms"] = float(np.mean(out["nms_keep_direct_vs_op_ms"]["op"]))
    out["nms_keep_direct_on_path_input_ms"] = float(np.mean(
        out["nms_keep_direct_vs_op_ms"]["direct"]))
    nms_keep.launches = launches
    with torch.inference_mode():
        for name, fn in (("eager", predict), *programs.items()):
            if name == "eager" or name.startswith(big):
                out[f"{name}_{big}_ms"] = cuda_time_ms(lambda: fn(images), iters=10, warmup=2)
            if name == "eager" or name.startswith("bs1"):
                out[f"{name}_bs1_ms_p50"] = float(np.median(call_ms(lambda: fn(one),
                                                                    calls=10, warmup=2)))
    nms_keep.launches = launches  # timing launches do not count
    return out, (boxes, thr)


def ptq_card_vs_cpu(state, images) -> dict:
    """``ptq_roundtrip``, ``calibrate_activations`` and ``quantized_apply`` on
    the trained EMA weights, on the card and on the CPU at B = 2 (TF32
    off): the round-tripped weights equal and the calibrated scales within
    1e-4 relative (float32); ``quantized_apply``'s raw maps with the CPU's
    scales within 1e-4 of their largest value in float64.  In float32 a
    fake-quantized value moves by a whole int8 step wherever a 1e-6
    difference between the devices crosses a rounding boundary, and ~200
    sites carry such flips on: the float32 card-vs-CPU difference is
    printed beside the int8 drift from float, not gated."""
    import copy

    import torch

    from cvpytorch_tpu_torch.utils import quantize

    class Raw(torch.nn.Module):  # the raw maps, the float outputs to compare
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            return self.model._raw(x)

    x = images[:2]
    seen, models = {}, {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(state.ema).float().to(device).eval()
        with torch.no_grad():
            float_raw = [t.cpu() for t in Raw(model)(x.to(device))]
            quantize.ptq_roundtrip(model)
            scales = quantize.calibrate_activations(Raw(model), [x.to(device)])
        models[device] = model
        seen[device] = {"weights": {k: v.cpu() for k, v in model.state_dict().items()},
                        "scales": scales, "float": float_raw}
    cpu, card = seen["cpu"], seen["cuda"]
    for device in ("cpu", "cuda"):
        for dtype in (torch.float32, torch.float64):
            with torch.no_grad():
                seen[device][dtype] = [t.cpu() for t in quantize.quantized_apply(
                    Raw(models[device].to(dtype)), x.to(device, dtype),
                    act_scales=cpu["scales"])]
    weights_equal = all(torch.equal(cpu["weights"][k], card["weights"][k]) for k in cpu["weights"])
    scale_err = max(abs(card["scales"][k] - v) / v for k, v in cpu["scales"].items())

    def mean_abs(a, b):
        return float(sum((u.double() - v.double()).abs().sum() for u, v in zip(a, b))
                     / sum(u.numel() for u in a))

    f32, f64 = torch.float32, torch.float64
    out = {"weights_equal": weights_equal, "sites": len(cpu["scales"]),
           "scales_max_rel_err": scale_err,
           "quantized_raw_maps_f64_card_vs_cpu_max_rel_err": max(
               max_rel_err(a, b) for a, b in zip(card[f64], cpu[f64])),
           "quantized_raw_maps_f32_card_vs_cpu_mean_abs": mean_abs(card[f32], cpu[f32]),
           "int8_drift_from_float_mean_abs": mean_abs(cpu[f32], cpu["float"]),
           "int8_drift_from_float_max_rel": max(
               max_rel_err(a, b) for a, b in zip(cpu[f32], cpu["float"])),
           "float_raw_maps_card_vs_cpu_max_rel_err": max(
               max_rel_err(a, b) for a, b in zip(card["float"], cpu["float"]))}
    print(f"PTQ on the trained YOLOv5-s, card vs CPU, B=2: {json.dumps(out)}", flush=True)
    if not (weights_equal and set(card["scales"]) == set(cpu["scales"]) and scale_err <= 1e-4
            and out["quantized_raw_maps_f64_card_vs_cpu_max_rel_err"] <= 1e-4):
        raise AssertionError(f"PTQ card vs CPU: {out}")
    return out


def precise_bn_card_vs_cpu(state, batch) -> dict:
    """``precise_bn`` over two augmented batches of 2 images on the card and
    on the CPU, float64 (in float32 the train-mode forward through 57 BNs
    puts the devices' statistics ~2e-4 of their scale apart): every BN's
    population mean and var within 1e-6 of their largest value."""
    import copy

    import torch

    from cvpytorch_tpu_torch.utils.model_utils import precise_bn

    n = min(2, len(batch["image"]) // 2)
    parts = [_tree(batch, lambda t, i=i: t[n * i:n * i + n]) for i in range(2)]
    stats = {}
    for device in ("cpu", "cuda"):
        model = copy.deepcopy(state.model).to(device, torch.float64)
        precise_bn(model, [_tree(p, lambda t: t.to(device, torch.float64)
                                 if t.is_floating_point() else t.to(device)) for p in parts])
        stats[device] = {k: v.cpu() for k, v in model.state_dict().items()
                         if k.endswith(("running_mean", "running_var"))}
    err = max(max_rel_err(stats["cuda"][k], v) for k, v in stats["cpu"].items())
    out = {"bn_layers": len(stats["cpu"]) // 2, "max_rel_err_float64": err}
    print(f"precise_bn card vs CPU: {json.dumps(out)}", flush=True)
    if not err <= 1e-6:
        raise AssertionError(f"precise_bn card vs CPU: {out}")
    return out


def backbones_phase() -> dict:
    """The seven backbones under ``Classification`` at their default
    subtypes, 1000 classes, 224²: one AMP train step at bs64 timed by CUDA
    events (2 steps after 1), and the eval logits on the card against the
    CPU at B = 2, f32, TF32 off, within 1e-4 of their largest value."""
    import copy
    import inspect

    import torch

    from cvpytorch_tpu_torch.models.classification import Classification
    from cvpytorch_tpu_torch.optim.optimizers import build_optimizer
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.train_state import create_train_state, make_train_step

    dictionary = tuple({f"class{i}": 1.0} for i in range(1000))
    cfg = CommonConfiguration({"INIT_LR": 0.01, "OPTIMIZER": {"TYPE": "SGD", "MOMENTUM": 0.9}})
    g = torch.Generator().manual_seed(0)
    images = torch.rand(BACKBONE_BATCH, BACKBONE_HW, BACKBONE_HW, 3, generator=g).cuda()
    labels = torch.randint(0, 1000, (BACKBONE_BATCH,), generator=g).cuda()
    out = {}
    for name in SLICE16_BACKBONES:
        torch.cuda.empty_cache()
        torch.manual_seed(0)
        base = Classification(dictionary=dictionary, model_cfg={"BACKBONE": {"name": name}})
        model = copy.deepcopy(base).to("cuda", memory_format=torch.channels_last)
        state = create_train_state(model, build_optimizer(cfg, model, lambda s: 0.01))
        step = make_train_step(amp=True)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: step(state, {"image": images, "target": labels}),
                          iters=2, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state, step, model
        x = images[:2]
        logits = {}
        for device in ("cpu", "cuda"):
            m = copy.deepcopy(base).to(device).eval()
            with torch.no_grad():
                logits[device] = m.backbone(x.to(device).permute(0, 3, 1, 2)).cpu()
        err = max_rel_err(logits["cuda"], logits["cpu"])
        out[name] = {"subtype": inspect.signature(type(base.backbone)).parameters[
                         "subtype"].default,
                     "params_m": sum(p.numel() for p in base.parameters()) / 1e6,
                     "amp_step_ms_bs64": ms, "amp_images_per_s": BACKBONE_BATCH / ms * 1e3,
                     "amp_max_memory_allocated_gb": peak, "eval_logits_card_vs_cpu": err}
        print(f"{name} under Classification at {BACKBONE_HW}²: {json.dumps(out[name])}",
              flush=True)
        if not err <= 1e-4:
            raise AssertionError(f"{name} eval logits card vs CPU: {err}")
    return out


def attentions_card_vs_cpu() -> dict:
    """Each attention block at (2, 64, 32, 32) on the card and on the CPU
    (f32, one seeded set of weights): outputs within 1e-5 of their largest
    value."""
    import copy

    import torch

    from cvpytorch_tpu_torch.models import attentions as att

    blocks = {"SEAttention": att.SEAttention(64), "cSEBlock": att.cSEBlock(64),
              "sSEBlock": att.sSEBlock(64), "scSEBlock": att.scSEBlock(64),
              "SimAM": att.SimAM(), "ChannelAttentionModule": att.ChannelAttentionModule(64),
              "SpatialAttentionModule": att.SpatialAttentionModule(), "CBAM": att.CBAM(64),
              "ECAAttention": att.ECAAttention()}
    x = torch.randn(2, 64, 32, 32, generator=torch.Generator().manual_seed(0))
    out = {}
    for name, block in blocks.items():
        with torch.no_grad():
            cpu = block(x)
            card = copy.deepcopy(block).cuda()(x.cuda()).cpu()
        out[name] = max_rel_err(card, cpu)
    print(f"attentions card vs CPU: {json.dumps(out)}", flush=True)
    if not max(out.values()) <= 1e-5:
        raise AssertionError(f"attentions card vs CPU: {out}")
    return out


def randaugment_timing(items: int = 8) -> dict:
    """The seg ``RandAugment`` (all fourteen operations, 2 a sample,
    magnitude 0.5) on one host thread at 512×1024, ms per item."""
    import random

    from cvpytorch_tpu_torch.data.transforms import seg_transforms as seg

    rng = np.random.RandomState(0)
    h, w = RANDAUG_FRAME
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = rng.randint(0, 19, (h, w)).astype(np.uint8)
    transform = seg.RandAugment(ops="full", n_ops=2, magnitude=0.5)
    random.seed(0)
    t0 = time.perf_counter()
    for _ in range(items):
        transform({"image": img, "target": mask})
    out = {"frame": [h, w], "item_ms": (time.perf_counter() - t0) * 1e3 / items}
    print(f"RandAugment host ms, one thread: {json.dumps(out)}", flush=True)
    return out


def slice16_phases(workdir: Path, card: str) -> tuple[dict, tuple]:
    """Full-width YOLOv5-s at 640²: ``Trainer.run()`` of one epoch of 3
    steps at bs32 with AMP, ``AMP_BN_BF16_STATS`` and ``PROFILER`` on step
    1 (its Chrome trace must hold CUDA kernel events of that step); the
    AMP step with the BN moments in bfloat16 and in float32; the
    checkpoint exported without and with ``--fuse`` at bs32 and bs1 and
    served from the loaded programs (``exported_serving``); PTQ and
    ``precise_bn`` card vs CPU; ``model_summary``.  Then the seven
    backbones, the attentions and RandAugment's host ms.  Returns every
    record and the exported path's NMS input."""
    import torch

    from cvpytorch_tpu_torch import trainer as trainer_mod
    from cvpytorch_tpu_torch.config import CommonConfiguration
    from cvpytorch_tpu_torch.utils.summary import format_summary, model_summary

    workdir.mkdir(parents=True)
    setting = slice16_config(workdir)
    torch.cuda.empty_cache()
    trainer = trainer_mod.Trainer(CommonConfiguration.from_file(str(setting)))
    if not all(m.bf16_stats for m in trainer.model.modules() if hasattr(m, "bf16_stats")):
        raise AssertionError("AMP_BN_BF16_STATS left a BN in float32")
    zero_class_biases(trainer.model)  # so that the served batch holds detections
    run = run_instrumented(trainer, trainer_mod)
    state = run["state"]
    losses = [float(m["loss"]) for m in run["metrics"]]
    if len(losses) != SLICE16_STEPS or state.step != SLICE16_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"slice16 Trainer.run(): losses {losses}, step {state.step}")
    trace = trace_kernels(trainer.trace_path)
    if trace["steps"] != ["train_step_1"] or trace["kernel_events"] == 0:
        raise AssertionError(f"the PROFILER trace holds {trace}")
    out = {"run": {"steps": SLICE16_STEPS, "losses": losses, "run_s": run["run_s"],
                   "launches": run["launches"], "trace": trace}}
    print(f"YOLOv5-s Trainer.run() with AMP_BN_BF16_STATS and PROFILER: {json.dumps(out['run'])}",
          flush=True)
    batch = trainer._device_aug_preprocess()(raw_train_batch(trainer))
    out["bn_stats_timing"] = bn_stats_timing(trainer, batch)
    print(json.dumps({"slice16_bn_stats_timing": out["bn_stats_timing"], "card": card}),
          flush=True)
    mark("slice16 train")
    ckpt = Path(trainer.checkpoints.save_dir) / "last.pt"
    out["exported"], nms_input = exported_serving(workdir, setting, ckpt, trainer, state)
    print(json.dumps({"slice16_exported": out["exported"], "card": card}), flush=True)
    mark("slice16 exports")
    images, _ = infer_batch(trainer, 2)
    out["ptq"] = ptq_card_vs_cpu(state, images)
    out["precise_bn"] = precise_bn_card_vs_cpu(state, batch)
    summary = model_summary(state.ema, (1, 640, 640, 3))
    print(format_summary(summary, "YOLOv5-s (EMA)"), flush=True)
    out["summary"] = {k: summary[k] for k in ("total_params", "params_by_module", "flops",
                                              "flops_basis")}
    del trainer, state
    mark("slice16 ptq, precise_bn, summary")
    out["backbones"] = backbones_phase()
    mark("slice16 backbones")
    out["attentions"] = attentions_card_vs_cpu()
    out["randaugment"] = randaugment_timing()
    mark("slice16 attentions, randaugment")
    return out, nms_input


def letterbox_timing(n: int = 20) -> dict:
    """Host ms of one letterbox on one thread, the OpenCV-exact
    ``imgproc.resize_linear`` that the port's ``Resize`` runs against a
    ``torch.nn.functional.interpolate`` bilinear resize of the same shape
    (what the letterbox ran before it equalled OpenCV), on the same
    frames: 640² to 320² (YOLOv5's DEVICE_AUG tile, an exact half) and
    427×640 to 214×320 (NanoDet-Plus)."""
    import torch
    import torch.nn.functional as F

    from cvpytorch_tpu_torch.data.transforms.det_transforms import Resize

    def interpolate(img, oh, ow):
        x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
        y = F.interpolate(x.float(), size=(oh, ow), mode="bilinear", align_corners=False)
        return y.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0).contiguous().numpy()

    out = {}
    rng = np.random.RandomState(0)
    threads = torch.get_num_threads()
    with torch.inference_mode():
        torch.set_num_threads(1)
        try:
            for (h, w), size in (((640, 640), 320), ((427, 640), 320)):
                frame = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                resize = Resize((size, size))
                scale = min(size / h, size / w)
                oh, ow = int(round(h * scale)), int(round(w * scale))
                times = {}
                for name, fn in (("letterbox_resize_linear", lambda: resize({"image": frame})),
                                 ("interpolate", lambda: interpolate(frame, oh, ow))):
                    fn()
                    t0 = time.perf_counter()
                    for _ in range(n):
                        fn()
                    times[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / n
                out[f"{h}x{w}_to_{oh}x{ow}"] = times
        finally:
            torch.set_num_threads(threads)
    print(f"letterbox host ms, one thread: {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of data_parallel_phase's torchrun
        return dp_rank_main(*sys.argv[2:8])
    from cvpytorch_tpu_torch.ops import nms_kernel  # raises outside the repo
    from cvpytorch_tpu_torch.train_state import make_train_step

    print("TF32: turned off by the port's step makers (predict, train, eval) "
          "and off in every comparison (cudnn.allow_tf32=False, "
          "cuda.matmul.allow_tf32=False); cuDNN's on only for "
          "bs32_images_per_s_tf32_convs")
    card = gpu_name_and_power()
    print(f"build nms_kernel: {build_kernels():.2f} s "
          f"({nms_kernel.library_path().name}); -Xptxas -v:", flush=True)
    print(nms_kernel.build_log().strip(), flush=True)
    decode = image_decode_phase()
    print(json.dumps({"image_decode": decode, "card": card}), flush=True)
    times = kernel_timing()
    mark("build, image_decode, kernel_timing")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        from cvpytorch_tpu_torch.config import load_dictionary

        _, coco_dictionary = load_dictionary(str(ROOT / "conf" / "dicts" / "coco_dict.yml"),
                                             "DET_CLASSES")
        coco = write_coco_dir(Path(tmp) / "coco", coco_dictionary)
        path, path_input = path_phase(Path(tmp))
        print(json.dumps({"path": path, "card": card}))
        train, trainer = train_phase(Path(tmp) / "train")
        print(json.dumps({"train": train, "card": card}))
        timing, aug_batch = train_timing(trainer)
        print(json.dumps({"train_timing": timing, "card": card}))
        # the OpenCV-exact letterbox against the interpolate resize it
        # replaced, beside the YOLOv5 loader rate it feeds
        print(json.dumps({"letterbox_host_ms_one_thread": letterbox_timing(),
                          "yolov5_host_loader_images_per_s": timing["host_loader_images_per_s"],
                          "card": card}), flush=True)
        check = train_step_check(trainer, aug_batch)
        print(json.dumps({"train_step_check": check, "card": card}))
        mark("path, train")
        torch.cuda.empty_cache()
        dp = data_parallel_phase(Path(tmp) / "data_parallel", card)
        print(json.dumps({"data_parallel": dp}), flush=True)
        mark("data_parallel")
        torch.cuda.empty_cache()
        mrcnn, mrcnn_trainer = maskrcnn_phase(Path(tmp) / "maskrcnn")
        print(json.dumps({"maskrcnn": mrcnn, "card": card}), flush=True)
        mrcnn_batches = {stage: loader_batch(mrcnn_trainer, stage, MASKRCNN_BATCH)
                         for stage in ("train", "val")}
        mrcnn_timing, mrcnn_extra = maskrcnn_timing(mrcnn_trainer, mrcnn_batches)
        print(json.dumps({"maskrcnn_timing": mrcnn_timing, "card": card}), flush=True)
        mrcnn_check = maskrcnn_card_vs_cpu(mrcnn_trainer, mrcnn_batches)
        print(json.dumps({"maskrcnn_card_vs_cpu": mrcnn_check, "card": card}), flush=True)
        coco_segm = coco_segm_check(mrcnn_trainer, coco, Path(tmp) / "coco_segm")
        print(json.dumps({"maskrcnn_coco_segm_val": coco_segm, "card": card}), flush=True)
        mark("maskrcnn")
        seg = {}
        for name in SEG_BATCH:
            torch.cuda.empty_cache()
            result, seg_trainer = seg_phase(Path(tmp) / f"seg_{name}", name)
            print(json.dumps({name: result, "card": card}), flush=True)
            if name in SEG_UNTIMED:
                seg[name] = {"result": result}
                del seg_trainer
                mark(name)
                continue
            steps_timed, states, batches = milestone_timing(
                seg_trainer, SEG_BATCH[name], None, iters=2,
                ema_decay=SEG_EMA.get(name, 0.0), amp_only=name in SEG_AMP_ONLY)
            if name in SEG_COUNT_FLOPS:
                step = make_train_step(amp=True, ema_decay=SEG_EMA.get(name, 0.0))
                tflop = step_tflop(lambda: step(states["train"], batches["train"]))
                steps_timed["amp_step_tflop_counted"] = tflop
                steps_timed["amp_achieved_tflop_per_s"] = tflop / steps_timed["amp_step_ms"] * 1e3
            if name == "incepformer_t":  # the AMP peak beside what the logits take
                steps_timed["stage1_attention_logits_gb_per_block"] = \
                    incepformer_logits_gb(seg_trainer.model, batches["train"]["image"])
            print(json.dumps({f"{name}_timing": steps_timed, "card": card}), flush=True)
            if name == "deeplabv3plus":  # the configs share the host pipelines
                print(json.dumps({"seg_host_timing": host_pipeline_timing(seg_trainer),
                                  "card": card}), flush=True)
            if name in SEG_CARD_VS_CPU:
                print(json.dumps({f"{name}_card_vs_cpu": seg_card_vs_cpu(
                    seg_trainer, batches, SEG_CARD_VS_CPU[name]), "card": card}), flush=True)
            seg[name] = {"result": result, "timing": steps_timed}
            del seg_trainer, states
            mark(name)
        torch.cuda.empty_cache()
        layouts = dataset_layouts_phase(Path(tmp) / "layouts")
        print(json.dumps({"dataset_layouts": layouts, "card": card}), flush=True)
        mark("dataset_layouts")
        torch.cuda.empty_cache()
        cls, cls_trainer = cls_phase(Path(tmp) / "cls")
        print(json.dumps({"cls": cls, "card": card}), flush=True)
        cls_timed, cls_states, cls_batches = milestone_timing(
            cls_trainer, CLS_BATCH, CLS_MILESTONE_BATCH, iters=5, amp_only=True)
        print(json.dumps({"cls_timing": cls_timed, "card": card}), flush=True)
        print(json.dumps({"cls_host_timing": host_pipeline_timing(cls_trainer, n_items=4),
                          "card": card}), flush=True)
        print(json.dumps({"cls_card_vs_cpu": cls_card_vs_cpu(cls_trainer, cls_batches),
                          "card": card}), flush=True)
        print(json.dumps({"cls_jpeg_loader": cls_loader_check(Path(tmp)), "card": card}),
              flush=True)
        del cls_trainer, cls_states, cls_batches  # timed, not profiled
        mark("cls")
        torch.cuda.empty_cache()
        nanodet, nd_trainer = nanodet_phase(Path(tmp) / "nanodet")
        print(json.dumps({"nanodet": nanodet, "card": card}), flush=True)
        nd_timed, nd_states, nd_batches = milestone_timing(
            nd_trainer, NANODET_BATCH, NANODET_MILESTONE_BATCH, iters=3, ema_decay=0.9999,
            amp_only=True)
        nd_state = nd_states["train"]
        nd_timed["dsl_assign"] = dsl_timing(nd_state, nd_batches["train"])
        print(json.dumps({"nanodet_timing": nd_timed, "card": card}), flush=True)
        nd_nms, nd_input = val_nms_input(nd_state, nd_batches["val"], "NanoDet-Plus")
        print(json.dumps({"nanodet_host_timing": host_pipeline_timing(nd_trainer, n_items=4),
                          "card": card}), flush=True)
        print(json.dumps({"nanodet_card_vs_cpu": nanodet_card_vs_cpu(nd_trainer, nd_batches),
                          "card": card}), flush=True)
        del nd_trainer, nd_state, nd_states, nd_batches  # timed, not profiled
        mark("nanodet")
        torch.cuda.empty_cache()
        ndv1, ndv1_trainer = nanodet_v1_phase(Path(tmp) / "nanodet_v1", coco)
        print(json.dumps({"nanodet_v1": ndv1, "card": card}), flush=True)
        ndv1_timed, ndv1_states, ndv1_batches = milestone_timing(
            ndv1_trainer, NANODET_V1_BATCH, None, iters=3, ema_decay=0.9999, amp_only=True)
        ndv1_timed["atss_assign"] = atss_timing(ndv1_states["train"], ndv1_batches["train"])
        print(json.dumps({"nanodet_v1_timing": ndv1_timed, "card": card}), flush=True)
        ndv1_nms, ndv1_input = val_nms_input(ndv1_states["train"], ndv1_batches["val"],
                                             "NanoDet v1")
        print(json.dumps({"nanodet_v1_card_vs_cpu": nanodet_v1_card_vs_cpu(
            ndv1_trainer, ndv1_batches), "card": card}), flush=True)
        del ndv1_trainer, ndv1_states, ndv1_batches  # timed, not profiled
        mark("nanodet_v1")
        torch.cuda.empty_cache()
        v6, v6_trainer = yolov6_phase(Path(tmp) / "yolov6", coco)
        print(json.dumps({"yolov6_s": v6, "card": card}), flush=True)
        v6_timed, v6_states, v6_batches = yolov6_timing(v6_trainer)
        print(json.dumps({"yolov6_s_timing": v6_timed, "card": card}), flush=True)
        v6_nms, v6_input = val_nms_input(v6_states["train"], v6_batches["val"], "YOLOv6-s")
        print(json.dumps({"yolov6_s_card_vs_cpu": yolov6_card_vs_cpu(v6_trainer, v6_batches),
                          "card": card}), flush=True)
        del v6_trainer, v6_states, v6_batches  # timed, not profiled
        mark("yolov6_s")
        one_step = {}
        for name in ONE_STEP_CONFIGS:
            torch.cuda.empty_cache()
            one_step[name] = one_step_run(Path(tmp) / name, name, coco)
            mark(name)
        # slice 13: YOLOX-s, YOLOv7-l, FCOS-R50, then the slice's other configs
        s13, s13_later = slice13_phases(Path(tmp) / "slice13", coco, card)
        # slice 14: EfficientDet-D0, AIRDet-s, the slice's other configs, NAS-FPN and RFP
        s14, s14_later = slice14_phases(Path(tmp) / "slice14", coco, card)
        # slice 15: OpenPose, LitePose, SimplePose and the optimizer rules
        s15, _ = slice15_phases(Path(tmp) / "slice15", card)
        # the host-augmented YOLOv5 path after the other phases
        torch.cuda.empty_cache()
        host_aug, ha_trainer = host_aug_phase(Path(tmp) / "host_aug", coco)
        print(json.dumps({"yolov5_host_aug": host_aug, "card": card}), flush=True)
        ha_timing = host_aug_timing(ha_trainer)
        print(json.dumps({"yolov5_host_aug_timing": ha_timing, "card": card}), flush=True)
        item = ha_timing["host_train_item_ms_one_thread"]
        print(f"YOLOv5-s 640 bs32 fed rate on {card}: host augmentation from JPEG files "
              f"{host_aug['fed_images_per_s']:.1f} img/s (train epoch "
              f"{host_aug['train_epoch_s']:.2f} s), device augmentation "
              f"{train['fed_images_per_s_epoch2']:.1f} img/s; host loader "
              f"{ha_timing['host_loader_images_per_s']:.1f} img/s with "
              f"{ha_timing['loader_threads']} threads; one item on one thread "
              f"{item['item_total']:.1f} ms (4 JPEG decodes "
              f"{item['load_group_of_4_jpeg_decodes']:.1f} ms, the rest of the load "
              f"{item['load_group_of_4_rest']:.1f} ms, transforms "
              f"{item['item_total'] - item['load_group_of_4']:.1f} ms); AMP step on a host "
              f"batch {ha_timing['amp_step_ms']:.2f} ms", flush=True)
        del ha_trainer
        torch.cuda.empty_cache()
        mark("yolov5_host_aug")
        # slice 16: YOLOv5-s exported and served, PTQ, precise BN, the summary,
        # the seven backbones, the attentions and RandAugment
        s16, s16_input = slice16_phases(Path(tmp) / "slice16", card)
        torch.cuda.empty_cache()
        checks = kernel_checks()
        mark("kernel_checks")
        # the profiler last: its sessions slow the host's launches afterwards
        split = device_phase({**times.pop("inputs"), "path_input": path_input,
                              "nanodet_val_input": nd_input,
                              "nanodet_v1_val_input": ndv1_input,
                              "yolov6_val_input": v6_input,
                              **{f"{key}_val_input": run["nms_input"]
                                 for key, run in {**s13_later, **s14_later}.items()},
                              "yolov5_exported_input": s16_input})
        mark("device_phase")
        train_step_fn = _profiled_train_state(trainer)
        train_profile = profile_device(train_step_fn, top=15)
        # the idle share against the step's wall without the profiler: the
        # AMP step and the device augmentation, each timed by CUDA events
        # before any profiler session
        train_profile["device_idle_share_unprofiled"] = 1 - train_profile[
            "device_busy_ms"] / (timing["amp_step_ms"] + timing["device_aug_ms"])
        print(json.dumps({"amp_train_step_profile": train_profile, "card": card}),
              flush=True)
        mrcnn_split = {name: nms_device_ms(*args)
                       for name, args in mrcnn_extra["inputs"].items()}
        mrcnn_step = make_train_step(amp=True)
        mrcnn_profile = profile_device(
            lambda: mrcnn_step(mrcnn_extra["state"], mrcnn_batches["train"]),
            top=15, groups=ROI_GROUPS)
        mrcnn_profile["device_idle_share_unprofiled"] = 1 - mrcnn_profile[
            "device_busy_ms"] / mrcnn_timing["amp_step_ms"]
        print(json.dumps({"maskrcnn_amp_train_step_profile": mrcnn_profile,
                          "nms_keep_device_ms": mrcnn_split, "card": card}), flush=True)
        mark("yolov5 and maskrcnn profiles")
        # the assigners' ranges: YOLOX-s's SimOTA only; the AIRDet-s,
        # EfficientDet-D0 and OpenPose sessions are left for the run's time
        # limit (PERF.md §5 keeps their last readings)
        run = s13_later["yolox_s"]
        prof = assigner_range_profile(run["state"], run["batch"], run["amp_ms"],
                                      "simota_assign")
        print(json.dumps({"yolox_s_amp_train_step_profile": prof, "card": card}), flush=True)
        s13["yolox_s"]["profile"] = {k: prof[k] for k in (
            "device_busy_ms", "device_idle_share", "device_idle_share_unprofiled",
            "simota_assign_share_of_busy")}
    mark("assigner profiles")
    bound, bound_by = nms_bound_ms(BATCH, 1024)
    bound1, _ = nms_bound_ms(1, 1024)
    print(json.dumps({"nms_keep_B1_K1024": {**times["B1"], **split["B1"],
                                             "bound_ms": bound1}}))
    mrcnn_nms = mrcnn_extra["nms"]
    for name, t in mrcnn_nms.items():
        t["bound_ms"], _ = nms_bound_ms(*t["shape"][:2])
        t.update(mrcnn_split[name])
    nd_nms["bound_ms"], _ = nms_bound_ms(*nd_nms["shape"][:2])
    nd_nms["bound_ms_milestone_B128"], _ = nms_bound_ms(NANODET_MILESTONE_BATCH, 1024)
    nd_nms.update(split["nanodet_val_input"])
    for record, B, key in ((ndv1_nms, NANODET_V1_BATCH, "nanodet_v1_val_input"),
                           (v6_nms, YOLOV6_BATCH, "yolov6_val_input"),
                           *((phase[k]["nms"], phase[k]["nms"]["shape"][0], f"{k}_val_input")
                             for phase, later in ((s13, s13_later), (s14, s14_later))
                             for k in later)):
        record["bound_ms"], _ = nms_bound_ms(B, 1024)
        record.update(split[key])
    exported = s16["exported"]
    exported_nms = {"shape": list(s16_input[0].shape), "thr": s16_input[1],
                    **exported["nms_keep_op_on_path_input"],
                    "route": "torch.ops.cvt.nms_keep",
                    "ms": exported["nms_keep_op_on_path_input_ms"],
                    "ms_direct_call": exported["nms_keep_direct_on_path_input_ms"],
                    "plain_ms": exported["nms_keep_plain_on_path_input_ms"],
                    "bound_ms": nms_bound_ms(*s16_input[0].shape[:2])[0],
                    **split["yolov5_exported_input"]}
    # each path's main run: the count set to 0 just before and read just after
    by_path = {"infer": path["launches"], "train": train["launches"],
               "yolov5_host_aug_train_and_val": host_aug["launches"],
               "yolov5_host_aug_served": host_aug["served_launches"],
               "maskrcnn_train_and_val": mrcnn["launches"],
               "maskrcnn_coco_segm_val": coco_segm["launches"],
               **{f"{name}_train_and_val": run["result"]["nms_keep_launches"]
                  for name, run in seg.items()},
               **{f"{name}_train_and_val": run["launches"] for name, run in layouts.items()},
               "cls_train_and_val": cls["nms_keep_launches"],
               "nanodet_train_and_val": nanodet["launches"],
               "nanodet_served": nanodet["served_launches"],
               "nanodet_v1_train_and_val": ndv1["launches"],
               "nanodet_v1_served": ndv1["served_launches"],
               "yolov6_s_train_and_val": v6["launches"],
               "yolov6_s_served": v6["served_launches"],
               **{f"{name}_train_and_val": run["launches"] for name, run in one_step.items()},
               **{f"{key}_train_and_val": s13[key]["run"]["launches"] for key in s13_later},
               **{f"{key}_served": s13[key]["run"]["served_launches"] for key in s13_later
                  if "served_launches" in s13[key]["run"]},
               **{f"{name}_train_and_val": run["launches"]
                  for name, run in s13["one_step"].items()},
               **{f"{key}_train_and_val": s14[key]["run"]["launches"] for key in s14_later},
               **{f"{key}_served": s14[key]["run"]["served_launches"] for key in s14_later},
               **{f"{name}_train_and_val": run["launches"]
                  for name, run in s14["one_step"].items()},
               "openpose_train_and_val": s15["openpose"]["run"]["launches"],
               "openpose_served": s15["openpose"]["run"]["served_launches"],
               "litepose_steps_val_and_served": s15["litepose"]["launches"],
               "slice16_train": s16["run"]["launches"],
               **{f"data_parallel_rank{r}_train_and_val": n
                  for r, n in enumerate(dp["launches_by_rank"])},
               "data_parallel_nccl_one_rank_train_and_val": dp["nccl_one_rank"]["launches"],
               **{f"tensor_parallel_rank{r}_train_and_val": n
                  for r, n in enumerate(dp["tensor_parallel"]["launches_by_rank"])},
               "tensor_parallel_served": dp["tensor_parallel"]["served_launches"],
               "yolov5_exported_served": s16["exported"]["launches"]}
    print(json.dumps({"kernels": [{
        "name": "nms_keep",
        "route": "cuda",
        "source": "cvpytorch_tpu_torch/csrc/nms_kernel.cu",
        "replaces": "cvpytorch_tpu/ops/pallas/nms_kernel.py:23",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": checks["max_abs_err"],
        "ms": times["B32"]["ms"],
        "plain_ms": times["B32"]["plain_ms"],
        "bound_ms": bound,
        "bound_by": bound_by,
        # no single PyTorch call computes greedy NMS here (no torchvision)
        "library_ms": None,
        "device_kernels_per_call": split["B32"]["device_kernels_per_call"],
        "bit_exact_cases": checks["cases"],
        "ms_B1": times["B1"]["ms"],
        "plain_ms_B1": times["B1"]["plain_ms"],
        "bound_ms_B1": bound1,
        "ms_dense": times["dense"]["ms"],
        "ms_path_input": path["nms_keep_on_path_input_ms"],
        "device_ms_by_kernel": split,
        "maskrcnn_path_inputs": mrcnn_nms,
        "nanodet_path_input": nd_nms,
        "nanodet_v1_path_input": ndv1_nms,
        "yolov6_s_path_input": v6_nms,
        "one_step_val_inputs": {name: run["val_nms_input"] for name, run in {
            **one_step, **s13["one_step"], **s14["one_step"]}.items()},
        **{f"{key}_path_input": s13[key]["nms"] for key in s13_later},
        **{f"{key}_path_input": s14[key]["nms"] for key in s14_later},
        "dataset_layout_path_inputs": {name: run["nms_inputs"] for name, run in layouts.items()
                                       if run["nms_inputs"]},
        "yolov5_exported_path_input": exported_nms,
        "data_parallel_rank_inputs": [{**r, "bound_ms": nms_bound_ms(*r["shape"][:2])[0]}
                                      for r in dp["nms_rank_inputs"]],
        "tensor_parallel_rank_inputs": [{**r, "bound_ms": nms_bound_ms(*r["shape"][:2])[0]}
                                        for r in dp["tensor_parallel"]["nms_rank_inputs"]],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
