"""Batched class-aware NMS (counterpart of ``cvpytorch_tpu/ops/nms.py``).

Fixed-shape, like the JAX design: confidence filtering is a top-k
pre-selection (``max_nms`` boxes), boxes are shifted by ``class_id * 4096``
so one suppression pass serves all classes, the greedy pass is
``nms_keep`` (the CUDA kernel for CUDA tensors, its plain version on the
CPU), and the output is padded to ``max_det`` with a validity mask.

``jax.lax.top_k`` and JAX's stable argsort put the lower index first among
equal scores; ``torch.topk`` promises no order among ties.  ``top_k``
below makes the order exact by ranking a composite integer key (the
float's order-preserving bits, then the reversed index), which has no ties.
"""
from __future__ import annotations

import torch

from .boxes import cxcywh_to_xyxy
from .nms_kernel import nms_keep

MAX_WH = 4096.0  # class-offset magnitude


def top_k(x: torch.Tensor, k: int):
    """Top-k over the last dim, descending, lower index first among equal
    values (the ``jax.lax.top_k`` order, which also ranks -0.0 below 0.0).
    ``x`` is float32 without NaN.  Returns (values, int64 indices)."""
    n = x.shape[-1]
    bits = x.view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # float order
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    key = ordered * (1 << 32) + (n - 1 - idx)  # distinct, fits in int64
    top_idx = key.topk(k, dim=-1).indices
    return x.gather(-1, top_idx), top_idx


def nms_keep_mask(boxes, scores, iou_threshold: float):
    """Greedy NMS over one image's candidates: boxes (K, 4) xyxy, scores
    (K,).  Returns the keep mask in score-descending order and that order."""
    order = torch.sort(-scores, stable=True).indices
    keep = nms_keep(boxes[order][None].contiguous(), iou_threshold)[0]
    return keep, order


def batched_nms(
    boxes,
    scores,
    labels,
    max_det: int = 300,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.001,
    max_nms: int = 1024,
    class_aware: bool = True,
):
    """Batched padded NMS.

    Args:
      boxes  (B, N, 4) xyxy in network pixels
      scores (B, N) confidence (obj*cls for YOLO)
      labels (B, N) int class ids
      class_aware: False suppresses across classes (the RPN's proposals)
    Returns dict with 'boxes' (B,max_det,4), 'scores', 'labels',
    'valid' (B,max_det) bool, 'num' (B,).  Scores and boxes are taken to
    float32 first (bf16 under autocast): ``top_k`` ranks float32 bits and
    the kernel reads float32 boxes.
    """
    B, N = scores.shape
    k = min(max_nms, N)
    scores = scores.float()
    boxes = boxes.float()
    sc = torch.where(scores >= score_threshold, scores, 0.0)
    top_sc, top_idx = top_k(sc, k)  # score-desc order
    top_bx = boxes.gather(1, top_idx[..., None].expand(B, k, 4))
    top_lb = labels.gather(1, top_idx)
    if class_aware:  # one suppression pass serves all classes
        shifted = top_bx + (top_lb.to(torch.float32) * MAX_WH)[..., None]
    else:
        shifted = top_bx
    keep = nms_keep(shifted.contiguous(), iou_threshold)
    final_sc = torch.where(keep & (top_sc > 0), top_sc, -1.0)
    if max_det > k:  # pad the candidate set so top_k(max_det) is valid
        pad = max_det - k
        final_sc = torch.nn.functional.pad(final_sc, (0, pad), value=-1.0)
        top_bx = torch.nn.functional.pad(top_bx, (0, 0, 0, pad))
        top_lb = torch.nn.functional.pad(top_lb, (0, pad))
    out_sc, out_idx = top_k(final_sc, max_det)
    valid = out_sc > 0
    out_bx = top_bx.gather(1, out_idx[..., None].expand(B, max_det, 4))
    out_lb = top_lb.gather(1, out_idx)
    return {
        "boxes": torch.where(valid[..., None], out_bx, 0.0),
        "scores": torch.where(valid, out_sc, 0.0),
        "labels": torch.where(valid, out_lb, -1),
        "valid": valid,
        "num": valid.sum(-1),
    }


def yolo_non_max_suppression(
    pred,
    num_classes: int,
    conf_threshold: float = 0.001,
    iou_threshold: float = 0.6,
    max_det: int = 300,
    max_nms: int = 1024,
    multi_label: bool = False,
):
    """YOLO-style NMS over decoded predictions.

    pred (B, N, 5+C): xywh(center) + obj + cls-probs in network pixels.
    multi_label=True makes every (box, class) pair a candidate: a top-k
    over the (N·C) score matrix taken to float32 (``top_k`` ranks float32
    bits; ``batched_nms`` takes the scores to float32 anyway), boxes
    gathered by idx // C.
    """
    boxes = cxcywh_to_xyxy(pred[..., :4])
    obj = pred[..., 4:5]
    cls_scores = pred[..., 5:5 + num_classes] * obj
    if multi_label:
        B, N, C = cls_scores.shape
        k = min(max_nms, N * C)
        scores, top_idx = top_k(cls_scores.reshape(B, N * C).float(), k)
        labels = top_idx % C
        box_idx = top_idx // C
        boxes = boxes.gather(1, box_idx[..., None].expand(B, k, 4))
    else:
        scores, labels = cls_scores.max(-1)
    return batched_nms(
        boxes, scores, labels,
        max_det=max_det, iou_threshold=iou_threshold,
        score_threshold=conf_threshold, max_nms=max_nms,
    )
