"""YOLOv5 loss (counterpart of ``cvpytorch_tpu/models/losses/yolov5_loss.py``).

Fixed shapes, as in the JAX package: every (target m, anchor a, offset o)
triple is a candidate positive of static shape (B, M·A·5) with a validity
weight

  w = target_valid ∧ (max(wh/anchor, anchor/wh) < anchor_t) ∧ offset_valid

where the offsets are the centre cell and its two nearest neighbours
(``_OFFSETS``, g = 0.5).  The candidates' predictions are one gather of the
packed (A·no)-wide cell rows per level; box and class losses are
validity-weighted means over the whole batch (n_pos = max(Σw, 1)), and the
objectness target is a scatter-max of the detached, clipped CIoU
(``scatter_reduce(..., "amax")``, exact because every score is ≥ 0).
Level balance (4, 1, 0.4); the total is scaled by the batch size.

Under data parallelism (``parallel.dist``) the normalisers are the global
batch's: n_pos is summed over the data group, the objectness mean divides
by the global B·S·A and the total is scaled by the global B, so the data
ranks' losses (and each term) sum to the loss of the global batch.

Runs in float32 on whatever raw maps it is given; the caller casts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.boxes import bbox_iou
from ...parallel import dist as dp
from ...registry import LOSSES

_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))
G = 0.5  # cell-offset reach


def sigmoid_binary_cross_entropy(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``, op for op."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _build_level_targets(boxes, valid, anchors, nx: int, ny: int,
                         anchor_t: float):
    """boxes (B,M,4) cxcywh normalised; anchors (A,2) grid units.

    Returns per-candidate tensors over P = M·A·5 in (m, a, o) order:
    ``cell`` (B, M·5) row index, ``flat_cell`` (B,P) = cell·A + a,
    ``txy``/``twh``/``anchor_wh`` (B,P,2) and the weight ``w`` (B,P)."""
    B, M, _ = boxes.shape
    A = anchors.shape[0]
    scale = torch.tensor([nx, ny], dtype=torch.float32, device=boxes.device)
    gxy = boxes[..., 0:2] * scale  # (B,M,2)
    gwh = boxes[..., 2:4] * scale

    r = gwh[:, :, None, :] / anchors[None, None, :, :]  # (B,M,A,2)
    match = torch.maximum(r, 1.0 / r).amax(-1) < anchor_t  # (B,M,A)

    gx, gy = gxy[..., 0], gxy[..., 1]
    ix, iy = nx - gx, ny - gy
    off_ok = torch.stack([
        torch.ones_like(gx, dtype=torch.bool),
        (torch.remainder(gx, 1.0) < G) & (gx > 1.0),
        (torch.remainder(gy, 1.0) < G) & (gy > 1.0),
        (torch.remainder(ix, 1.0) < G) & (ix > 1.0),
        (torch.remainder(iy, 1.0) < G) & (iy > 1.0),
    ], -1)  # (B,M,5)

    w = (valid[:, :, None, None] & match[:, :, :, None]
         & off_ok[:, :, None, :]).to(torch.float32)  # (B,M,A,5)

    offsets = torch.tensor(_OFFSETS, dtype=torch.float32, device=boxes.device)
    gij = torch.floor(gxy[:, :, None, :] - offsets[None, None])  # (B,M,5,2)
    gi = gij[..., 0].clamp(0, nx - 1)
    gj = gij[..., 1].clamp(0, ny - 1)
    txy = gxy[:, :, None, :] - torch.stack([gi, gj], -1)  # (B,M,5,2)

    def bx(x, extra=()):  # (B,M,5,…) → (B,M,A,5,…)
        return x[:, :, None].expand(B, M, A, 5, *extra)

    P = M * A * 5
    cell = gj.to(torch.int64) * nx + gi.to(torch.int64)  # (B,M,5)
    a_idx = torch.arange(A, device=boxes.device)[None, None, :, None]
    return {
        "cell": cell.reshape(B, M * 5),
        "flat_cell": (bx(cell) * A + a_idx).reshape(B, P),
        "txy": bx(txy, (2,)).reshape(B, P, 2),
        "twh": gwh[:, :, None, None, :].expand(B, M, A, 5, 2).reshape(B, P, 2),
        "anchor_wh": anchors[None, None, :, None, :].expand(
            B, M, A, 5, 2).reshape(B, P, 2),
        "w": w.reshape(B, P),
    }


@LOSSES.register(name="YOLOv5Loss")
class YOLOv5Loss:
    def __init__(self, num_classes: int, anchors, strides=(8.0, 16.0, 32.0),
                 hyp_box: float = 0.05, hyp_obj: float = 1.0,
                 hyp_cls: float = 0.5, anchor_t: float = 4.0,
                 label_smoothing: float = 0.0, **_):
        self.num_classes = num_classes
        self.anchors = tuple(tuple(tuple(a) for a in lvl) for lvl in anchors)
        self.strides = tuple(strides)
        self.hyp_box, self.hyp_obj, self.hyp_cls = hyp_box, hyp_obj, hyp_cls
        self.anchor_t = anchor_t
        self.balance = {3: (4.0, 1.0, 0.4)}.get(
            len(self.anchors), (4.0, 1.0, 0.25, 0.06, 0.02))
        eps = label_smoothing
        self.cp, self.cn = 1.0 - 0.5 * eps, 0.5 * eps

    def __call__(self, raw_outs, targets):
        """raw_outs: list of (B, ny, nx, A, 5+C) float32.
        targets: {'boxes': (B,M,4) cxcywh normalised, 'labels': (B,M) int,
                  'valid': (B,M) bool}."""
        boxes, labels = targets["boxes"], targets["labels"]
        valid = targets["valid"]
        B, M = boxes.shape[:2]
        split = dp.reductions_active()  # this rank's share of a global batch
        B_global = dp.global_batch(B)
        lbox = lobj = lcls = 0.0
        for i, pi in enumerate(raw_outs):
            _, ny, nx, A, no = pi.shape
            anchors = torch.tensor(self.anchors[i], dtype=torch.float32,
                                   device=pi.device)
            t = _build_level_targets(boxes, valid, anchors, nx, ny,
                                     self.anchor_t)
            # the packed (B, S, A·no) view of the level: candidates are one
            # gather of M·5 whole cell rows, objectness a strided slice
            S = ny * nx
            pk = pi.reshape(B, S, A * no)
            rows = torch.gather(pk, 1, t["cell"][..., None].expand(B, M * 5, A * no))
            ps = rows.reshape(B, M, 5, A, no).transpose(2, 3).reshape(B, M * A * 5, no)
            w = t["w"]
            n_pos = dp.global_sum(w.sum()).clamp(min=1.0)

            # box: CIoU in grid units, cxcywh
            pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * t["anchor_wh"]
            pbox = torch.cat([pxy, pwh], -1)
            tbox = torch.cat([t["txy"], t["twh"]], -1)
            iou = bbox_iou(pbox, tbox, fmt="cxcywh", iou_type="ciou")  # (B,P)
            lbox = lbox + ((1.0 - iou) * w).sum() / n_pos

            # objectness: scatter-max of the detached IoU into the cell grid
            # (flat index s·A + a == flat_cell)
            obj_logits = pk[..., 4::no].reshape(B, S * A)
            score = iou.detach().clamp(min=0.0) * w
            tobj = torch.zeros(B, S * A, dtype=score.dtype, device=score.device)
            tobj = tobj.scatter_reduce(1, t["flat_cell"], score, "amax",
                                       include_self=True)
            obj_bce = sigmoid_binary_cross_entropy(obj_logits, tobj)
            obj_mean = (obj_bce.sum() / (B_global * S * A)) if split else obj_bce.mean()
            lobj = lobj + obj_mean * self.balance[i]

            if self.num_classes > 1:
                tcls = torch.where(valid, labels, 0)  # (B,M)
                cls_flat = tcls[:, :, None, None].expand(B, M, A, 5).reshape(B, -1)
                onehot = (F.one_hot(cls_flat.long(), self.num_classes)
                          .to(torch.float32) * (self.cp - self.cn) + self.cn)
                cls_bce = sigmoid_binary_cross_entropy(ps[..., 5:], onehot)
                lcls = lcls + (cls_bce * w[..., None]).sum() / (
                    n_pos * self.num_classes)

        lbox = lbox * self.hyp_box
        lobj = lobj * self.hyp_obj
        lcls = lcls * self.hyp_cls
        total = (lbox + lobj + lcls) * B_global  # scaled by the batch, as in JAX
        return total, {"box_loss": lbox, "obj_loss": lobj, "cls_loss": lcls}
