"""ObjectBox loss and decode (counterpart of
``cvpytorch_tpu/models/losses/objectbox_loss.py``).

ObjectBox regresses corner distances from the assigned cell: at level i
the prediction is d = (2·sigmoid(t))² · 2^i grid units for (dx1, dy1,
dx2, dy2), the box x1 = (gi + 1 − dx1)·s … y2 = (gj + dy2)·s.  Every gt is
a candidate at its centre cell on every level through nine cross-grid
offsets (centre, 4 sides, 4 corners, g = 0.5), with no anchor gating: the
candidates are a static (B, M·9) set with a validity weight.  The side
tests use the floor-mod ``%`` (``torch.remainder``) of the signed grid
coordinates, and the distance targets the unclamped ⌊gxy − offset⌋; the
gather index clamps.  Box quality is the SDIoU over the four distances,
the objectness target a scatter-max (``scatter_reduce`` "amax") of the
detached clamped SDIoU; level balance (4, 1, 0.4) and the total × B.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...registry import LOSSES
from .yolov5_loss import sigmoid_binary_cross_entropy

# center, j(x−), k(y−), l(x+), m(y+), jk, jm, lk, lm
_OB_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5),
               (0.5, 0.5), (0.5, -0.5), (-0.5, 0.5), (-0.5, -0.5))


def sd_iou(p, t, eps: float = 1e-9):
    """SDIoU over corner distances p, t (..., 4) = (dx1, dy1, dx2, dy2)."""
    s = ((t - p) ** 2).sum(-1)
    mn = torch.minimum(p, t)
    mx = torch.maximum(p, t)
    i = (mn[..., 0] + mn[..., 2] - 1.0) ** 2 + (mn[..., 1] + mn[..., 3] - 1.0) ** 2
    c = ((mx[..., 0] + mx[..., 2] - 1.0) ** 2 + (mx[..., 1] + mx[..., 3] - 1.0) ** 2) + eps
    return (i - s) / c


def _build_level_targets(boxes, valid, nx: int, ny: int):
    """boxes (B, M, 4) normalised cxcywh → per candidate (B, P = M·9): the
    flat cell index, the distance targets (B, P, 4) and the weight."""
    B, M, _ = boxes.shape
    scale = torch.tensor([nx, ny], dtype=torch.float32, device=boxes.device)
    gxy = boxes[..., 0:2] * scale
    half = boxes[..., 2:4] * scale / 2.0
    xmin, ymin = gxy[..., 0] - half[..., 0], gxy[..., 1] - half[..., 1]
    xmax, ymax = gxy[..., 0] + half[..., 0], gxy[..., 1] + half[..., 1]
    gx, gy = gxy[..., 0], gxy[..., 1]
    ix, iy = nx - gx, ny - gy
    g = 0.5
    j = (gx % 1.0 < g) & (gx > 1.0)
    k = (gy % 1.0 < g) & (gy > 1.0)
    l = (ix % 1.0 < g) & (ix > 1.0)  # noqa: E741
    m = (iy % 1.0 < g) & (iy > 1.0)
    off_ok = torch.stack([torch.ones_like(j), j, k, l, m, j & k, j & m, l & k, l & m], -1)
    w = (valid[:, :, None] & off_ok).to(boxes.dtype)
    offsets = torch.tensor(_OB_OFFSETS, dtype=torch.float32, device=boxes.device)
    gij = torch.floor(gxy[:, :, None, :] - offsets)
    gi, gj = gij[..., 0], gij[..., 1]  # unclamped: the distances use these
    tdist = torch.stack([gi + 1.0 - xmin[..., None], gj + 1.0 - ymin[..., None],
                         xmax[..., None] - gi, ymax[..., None] - gj], -1)
    flat_cell = gj.clamp(0, ny - 1).long() * nx + gi.clamp(0, nx - 1).long()
    P = M * 9
    return {"flat_cell": flat_cell.reshape(B, P), "tdist": tdist.reshape(B, P, 4),
            "w": w.reshape(B, P)}


@LOSSES.register(name="ObjectBoxLoss")
class ObjectBoxLoss:
    def __init__(self, num_classes: int, strides=(8.0, 16.0, 32.0), hyp_box: float = 0.05,
                 hyp_obj: float = 1.0, hyp_cls: float = 1.0, label_smoothing: float = 0.0,
                 **_):
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.hyp_box, self.hyp_obj, self.hyp_cls = hyp_box, hyp_obj, hyp_cls
        self.balance = {3: (4.0, 1.0, 0.4)}.get(len(self.strides), (4.0, 1.0, 0.25, 0.06, 0.02))
        eps = label_smoothing
        self.cp, self.cn = 1.0 - 0.5 * eps, 0.5 * eps

    def __call__(self, raw_outs, targets):
        """raw_outs: list of (B, ny, nx, 1, 5 + C); targets as YOLOv5Loss's
        (normalised cxcywh boxes)."""
        boxes, labels, valid = targets["boxes"], targets["labels"], targets["valid"]
        B, M = labels.shape
        lbox = lobj = lcls = 0.0
        for i, pi in enumerate(raw_outs):
            _, ny, nx, A, no = pi.shape
            t = _build_level_targets(boxes, valid, nx, ny)
            pi_flat = pi.reshape(B, ny * nx * A, no)
            ps = pi_flat.gather(1, t["flat_cell"][..., None].expand(-1, -1, no))
            w = t["w"]
            n_pos = w.sum().clamp(min=1.0)
            pdist = (torch.sigmoid(ps[..., 0:4]) * 2.0) ** 2 * (2.0 ** i)
            iou = sd_iou(pdist, t["tdist"])
            lbox = lbox + ((1.0 - iou) * w).sum() / n_pos
            score = iou.detach().clamp(min=0.0) * w
            tobj = torch.zeros(B, ny * nx * A, dtype=score.dtype, device=score.device)
            tobj = tobj.scatter_reduce(1, t["flat_cell"], score, "amax")
            obj_bce = sigmoid_binary_cross_entropy(pi_flat[..., 4], tobj)
            lobj = lobj + obj_bce.mean() * self.balance[i]
            if self.num_classes > 1:
                tcls = torch.where(valid, labels, 0).long()
                cls_flat = tcls[:, :, None].expand(B, M, 9).reshape(B, -1)
                onehot = F.one_hot(cls_flat, self.num_classes).to(ps.dtype)
                onehot = onehot * (self.cp - self.cn) + self.cn
                cls_bce = sigmoid_binary_cross_entropy(ps[..., 5:], onehot)
                lcls = lcls + (cls_bce * w[..., None]).sum() / (n_pos * self.num_classes)
        lbox = lbox * self.hyp_box
        lobj = lobj * self.hyp_obj
        lcls = lcls * self.hyp_cls
        total = (lbox + lobj + lcls) * B
        return total, {"box_loss": lbox, "obj_loss": lobj, "cls_loss": lcls}


def decode_objectbox(raw_outs, strides):
    """Corner-distance decode → (B, N, 5 + C): cxcywh in network pixels,
    then the objectness and class probabilities."""
    decoded = []
    for i, x in enumerate(raw_outs):
        b, ny, nx, na, no = x.shape
        y = torch.sigmoid(x)
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=x.device),
                                torch.arange(nx, dtype=torch.float32, device=x.device),
                                indexing="ij")
        gx, gy = gx[None, :, :, None], gy[None, :, :, None]
        d = (y[..., 0:4] * 2.0) ** 2 * (2.0 ** i)
        s = strides[i]
        x1 = (gx + 1.0 - d[..., 0]) * s
        y1 = (gy + 1.0 - d[..., 1]) * s
        x2 = (gx + d[..., 2]) * s
        y2 = (gy + d[..., 3]) * s
        cxcywh = torch.stack([(x1 + x2) / 2.0, (y1 + y2) / 2.0, x2 - x1, y2 - y1], -1)
        decoded.append(torch.cat([cxcywh, y[..., 4:]], -1).reshape(b, ny * nx * na, no))
    return torch.cat(decoded, 1)
