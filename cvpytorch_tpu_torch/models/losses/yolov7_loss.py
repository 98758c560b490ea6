"""YOLOv7 loss (counterpart of ``cvpytorch_tpu/models/losses/yolov7_loss.py``):
SimOTA over YOLOv5's cross-grid candidates, fixed shapes.

1. find-3-positive: YOLOv5's candidates, every (gt m, anchor a, offset o)
   of a level with its validity weight (``yolov5_loss._build_level_targets``).
2. SimOTA over the N candidates of all levels together: the candidates'
   boxes decoded to pixels, IoU against each gt in pixels (the gts
   scaled by the image height on both axes, as the reference does),
   dynamic_k = max(⌊Σ of the 20 largest IoUs⌋, 1) summed largest first,
   cost = BCE(logit √(cls·obj), onehot) in closed form + 3·(−log IoU),
   1e8 for each of an invalid candidate and an invalid gt; each gt takes
   its dynamic_k lowest-cost candidates (ranks from a stable sort along
   the candidates: the double ``argsort`` of JAX, whose ties, common where
   the 1e8 terms swamp the cost, resolve by index); a candidate taken by
   several gts goes to the gt of least cost over **all** gts.  No
   gradient flows through this stage (its outputs are ranks and indices),
   so it runs without autograd, under the ``yolov7_ota`` profiler range.
3. YOLOv5's level losses on the selected candidates, the box target from
   the OTA-matched gt: CIoU box, scatter-max objectness of the detached
   clipped CIoU, BCE classes; (box, obj, cls) weights (0.05, 0.7, 0.3),
   level balance (4, 1, 0.4), the total times the batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.boxes import bbox_iou
from ...registry import LOSSES
from ..assigners.dsl_assigner import _ranks
from .yolov5_loss import _build_level_targets, sigmoid_binary_cross_entropy

BIG = 1e8
TOPK_IOU = 20  # the dynamic-k window


@LOSSES.register(name="YOLOv7Loss")
class YOLOv7Loss:
    def __init__(self, num_classes: int, anchors, strides=(8.0, 16.0, 32.0),
                 hyp_box: float = 0.05, hyp_obj: float = 0.7, hyp_cls: float = 0.3,
                 anchor_t: float = 4.0, **_):
        self.num_classes = num_classes
        self.anchors = tuple(tuple(tuple(a) for a in lvl) for lvl in anchors)
        self.strides = tuple(strides)
        self.hyp_box, self.hyp_obj, self.hyp_cls = hyp_box, hyp_obj, hyp_cls
        self.anchor_t = anchor_t
        self.balance = {3: (4.0, 1.0, 0.4)}.get(len(self.anchors), (4.0, 1.0, 0.25, 0.06, 0.02))
        self.cp, self.cn = 1.0, 0.0

    def candidates(self, raw_outs, targets):
        """Stage 1: each level's candidates and their decoded pixel boxes."""
        boxes, valid = targets["boxes"], targets["valid"]
        B = boxes.shape[0]
        lvl = []
        for i, pi in enumerate(raw_outs):
            _, ny, nx, A, no = pi.shape
            anchors = torch.tensor(self.anchors[i], dtype=boxes.dtype, device=pi.device)
            t = _build_level_targets(boxes, valid, anchors, nx, ny, self.anchor_t)
            P = t["w"].shape[1]
            ps = pi.reshape(B, ny * nx * A, no).gather(1, t["flat_cell"][..., None].expand(
                B, P, no))
            cell = t["flat_cell"] // A
            grid = torch.stack([cell % nx, cell // nx], -1).to(ps.dtype)
            pxy = (torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5 + grid) * self.strides[i]
            pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * t["anchor_wh"] * self.strides[i]
            lvl.append(dict(ps=ps, w=t["w"].to(ps.dtype), flat_cell=t["flat_cell"], grid=grid,
                            anchor_wh=t["anchor_wh"], pbox=torch.cat([pxy, pwh], -1),
                            ny=ny, nx=nx, A=A))
        return lvl

    @staticmethod
    def ota_match(lvl, targets, img_size: float):
        """Stage 2 over the concatenated candidates: ``(selected (B, N)
        bool, matched_gt (B, N) int64)``."""
        boxes, labels, valid = targets["boxes"], targets["labels"], targets["valid"]
        with torch.no_grad():
            ps = torch.cat([l["ps"] for l in lvl], 1).detach()
            p_obj, p_cls = torch.sigmoid(ps[..., 4]), torch.sigmoid(ps[..., 5:])
            p_boxes = torch.cat([l["pbox"] for l in lvl], 1).detach()
            w_cand = torch.cat([l["w"] for l in lvl], 1)  # (B, N)
            N, M = w_cand.shape[1], boxes.shape[1]
            gt_px = boxes * img_size
            iou = bbox_iou(gt_px[:, :, None, :], p_boxes[:, None, :, :], fmt="cxcywh",
                           iou_type="iou")
            iou = iou * w_cand[:, None, :] * valid[:, :, None]  # (B, M, N)

            top = iou.topk(min(TOPK_IOU, N), dim=-1).values
            total = top[..., 0]
            for j in range(1, top.shape[-1]):
                total = total + top[..., j]
            dyn_k = total.to(torch.int32).clamp(min=1)  # (B, M)

            # BCE(logit(y), onehot) = −[log y_gt − log1p(−y_gt) + Σ_c log1p(−y_c)]
            y = torch.sqrt((p_cls * p_obj[..., None]).clamp(1e-8, 1 - 1e-8))
            log_1my = torch.log1p(-y)
            diff = torch.log(y) - log_1my  # (B, N, C)
            safe_cls = torch.where(valid, labels, 0).long()
            val = diff.transpose(1, 2).gather(1, safe_cls[:, :, None].expand(-1, -1, N))
            cls_cost = -(val + log_1my.sum(-1)[:, None, :])
            cost = cls_cost + 3.0 * -torch.log(iou + 1e-8)
            cost = (cost + BIG * (1.0 - w_cand[:, None, :])
                    + BIG * (1.0 - valid[:, :, None].to(cost.dtype)))

            # ranks along the candidates (JAX's argsort(argsort(cost)))
            rank = _ranks(cost.transpose(1, 2)).transpose(1, 2)
            matching = ((rank < dyn_k[..., None]) & valid[:, :, None]
                        & (w_cand[:, None, :] > 0))
            conflict = matching.sum(1) > 1  # (B, N)
            win = F.one_hot(cost.argmin(1), M).bool().transpose(1, 2)  # first among equals
            keep = torch.where(conflict[:, None, :], win, matching)
            return keep.any(1), keep.to(torch.int32).argmax(1)

    def __call__(self, raw_outs, targets, img_size: float):
        """raw_outs: list of (B, ny, nx, A, 5 + C); targets: ``{'boxes'
        (B, M, 4) cxcywh normalised, 'labels', 'valid'}``; ``img_size``:
        the image height in pixels."""
        boxes, labels, valid = targets["boxes"], targets["labels"], targets["valid"]
        B, C = boxes.shape[0], self.num_classes
        lvl = self.candidates(raw_outs, targets)
        with torch.profiler.record_function("yolov7_ota"):  # a range in step profiles
            selected, matched_gt = self.ota_match(lvl, targets, img_size)
        sel = selected.to(boxes.dtype)
        safe_cls = torch.where(valid, labels, 0).long()
        lbox = lobj = lcls = 0.0
        off = 0
        for i, l in enumerate(lvl):
            ny, nx, A, ps = l["ny"], l["nx"], l["A"], l["ps"]
            P = ps.shape[1]
            w7, mg = sel[:, off:off + P], matched_gt[:, off:off + P]
            off += P
            n_pos = w7.sum().clamp(min=1.0)

            g = boxes.gather(1, mg[..., None].expand(B, P, 4))  # normalised
            scale = torch.tensor([nx, ny], dtype=boxes.dtype, device=boxes.device)
            tbox = torch.cat([g[..., 0:2] * scale - l["grid"], g[..., 2:4] * scale], -1)
            pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * l["anchor_wh"]
            ciou = bbox_iou(torch.cat([pxy, pwh], -1), tbox, fmt="cxcywh", iou_type="ciou")
            lbox = lbox + ((1.0 - ciou) * w7).sum() / n_pos

            score = ciou.detach().clamp(min=0.0) * w7
            tobj = torch.zeros(B, ny * nx * A, dtype=score.dtype, device=score.device)
            tobj = tobj.scatter_reduce(1, l["flat_cell"], score, "amax", include_self=True)
            obj_logits = raw_outs[i].reshape(B, ny * nx * A, -1)[..., 4]
            lobj = lobj + sigmoid_binary_cross_entropy(obj_logits, tobj).mean() * self.balance[i]

            if C > 1:
                t_cls = safe_cls.gather(1, mg)
                onehot = F.one_hot(t_cls, C).to(ps.dtype) * (self.cp - self.cn) + self.cn
                cls_bce = sigmoid_binary_cross_entropy(ps[..., 5:], onehot)
                lcls = lcls + (cls_bce * w7[..., None]).sum() / (n_pos * C)

        lbox, lobj, lcls = lbox * self.hyp_box, lobj * self.hyp_obj, lcls * self.hyp_cls
        total = (lbox + lobj + lcls) * B
        return total, {"box_loss": lbox, "obj_loss": lobj, "cls_loss": lcls}
