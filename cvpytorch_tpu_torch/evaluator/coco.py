"""COCO-protocol box, mask and keypoint evaluator (a copy of
``cvpytorch_tpu/evaluator/coco.py``, numpy; OpenPose's people assembled by
``ops/paf``'s host code).

Protocol (pycocotools ``cocoeval.py`` semantics):
* IoU thresholds 0.50:0.05:0.95, 101 recall points;
* area ranges all/small/medium/large on GT (and unmatched-det) areas;
* maxDets sweep [1, 10, 100] (keypoints: [20], and no 'small' range);
* crowd GT are ignore-matched with IoU = intersection/det_area and may
  match many detections;
* greedy best-IoU matching in score order, non-ignored GT preferred;
* segm: IoU of binary masks on the dataset's raster, areas in mask
  pixels: masks of 256² or more through the host C RLE codec (run-merge
  intersection, ``native.rle_iou``), smaller ones as one product of the
  flattened masks (``_mask_iou_dense``), as the JAX evaluator does;
* keypoints: OKS (``_oks_iou``, pycocotools' ``computeOks``) normalised by
  the annotation areas the dataset carries (box areas without them);
  bottom-up predictions (OpenPose's peaks, scores and ``conns``) are
  assembled into people on the host first (``ops/paf``);
* the 12-metric summary (mAP, AP_50, AP_75, AP_small/medium/large,
  Recall_1/10/100, Recall_small/medium/large; for keypoints the 8 of
  its ranges and maxDets) of each IoU type, prefixed ``bbox_`` /
  ``segm_`` / ``keypoints_``, and ``performance`` = the ``eval_type``
  metric (``mAP`` is the bbox one).

Matching runs in host C (``native.coco_match_areas``: every area range
of one image and category in one call), as the JAX evaluator's does;
``_evaluate_img``, the pure-Python loop it copies, is the plain version
the tests hold it to.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..ops import paf
from ..registry import EVALUATORS
from .base import BaseEvaluator

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)          # T = 10
RECALL_POINTS = np.round(np.linspace(0.0, 1.00, 101), 2)    # R = 101
MAX_DETS = (1, 10, 100)                                     # M = 3
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
AREA_KEYS = ("all", "small", "medium", "large")
# keypoint protocol (pycocotools' kpt Params): maxDets [20], no 'small'
KPT_MAX_DETS = (20,)
KPT_AREA_KEYS = ("all", "medium", "large")
# per-keypoint OKS constants of the 17 COCO keypoints (cocoeval.py)
COCO_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0


def _box_iou(dt, gt, crowd):
    """IoU matrix (D, G); crowd GT use intersection/det_area."""
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = np.clip(dt[:, 2] - dt[:, 0], 0, None) * \
        np.clip(dt[:, 3] - dt[:, 1], 0, None)
    area_g = np.clip(gt[:, 2] - gt[:, 0], 0, None) * \
        np.clip(gt[:, 3] - gt[:, 1], 0, None)
    union = area_d[:, None] + area_g[None, :] - inter
    denom = np.where(crowd[None, :], area_d[:, None], union)
    return inter / np.maximum(denom, 1e-9)


RLE_MIN_PIXELS = 256 * 256  # masks this large go through the RLE codec


def _mask_iou(dt_masks, gt_masks, crowd):
    """Binary-mask IoU (D, G); crowd GT use intersection/det_area."""
    D, G = len(dt_masks), len(gt_masks)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    if dt_masks[0].size >= RLE_MIN_PIXELS:
        return native.rle_iou([native.rle_from_mask(m) for m in dt_masks],
                              [native.rle_from_mask(m) for m in gt_masks], crowd)
    return _mask_iou_dense(dt_masks, gt_masks, crowd)


def _mask_iou_dense(dt_masks, gt_masks, crowd):
    """Binary-mask IoU (D, G) as one BLAS product."""
    D, G = len(dt_masks), len(gt_masks)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    d_flat = dt_masks.reshape(D, -1).astype(bool)
    g_flat = gt_masks.reshape(G, -1).astype(bool)
    inter = (d_flat.astype(np.float32) @ g_flat.astype(np.float32).T).astype(float)
    area_d = d_flat.sum(-1).astype(float)
    area_g = g_flat.sum(-1).astype(float)
    union = area_d[:, None] + area_g[None, :] - inter
    denom = np.where(crowd[None, :], area_d[:, None], union)
    return inter / np.maximum(denom, 1e-9)


def _mask_areas(m):
    return m.astype(bool).sum(axis=tuple(range(1, m.ndim))).astype(float)


def _box_areas(b):
    return np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)


def _oks_iou(dt_kpts, gt_kpts, gt_boxes, gt_areas, crowd):
    """Object-keypoint-similarity matrix (D, G) (pycocotools'
    ``computeOks``): keypoints with v > 0 count; a GT with none labelled
    falls back to the distance outside its box widened by its size."""
    D, G = len(dt_kpts), len(gt_kpts)
    out = np.zeros((D, G))
    if D == 0 or G == 0:
        return out
    K = gt_kpts.shape[1]
    sigmas = COCO_SIGMAS if K == len(COCO_SIGMAS) else np.full(K, float(COCO_SIGMAS.mean()))
    var2 = (sigmas * 2.0) ** 2
    for j in range(G):
        xg, yg, vg = gt_kpts[j, :, 0], gt_kpts[j, :, 1], gt_kpts[j, :, 2]
        k1 = int((vg > 0).sum())
        x1, y1, x2, y2 = gt_boxes[j]
        w, h = x2 - x1, y2 - y1
        for i in range(D):
            xd, yd = dt_kpts[i, :, 0], dt_kpts[i, :, 1]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0, (x1 - w) - xd) + np.maximum(0, xd - (x2 + w))
                dy = np.maximum(0, (y1 - h) - yd) + np.maximum(0, yd - (y2 + h))
            e = (dx ** 2 + dy ** 2) / var2 / (gt_areas[j] + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.exp(-e).sum() / e.shape[0]
    return out


def _evaluate_img(ious, gt_ignore_base, gt_crowd, gt_areas, dt_areas,
                  area_rng):
    """COCOeval's evaluateImg matching for one (img, cat, areaRng): the
    plain version of ``native.coco_match_areas``.

    ious (D, G) with dets in score order; returns
    (dt_matched (T,D) bool, dt_ignore (T,D) bool, npig)."""
    T = len(IOU_THRS)
    D, G = ious.shape
    gt_ig = gt_ignore_base | (gt_areas < area_rng[0]) | (gt_areas > area_rng[1])
    gt_order = np.argsort(gt_ig, kind="stable")  # non-ignored gts first
    npig = int((~gt_ig).sum())
    dtm = np.zeros((T, D), bool)
    dtig = np.zeros((T, D), bool)
    gtm = np.zeros((T, G), bool)
    for t, thr in enumerate(IOU_THRS):
        thr = min(thr, 1 - 1e-10)
        for d in range(D):
            best_iou = thr
            m = -1
            for g in gt_order:
                if gtm[t, g] and not gt_crowd[g]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[g]:
                    break  # remaining gts all ignored; keep current
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                m = g
            if m == -1:
                continue
            dtm[t, d] = True
            dtig[t, d] = gt_ig[m]
            gtm[t, m] = True
    out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
    dtig = dtig | ((~dtm) & out_of_rng[None, :])
    return dtm, dtig, npig


class COCOEval:
    """Accumulates per-image records of one IoU type ('bbox', 'segm' or
    'keypoints') and produces its COCO stats."""

    def __init__(self, num_classes: int, iou_type: str = "bbox"):
        if iou_type not in ("bbox", "segm", "keypoints"):
            raise ValueError(f"iou_type {iou_type!r}: one of bbox, segm, keypoints")
        self.num_classes = num_classes
        self.iou_type = iou_type
        kpt = iou_type == "keypoints"
        self.max_dets = KPT_MAX_DETS if kpt else MAX_DETS
        self.area_keys = KPT_AREA_KEYS if kpt else AREA_KEYS
        self.reset()

    def reset(self):
        # records[c][area] = list over images of
        #   (scores (D,), dtm (T,D), dtig (T,D), npig, position)
        self.records = [{a: [] for a in self.area_keys} for _ in range(self.num_classes)]

    def state_dict(self):
        return {"records": self.records}

    def merge_state_dicts(self, states):
        """Every rank's per-(class, areaRng) image records, in the images'
        single-process order when every record has its position: the AP's
        stable sort ranks cross-image score ties by that order, which a
        rank-by-rank concatenation changes.  Records without positions are
        concatenated in the states' order, as the JAX merge does."""
        def merged(recs):
            recs = list(recs)
            return sorted(recs, key=lambda r: r[4]) \
                if all(r[4] is not None for r in recs) else recs

        self.records = [
            {a: merged(r for s in states for r in s["records"][c][a]) for a in self.area_keys}
            for c in range(self.num_classes)]

    def add_image(self, gt_boxes, gt_labels, det_boxes, det_scores,
                  det_labels, gt_crowd=None, gt_masks=None, det_masks=None,
                  gt_kpts=None, det_kpts=None, gt_ann_areas=None, position=None):
        """All arrays unpadded, boxes xyxy original-image pixels; segm
        takes the (n, Hm, Wm) masks too, keypoints the (n, K, 3) keypoints
        and optionally the GT annotation areas.  ``position``: the image's
        place in the single-process order, for ``merge_state_dicts``."""
        position = None if position is None else int(position)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt_labels).reshape(-1)
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        det_scores = np.asarray(det_scores).reshape(-1)
        det_labels = np.asarray(det_labels).reshape(-1)
        if gt_crowd is None:
            gt_crowd = np.zeros(len(gt_boxes), bool)
        gt_crowd = np.asarray(gt_crowd, bool).reshape(-1)
        for c in range(self.num_classes):
            g_sel = gt_labels == c
            d_sel = det_labels == c
            if not (g_sel.any() or d_sel.any()):
                continue
            gb, crowd = gt_boxes[g_sel], gt_crowd[g_sel]
            db, ds = det_boxes[d_sel], det_scores[d_sel]
            order = np.argsort(-ds, kind="stable")[:self.max_dets[-1]]
            db, ds = db[order], ds[order]
            if self.iou_type == "segm":
                gm = np.asarray(gt_masks)[g_sel]
                dm = np.asarray(det_masks)[d_sel][order]
                ious = _mask_iou(dm, gm, crowd)
                gt_areas, dt_areas = _mask_areas(gm), _mask_areas(dm)
            elif self.iou_type == "keypoints":
                gk = np.asarray(gt_kpts)[g_sel]
                dk = np.asarray(det_kpts)[d_sel][order]
                gt_areas = (np.asarray(gt_ann_areas, float)[g_sel]
                            if gt_ann_areas is not None else _box_areas(gb))
                dt_areas = _box_areas(db)
                ious = _oks_iou(dk, gk, gb, gt_areas, crowd)
            else:
                ious = _box_iou(db, gb, crowd)
                gt_areas, dt_areas = _box_areas(gb), _box_areas(db)
            dtm, dtig, npig = native.coco_match_areas(
                ious, IOU_THRS, crowd, crowd, gt_areas, dt_areas,
                [AREA_RNG[a] for a in self.area_keys])
            for i, a in enumerate(self.area_keys):
                self.records[c][a].append((ds, dtm[i], dtig[i], int(npig[i]), position))

    def _pr_curves(self, c, area, max_det):
        """(ap (T,) or None, recall (T,) or None) for one cell."""
        recs = self.records[c][area]
        npig = sum(r[3] for r in recs)
        if npig == 0:
            return None, None
        T = len(IOU_THRS)
        scores = np.concatenate([r[0][:max_det] for r in recs]) \
            if recs else np.zeros(0)
        if scores.size == 0:
            return np.zeros(T), np.zeros(T)
        dtm = np.concatenate([r[1][:, :max_det] for r in recs], axis=1)
        dtig = np.concatenate([r[2][:, :max_det] for r in recs], axis=1)
        order = np.argsort(-scores, kind="mergesort")
        dtm, dtig = dtm[:, order], dtig[:, order]
        tps = dtm & ~dtig
        fps = (~dtm) & ~dtig
        tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
        ap = np.zeros(T)
        rec_out = np.zeros(T)
        for t in range(T):
            tp, fp = tp_cum[t], fp_cum[t]
            rc = tp / npig
            pr = tp / np.maximum(tp + fp, np.spacing(1))
            rec_out[t] = rc[-1] if len(rc) else 0.0
            # monotone precision envelope (right-to-left running maximum)
            pr = np.maximum.accumulate(pr[::-1])[::-1]
            inds = np.searchsorted(rc, RECALL_POINTS, side="left")
            q = np.zeros(len(RECALL_POINTS))
            valid = inds < len(pr)
            q[valid] = pr[inds[valid]]
            ap[t] = q.mean()
        return ap, rec_out

    def summarize(self) -> dict:
        C, T = self.num_classes, len(IOU_THRS)
        cells_ap = {}   # area -> (C, T) with nan
        cells_ar = {}   # (area, maxdet) -> (C, T)
        for area in self.area_keys:
            ap_mat = np.full((C, T), np.nan)
            for c in range(C):
                ap, _ = self._pr_curves(c, area, self.max_dets[-1])
                if ap is not None:
                    ap_mat[c] = ap
            cells_ap[area] = ap_mat
        for area in self.area_keys:
            for md in self.max_dets:
                if area != "all" and md != self.max_dets[-1]:
                    continue
                ar_mat = np.full((C, T), np.nan)
                for c in range(C):
                    _, rec = self._pr_curves(c, area, md)
                    if rec is not None:
                        ar_mat[c] = rec
                cells_ar[(area, md)] = ar_mat

        def mean(x):
            return float(np.nanmean(x)) if np.any(~np.isnan(x)) else -1.0

        i75 = int(np.argmin(np.abs(IOU_THRS - 0.75)))
        stats = {
            "mAP": mean(cells_ap["all"]),
            "AP_50": mean(cells_ap["all"][:, 0]),
            "AP_75": mean(cells_ap["all"][:, i75]),
        }
        for area in self.area_keys[1:]:
            stats[f"AP_{area}"] = mean(cells_ap[area])
        for md in self.max_dets:
            stats[f"Recall_{md}"] = mean(cells_ar[("all", md)])
        for area in self.area_keys[1:]:
            stats[f"Recall_{area}"] = mean(cells_ar[(area, self.max_dets[-1])])
        allc = cells_ap["all"]
        self._per_class_ap = np.where(
            np.isnan(allc).all(axis=1), np.nan,
            np.nanmean(np.where(np.isnan(allc), 0.0, allc), axis=1)
            * allc.shape[1]
            / np.maximum((~np.isnan(allc)).sum(axis=1), 1))
        return stats


@EVALUATORS.register(name="coco_detection", aliases=("coco",))
class CocoEvaluator(BaseEvaluator):
    """Trainer-facing evaluator over padded batches (numpy)."""

    def __init__(self, dataset=None, num_classes: int | None = None,
                 eval_type: str = "mAP", iou_types=("bbox",), **_):
        super().__init__(dataset)
        self.num_classes = num_classes or getattr(dataset, "num_classes", None)
        if not self.num_classes:
            raise ValueError("num_classes required")
        self.eval_type = eval_type
        self.iou_types = tuple(iou_types)
        self.id2name = getattr(dataset, "id2name", {})
        self.reset()

    def reset(self):
        self._evals = {t: COCOEval(self.num_classes, t) for t in self.iou_types}

    def state_dict(self):
        return {t: ev.state_dict() for t, ev in self._evals.items()}

    def merge_state_dicts(self, states):
        for t, ev in self._evals.items():
            ev.merge_state_dicts([s[t] for s in states])

    def update(self, targets, preds, indices=None):
        """targets: padded dict {'boxes','labels','valid','pads','scales'
        [,'crowd'][,'masks']} (GT in network pixels, un-letterboxed here);
        preds: the NMS output dict, already un-letterboxed by the model,
        with 'masks' (B, K, Hm, Wm) pasted instance masks for segm and
        'keypoints' (B, K, 17, 3) for keypoints (original pixels; GT
        keypoints are un-letterboxed here).  A bottom-up model's decode
        pieces ('peaks_xy', 'peaks_score', 'conns', 'stride') are
        assembled into people here first.  ``indices``: the images'
        positions in the single-process order (``BaseEvaluator``)."""
        if "conns" in preds:
            xy, sc, cn = (np.asarray(preds[k]) for k in ("peaks_xy", "peaks_score", "conns"))
            decoded = [paf.assemble_instances(xy[b], sc[b], cn[b]) for b in range(len(xy))]
            preds = paf.instances_to_eval(decoded, stride=float(np.asarray(preds["stride"])[0]),
                                          targets=targets)
        t_boxes = np.asarray(targets["boxes"])
        t_labels = np.asarray(targets["labels"])
        t_valid = np.asarray(targets["valid"])
        B = len(t_boxes)
        pads = np.asarray(targets.get("pads", np.zeros((B, 2))))
        scales = np.asarray(targets.get("scales", np.ones((B, 2))))
        t_crowd = np.asarray(targets["crowd"]) if "crowd" in targets else \
            np.zeros(t_labels.shape, bool)
        p_boxes = np.asarray(preds["boxes"])
        p_scores = np.asarray(preds["scores"])
        p_labels = np.asarray(preds["labels"])
        p_valid = np.asarray(preds["valid"])
        for i in range(B):
            gv = t_valid[i]
            gb = t_boxes[i][gv].copy()
            if len(gb):
                gb[:, [0, 2]] = (gb[:, [0, 2]] - pads[i, 0]) / scales[i, 0]
                gb[:, [1, 3]] = (gb[:, [1, 3]] - pads[i, 1]) / scales[i, 1]
            pv = p_valid[i]
            for t, ev in self._evals.items():
                kw = {}
                if t == "segm":
                    kw = dict(gt_masks=np.asarray(targets["masks"])[i][gv],
                              det_masks=np.asarray(preds["masks"])[i][pv])
                elif t == "keypoints":
                    gk = np.asarray(targets["keypoints"])[i][gv].copy()
                    if len(gk):
                        gk[..., 0] = (gk[..., 0] - pads[i, 0]) / scales[i, 0]
                        gk[..., 1] = (gk[..., 1] - pads[i, 1]) / scales[i, 1]
                    kw = dict(gt_kpts=gk, det_kpts=np.asarray(preds["keypoints"])[i][pv])
                    if "areas" in targets:
                        kw["gt_ann_areas"] = np.asarray(targets["areas"])[i][gv]
                ev.add_image(gb, t_labels[i][gv], p_boxes[i][pv],
                             p_scores[i][pv], p_labels[i][pv],
                             gt_crowd=t_crowd[i][gv],
                             position=None if indices is None else indices[i], **kw)

    def evaluate(self) -> dict:
        out = {"performance": 0.0}
        for t, ev in self._evals.items():
            stats = ev.summarize()
            for k, v in stats.items():
                out[f"{t}_{k}"] = v
                if k == "mAP":
                    out["performance"] += max(v, 0.0)
            if t == "bbox":
                out["mAP"] = stats["mAP"]
                out["AP50"] = stats["AP_50"]
                out["AP75"] = stats["AP_75"]
                for c in range(self.num_classes):
                    if not np.isnan(ev._per_class_ap[c]):
                        out[f"AP_{self.id2name.get(c, c)}"] = float(ev._per_class_ap[c])
        if self.eval_type in out:
            out["performance"] = out[self.eval_type]
        return out
