/* COCO run-length-encoding codec, mask IoU and the COCO matcher: the
 * port's own copy of cvpytorch_tpu/native/rle.c (the JAX package's host C),
 * built by cvpytorch_tpu_torch/native/__init__.py.
 *
 * Implemented from the public RLE format specification (column-major runs,
 * alternating background/foreground, counts[i>2] delta-coded against
 * counts[i-2], 6-bit ASCII varint chars offset by 48).
 *
 * All functions operate on int64 run-count arrays; masks are uint8 in
 * COLUMN-major (Fortran) order, matching the COCO convention.
 */
#include <stdint.h>
#include <stddef.h>

/* Decode a compressed RLE string into run counts.
 * Returns the number of runs, or -1 if it would exceed max_runs. */
int64_t rle_decode_string(const char *s, int64_t n, int64_t *counts,
                          int64_t max_runs) {
    int64_t m = 0, i = 0;
    while (i < n) {
        int64_t x = 0;
        int k = 0, more = 1;
        while (more) {
            if (i >= n) return -1;
            int64_t c = (int64_t)(unsigned char)s[i] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (int)(c & 0x20);
            i++; k++;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (m > 2) x += counts[m - 2];
        if (m >= max_runs) return -1;
        counts[m++] = x;
    }
    return m;
}

/* Encode run counts into the compressed string form.
 * Returns the string length, or -1 if it would exceed max_len. */
int64_t rle_encode_string(const int64_t *counts, int64_t m, char *s,
                          int64_t max_len) {
    int64_t p = 0;
    for (int64_t j = 0; j < m; j++) {
        int64_t x = counts[j];
        if (j > 2) x -= counts[j - 2];
        int more = 1;
        while (more) {
            int64_t c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            if (p >= max_len) return -1;
            s[p++] = (char)(c + 48);
        }
    }
    return p;
}

/* uint8 column-major mask (len = h*w) → run counts (first run = zeros).
 * Returns number of runs, or -1 on overflow of max_runs. */
int64_t rle_from_mask(const uint8_t *mask, int64_t len, int64_t *counts,
                      int64_t max_runs) {
    int64_t m = 0, run = 0;
    uint8_t cur = 0;
    for (int64_t i = 0; i < len; i++) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v != cur) {
            if (m >= max_runs) return -1;
            counts[m++] = run;
            run = 0;
            cur = v;
        }
        run++;
    }
    if (m >= max_runs) return -1;
    counts[m++] = run;
    return m;
}

/* run counts → uint8 column-major mask (caller allocates len bytes). */
void rle_to_mask(const int64_t *counts, int64_t m, uint8_t *mask,
                 int64_t len) {
    int64_t pos = 0;
    uint8_t val = 0;
    for (int64_t j = 0; j < m; j++) {
        int64_t run = counts[j];
        if (run > len - pos) run = len - pos;
        if (val)
            for (int64_t i = 0; i < run; i++) mask[pos + i] = 1;
        else
            for (int64_t i = 0; i < run; i++) mask[pos + i] = 0;
        pos += run;
        val ^= 1;
    }
    while (pos < len) mask[pos++] = 0;
}

/* Foreground area of an RLE (sum of odd-indexed runs). */
int64_t rle_area(const int64_t *counts, int64_t m) {
    int64_t a = 0;
    for (int64_t j = 1; j < m; j += 2) a += counts[j];
    return a;
}

/* Intersection of two run lists over the same canvas: two-pointer sweep
 * over run boundaries, accumulating overlap where both are foreground. */
int64_t rle_intersection(const int64_t *ca, int64_t ma,
                         const int64_t *cb, int64_t mb) {
    int64_t ia = 0, ib = 0;          /* run indices */
    int64_t ea = ma ? ca[0] : 0;     /* end position of current a-run */
    int64_t eb = mb ? cb[0] : 0;
    int64_t pos = 0, inter = 0;
    int va = 0, vb = 0;              /* current run values */
    while (ia < ma && ib < mb) {
        int64_t e = ea < eb ? ea : eb;
        if (va && vb) inter += e - pos;
        pos = e;
        if (ea == e) { ia++; va ^= 1; if (ia < ma) ea += ca[ia]; }
        if (eb == e) { ib++; vb ^= 1; if (ib < mb) eb += cb[ib]; }
    }
    return inter;
}

/* Pairwise IoU between D det RLEs and G gt RLEs, flattened into one
 * counts buffer each with per-item offsets/lengths.  iscrowd gt → IoU is
 * intersection / det_area (pycocotools protocol).  out is row-major
 * (D, G) float64. */
void rle_iou_matrix(const int64_t *dc, const int64_t *doff,
                    const int64_t *dlen, int64_t D,
                    const int64_t *gc, const int64_t *goff,
                    const int64_t *glen, int64_t G,
                    const uint8_t *iscrowd, double *out) {
    for (int64_t i = 0; i < D; i++) {
        const int64_t *ci = dc + doff[i];
        int64_t mi = dlen[i];
        double ai = (double)rle_area(ci, mi);
        for (int64_t j = 0; j < G; j++) {
            const int64_t *cj = gc + goff[j];
            int64_t mj = glen[j];
            double inter = (double)rle_intersection(ci, mi, cj, mj);
            double denom;
            if (iscrowd[j]) {
                denom = ai;
            } else {
                denom = ai + (double)rle_area(cj, mj) - inter;
            }
            out[i * G + j] = denom > 0 ? inter / denom : 0.0;
        }
    }
}

/* Greedy COCO detection<->gt matching for one (image, category, areaRng)
 * cell — the pycocotools evaluateImg inner loops (cocoeval.py semantics,
 * reference src/evaluator/eval_coco.py feeds the same C path via
 * pycocotools._mask).  Dets arrive in descending score order; gt_order
 * lists gt indices non-ignored-first (stable).  For each IoU threshold
 * independently: each det takes the best-IoU gt above the threshold,
 * already-matched non-crowd gts are skipped, crowd gts may match many
 * dets, and once a non-ignored best exists the scan stops at the first
 * ignored gt (they sort last).  Outputs dtm / dtig as (T, D) uint8. */
void coco_match(const double *ious, int64_t D, int64_t G,
                const double *thrs, int64_t T,
                const uint8_t *gt_ig, const uint8_t *gt_crowd,
                const int64_t *gt_order,
                uint8_t *dtm, uint8_t *dtig, uint8_t *gtm_scratch) {
    for (int64_t t = 0; t < T; t++) {
        double thr = thrs[t];
        if (thr > 1.0 - 1e-10) thr = 1.0 - 1e-10;
        uint8_t *gtm = gtm_scratch;
        for (int64_t g = 0; g < G; g++) gtm[g] = 0;
        for (int64_t d = 0; d < D; d++) {
            double best = thr;
            int64_t m = -1;
            for (int64_t gi = 0; gi < G; gi++) {
                int64_t g = gt_order[gi];
                if (gtm[g] && !gt_crowd[g]) continue;
                if (m > -1 && !gt_ig[m] && gt_ig[g]) break;
                double v = ious[d * G + g];
                if (v < best) continue;
                best = v;
                m = g;
            }
            if (m == -1) continue;
            dtm[t * D + d] = 1;
            dtig[t * D + d] = gt_ig[m];
            gtm[m] = 1;
        }
    }
}

/* All-areaRng variant: runs coco_match for A area ranges in one call,
 * building each range's gt-ignore set (base-ignore OR gt area outside
 * [lo, hi]), the stable non-ignored-first order, and the unmatched-det
 * out-of-range dt-ignore — one C roundtrip per (image, category) instead
 * of 4 numpy-heavy python calls (pycocotools evaluateImg over p.areaRng).
 * dtm/dtig are (A, T, D) uint8, npig_out is (A,) int64. */
void coco_match_areas(const double *ious, int64_t D, int64_t G,
                      const double *thrs, int64_t T,
                      const uint8_t *gt_base_ig, const uint8_t *gt_crowd,
                      const double *gt_areas, const double *dt_areas,
                      const double *area_lo, const double *area_hi,
                      int64_t A,
                      uint8_t *dtm, uint8_t *dtig, int64_t *npig_out,
                      uint8_t *scratch /* >= 2*G */, int64_t *order /* G */) {
    uint8_t *gt_ig = scratch;            /* G */
    uint8_t *gtm = scratch + G;          /* G */
    for (int64_t a = 0; a < A; a++) {
        double lo = area_lo[a], hi = area_hi[a];
        int64_t npig = 0, k = 0;
        for (int64_t g = 0; g < G; g++) {
            gt_ig[g] = gt_base_ig[g] || gt_areas[g] < lo || gt_areas[g] > hi;
            if (!gt_ig[g]) { order[k++] = g; npig++; }
        }
        for (int64_t g = 0; g < G; g++) if (gt_ig[g]) order[k++] = g;
        npig_out[a] = npig;
        uint8_t *dtm_a = dtm + a * T * D;
        uint8_t *dtig_a = dtig + a * T * D;
        for (int64_t t = 0; t < T; t++) {
            double thr = thrs[t];
            if (thr > 1.0 - 1e-10) thr = 1.0 - 1e-10;
            for (int64_t g = 0; g < G; g++) gtm[g] = 0;
            for (int64_t d = 0; d < D; d++) {
                double best = thr;
                int64_t m = -1;
                for (int64_t gi = 0; gi < G; gi++) {
                    int64_t g = order[gi];
                    if (gtm[g] && !gt_crowd[g]) continue;
                    if (m > -1 && !gt_ig[m] && gt_ig[g]) break;
                    double v = ious[d * G + g];
                    if (v < best) continue;
                    best = v;
                    m = g;
                }
                if (m == -1) continue;
                dtm_a[t * D + d] = 1;
                dtig_a[t * D + d] = gt_ig[m];
                gtm[m] = 1;
            }
            /* unmatched dets outside the area range are ignored */
            for (int64_t d = 0; d < D; d++) {
                if (!dtm_a[t * D + d] &&
                    (dt_areas[d] < lo || dt_areas[d] > hi))
                    dtig_a[t * D + d] = 1;
            }
        }
    }
}
