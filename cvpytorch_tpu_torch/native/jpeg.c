/* JPEG decoder (ITU-T T.81) computing what cv2.imread(path, IMREAD_COLOR)
 * returns through libjpeg-turbo: the same pixels, byte for byte.
 *
 * Built by cvpytorch_tpu_torch/native and called by
 * cvpytorch_tpu_torch/data/jpeg.py, which parses the header, allocates the
 * output and applies the EXIF orientation.  What it copies, in libjpeg's
 * integer arithmetic (the SIMD paths of libjpeg-turbo compute the same):
 *
 *  - Huffman decoding of baseline, extended-sequential and progressive
 *    files (DC and AC first scans and refinements), restart intervals with
 *    libjpeg's resynchronisation, and on a stream that ends early the zero
 *    bits libjpeg feeds after "premature end of data": the MCU in which the
 *    data ran out is decoded with zeros, the rest of the segment is left
 *    zero;
 *  - for a progressive file whose scans left coefficient bits unsent
 *    (a truncated file), the block smoothing of jdcoefct.c
 *    (decompress_smooth_data, 5x5 DC window, DC interpolation when no AC
 *    data arrived);
 *  - the islow inverse DCT as libjpeg-turbo's x86 SIMD computes it (equal to
 *    jidctint.c on valid data, saturating where jidctint.c wraps);
 *  - fancy upsampling of jdsample.c for h2v1, h2v2 (widths above 2) and
 *    h1v2, replication for other integral factors;
 *  - the YCbCr -> BGR tables of jdcolor.c, grey replicated to BGR, Adobe
 *    RGB, and 4-component CMYK / YCCK to CMYK, then OpenCV's own
 *    CMYK -> BGR (icvCvt_CMYK2BGR_8u_C4C3R);
 *  - with gray = 1, libjpeg's grayscale output: the luma of a YCbCr or
 *    grey file, libjpeg's rgb_gray_convert of an RGB file, and OpenCV's
 *    icvCvt_CMYK2Gray_8u_C4C1R of a CMYK or YCCK file;
 *  - lossless (SOF3) files of 2-8 bits (jdlhuff.c, jdlossls.c): the seven
 *    predictors, the point transform, restarts, libjpeg's uniform grey for
 *    a row begun out of data, and no colour conversion (a grey read takes
 *    grey or CMYK files, a colour read RGB or CMYK ones);
 *  - arithmetic-coded sequential and progressive files (SOF9, SOF10) as
 *    jdarith.c decodes them: the Qe table of jaricom.c, the DAC
 *    conditioning (L = 0, U = 1, Kx = 5 where no DAC defines a table),
 *    DC and AC first scans and refinements, restarts that reset the
 *    statistics, and libjpeg's "corrupt data" path: a magnitude or
 *    spectral overflow leaves the rest of the restart interval as it is;
 *  - libjpeg's fatal checks of the markers: SOF and DRI lengths exact, DAC
 *    indices and bounds, a scan's components in frame order, and in a
 *    progressive or lossless file no standard Huffman table stands in for
 *    a missing one.
 *
 * Lossless arithmetic-coded files (SOF11; libjpeg-turbo has no decoder for
 * them), hierarchical files, subsampled lossless files and other
 * precisions are refused with a message, as cv2.imread refuses them.  All
 * state lives in one struct on the caller's stack: threads decode at once.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAXC 4
#define MIN_GET_BITS 57
#define EOI_PAIRS 32768

static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    uint8_t bits[17];
    uint8_t vals[256];
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint16_t look[256]; /* (length << 8) | value; length 9: longer than 8 bits */
    int present;
} huff_t;

typedef struct {
    int id, h, v, tq;
    int bw, bh; /* width_in_blocks, height_in_blocks */
    int aw, ah; /* blocks allocated: whole MCUs */
    int dw, dh; /* downsampled width and height in samples */
    int16_t *coef;
    uint16_t *samples; /* lossless files: the undifferenced samples */
    int al, scanned;   /* lossless files: the point transform; whether a scan coded it */
    int dc_context;    /* arithmetic coding: the DC conditioning category */
    uint16_t q[64];
    int q_latched;
    int dc_tbl, ac_tbl;
    int coef_bits[64];
    int prev_bits[64];
    int last_dc;
    uint8_t *plane;
    int pstride;
} comp_t;

typedef struct {
    const uint8_t *data;
    size_t size, pos;
    int width, height, ncomp, progressive, lossless, arith, precision, seen_sof;
    int maxh, maxv, mcux, mcuy;
    comp_t comp[MAXC];
    uint16_t qt[4][64];
    int qt_present[4];
    huff_t dc[4], ac[4];
    int restart_interval;
    int saw_jfif, saw_adobe, adobe_transform;
    int scan_number, scans_done;
    int last_good_row;
    /* bit reader */
    uint64_t buf;
    int bits, marker, insufficient;
    /* current scan */
    int ns, scomp[MAXC], Ss, Se, Ah, Al;
    unsigned int eobrun;
    int restarts_to_go, next_restart;
    /* arithmetic decoding (jdarith.c): the DAC conditioning of the 16
     * tables, the C and A registers and the bit counter (-1 after an
     * error), and the statistics bins */
    uint8_t dac_L[16], dac_U[16], dac_K[16];
    int64_t ac_c, ac_a;
    int ac_ct;
    uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin[4];
    char *err;
    int errlen;
} jd_t;

static int fail_plain(char *err, int64_t errlen, const char *msg) {
    if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg);
    return -1;
}

static int fail(jd_t *d, const char *msg) { return fail_plain(d->err, d->errlen, msg); }

/* ---- markers -------------------------------------------------------- */

/* libjpeg's next_marker: skip to 0xFF, skip fill bytes, skip stuffed FF00.
 * The end of the data reads as the EOI that libjpeg's source inserts. */
static int scan_marker(jd_t *d) {
    for (;;) {
        while (d->pos < d->size && d->data[d->pos] != 0xFF) d->pos++;
        while (d->pos < d->size && d->data[d->pos] == 0xFF) d->pos++;
        if (d->pos >= d->size) return 0xD9;
        int c = d->data[d->pos++];
        if (c != 0) return c;
    }
}

static int next_marker(jd_t *d) {
    if (d->marker) {
        int m = d->marker;
        d->marker = 0;
        return m;
    }
    return scan_marker(d);
}

static int read_u16(jd_t *d, int *v) {
    if (d->pos + 2 > d->size) return -1;
    *v = (d->data[d->pos] << 8) | d->data[d->pos + 1];
    d->pos += 2;
    return 0;
}

/* ---- bit reader (jdhuff.c semantics) -------------------------------- */

static void fill(jd_t *d) {
    while (d->bits < MIN_GET_BITS && !d->marker) {
        int c;
        if (d->pos >= d->size) {
            d->marker = 0xD9;
            break;
        }
        c = d->data[d->pos++];
        if (c == 0xFF) {
            do {
                if (d->pos >= d->size) {
                    c = 0xD9;
                    break;
                }
                c = d->data[d->pos++];
            } while (c == 0xFF);
            if (c == 0) {
                c = 0xFF;
            } else {
                d->marker = c;
                break;
            }
        }
        d->buf = (d->buf << 8) | (uint64_t)c;
        d->bits += 8;
    }
}

/* Make n bits available; past the data they are zeros, and the segment is
 * marked as out of data (libjpeg's insufficient_data). */
static inline void need(jd_t *d, int n) {
    if (d->bits < n) {
        fill(d);
        if (d->bits < n) {
            d->insufficient = 1;
            d->buf <<= (MIN_GET_BITS - d->bits);
            d->bits = MIN_GET_BITS;
        }
    }
}

static inline int get_bits(jd_t *d, int n) {
    d->bits -= n;
    return (int)((d->buf >> d->bits) & ((1u << n) - 1));
}

static inline int extend(int x, int s) {
    return x < (1 << (s - 1)) ? x + (int)(-1u << s) + 1 : x;
}

static int huff_decode(jd_t *d, const huff_t *t) {
    int l;
    int32_t code;
    if (d->bits < 8) fill(d);
    if (d->bits >= 8) {
        int v = t->look[(d->buf >> (d->bits - 8)) & 0xFF];
        int nb = v >> 8;
        if (nb <= 8) {
            d->bits -= nb;
            return v & 0xFF;
        }
        l = 9;
    } else {
        l = 1;
    }
    need(d, l);
    code = get_bits(d, l);
    while (code > t->maxcode[l]) {
        code <<= 1;
        need(d, 1);
        code |= get_bits(d, 1);
        l++;
    }
    if (l > 16) return 0;
    return t->vals[(code + t->valoffset[l]) & 0xFF];
}

static int make_table(jd_t *d, huff_t *t) {
    int huffsize[257], huffcode[257];
    int p = 0, l, i, code, si;
    for (l = 1; l <= 16; l++)
        for (i = 0; i < t->bits[l]; i++) {
            if (p >= 256) return fail(d, "bad Huffman table");
            huffsize[p++] = l;
        }
    huffsize[p] = 0;
    code = 0;
    si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) {
            huffcode[p++] = code;
            code++;
        }
        if (code >= (1 << si)) return fail(d, "bad Huffman table");
        code <<= 1;
        si++;
    }
    p = 0;
    for (l = 1; l <= 16; l++) {
        if (t->bits[l]) {
            t->valoffset[l] = p - huffcode[p];
            p += t->bits[l];
            t->maxcode[l] = huffcode[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF;
    for (i = 0; i < 256; i++) t->look[i] = 9 << 8;
    p = 0;
    for (l = 1; l <= 8; l++)
        for (i = 1; i <= t->bits[l]; i++, p++) {
            int look = huffcode[p] << (8 - l);
            for (int ctr = 1 << (8 - l); ctr > 0; ctr--) t->look[look++] = (uint16_t)((l << 8) | t->vals[p]);
        }
    return 0;
}

/* ---- segments ------------------------------------------------------- */

static int seg_len(jd_t *d, size_t *end) {
    int len;
    if (read_u16(d, &len) || len < 2 || d->pos + (size_t)len - 2 > d->size)
        return fail(d, "JPEG segment runs past the end of the data");
    *end = d->pos + (size_t)len - 2;
    return 0;
}

static int parse_dqt(jd_t *d) {
    size_t end;
    if (seg_len(d, &end)) return -1;
    while (d->pos < end) {
        int pq = d->data[d->pos] >> 4, tq = d->data[d->pos] & 15;
        d->pos++;
        if (tq > 3) return fail(d, "bad quantization table id");
        if (d->pos + (size_t)(pq ? 128 : 64) > end) return fail(d, "short DQT segment");
        for (int i = 0; i < 64; i++) {
            int v = pq ? (d->data[d->pos] << 8) | d->data[d->pos + 1] : d->data[d->pos];
            d->pos += pq ? 2 : 1;
            d->qt[tq][natural_order[i]] = (uint16_t)v;
        }
        d->qt_present[tq] = 1;
    }
    d->pos = end;
    return 0;
}

static int parse_dht(jd_t *d) {
    size_t end;
    if (seg_len(d, &end)) return -1;
    while (d->pos < end) {
        int tc = d->data[d->pos] >> 4, th = d->data[d->pos] & 15, count = 0;
        d->pos++;
        if (th > 3 || tc > 1) return fail(d, "bad Huffman table id");
        if (d->pos + 16 > end) return fail(d, "short DHT segment");
        huff_t *t = tc ? &d->ac[th] : &d->dc[th];
        memset(t, 0, sizeof(*t));
        for (int l = 1; l <= 16; l++) count += (t->bits[l] = d->data[d->pos++]);
        if (count > 256 || d->pos + (size_t)count > end) return fail(d, "bad Huffman table");
        memcpy(t->vals, d->data + d->pos, (size_t)count);
        d->pos += (size_t)count;
        t->present = 1;
    }
    d->pos = end;
    return 0;
}

/* jdmarker.c get_dac: (index, value) pairs, index < 32 (16 and up: an AC
 * table's Kx), a DC pair's low bound L at most its high one U, and the
 * pairs filling the length exactly.  A later DAC overrides for later
 * scans. */
static int parse_dac(jd_t *d) {
    int len;
    if (read_u16(d, &len)) return fail(d, "JPEG segment runs past the end of the data");
    for (len -= 2; len > 0; len -= 2) {
        if (d->pos + 2 > d->size) return fail(d, "JPEG segment runs past the end of the data");
        int index = d->data[d->pos], val = d->data[d->pos + 1];
        d->pos += 2;
        if (index >= 32) return fail(d, "bad DAC index");
        if (index >= 16) {
            d->dac_K[index - 16] = (uint8_t)val;
        } else {
            d->dac_L[index] = (uint8_t)(val & 15);
            d->dac_U[index] = (uint8_t)(val >> 4);
            if (d->dac_L[index] > d->dac_U[index]) return fail(d, "bad DAC value");
        }
    }
    return len ? fail(d, "bad DAC segment length") : 0;
}

static int parse_sof(jd_t *d, int marker) {
    size_t end;
    if (seg_len(d, &end)) return -1;
    if (d->seen_sof) return fail(d, "JPEG file with two frames");
    if (end - d->pos < 6) return fail(d, "short SOF segment");
    const uint8_t *p = d->data + d->pos;
    d->lossless = marker == 0xC3;
    d->precision = p[0];
    /* libjpeg's 8-bit interface, which cv2 calls: 8 bits, 2 to 8 when lossless */
    if (d->lossless ? p[0] < 2 || p[0] > 8 : p[0] != 8)
        return fail(d, "JPEG sample precision other than 8 bits is not supported");
    d->height = (p[1] << 8) | p[2];
    d->width = (p[3] << 8) | p[4];
    d->ncomp = p[5];
    if (d->height == 0 || d->width == 0) return fail(d, "JPEG frame of zero size (DNL is not supported)");
    if (d->height > 65500 || d->width > 65500) return fail(d, "JPEG frame larger than libjpeg's 65500");
    if (d->ncomp < 1 || d->ncomp > MAXC || d->ncomp == 2)
        return fail(d, "JPEG with an unsupported number of components");
    if (end - d->pos != 6 + 3 * (size_t)d->ncomp) return fail(d, "bad SOF segment length");
    d->progressive = marker == 0xC2 || marker == 0xCA;
    d->arith = marker == 0xC9 || marker == 0xCA;
    d->maxh = d->maxv = 1;
    for (int c = 0; c < d->ncomp; c++) {
        comp_t *cp = &d->comp[c];
        cp->id = p[6 + 3 * c];
        cp->h = p[7 + 3 * c] >> 4;
        cp->v = p[7 + 3 * c] & 15;
        cp->tq = p[8 + 3 * c];
        if (cp->h < 1 || cp->h > 4 || cp->v < 1 || cp->v > 4)
            return fail(d, "bad sampling factor");
        if (d->lossless && (cp->h != 1 || cp->v != 1))
            return fail(d, "subsampled lossless JPEG files are not supported");
        if (cp->h > d->maxh) d->maxh = cp->h;
        if (cp->v > d->maxv) d->maxv = cp->v;
    }
    d->mcux = (d->width + 8 * d->maxh - 1) / (8 * d->maxh);
    d->mcuy = (d->height + 8 * d->maxv - 1) / (8 * d->maxv);
    for (int c = 0; c < d->ncomp; c++) {
        comp_t *cp = &d->comp[c];
        if (d->maxh % cp->h || d->maxv % cp->v) return fail(d, "fractional sampling factors are not supported");
        cp->bw = (int)(((int64_t)d->width * cp->h + 8 * d->maxh - 1) / (8 * d->maxh));
        cp->bh = (int)(((int64_t)d->height * cp->v + 8 * d->maxv - 1) / (8 * d->maxv));
        cp->dw = (int)(((int64_t)d->width * cp->h + d->maxh - 1) / d->maxh);
        cp->dh = (int)(((int64_t)d->height * cp->v + d->maxv - 1) / d->maxv);
        cp->aw = d->mcux * cp->h;
        cp->ah = d->mcuy * cp->v;
        if (d->lossless) {
            cp->samples = (uint16_t *)calloc((size_t)d->width * d->height, sizeof(uint16_t));
            if (!cp->samples) return fail(d, "out of memory");
            continue;
        }
        cp->coef = (int16_t *)calloc((size_t)cp->aw * cp->ah * 64, sizeof(int16_t));
        if (!cp->coef) return fail(d, "out of memory");
        for (int i = 0; i < 64; i++) cp->coef_bits[i] = -1;
    }
    d->seen_sof = 1;
    d->pos = end;
    return 0;
}

/* ITU T.81 Annex K.3: the tables libjpeg installs when a scan needs a
 * table 0 or 1 that no DHT defined (Motion-JPEG frames). */
static const uint8_t std_bits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},     /* DC luminance */
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},     /* DC chrominance */
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},  /* AC luminance */
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}}; /* AC chrominance */
static const uint8_t std_ac_vals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

/* The DC or AC table `id` a scan reads: defined by a DHT, else (in a
 * sequential DCT file) the standard one for ids 0 and 1; NULL (with a
 * message) otherwise. */
static huff_t *table_for_scan(jd_t *d, int dc, int id) {
    huff_t *t;
    if (id > 3) {
        fail(d, "bad Huffman table id");
        return NULL;
    }
    t = dc ? &d->dc[id] : &d->ac[id];
    if (!t->present) {
        if (id > 1 || d->progressive || d->lossless) {
            fail(d, "missing Huffman table");
            return NULL;
        }
        memset(t, 0, sizeof(*t));
        memcpy(t->bits, std_bits[(dc ? 0 : 2) + id], 17);
        if (dc)
            for (int k = 0; k < 12; k++) t->vals[k] = (uint8_t)k;
        else
            memcpy(t->vals, std_ac_vals[id], 162);
        t->present = 1;
    }
    return make_table(d, t) ? NULL : t;
}

static int parse_sos(jd_t *d) {
    size_t end;
    if (seg_len(d, &end)) return -1;
    if (!d->seen_sof) return fail(d, "SOS before SOF");
    const uint8_t *p = d->data + d->pos;
    int ns = p[0];
    if (ns < 1 || ns > d->ncomp || end - d->pos != 4 + 2 * (size_t)ns) return fail(d, "bad SOS segment");
    d->ns = ns;
    for (int i = 0; i < ns; i++) {
        int id = p[1 + 2 * i], c;
        for (c = 0; c < d->ncomp && d->comp[c].id != id; c++) {}
        /* jdmarker.c get_sos: a component whose frame index is below its
         * place in the scan finds its slot taken (frame order, no repeats) */
        if (c == d->ncomp || c < i) return fail(d, "SOS names an unknown component");
        d->scomp[i] = c;
        d->comp[c].dc_tbl = p[2 + 2 * i] >> 4;
        d->comp[c].ac_tbl = p[2 + 2 * i] & 15;
    }
    if (ns > 1) {
        int blocks = 0;
        for (int i = 0; i < ns; i++) blocks += d->comp[d->scomp[i]].h * d->comp[d->scomp[i]].v;
        if (blocks > 10) return fail(d, "more than 10 blocks in an MCU");
    }
    d->Ss = p[1 + 2 * ns];
    d->Se = p[2 + 2 * ns];
    d->Ah = p[3 + 2 * ns] >> 4;
    d->Al = p[3 + 2 * ns] & 15;
    d->pos = end;
    d->scan_number++;
    if (d->lossless) {
        /* jdlossls.c: a predictor 1-7, Se 0, Ah 0, Al below the precision;
         * restarts on whole MCU rows (jddiffct.c) */
        if (d->Ss < 1 || d->Ss > 7 || d->Se != 0 || d->Ah != 0 || d->Al >= d->precision)
            return fail(d, "bad lossless scan");
        if (d->restart_interval % d->width) return fail(d, "bad lossless restart interval");
        for (int i = 0; i < ns; i++) {
            comp_t *cp = &d->comp[d->scomp[i]];
            huff_t *t = table_for_scan(d, 1, cp->dc_tbl);
            int n = 0;
            if (!t) return -1;
            for (int l = 1; l <= 16; l++) n += t->bits[l];
            for (int k = 0; k < n; k++)
                if (t->vals[k] > 16) return fail(d, "bad Huffman table");
            cp->al = d->Al;
            cp->scanned = 1;
        }
        d->buf = 0;
        d->bits = 0;
        d->insufficient = 0;
        d->marker = 0;
        d->restarts_to_go = d->restart_interval;
        d->next_restart = 0;
        return 0;
    }
    if (d->progressive) {
        if (d->Ss == 0 ? d->Se != 0 : (d->Se < d->Ss || d->Se > 63 || ns != 1))
            return fail(d, "bad progressive scan");
        if (d->Al > 13 || (d->Ah && d->Ah - 1 != d->Al)) return fail(d, "bad progressive scan");
    } else {
        d->Ss = 0;
        d->Se = 63;
        d->Ah = d->Al = 0;
    }
    for (int i = 0; i < ns; i++) {
        comp_t *cp = &d->comp[d->scomp[i]];
        if (!cp->q_latched) {
            if (cp->tq > 3 || !d->qt_present[cp->tq]) return fail(d, "missing quantization table");
            memcpy(cp->q, d->qt[cp->tq], sizeof(cp->q));
            cp->q_latched = 1;
        }
        if (d->arith) {
            /* jdarith.c start_pass: fresh statistics for the tables the
             * scan codes with (the DC predictions and contexts restart at 0
             * below; a scan that codes no DC reads neither) */
            if (!d->progressive || (d->Ss == 0 && d->Ah == 0))
                memset(d->dc_stats[cp->dc_tbl], 0, sizeof(d->dc_stats[0]));
            if (!d->progressive || d->Ss) memset(d->ac_stats[cp->ac_tbl], 0, sizeof(d->ac_stats[0]));
        } else {
            /* only the tables this scan reads must exist, as libjpeg derives them */
            if (d->Ss == 0 && d->Ah == 0) {
                huff_t *t = table_for_scan(d, 1, cp->dc_tbl);
                int n = 0;
                if (!t) return -1;
                for (int l = 1; l <= 16; l++) n += t->bits[l];
                for (int k = 0; k < n; k++)
                    if (t->vals[k] > 15) return fail(d, "bad Huffman table");
            }
            if (d->Se > 0 && !table_for_scan(d, 0, cp->ac_tbl)) return -1;
        }
        if (d->progressive) {
            for (int k = d->Ss < 1 ? d->Ss : 1; k <= (d->Se > 9 ? d->Se : 9); k++)
                cp->prev_bits[k] = d->scan_number > 1 ? cp->coef_bits[k] : 0;
            for (int k = d->Ss; k <= d->Se; k++) cp->coef_bits[k] = d->Al;
        }
        cp->last_dc = 0;
        cp->dc_context = 0;
    }
    d->ac_c = d->ac_a = 0;
    d->ac_ct = -16; /* read two bytes into C first */
    d->eobrun = 0;
    d->buf = 0;
    d->bits = 0;
    d->insufficient = 0;
    d->marker = 0;
    d->restarts_to_go = d->restart_interval;
    d->next_restart = 0;
    return 0;
}

/* ---- entropy decoding of one block ---------------------------------- */

static void block_baseline(jd_t *d, comp_t *cp, int16_t *blk) {
    const huff_t *ac = &d->ac[cp->ac_tbl];
    int s = huff_decode(d, &d->dc[cp->dc_tbl]), r, k;
    if (s) {
        need(d, s);
        r = get_bits(d, s);
        s = extend(r, s);
    }
    s += cp->last_dc;
    cp->last_dc = s;
    blk[0] = (int16_t)s;
    for (k = 1; k < 64; k++) {
        s = huff_decode(d, ac);
        r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            need(d, s);
            r = get_bits(d, s);
            blk[natural_order[k]] = (int16_t)extend(r, s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
}

static void block_dc_first(jd_t *d, comp_t *cp, int16_t *blk) {
    int s = huff_decode(d, &d->dc[cp->dc_tbl]), r;
    if (s) {
        need(d, s);
        r = get_bits(d, s);
        s = extend(r, s);
    }
    s += cp->last_dc;
    cp->last_dc = s;
    blk[0] = (int16_t)(int)((unsigned)s << d->Al);
}

static void block_dc_refine(jd_t *d, int16_t *blk) {
    need(d, 1);
    if (get_bits(d, 1)) blk[0] = (int16_t)(blk[0] | (1 << d->Al));
}

static void block_ac_first(jd_t *d, comp_t *cp, int16_t *blk) {
    const huff_t *t = &d->ac[cp->ac_tbl];
    if (d->eobrun > 0) {
        d->eobrun--;
        return;
    }
    for (int k = d->Ss; k <= d->Se; k++) {
        int s = huff_decode(d, t), r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            need(d, s);
            r = get_bits(d, s);
            blk[natural_order[k]] = (int16_t)(int)((unsigned)extend(r, s) << d->Al);
        } else if (r == 15) {
            k += 15;
        } else {
            d->eobrun = 1u << r;
            if (r) {
                need(d, r);
                d->eobrun += (unsigned)get_bits(d, r);
            }
            d->eobrun--;
            break;
        }
    }
}

static void block_ac_refine(jd_t *d, comp_t *cp, int16_t *blk) {
    const huff_t *t = &d->ac[cp->ac_tbl];
    int p1 = 1 << d->Al, m1 = (int)(-1u << d->Al);
    int k = d->Ss, Se = d->Se;
    if (d->eobrun == 0) {
        for (; k <= Se; k++) {
            int s = huff_decode(d, t), r = s >> 4;
            s &= 15;
            if (s) {
                need(d, 1);
                s = get_bits(d, 1) ? p1 : m1;
            } else if (r != 15) {
                d->eobrun = 1u << r;
                if (r) {
                    need(d, r);
                    d->eobrun += (unsigned)get_bits(d, r);
                }
                break;
            }
            do {
                int16_t *c = blk + natural_order[k];
                if (*c != 0) {
                    need(d, 1);
                    if (get_bits(d, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= Se);
            if (s) blk[natural_order[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {
        for (; k <= Se; k++) {
            int16_t *c = blk + natural_order[k];
            if (*c != 0) {
                need(d, 1);
                if (get_bits(d, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
            }
        }
        d->eobrun--;
    }
}

static int arith_block(jd_t *d, comp_t *cp, int16_t *blk);

/* One block of the scan; -1 when an arithmetic decoder's error ends the
 * MCU. */
static int decode_block(jd_t *d, comp_t *cp, int16_t *blk) {
    if (d->arith)
        return arith_block(d, cp, blk);
    if (!d->progressive)
        block_baseline(d, cp, blk);
    else if (d->Ss == 0)
        d->Ah == 0 ? block_dc_first(d, cp, blk) : block_dc_refine(d, blk);
    else
        d->Ah == 0 ? block_ac_first(d, cp, blk) : block_ac_refine(d, cp, blk);
    return 0;
}

/* ---- arithmetic decoding (jdarith.c) -------------------------------- */

/* jaricom.c: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
 * Next_Index_LPS, T.81 Table D.2; the last entry is the fixed 0.5
 * estimate of T.851 that codes signs and DC refinement bits. */
#define V(qe, nlps, nmps, sw) (((int64_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
static const int64_t aritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

/* One binary decision (T.81 D.2.4-D.2.6, jdarith.c arith_decode).  A
 * marker inside the data stops the input: zeros follow, as the standard
 * allows, and the marker is left for the marker reader. */
static int arith_decode(jd_t *d, uint8_t *st) {
    while (d->ac_a < 0x8000) {
        if (--d->ac_ct < 0) {
            int data = 0;
            if (!d->marker) {
                data = d->data[d->pos++];
                if (data == 0xFF) {
                    do data = d->data[d->pos++];
                    while (data == 0xFF);
                    if (data == 0) {
                        data = 0xFF;
                    } else {
                        d->marker = data;
                        data = 0;
                    }
                }
            }
            d->ac_c = (int64_t)((uint64_t)d->ac_c << 8) | data;
            if ((d->ac_ct += 8) < 0 && ++d->ac_ct == 0) d->ac_a = 0x8000; /* two bytes in: A = 0x10000 below */
        }
        d->ac_a <<= 1;
    }
    int sv = *st;
    int64_t qe = aritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF), nm = (int)((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = d->ac_a - qe;
    d->ac_a = temp;
    temp = (int64_t)((uint64_t)temp << d->ac_ct);
    if (d->ac_c >= temp) {
        d->ac_c -= temp;
        /* conditional LPS exchange */
        if (d->ac_a < qe) {
            d->ac_a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            d->ac_a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (d->ac_a < 0x8000) {
        /* conditional MPS exchange */
        if (d->ac_a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* The magnitude bits of a value of category m (F.24) from the bins at
 * st, then v = sign * (bits + 1). */
static int arith_bits(jd_t *d, uint8_t *st, int m, int sign) {
    int v = m;
    while (m >>= 1)
        if (arith_decode(d, st)) v |= m;
    v += 1;
    return sign ? -v : v;
}

/* A DC difference (F.19, F.21-F.23, the conditioning of F.1.4.4.1)
 * added to the component's prediction mod 2^16.  -1 on a magnitude
 * overflow, which sets ct = -1: libjpeg's "corrupt data" warning. */
static int arith_dc(jd_t *d, comp_t *cp) {
    int tbl = cp->dc_tbl, sign, m;
    uint8_t *st = d->dc_stats[tbl] + cp->dc_context;
    if (arith_decode(d, st) == 0) {
        cp->dc_context = 0;
        return 0;
    }
    sign = arith_decode(d, st + 1);
    st += 2 + sign;
    if ((m = arith_decode(d, st)) != 0) {
        st = d->dc_stats[tbl] + 20;
        while (arith_decode(d, st)) {
            if ((m <<= 1) == 0x8000) {
                d->ac_ct = -1;
                return -1;
            }
            st++;
        }
    }
    if (m < (int)((1L << d->dac_L[tbl]) >> 1))
        cp->dc_context = 0;
    else if (m > (int)((1L << d->dac_U[tbl]) >> 1))
        cp->dc_context = 12 + sign * 4;
    else
        cp->dc_context = 4 + sign * 4;
    cp->last_dc = (cp->last_dc + arith_bits(d, st + 14, m, sign)) & 0xFFFF;
    return 0;
}

/* AC coefficients Ss..Se (F.20-F.24), each shifted left by Al.  -1 on a
 * spectral or magnitude overflow (ct = -1). */
static int arith_ac(jd_t *d, comp_t *cp, int16_t *blk, int Ss, int Se, int Al) {
    int tbl = cp->ac_tbl;
    for (int k = Ss; k <= Se; k++) {
        uint8_t *st = d->ac_stats[tbl] + 3 * (k - 1);
        int sign, m;
        if (arith_decode(d, st)) break; /* EOB */
        while (arith_decode(d, st + 1) == 0) {
            st += 3;
            if (++k > Se) {
                d->ac_ct = -1;
                return -1;
            }
        }
        sign = arith_decode(d, d->fixed_bin);
        st += 2;
        if ((m = arith_decode(d, st)) != 0 && arith_decode(d, st)) {
            m <<= 1;
            st = d->ac_stats[tbl] + (k <= d->dac_K[tbl] ? 189 : 217);
            while (arith_decode(d, st)) {
                if ((m <<= 1) == 0x8000) {
                    d->ac_ct = -1;
                    return -1;
                }
                st++;
            }
        }
        blk[natural_order[k]] = (int16_t)(int)((unsigned)arith_bits(d, st + 14, m, sign) << Al);
    }
    return 0;
}

/* A refinement scan's bits of AC coefficients Ss..Se (decode_mcu_AC_refine):
 * past the block's last nonzero coefficient of earlier scans an EOB bin,
 * then for each coefficient a correction bit if it was nonzero, else a
 * newly-nonzero bin and a sign. */
static int arith_ac_refine(jd_t *d, comp_t *cp, int16_t *blk) {
    int tbl = cp->ac_tbl, p1 = 1 << d->Al, m1 = (int)(-1u << d->Al), kex, k;
    for (kex = d->Se; kex > 0; kex--)
        if (blk[natural_order[kex]]) break;
    for (k = d->Ss; k <= d->Se; k++) {
        uint8_t *st = d->ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && arith_decode(d, st)) break; /* EOB */
        for (;;) {
            int16_t *c = blk + natural_order[k];
            if (*c) {
                if (arith_decode(d, st + 2)) *c = (int16_t)(*c < 0 ? *c + m1 : *c + p1);
                break;
            }
            if (arith_decode(d, st + 1)) {
                *c = (int16_t)(arith_decode(d, d->fixed_bin) ? m1 : p1);
                break;
            }
            st += 3;
            if (++k > d->Se) {
                d->ac_ct = -1;
                return -1;
            }
        }
    }
    return 0;
}

/* One block of an arithmetic-coded scan; -1 after an error. */
static int arith_block(jd_t *d, comp_t *cp, int16_t *blk) {
    if (!d->progressive) {
        if (arith_dc(d, cp)) return -1;
        blk[0] = (int16_t)cp->last_dc;
        return arith_ac(d, cp, blk, 1, 63, 0);
    }
    if (d->Ss == 0) {
        if (d->Ah) {
            if (arith_decode(d, d->fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << d->Al));
            return 0;
        }
        if (arith_dc(d, cp)) return -1;
        blk[0] = (int16_t)(int)((unsigned)cp->last_dc << d->Al);
        return 0;
    }
    return d->Ah ? arith_ac_refine(d, cp, blk) : arith_ac(d, cp, blk, d->Ss, d->Se, d->Al);
}

/* jdmarker.c read_restart_marker and jpeg_resync_to_restart */
static void process_restart(jd_t *d) {
    d->bits = 0;
    d->buf = 0;
    if (!d->marker) d->marker = scan_marker(d);
    int desired = d->next_restart;
    if (d->marker == 0xD0 + desired) {
        d->marker = 0;
    } else {
        for (;;) {
            int m = d->marker, action;
            if (m < 0xC0)
                action = 2;
            else if (m < 0xD0 || m > 0xD7)
                action = 3;
            else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7))
                action = 3;
            else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7))
                action = 2;
            else
                action = 1;
            if (action == 1) {
                d->marker = 0;
                break;
            }
            if (action == 3) break;
            d->marker = scan_marker(d);
        }
    }
    d->next_restart = (d->next_restart + 1) & 7;
    if (d->arith) {
        /* jdarith.c process_restart: the scan's statistics afresh, and C
         * and A read anew */
        for (int i = 0; i < d->ns; i++) {
            comp_t *cp = &d->comp[d->scomp[i]];
            if (!d->progressive || (d->Ss == 0 && d->Ah == 0)) {
                memset(d->dc_stats[cp->dc_tbl], 0, sizeof(d->dc_stats[0]));
                cp->dc_context = 0;
            }
            if (!d->progressive || d->Ss) memset(d->ac_stats[cp->ac_tbl], 0, sizeof(d->ac_stats[0]));
        }
        d->ac_c = d->ac_a = 0;
        d->ac_ct = -16;
    }
    for (int c = 0; c < d->ncomp; c++) d->comp[c].last_dc = 0;
    d->eobrun = 0;
    d->restarts_to_go = d->restart_interval;
    if (!d->marker) d->insufficient = 0;
}

/* jdlhuff.c + jdlossls.c: one Huffman-coded difference per sample (16:
 * 32768), added mod 2^16 to the prediction.  The first row of the scan
 * and of each restart interval predicts from the left (the first sample
 * from 2^(P - Pt - 1)), the first column from above, the rest by the
 * scan's predictor.  A row that runs out of data reads zero bits to its
 * end; a row begun out of data is uniform grey, 2^(P - Pt - 1) (the
 * first-row prediction of differences of 0). */
static void decode_scan_lossless(jd_t *d) {
    int W = d->width, first = 1;
    for (int y = 0; y < d->height; y++) {
        if (d->restart_interval && d->restarts_to_go == 0) {
            process_restart(d);
            first = 1;
        }
        int grey = d->insufficient;
        for (int x = 0; x < W; x++) {
            for (int i = 0; i < d->ns; i++) {
                comp_t *cp = &d->comp[d->scomp[i]];
                int diff = 0;
                if (!grey) {
                    int s = huff_decode(d, &d->dc[cp->dc_tbl]);
                    if (s == 16) {
                        diff = 32768;
                    } else if (s) {
                        need(d, s);
                        diff = extend(get_bits(d, s), s);
                    }
                }
                uint16_t *row = cp->samples + (size_t)y * W, *up = row - W;
                int pred;
                if (first || grey) {
                    pred = x ? row[x - 1] : 1 << (d->precision - d->Al - 1);
                } else if (!x) {
                    pred = up[0];
                } else {
                    int ra = row[x - 1], rb = up[x], rc = up[x - 1];
                    switch (d->Ss) {
                    case 1: pred = ra; break;
                    case 2: pred = rb; break;
                    case 3: pred = rc; break;
                    case 4: pred = ra + rb - rc; break;
                    case 5: pred = ra + ((rb - rc) >> 1); break;
                    case 6: pred = rb + ((ra - rc) >> 1); break;
                    default: pred = (ra + rb) >> 1; break;
                    }
                }
                row[x] = (uint16_t)((diff + pred) & 0xFFFF);
            }
            if (d->restart_interval) d->restarts_to_go--;
        }
        first = 0;
    }
    d->scans_done++;
}

static void decode_scan(jd_t *d) {
    if (d->lossless) {
        decode_scan_lossless(d);
        return;
    }
    int single = d->ns == 1;
    comp_t *c0 = &d->comp[d->scomp[0]];
    int mx_n = single ? c0->bw : d->mcux;
    int my_n = single ? c0->bh : d->mcuy;
    for (int my = 0; my < my_n; my++) {
        for (int mx = 0; mx < mx_n; mx++) {
            /* jdcoefct.c consume_data: the last good iMCU row (which rows
             * block smoothing treats as complete) moves on where the data
             * sufficed before this MCU, the restart it may begin with not
             * yet read */
            if (!d->insufficient) d->last_good_row = single ? my / c0->v : my;
            if (d->restart_interval && d->restarts_to_go == 0) process_restart(d);
            /* out of Huffman data, or after an arithmetic decoder's error
             * until the next restart: the MCU is left as it is */
            int err = d->insufficient || (d->arith && d->ac_ct == -1);
            if (single && !err) {
                decode_block(d, c0, c0->coef + ((size_t)my * c0->aw + mx) * 64);
            } else {
                for (int i = 0; i < d->ns && !err; i++) {
                    comp_t *cp = &d->comp[d->scomp[i]];
                    for (int yy = 0; yy < cp->v && !err; yy++)
                        for (int xx = 0; xx < cp->h && !err; xx++)
                            err = decode_block(d, cp, cp->coef + (((size_t)my * cp->v + yy) * cp->aw + (size_t)mx * cp->h + xx) * 64);
                }
            }
            if (d->restart_interval) d->restarts_to_go--;
        }
    }
    d->scans_done++;
}

/* ---- inverse DCT ---------------------------------------------------- */

/* libjpeg-turbo's islow IDCT as its x86 SIMD computes it (jidctint-sse2 /
 * -avx2, the path cv2 takes): the arithmetic of jidctint.c with the
 * constants folded into pairs for pmaddwd, dequantised coefficients and
 * the 16-bit sums of the odd part wrapping, each pass's results saturated
 * to 16 bits, and the output saturated to 8 bits around 128.  On valid
 * data this equals jidctint.c bit for bit; on the wild coefficients of a
 * damaged stream it is what cv2 returns.  A block whose AC coefficients
 * are all zero takes the shortcut of pass 1 (DC << 2, wrapping). */

#define F054 4433    /* FIX(0.541196100) */
#define F130 10703   /* FIX(0.541196100 + 0.765366865) */
#define MF130 -10704 /* FIX(0.541196100 - 1.847759065) */
#define F117 9633    /* FIX(1.175875602) */
#define MF078 -6436  /* FIX(1.175875602 - 1.961570560) */
#define F078 6437    /* FIX(1.175875602 - 0.390180644) */
#define MF060 -4927  /* FIX(0.298631336 - 0.899976223) */
#define MF089 -7373  /* -FIX(0.899976223) */
#define F060 4926    /* FIX(1.501321110 - 0.899976223) */
#define MF050 -4176  /* FIX(2.053119869 - 2.562915447) */
#define MF256 -20995 /* -FIX(2.562915447) */
#define F050 4177    /* FIX(3.072711026 - 2.562915447) */

static inline int16_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
static inline int16_t sat16(int32_t x) { return (int16_t)(x > 32767 ? 32767 : x < -32768 ? -32768 : x); }
static inline int32_t add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
static inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
static inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {
    return add32(a * ca, b * cb);
}

/* One 8-point pass over in[0], in[step], ...: 11-bit descale for pass 1,
 * 18-bit for pass 2. */
static inline void idct_1d(const int16_t *in, int step, int16_t *out, int ostep, int shift) {
    int16_t i0 = in[0], i1 = in[step], i2 = in[2 * step], i3 = in[3 * step];
    int16_t i4 = in[4 * step], i5 = in[5 * step], i6 = in[6 * step], i7 = in[7 * step];
    int32_t t3 = madd(i2, F130, i6, F054), t2 = madd(i2, F054, i6, MF130);
    int32_t t0 = (int32_t)wrap16(i0 + i4) * 8192, t1 = (int32_t)wrap16(i0 - i4) * 8192;
    int32_t t10 = add32(t0, t3), t13 = sub32(t0, t3), t11 = add32(t1, t2), t12 = sub32(t1, t2);
    int16_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
    int32_t z3p = madd(z3, MF078, z4, F117), z4p = madd(z3, F117, z4, F078);
    int32_t o0 = add32(madd(i7, MF060, i1, MF089), z3p);
    int32_t o3 = add32(madd(i7, MF089, i1, F060), z4p);
    int32_t o1 = add32(madd(i5, MF050, i3, MF256), z4p);
    int32_t o2 = add32(madd(i5, MF256, i3, F050), z3p);
    int32_t r = 1 << (shift - 1);
    out[0] = sat16(add32(add32(t10, o3), r) >> shift);
    out[7 * ostep] = sat16(add32(sub32(t10, o3), r) >> shift);
    out[1 * ostep] = sat16(add32(add32(t11, o2), r) >> shift);
    out[6 * ostep] = sat16(add32(sub32(t11, o2), r) >> shift);
    out[2 * ostep] = sat16(add32(add32(t12, o1), r) >> shift);
    out[5 * ostep] = sat16(add32(sub32(t12, o1), r) >> shift);
    out[3 * ostep] = sat16(add32(add32(t13, o0), r) >> shift);
    out[4 * ostep] = sat16(add32(sub32(t13, o0), r) >> shift);
}

static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int stride) {
    int16_t deq[64], ws[64], row[8];
    int ac = 0;
    for (int i = 8; i < 64; i++) ac |= in[i];
    if (!ac) {
        for (int c = 0; c < 8; c++) {
            int16_t dc = wrap16((int32_t)((uint32_t)(in[c] * q[c]) << 2));
            for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
        }
    } else {
        for (int i = 0; i < 64; i++) deq[i] = wrap16(in[i] * q[i]);
        for (int c = 0; c < 8; c++) idct_1d(deq + c, 8, ws + c, 8, 11);
    }
    for (int r = 0; r < 8; r++) {
        uint8_t *op = out + (size_t)r * stride;
        idct_1d(ws + 8 * r, 1, row, 1, 18);
        for (int i = 0; i < 8; i++) op[i] = (uint8_t)((row[i] > 127 ? 127 : row[i] < -128 ? -128 : row[i]) + 128);
    }
}

/* ---- block smoothing (jdcoefct.c, libjpeg-turbo >= 2.1) -------------- */

#define SAVED_COEFS 10

static int smoothing_ok(jd_t *d, int latch[MAXC][SAVED_COEFS], int prev_latch[MAXC][SAVED_COEFS]) {
    static const int qpos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    int useful = 0;
    if (!d->progressive) return 0;
    for (int c = 0; c < d->ncomp; c++) {
        comp_t *cp = &d->comp[c];
        if (!cp->q_latched) return 0;
        for (int i = 0; i < 10; i++)
            if (cp->q[qpos[i]] == 0) return 0;
        if (cp->coef_bits[0] < 0) return 0;
        latch[c][0] = cp->coef_bits[0];
        for (int k = 1; k < SAVED_COEFS; k++) {
            prev_latch[c][k] = d->scan_number > 1 ? cp->prev_bits[k] : -1;
            latch[c][k] = cp->coef_bits[k];
            if (cp->coef_bits[k] != 0) useful = 1;
        }
    }
    return useful;
}

static inline int smooth_pred(int64_t num, int64_t q, int Al) {
    int pred;
    if (num >= 0) {
        pred = (int)(((q << 7) + num) / (q << 8));
        if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
    } else {
        pred = (int)(((q << 7) - num) / (q << 8));
        if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
        pred = -pred;
    }
    return pred;
}

static void idct_smoothed(jd_t *d, comp_t *cp, const int *latch, const int *prev_latch) {
    int total = d->mcuy;
    int last_imcu = total - 1;
    int last_col = cp->bw - 1;
    int16_t ws[64];
    const uint16_t *q = cp->q;
    int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2];
    int64_t Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
    for (int row = 0; row < total; row++) {
        int block_rows;
        if (row < last_imcu) {
            block_rows = cp->v;
        } else {
            block_rows = cp->bh % cp->v;
            if (block_rows == 0) block_rows = cp->v;
        }
        const int *cb = row > d->last_good_row ? prev_latch : latch;
        int change_dc = 1;
        for (int k = 1; k <= 9; k++)
            if (cb[k] != -1) change_dc = 0;
        int image_block_rows = block_rows * total;
        for (int b = 0; b < block_rows; b++) {
            int R = row * cp->v + b;
            int ibr = row * block_rows + b;
            const int16_t *cur = cp->coef + (size_t)R * cp->aw * 64;
            const int16_t *prev = ibr > 0 ? cur - (size_t)cp->aw * 64 : cur;
            const int16_t *pprev = ibr > 1 ? cur - (size_t)2 * cp->aw * 64 : prev;
            const int16_t *next = ibr < image_block_rows - 1 ? cur + (size_t)cp->aw * 64 : cur;
            const int16_t *nnext = ibr < image_block_rows - 2 ? cur + (size_t)2 * cp->aw * 64 : next;
            for (int bn = 0; bn <= last_col; bn++) {
                /* the 5x5 window of DC values, columns clamped to the component */
                int col[5], DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13,
                    DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
                for (int k = 0; k < 5; k++) {
                    int x = bn + k - 2;
                    col[k] = 64 * (x < 0 ? 0 : x > last_col ? last_col : x);
                }
                DC01 = pprev[col[0]]; DC02 = pprev[col[1]]; DC03 = pprev[col[2]]; DC04 = pprev[col[3]]; DC05 = pprev[col[4]];
                DC06 = prev[col[0]]; DC07 = prev[col[1]]; DC08 = prev[col[2]]; DC09 = prev[col[3]]; DC10 = prev[col[4]];
                DC11 = cur[col[0]]; DC12 = cur[col[1]]; DC13 = cur[col[2]]; DC14 = cur[col[3]]; DC15 = cur[col[4]];
                DC16 = next[col[0]]; DC17 = next[col[1]]; DC18 = next[col[2]]; DC19 = next[col[3]]; DC20 = next[col[4]];
                DC21 = nnext[col[0]]; DC22 = nnext[col[1]]; DC23 = nnext[col[2]]; DC24 = nnext[col[3]]; DC25 = nnext[col[4]];
                memcpy(ws, cur + (size_t)bn * 64, sizeof(ws));
                int Al;
                int64_t num;
                if ((Al = cb[1]) != 0 && ws[1] == 0) {
                    num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                              3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                              3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                              DC24 + DC25)
                                           : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                    ws[1] = (int16_t)smooth_pred(num, Q01, Al);
                }
                if ((Al = cb[2]) != 0 && ws[8] == 0) {
                    num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                              13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 -
                                              38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                                              3 * DC24 + DC25)
                                           : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                    ws[8] = (int16_t)smooth_pred(num, Q10, Al);
                }
                if ((Al = cb[3]) != 0 && ws[16] == 0) {
                    num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                              5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                           : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                    ws[16] = (int16_t)smooth_pred(num, Q20, Al);
                }
                if ((Al = cb[4]) != 0 && ws[9] == 0) {
                    num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                              DC21 - DC25)
                                           : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                              DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
                    ws[9] = (int16_t)smooth_pred(num, Q11, Al);
                }
                if ((Al = cb[5]) != 0 && ws[2] == 0) {
                    num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                              7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                           : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                    ws[2] = (int16_t)smooth_pred(num, Q02, Al);
                }
                if (change_dc) {
                    if ((Al = cb[6]) != 0 && ws[3] == 0) {
                        num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
                        ws[3] = (int16_t)smooth_pred(num, Q03, Al);
                    }
                    if ((Al = cb[7]) != 0 && ws[10] == 0) {
                        num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
                        ws[10] = (int16_t)smooth_pred(num, Q12, Al);
                    }
                    if ((Al = cb[8]) != 0 && ws[17] == 0) {
                        num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
                        ws[17] = (int16_t)smooth_pred(num, Q21, Al);
                    }
                    if ((Al = cb[9]) != 0 && ws[24] == 0) {
                        num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
                        ws[24] = (int16_t)smooth_pred(num, Q30, Al);
                    }
                    num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                                 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                                 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                                 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
                    ws[0] = (int16_t)smooth_pred(num, Q00, 0);
                }
                idct_islow(ws, q, cp->plane + (size_t)R * 8 * cp->pstride + (size_t)bn * 8, cp->pstride);
            }
        }
    }
}

/* ---- upsampling (jdsample.c) ---------------------------------------- */

static inline const uint8_t *prow(const comp_t *cp, int r) {
    if (r < 0) r = 0;
    if (r > cp->dh - 1) r = cp->dh - 1;
    return cp->plane + (size_t)r * cp->pstride;
}

/* Output row y of component cp at full resolution into out[0 .. width). */
static void upsample_row(const jd_t *d, const comp_t *cp, int y, uint8_t *out) {
    int hx = d->maxh / cp->h, vy = d->maxv / cp->v, dw = cp->dw, i;
    if (hx == 1 && vy == 1) {
        memcpy(out, prow(cp, y), (size_t)d->width);
    } else if (hx == 2 && vy == 1 && dw > 2) {
        const uint8_t *in = prow(cp, y);
        out[0] = in[0];
        out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (i = 1; i < dw - 1; i++) {
            int v = in[i] * 3;
            out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
            out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
        }
        out[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        out[2 * dw - 1] = in[dw - 1];
    } else if (hx == 1 && vy == 2) {
        int r = y >> 1, below = y & 1;
        const uint8_t *n = prow(cp, r), *f = prow(cp, below ? r + 1 : r - 1);
        int bias = below ? 2 : 1;
        for (i = 0; i < dw; i++) out[i] = (uint8_t)((n[i] * 3 + f[i] + bias) >> 2);
    } else if (hx == 2 && vy == 2 && dw > 2) {
        int r = y >> 1, below = y & 1;
        const uint8_t *n = prow(cp, r), *f = prow(cp, below ? r + 1 : r - 1);
        int this_s = n[0] * 3 + f[0], next_s = n[1] * 3 + f[1], last_s;
        out[0] = (uint8_t)((this_s * 4 + 8) >> 4);
        out[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
        last_s = this_s;
        this_s = next_s;
        for (i = 1; i < dw - 1; i++) {
            next_s = n[i + 1] * 3 + f[i + 1];
            out[2 * i] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
            out[2 * i + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
            last_s = this_s;
            this_s = next_s;
        }
        out[2 * dw - 2] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
        out[2 * dw - 1] = (uint8_t)((this_s * 4 + 7) >> 4);
    } else {
        const uint8_t *in = prow(cp, y / vy);
        for (i = 0; i < d->width; i++) out[i] = in[i / hx];
    }
}

/* ---- colour conversion (jdcolor.c, OpenCV's CMYK -> BGR) ------------- */

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

typedef struct {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
} ycc_tab_t;

static void build_ycc(ycc_tab_t *t) {
    for (int i = 0, x = -128; i < 256; i++, x++) {
        t->cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        t->cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        t->cr_g[i] = (-FIX(0.71414)) * x;
        t->cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
}

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

enum { CS_GRAY, CS_YCC, CS_RGB, CS_CMYK, CS_YCCK };

static int colorspace(const jd_t *d) {
    if (d->ncomp == 1) return CS_GRAY;
    if (d->ncomp == 3) {
        if (d->saw_jfif) return CS_YCC;
        if (d->lossless && !d->saw_adobe) return CS_RGB; /* libjpeg assumes RGB there */
        if (d->saw_adobe) return d->adobe_transform == 0 ? CS_RGB : CS_YCC;
        if (d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66) return CS_RGB;
        return CS_YCC;
    }
    if (d->saw_adobe) return d->adobe_transform == 0 ? CS_CMYK : CS_YCCK;
    return CS_CMYK;
}

/* The planes a read needs: a grey read of a grey or YCbCr file takes Y
 * alone (libjpeg marks the chroma components not needed). */
static int planes_needed(const jd_t *d, int gray) {
    int cs = colorspace(d);
    return gray && (cs == CS_GRAY || cs == CS_YCC) ? 1 : d->ncomp;
}

/* BGR -> grey of a grey read: libjpeg's rgb_gray_convert for an RGB file
 * (16-bit weights), OpenCV's icvCvt_CMYK2Gray_8u_C4C1R (14-bit weights,
 * descaled) on the CMYK that libjpeg gives for a CMYK or YCCK file. */
static inline uint8_t grey_of(int cs, int b, int g, int r) {
    if (cs == CS_RGB) return (uint8_t)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
    return (uint8_t)((1868 * b + 9617 * g + 4899 * r + 8192) >> 14);
}

static int output(jd_t *d, uint8_t *out, int gray) {
    int cs = colorspace(d), W = d->width, n = planes_needed(d, gray);
    uint8_t *rows = (uint8_t *)malloc((size_t)MAXC * (W + 16));
    if (!rows) return fail(d, "out of memory");
    ycc_tab_t tab;
    build_ycc(&tab);
    for (int y = 0; y < d->height; y++) {
        for (int c = 0; c < n; c++) upsample_row(d, &d->comp[c], y, rows + (size_t)c * (W + 16));
        const uint8_t *c0 = rows, *c1 = rows + (W + 16), *c2 = rows + 2 * (W + 16), *c3 = rows + 3 * (W + 16);
        if (gray && n == 1) {
            memcpy(out + (size_t)y * W, c0, (size_t)W);
            continue;
        }
        uint8_t *o = out + (size_t)y * W * (gray ? 1 : 3);
        for (int x = 0; x < W; x++, o += gray ? 1 : 3) {
            int b, g, r;
            if (cs == CS_GRAY) {
                b = g = r = c0[x];
            } else if (cs == CS_RGB) {
                r = c0[x];
                g = c1[x];
                b = c2[x];
            } else {
                int Y = c0[x], cb = c1[x], cr = c2[x];
                int rr = clamp255(Y + tab.cr_r[cr]);
                int gg = clamp255(Y + (int)((tab.cb_g[cb] + tab.cr_g[cr]) >> SCALEBITS));
                int bb = clamp255(Y + tab.cb_b[cb]);
                if (cs == CS_YCC) {
                    r = rr;
                    g = gg;
                    b = bb;
                } else {
                    int C, M, Yl, K = c3[x];
                    if (cs == CS_YCCK) {
                        C = clamp255(255 - (Y + tab.cr_r[cr]));
                        M = clamp255(255 - (Y + (int)((tab.cb_g[cb] + tab.cr_g[cr]) >> SCALEBITS)));
                        Yl = clamp255(255 - (Y + tab.cb_b[cb]));
                    } else {
                        C = c0[x];
                        M = c1[x];
                        Yl = c2[x];
                    }
                    r = K - (((255 - C) * K) >> 8);
                    g = K - (((255 - M) * K) >> 8);
                    b = K - (((255 - Yl) * K) >> 8);
                }
            }
            if (gray) {
                o[0] = grey_of(cs, b, g, r);
                continue;
            }
            o[0] = (uint8_t)b;
            o[1] = (uint8_t)g;
            o[2] = (uint8_t)r;
        }
    }
    free(rows);
    return 0;
}

/* A lossless file's output planes: the samples shifted left by the point
 * transform to 8 bits.  libjpeg converts no colour space in lossless mode:
 * a grey read takes a grey or CMYK file, a colour read an RGB or CMYK one
 * (OpenCV converts the CMYK); every component must have been coded. */
static int lossless_planes(jd_t *d, int gray) {
    int cs = colorspace(d);
    if (gray ? cs != CS_GRAY && cs != CS_CMYK : cs != CS_RGB && cs != CS_CMYK)
        return fail(d, "lossless JPEG file read in another colour space (libjpeg converts none)");
    for (int c = 0; c < d->ncomp; c++) {
        comp_t *cp = &d->comp[c];
        if (!cp->scanned) return fail(d, "a component of the lossless JPEG file has no scan");
        size_t n = (size_t)d->width * d->height;
        cp->pstride = d->width;
        cp->plane = (uint8_t *)malloc(n);
        if (!cp->plane) return fail(d, "out of memory");
        for (size_t i = 0; i < n; i++) cp->plane[i] = (uint8_t)(cp->samples[i] << cp->al);
    }
    return 0;
}

/* ---- entry points --------------------------------------------------- */

static int decode_all(jd_t *d, int gray) {
    int m;
    if (d->size < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8) return fail(d, "not a JPEG file");
    d->pos = 2;
    for (;;) {
        m = next_marker(d);
        if (m == 0xD9) break;
        if (m >= 0xC0 && m <= 0xC3) {
            if (parse_sof(d, m)) return -1;
        } else if (m == 0xC9 || m == 0xCA) {
            if (parse_sof(d, m)) return -1;
        } else if (m == 0xCB) {
            /* libjpeg-turbo reads the frame, then has no decoder for it */
            return fail(d, "lossless arithmetic-coded JPEG files are not supported");
        } else if ((m >= 0xC5 && m <= 0xC8) || (m >= 0xCD && m <= 0xCF)) {
            return fail(d, "hierarchical JPEG files are not supported");
        } else if (m == 0xC4) {
            if (parse_dht(d)) return -1;
        } else if (m == 0xDB) {
            if (parse_dqt(d)) return -1;
        } else if (m == 0xDD) {
            size_t end;
            int ri = 0;
            if (seg_len(d, &end) || end - d->pos != 2 || read_u16(d, &ri)) return fail(d, "bad DRI segment");
            d->restart_interval = ri;
            d->pos = end;
        } else if (m == 0xDA) {
            if (parse_sos(d)) return -1;
            decode_scan(d);
            /* libjpeg decodes a sequential file whose first scan holds every
             * component in one pass: what follows that scan is never read */
            if (!d->progressive && d->scans_done == 1 && d->ns == d->ncomp) break;
        } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
            /* parameterless markers outside a scan: libjpeg passes over them */
        } else if (m == 0xD8) {
            return fail(d, "JPEG file with two SOI markers");
        } else if (m == 0xCC) {
            if (parse_dac(d)) return -1;
        } else if (!(m >= 0xE0 && m <= 0xEF) && m != 0xFE && m != 0xDC) {
            return fail(d, "unknown or reserved JPEG marker");
        } else {
            /* APPn, COM, DNL: libjpeg skips length - 2 bytes, none when
             * the length is under 2 */
            int len16;
            if (read_u16(d, &len16)) return fail(d, "JPEG segment runs past the end of the data");
            size_t len = len16 > 2 ? (size_t)len16 - 2 : 0, end = d->pos + len;
            if (end > d->size) return fail(d, "JPEG segment runs past the end of the data");
            const uint8_t *p = d->data + d->pos;
            if (m == 0xE0 && len >= 14 && memcmp(p, "JFIF\0", 5) == 0) d->saw_jfif = 1;
            if (m == 0xEE && len >= 12 && memcmp(p, "Adobe", 5) == 0) {
                d->saw_adobe = 1;
                d->adobe_transform = p[11];
            }
            d->pos = end;
        }
    }
    if (!d->seen_sof || d->scans_done == 0) return fail(d, "JPEG file has no image data");
    if (d->lossless) return lossless_planes(d, gray);
    int latch[MAXC][SAVED_COEFS], prev_latch[MAXC][SAVED_COEFS];
    memset(prev_latch, 0, sizeof(prev_latch));
    int smooth = smoothing_ok(d, latch, prev_latch);
    int needed = planes_needed(d, gray);
    for (int c = 0; c < needed; c++) {
        comp_t *cp = &d->comp[c];
        cp->pstride = cp->bw * 8;
        cp->plane = (uint8_t *)malloc((size_t)cp->pstride * cp->bh * 8);
        if (!cp->plane) return fail(d, "out of memory");
        if (smooth) {
            idct_smoothed(d, cp, latch[c], prev_latch[c]);
        } else {
            for (int by = 0; by < cp->bh; by++)
                for (int bx = 0; bx < cp->bw; bx++)
                    idct_islow(cp->coef + ((size_t)by * cp->aw + bx) * 64, cp->q,
                               cp->plane + (size_t)by * 8 * cp->pstride + (size_t)bx * 8, cp->pstride);
        }
    }
    return 0;
}

/* Decode `size` bytes of JPEG into out: (height, width, 3) BGR, or
 * (height, width) with gray = 1.  out_size must be that many bytes.
 * Returns 0, or -1 with a message in err. */
int64_t jpeg_decode(const uint8_t *data, int64_t size, uint8_t *out, int64_t height, int64_t width,
                    int64_t gray, char *err, int64_t errlen) {
    jd_t d;
    int rc;
    /* Past its end the data reads as libjpeg's stdio source gives it: the
     * inserted EOI marker, FF D9, over and over (enough for any segment). */
    uint8_t *padded = (uint8_t *)malloc((size_t)size + 2 * EOI_PAIRS);
    if (!padded) return fail_plain(err, errlen, "out of memory");
    memcpy(padded, data, (size_t)size);
    for (size_t i = 0; i < EOI_PAIRS; i++) {
        padded[size + 2 * i] = 0xFF;
        padded[size + 2 * i + 1] = 0xD9;
    }
    memset(&d, 0, sizeof(d));
    /* jdmarker.c get_soi: the conditioning of tables no DAC defines */
    memset(d.dac_U, 1, sizeof(d.dac_U));
    memset(d.dac_K, 5, sizeof(d.dac_K));
    d.fixed_bin[0] = 113;
    d.data = padded;
    d.size = (size_t)size + 2 * EOI_PAIRS;
    d.err = err;
    d.errlen = (int)errlen;
    rc = decode_all(&d, (int)gray);
    if (rc == 0 && (d.height != height || d.width != width)) rc = fail(&d, "JPEG size differs from its header");
    if (rc == 0) rc = output(&d, out, (int)gray);
    for (int c = 0; c < MAXC; c++) {
        free(d.comp[c].coef);
        free(d.comp[c].samples);
        free(d.comp[c].plane);
    }
    free(padded);
    return rc;
}
