/* PNG row unfiltering (ISO/IEC 15948, section 9): None, Sub, Up, Average
 * and Paeth, for 8-bit samples.  Built by cvpytorch_tpu_torch/native and
 * called by cvpytorch_tpu_torch/data/png.py; the numpy version there is
 * the plain reference the tests hold this to.
 *
 * raw: h rows of 1 + stride bytes (the filter type, then the filtered
 * row); out: h rows of stride bytes; bpp: bytes per complete pixel.
 * Returns 0, the 1-based row of the first unknown filter type, or -1 when
 * out of memory.
 */
#include <stdint.h>
#include <stdlib.h>

/* The Paeth predictor, in libpng's arrangement (pa = |p - a| = |b - c|,
 * pb = |p - b| = |a - c|, pc = |p - c|; ties go to a, then b). */
static inline int paeth(int a, int b, int c) {
    int p = b - c, q = a - c;
    int pa = abs(p), pb = abs(q), pc = abs(p + q);
    if (pb < pa) {
        pa = pb;
        a = b;
    }
    return pc < pa ? c : a;
}

int64_t png_unfilter(const uint8_t *raw, int64_t h, int64_t stride, int64_t bpp,
                     uint8_t *out) {
    uint8_t *zeros = (uint8_t *)calloc((size_t)(stride > 0 ? stride : 1), 1);
    if (!zeros) return -1;
    int64_t bad = 0;
    for (int64_t y = 0; y < h && !bad; y++) {
        const uint8_t *in = raw + y * (stride + 1) + 1;
        uint8_t *row = out + y * stride;
        const uint8_t *prev = y ? row - stride : zeros;
        int64_t first = bpp < stride ? bpp : stride, x;
        switch (raw[y * (stride + 1)]) {
        case 0:
            for (x = 0; x < stride; x++) row[x] = in[x];
            break;
        case 1:
            for (x = 0; x < first; x++) row[x] = in[x];
            for (; x < stride; x++) row[x] = (uint8_t)(in[x] + row[x - bpp]);
            break;
        case 2:
            for (x = 0; x < stride; x++) row[x] = (uint8_t)(in[x] + prev[x]);
            break;
        case 3:
            for (x = 0; x < first; x++) row[x] = (uint8_t)(in[x] + (prev[x] >> 1));
            for (; x < stride; x++) row[x] = (uint8_t)(in[x] + ((row[x - bpp] + prev[x]) >> 1));
            break;
        case 4:
            for (x = 0; x < first; x++) row[x] = (uint8_t)(in[x] + prev[x]);
            for (; x < stride; x++)
                row[x] = (uint8_t)(in[x] + paeth(row[x - bpp], prev[x], prev[x - bpp]));
            break;
        default:
            bad = y + 1;
        }
    }
    free(zeros);
    return bad;
}
