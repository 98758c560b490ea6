/* Writes an arithmetic-coded JPEG file through libjpeg's compressor (the
 * fixtures of this directory were written by libjpeg-turbo 2.1.5's
 * libjpeg.so.62).  `python -m tests.test_torch_jpeg --write-arith-fixtures`
 * builds and runs it:
 *
 *   write_arith in.raw width height components out.jpg h_samp v_samp
 *               quality mode restart_rows dc_L dc_U ac_K
 *
 * in.raw holds height x width x components bytes (grey, or RGB).  mode 0
 * is sequential with all components in one scan, 1 sequential with one
 * scan per component, 2 progressive (jpeg_simple_progression: spectral
 * selection and successive approximation with refinement scans).  The
 * first component takes the sampling factors h_samp x v_samp, the others
 * 1 x 1.  dc_L, dc_U and ac_K set table 0's DAC conditioning. */
#include <stdio.h>
#include <stdlib.h>

#include <jpeglib.h>

int main(int argc, char **argv) {
    struct jpeg_compress_struct cinfo;
    struct jpeg_error_mgr jerr;
    jpeg_scan_info scans[4];
    if (argc != 14) {
        fprintf(stderr, "usage: see the head of write_arith.c\n");
        return 2;
    }
    int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
    int mode = atoi(argv[9]);
    FILE *in = fopen(argv[1], "rb"), *out = fopen(argv[5], "wb");
    if (!in || !out) return 1;
    unsigned char *pix = malloc((size_t)w * h * nc);
    if (fread(pix, 1, (size_t)w * h * nc, in) != (size_t)w * h * nc) return 1;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_compress(&cinfo);
    jpeg_stdio_dest(&cinfo, out);
    cinfo.image_width = w;
    cinfo.image_height = h;
    cinfo.input_components = nc;
    cinfo.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, atoi(argv[8]), TRUE);
    cinfo.arith_code = TRUE;
    cinfo.comp_info[0].h_samp_factor = atoi(argv[6]);
    cinfo.comp_info[0].v_samp_factor = atoi(argv[7]);
    for (int c = 1; c < nc; c++) cinfo.comp_info[c].h_samp_factor = cinfo.comp_info[c].v_samp_factor = 1;
    cinfo.restart_in_rows = atoi(argv[10]);
    cinfo.arith_dc_L[0] = (UINT8)atoi(argv[11]);
    cinfo.arith_dc_U[0] = (UINT8)atoi(argv[12]);
    cinfo.arith_ac_K[0] = (UINT8)atoi(argv[13]);
    if (mode == 1) {
        for (int c = 0; c < nc; c++) {
            scans[c].comps_in_scan = 1;
            scans[c].component_index[0] = c;
            scans[c].Ss = 0;
            scans[c].Se = 63;
            scans[c].Ah = scans[c].Al = 0;
        }
        cinfo.scan_info = scans;
        cinfo.num_scans = nc;
    } else if (mode == 2) {
        jpeg_simple_progression(&cinfo);
    }
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = pix + (size_t)cinfo.next_scanline * w * nc;
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    fclose(out);
    fclose(in);
    free(pix);
    return 0;
}
