/* PNG row unfiltering on the host (the port's stand-in for the unfilter
 * step of libpng, which cv2 and Pillow run in the JAX package).
 *
 * Not a port of a TPU kernel: the JAX package decodes PNGs on the host
 * too. The Average and Paeth filters are sequential along a row (each byte
 * needs the byte bpp before it once decoded), so a numpy version has to
 * walk the image in anti-diagonals; this plain C loop takes one pass.
 * Built at first use with the system C compiler (-O2 -shared -fPIC) and
 * called through ctypes, which releases the GIL, so the data loader's
 * threads decode in parallel. The plain numpy version beside it is
 * stc_unet_tpu_torch/utils/png.py:unfilter_reference.
 *
 * src holds `height` filtered rows of 1 + row_bytes bytes each (a filter
 * type byte, then the row); dst receives the height * row_bytes bytes of
 * the image. bpp is the bytes of one pixel (1 to 4 at 8 bits a sample).
 * Returns 0, or 1 + the index of the first row whose filter type is not
 * 0 to 4 (dst is then incomplete).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* p = a + b - c; the neighbour nearest p, ties to a, then b. With masks
   and no branch: on noisy rows the branches mispredict about half the
   time. */
static inline int paeth(int a, int b, int c) {
    const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
    const int take_b = -(pb <= pc);
    const int take_a = -((pa <= pb) & (pa <= pc));
    const int bc = (b & take_b) | (c & ~take_b);
    return (a & take_a) | (bc & ~take_a);
}

int64_t stc_png_unfilter(const uint8_t *src, uint8_t *dst, int64_t height,
                         int64_t row_bytes, int32_t bpp) {
    const int64_t lead = bpp < row_bytes ? bpp : row_bytes;
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t *in = src + y * (row_bytes + 1) + 1;
        const int filter = in[-1];
        uint8_t *out = dst + y * row_bytes;
        /* the first row's upper neighbours are 0: Up is None, Average
           halves the left byte, Paeth takes it */
        const uint8_t *up = y > 0 ? out - row_bytes : NULL;
        int64_t x;
        switch (filter) {
        case 0:
            memcpy(out, in, (size_t)row_bytes);
            break;
        case 1:
            memcpy(out, in, (size_t)lead);
            for (x = lead; x < row_bytes; ++x)
                out[x] = (uint8_t)(in[x] + out[x - bpp]);
            break;
        case 2:
            if (up == NULL) {
                memcpy(out, in, (size_t)row_bytes);
            } else {
                for (x = 0; x < row_bytes; ++x)
                    out[x] = (uint8_t)(in[x] + up[x]);
            }
            break;
        case 3:
            if (up == NULL) {
                memcpy(out, in, (size_t)lead);
                for (x = lead; x < row_bytes; ++x)
                    out[x] = (uint8_t)(in[x] + (out[x - bpp] >> 1));
            } else {
                for (x = 0; x < lead; ++x)
                    out[x] = (uint8_t)(in[x] + (up[x] >> 1));
                for (; x < row_bytes; ++x)
                    out[x] = (uint8_t)(in[x] + ((out[x - bpp] + up[x]) >> 1));
            }
            break;
        case 4:
            if (up == NULL) {
                memcpy(out, in, (size_t)lead);
                for (x = lead; x < row_bytes; ++x)
                    out[x] = (uint8_t)(in[x] + out[x - bpp]);
            } else {
                for (x = 0; x < lead; ++x)
                    out[x] = (uint8_t)(in[x] + up[x]);
                for (; x < row_bytes; ++x)
                    out[x] = (uint8_t)(in[x] + paeth(out[x - bpp], up[x],
                                                     up[x - bpp]));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
