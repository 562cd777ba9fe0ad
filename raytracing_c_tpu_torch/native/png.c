/* The PNG decoder's unfilter: undoes the row filters of an 8-bit,
 * non-interlaced image's inflated scanlines, one pass a row, with the five
 * filter types of the PNG specification (ISO/IEC 15948, section 9.2).
 * io/image_io.py:_unfilter is its plain version.
 *
 * Bound through ctypes by raytracing_c_tpu_torch/native/__init__.py:
 *   png_unfilter(src, height, stride, bpp, out) -> 0, or the first filter
 *     type above 4 that it meets
 * src holds `height` rows of one filter-type byte and `stride` filtered
 * bytes, as zlib returns them; out receives the (height, stride) bytes.
 * bpp is the bytes per pixel, 1-4. The row above the first row and the
 * bytes left of a row's first pixel read as zero; sums wrap mod 256.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* The specification's predictor: pa, pb, pc are |p - a|, |p - b|, |p - c|
 * for p = a + b - c, with the ties broken towards a, then b. */
static uint8_t paeth(int a, int b, int c) {
  int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  int bc = pb <= pc ? b : c;
  return (uint8_t)(pa <= pb && pa <= pc ? a : bc);
}

/* One row; `up` is the reconstructed row above, NULL for the first row. */
static int unfilter_row(int kind, const uint8_t *in, const uint8_t *up, uint8_t *row,
                        long n, long bpp) {
  long x = 0;
  if (up == NULL) {
    if (kind == 2) kind = 0; /* Up adds the zero row */
    if (kind == 4) kind = 1; /* Paeth of (left, 0, 0) picks left: Sub */
  }
  switch (kind) {
    case 0:
      memcpy(row, in, (size_t)n);
      return 0;
    case 1:
      for (; x < bpp && x < n; x++) row[x] = in[x];
      for (; x < n; x++) row[x] = (uint8_t)(in[x] + row[x - bpp]);
      return 0;
    case 2:
      for (; x < n; x++) row[x] = (uint8_t)(in[x] + up[x]);
      return 0;
    case 3:
      if (up == NULL) {
        for (; x < bpp && x < n; x++) row[x] = in[x];
        for (; x < n; x++) row[x] = (uint8_t)(in[x] + (row[x - bpp] >> 1));
      } else {
        for (; x < bpp && x < n; x++) row[x] = (uint8_t)(in[x] + (up[x] >> 1));
        for (; x < n; x++) row[x] = (uint8_t)(in[x] + ((row[x - bpp] + up[x]) >> 1));
      }
      return 0;
    case 4: /* left and upper left read as zero: Paeth picks up */
      for (; x < bpp && x < n; x++) row[x] = (uint8_t)(in[x] + up[x]);
      for (; x < n; x++) row[x] = (uint8_t)(in[x] + paeth(row[x - bpp], up[x], up[x - bpp]));
      return 0;
    default:
      return kind;
  }
}

int png_unfilter(const uint8_t *src, long height, long stride, int bpp, uint8_t *out) {
  const uint8_t *up = NULL;
  for (long y = 0; y < height; y++) {
    const uint8_t *line = src + y * (stride + 1);
    uint8_t *row = out + y * stride;
    int bad = unfilter_row(line[0], line + 1, up, row, stride, bpp);
    if (bad) return bad;
    up = row;
  }
  return 0;
}
