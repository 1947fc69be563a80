/* PNG row unfiltering (the five filters of the PNG specification, 9.2) for
 * the host data path's frame reader, mscl_torch/utils/image_io.py.
 *
 * Avg and Paeth predict each byte from the byte bpp to its left, which is
 * itself an output, so a row is a sequential recurrence; numpy can only
 * walk it one anti-diagonal of pixels at a time. This is the plain C loop,
 * one pass over the bytes, and ctypes releases the GIL around the call, so
 * the loader's decode threads run it side by side.
 *
 * Built with the host C compiler into build/ (ops/cuda_build.py
 * load_host); a plain C interface.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

/* lines: h rows of 1 + row_bytes (the filter type, then the filtered
 * bytes); out: h rows of row_bytes. Returns 0, or the 1-based row of the
 * first unknown filter type (out is then incomplete). */
int png_unfilter(const uint8_t *lines, uint8_t *out, int64_t h,
                 int64_t row_bytes, int64_t bpp) {
  uint8_t *zero = (uint8_t *)calloc((size_t)row_bytes + 1, 1);
  if (!zero) return -1;
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t *line = lines + r * (row_bytes + 1);
    const uint8_t *f = line + 1;
    uint8_t *cur = out + r * row_bytes;
    const uint8_t *prev = r ? cur - row_bytes : zero;
    int64_t i;
    switch (line[0]) {
      case 0:
        memcpy(cur, f, (size_t)row_bytes);
        break;
      case 1:
        for (i = 0; i < bpp && i < row_bytes; ++i) cur[i] = f[i];
        for (; i < row_bytes; ++i) cur[i] = (uint8_t)(f[i] + cur[i - bpp]);
        break;
      case 2:
        for (i = 0; i < row_bytes; ++i) cur[i] = (uint8_t)(f[i] + prev[i]);
        break;
      case 3:
        for (i = 0; i < bpp && i < row_bytes; ++i)
          cur[i] = (uint8_t)(f[i] + (prev[i] >> 1));
        for (; i < row_bytes; ++i)
          cur[i] = (uint8_t)(f[i] + ((cur[i - bpp] + prev[i]) >> 1));
        break;
      case 4:
        for (i = 0; i < bpp && i < row_bytes; ++i)
          cur[i] = (uint8_t)(f[i] + prev[i]);       /* a = c = 0: b */
        for (; i < row_bytes; ++i)
          cur[i] = (uint8_t)(f[i] + paeth(cur[i - bpp], prev[i],
                                          prev[i - bpp]));
        break;
      default:
        free(zero);
        return (int)(r + 1);
    }
  }
  free(zero);
  return 0;
}
