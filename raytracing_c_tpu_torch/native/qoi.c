/* QOI (Quite OK Image) codec, the native encoder and decoder of the
 * port's image output (the reference's qoi_save_writer, driver.c:862-864),
 * written from the public QOI specification (qoiformat.org). The port's
 * own copy of raytracing_c_tpu/native/qoi.c, with the same bytes out.
 *
 * Bound through ctypes by raytracing_c_tpu_torch/native/__init__.py:
 *   qoi_encode_rgb(pixels, w, h, out, out_cap) -> bytes written (or -1)
 *   qoi_decode_header(data, len, &w, &h)        -> 0 on success
 *   qoi_decode_rgb(data, len, out, w, h)        -> 0 on success
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define OP_INDEX 0x00
#define OP_DIFF 0x40
#define OP_LUMA 0x80
#define OP_RUN 0xc0
#define OP_RGB 0xfe

typedef struct {
  uint8_t r, g, b, a;
} Px;

static int px_eq(Px x, Px y) {
  return x.r == y.r && x.g == y.g && x.b == y.b && x.a == y.a;
}

static int px_hash(Px p) {
  return (p.r * 3 + p.g * 5 + p.b * 7 + p.a * 11) % 64;
}

static void put32(uint8_t *dst, uint32_t v) {
  dst[0] = (uint8_t)(v >> 24);
  dst[1] = (uint8_t)(v >> 16);
  dst[2] = (uint8_t)(v >> 8);
  dst[3] = (uint8_t)v;
}

static uint32_t get32(const uint8_t *src) {
  return ((uint32_t)src[0] << 24) | ((uint32_t)src[1] << 16) |
         ((uint32_t)src[2] << 8) | (uint32_t)src[3];
}

long qoi_encode_rgb(const uint8_t *pixels, int w, int h, uint8_t *out,
                    long out_cap) {
  long n = (long)w * h;
  long need_worst = 14 + n * 4 + 8;
  if (out_cap < need_worst) return -1;

  long p = 0;
  memcpy(out, "qoif", 4);
  p = 4;
  put32(out + p, (uint32_t)w);
  p += 4;
  put32(out + p, (uint32_t)h);
  p += 4;
  out[p++] = 3; /* channels */
  out[p++] = 0; /* sRGB */

  Px index[64];
  memset(index, 0, sizeof(index));
  Px prev = {0, 0, 0, 255};
  int run = 0;

  for (long i = 0; i < n; i++) {
    Px cur = {pixels[i * 3 + 0], pixels[i * 3 + 1], pixels[i * 3 + 2], 255};
    if (px_eq(cur, prev)) {
      run++;
      if (run == 62) {
        out[p++] = (uint8_t)(OP_RUN | (run - 1));
        run = 0;
      }
      prev = cur;
      continue;
    }
    if (run) {
      out[p++] = (uint8_t)(OP_RUN | (run - 1));
      run = 0;
    }
    int hi = px_hash(cur);
    if (px_eq(index[hi], cur)) {
      out[p++] = (uint8_t)(OP_INDEX | hi);
    } else {
      index[hi] = cur;
      int8_t dr = (int8_t)(cur.r - prev.r);
      int8_t dg = (int8_t)(cur.g - prev.g);
      int8_t db = (int8_t)(cur.b - prev.b);
      int8_t dr_dg = (int8_t)(dr - dg);
      int8_t db_dg = (int8_t)(db - dg);
      if (dr >= -2 && dr <= 1 && dg >= -2 && dg <= 1 && db >= -2 && db <= 1) {
        out[p++] = (uint8_t)(OP_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) |
                             (db + 2));
      } else if (dg >= -32 && dg <= 31 && dr_dg >= -8 && dr_dg <= 7 &&
                 db_dg >= -8 && db_dg <= 7) {
        out[p++] = (uint8_t)(OP_LUMA | (dg + 32));
        out[p++] = (uint8_t)(((dr_dg + 8) << 4) | (db_dg + 8));
      } else {
        out[p++] = OP_RGB;
        out[p++] = cur.r;
        out[p++] = cur.g;
        out[p++] = cur.b;
      }
    }
    prev = cur;
  }
  if (run) out[p++] = (uint8_t)(OP_RUN | (run - 1));

  memset(out + p, 0, 7);
  p += 7;
  out[p++] = 1;
  return p;
}

int qoi_decode_header(const uint8_t *data, long len, int *w, int *h) {
  if (len < 14 || memcmp(data, "qoif", 4) != 0) return -1;
  *w = (int)get32(data + 4);
  *h = (int)get32(data + 8);
  return 0;
}

int qoi_decode_rgb(const uint8_t *data, long len, uint8_t *out, int w, int h) {
  if (len < 14 || memcmp(data, "qoif", 4) != 0) return -1;
  long n = (long)w * h;
  long p = 14;
  Px index[64];
  memset(index, 0, sizeof(index));
  Px px = {0, 0, 0, 255};

  for (long i = 0; i < n;) {
    if (p < len - 8) {
      uint8_t b0 = data[p++];
      if (b0 == OP_RGB) {
        px.r = data[p++];
        px.g = data[p++];
        px.b = data[p++];
      } else if (b0 == 0xff) { /* OP_RGBA */
        px.r = data[p++];
        px.g = data[p++];
        px.b = data[p++];
        px.a = data[p++];
      } else if ((b0 & 0xc0) == OP_INDEX) {
        px = index[b0 & 0x3f];
      } else if ((b0 & 0xc0) == OP_DIFF) {
        px.r += ((b0 >> 4) & 3) - 2;
        px.g += ((b0 >> 2) & 3) - 2;
        px.b += (b0 & 3) - 2;
      } else if ((b0 & 0xc0) == OP_LUMA) {
        int dg = (b0 & 0x3f) - 32;
        uint8_t b1 = data[p++];
        px.r += (uint8_t)(dg - 8 + ((b1 >> 4) & 0xf));
        px.g += (uint8_t)dg;
        px.b += (uint8_t)(dg - 8 + (b1 & 0xf));
      } else if ((b0 & 0xc0) == OP_RUN) {
        int run = (b0 & 0x3f) + 1;
        while (run-- && i < n) {
          out[i * 3 + 0] = px.r;
          out[i * 3 + 1] = px.g;
          out[i * 3 + 2] = px.b;
          i++;
        }
        continue;
      }
      index[px_hash(px)] = px;
    }
    out[i * 3 + 0] = px.r;
    out[i * 3 + 1] = px.g;
    out[i * 3 + 2] = px.b;
    i++;
  }
  return 0;
}
