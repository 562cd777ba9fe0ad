/* The lightmap bake's UV-space rasterizer: each triangle's UV bounding box
 * walked row by row with the barycentric inside test of
 * raytracer.c:727-757, each texel inside giving one record (its texel id,
 * world position, interpolated normal and the triangle's slot).
 * render/lightmap.py:_rasterize_plain is its plain version; the records are
 * its records, byte for byte and in its order (triangle by triangle in the
 * given order, then row-major in the box), so the arithmetic is its
 * float64 arithmetic in its order. Build with -ffp-contract=off and without
 * -ffast-math: no product may fuse into an add, no division become a
 * multiply by a reciprocal.
 *
 * Bound through ctypes by raytracing_c_tpu_torch/native/__init__.py:
 *   raster_count(n, uv, width, height, &candidates) -> records
 *   raster_fill(n, uv, v0, e1, e2, n0, n1, n2, slots, width, height,
 *               index, position, normal, slot_out, counts) -> records, or
 *     -1 if the texel marks could not be allocated
 * uv is (n, 3, 2) float32 UVs in [0, 1] units; v0, e1, e2, n0, n1, n2 are
 * (n, 3) float32; slots is (n,) int64. candidates receives the sum of the
 * kept triangles' box areas; counts receives the texels covered and the
 * texels written more than once. index and slot_out take one int64 a
 * record, position and normal three float32 a record: raster_count's
 * records in all.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#define EPSILON 1.0e-4 /* raytracing_c_tpu_torch.EPSILON, common.h:8 */

/* float64 -> int64 as numpy's cast does on x86-64: truncation, and
 * INT64_MIN (the conversion's "integer indefinite") for a value outside
 * the int64 range or NaN. */
static int64_t to_i64(double t) {
  if (!(t >= -9223372036854775808.0 && t < 9223372036854775808.0)) return INT64_MIN;
  return (int64_t)t;
}

/* One triangle's UVs in texels, its denominator and its clamped box;
 * returns 0 when it is skipped (|denom| < 1e-20, NaN included, or an
 * empty box). The denominator is tested before any cast. */
typedef struct {
  double ax, ay, bx, by, cx, cy, denom;
  int64_t x0, x1, y0, y1;
} Tri;

static int setup(Tri *t, const float *uv, long width, long height) {
  double w = (double)width, h = (double)height;
  t->ax = (double)uv[0] * w;
  t->ay = (double)uv[1] * h;
  t->bx = (double)uv[2] * w;
  t->by = (double)uv[3] * h;
  t->cx = (double)uv[4] * w;
  t->cy = (double)uv[5] * h;
  t->denom = (t->by - t->cy) * (t->ax - t->cx) + (t->cx - t->bx) * (t->ay - t->cy);
  if (!(fabs(t->denom) >= 1e-20)) return 0;
  /* numpy's minimum/maximum; NaN cannot reach here (it would make denom NaN) */
  double lx = fmin(fmin(t->ax, t->bx), t->cx), hx = fmax(fmax(t->ax, t->bx), t->cx);
  double ly = fmin(fmin(t->ay, t->by), t->cy), hy = fmax(fmax(t->ay, t->by), t->cy);
  int64_t x0 = to_i64(trunc(lx)), x1 = to_i64(trunc(hx));
  int64_t y0 = to_i64(trunc(ly)), y1 = to_i64(trunc(hy));
  t->x0 = x0 > 0 ? x0 : 0;
  t->x1 = x1 < width - 1 ? x1 : width - 1;
  t->y0 = y0 > 0 ? y0 : 0;
  t->y1 = y1 < height - 1 ? y1 : height - 1;
  return t->x1 >= t->x0 && t->y1 >= t->y0;
}

/* The barycentric weights of texel (x, y); 1 if it is inside. */
static inline int weights(const Tri *t, int64_t x, int64_t y, double *w0, double *w1,
                          double *w2) {
  double dx = (double)x - t->cx, dy = (double)y - t->cy;
  *w0 = ((t->by - t->cy) * dx + (t->cx - t->bx) * dy) / t->denom;
  *w1 = ((t->cy - t->ay) * dx + (t->ax - t->cx) * dy) / t->denom;
  *w2 = (1.0 - *w0) - *w1;
  return *w0 >= -EPSILON && *w1 >= -EPSILON && *w2 >= -EPSILON;
}

long raster_count(long n, const float *uv, long width, long height, long *candidates) {
  long records = 0, cand = 0;
  for (long i = 0; i < n; i++) {
    Tri t;
    if (!setup(&t, uv + 6 * i, width, height)) continue;
    cand += (long)((t.x1 - t.x0 + 1) * (t.y1 - t.y0 + 1));
    for (int64_t y = t.y0; y <= t.y1; y++)
      for (int64_t x = t.x0; x <= t.x1; x++) {
        double w0, w1, w2;
        records += weights(&t, x, y, &w0, &w1, &w2);
      }
  }
  *candidates = cand;
  return records;
}

/* (a * w0 + b * w1) + c * w2 in float64, rounded once to float32 */
static inline float lerp3(float a, float b, float c, double w0, double w1, double w2) {
  return (float)(((double)a * w0 + (double)b * w1) + (double)c * w2);
}

long raster_fill(long n, const float *uv, const float *v0, const float *e1, const float *e2,
                 const float *n0, const float *n1, const float *n2, const int64_t *slots,
                 long width, long height, int64_t *index, float *position, float *normal,
                 int64_t *slot_out, long *counts) {
  uint8_t *marks = calloc((size_t)width * (size_t)height, 1);
  if (marks == NULL) return -1;
  long r = 0, covered = 0, overwritten = 0;
  for (long i = 0; i < n; i++) {
    Tri t;
    if (!setup(&t, uv + 6 * i, width, height)) continue;
    const float *p0 = v0 + 3 * i, *q0 = n0 + 3 * i, *q1 = n1 + 3 * i, *q2 = n2 + 3 * i;
    float p1[3], p2[3]; /* v0 + e1, v0 + e2, rounded in float32 */
    for (int k = 0; k < 3; k++) {
      p1[k] = p0[k] + e1[3 * i + k];
      p2[k] = p0[k] + e2[3 * i + k];
    }
    for (int64_t y = t.y0; y <= t.y1; y++)
      for (int64_t x = t.x0; x <= t.x1; x++) {
        double w0, w1, w2;
        if (!weights(&t, x, y, &w0, &w1, &w2)) continue;
        int64_t id = x + y * width;
        index[r] = id;
        slot_out[r] = slots[i];
        for (int k = 0; k < 3; k++) {
          position[3 * r + k] = lerp3(p0[k], p1[k], p2[k], w0, w1, w2);
          normal[3 * r + k] = lerp3(q0[k], q1[k], q2[k], w0, w1, w2);
        }
        if (marks[id] == 0) covered++;
        else if (marks[id] == 1) overwritten++;
        if (marks[id] < 2) marks[id]++;
        r++;
      }
  }
  free(marks);
  counts[0] = covered;
  counts[1] = overwritten;
  return r;
}
