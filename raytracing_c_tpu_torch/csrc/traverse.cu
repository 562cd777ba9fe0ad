// BVH traversal (K1) and hit-attribute fetch (K2) for NVIDIA Hopper.
//
// Built by raytracing_c_tpu_torch/ops/traverse_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and bound with ctypes through the plain C entry points at the end.
// --fmad=false keeps a*b+c as two rounded operations, so Moller-Trumbore
// and the attribute interpolation round exactly like the plain PyTorch
// versions (ops/intersect.py, ops/traverse_cuda.py) and the hits agree bit
// for bit.
//
// K1 bvh_traverse_kernel replaces the Pallas kernel
//   raytracing_c_tpu/ops/traverse_pallas.py: intersect_bvh_pallas ->
//   _traverse_kernel (per-lane body _traverse_stages, tile-wavefront body
//   _traverse_stages_tw, fused epilogue _interp_attrs).
//   The TPU kernel descends level-synchronously with top-k selection and
//   one-hot matmul fetches, because a TPU has no fast per-lane gather and
//   no divergent control flow; it is exact only together with its
//   dropped_min certificate and the repair tiers. A GPU thread can chase
//   pointers, so K1 is the reference's own algorithm (ray_bvh_node_hit,
//   raytracer.c:443-483): one thread per ray, ordered nearest-first
//   descent of the implicit 8-ary tree with a per-thread stack. It is
//   exact by construction and reports dropped_min = +inf.
//   What bounds it on the card: latency of the dependent node/leaf row
//   loads (48 floats per node, 72 per leaf block, from L2-resident tables:
//   a 15k-triangle scene's tables are ~2.5 MB) and warp divergence between
//   rays of unequal traversal length. The design answers with many rays in
//   flight (one thread each, small blocks, no shared memory) so the SM
//   hides load latency by switching warps; packet (CTA-cooperative)
//   traversal for coherent camera rays is later work.
//   The stack holds 7*depth+1 entries (each internal pop pushes at most 8,
//   one per level stays popped), picked from three compiled sizes, so any
//   tree depth up to 16 runs without the TPU package's forest of subtrees.
//
// K2 fetch_attrs_kernel replaces traverse_pallas.py: fetch_attrs ->
//   _attr_kernel. One thread per ray reads the winner's 25-float attribute
//   row and writes the 16 interpolated planes; it shares interp_attrs with
//   K1's fused epilogue. Bound by the scattered 100-byte row reads and the
//   64 bytes written per ray: a memory-bound gather, kept simple.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int W = 8;      // BVH fan-out and triangles per leaf block
constexpr int ROW = 128;  // floats per node, leaf and attribute row
constexpr float EPS = 1.0e-4f;  // EPSILON, common.h:8

// 1 + EPSILON, rounded once from double as the plain versions compare it
__device__ __forceinline__ float one_plus_eps() { return (float)(1.0 + 1.0e-4); }

// Moller-Trumbore in the operation order of ops/intersect.py
// (Vec3.cross / Vec3.dot); t = +inf on a miss.
__device__ __forceinline__ void moller_trumbore(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float& t, float& u, float& v) {
  float px = dy * e2z - dz * e2y;
  float py = dz * e2x - dx * e2z;
  float pz = dx * e2y - dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float inv_det = 1.0f / det;
  float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  u = inv_det * (tx * px + ty * py + tz * pz);
  v = inv_det * (dx * qx + dy * qy + dz * qz);
  t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
  bool ok = (u >= -EPS) && (u <= one_plus_eps()) && (v >= -EPS) &&
            (u + v <= one_plus_eps()) && (t >= EPS);
  if (!ok) t = CUDART_INF_F;
}

// One slab axis. A NaN (origin exactly on the plane of a slab the ray runs
// parallel to: 0 * inf) leaves the axis unconstrained, so the traversal
// never loses a hit that the brute-force oracle finds.
__device__ __forceinline__ void slab_axis(float bmin, float bmax, float o,
                                          float inv, float& lo, float& hi) {
  float t0 = (bmin - o) * inv;
  float t1 = (bmax - o) * inv;
  if (isnan(t0) || isnan(t1)) return;
  lo = fmaxf(lo, fminf(t0, t1));
  hi = fminf(hi, fmaxf(t0, t1));
}

// Shared by K1's fused epilogue and K2: the winner's attributes
// (models/scene.py ATTR_* columns) -> 16 planes
// [normal3, ng3, tangent3, bitangent3, uv_u, uv_v, mat, 0],
// interpolated as n0*w + n1*u + n2*v with w = 1 - u - v.
__device__ __forceinline__ void interp_attrs(const float* __restrict__ attr_rows,
                                             int tri, float u, float v,
                                             float* __restrict__ out, int R, int i) {
  const float* a = attr_rows + (size_t)tri * ROW;
  float w = (1.0f - u) - v;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[(size_t)c * R + i] = (a[c] * w + a[3 + c] * u) + a[6 + c] * v;
#pragma unroll
  for (int c = 0; c < 9; ++c) out[(size_t)(3 + c) * R + i] = a[9 + c];
  out[(size_t)12 * R + i] = (a[18] * w + a[20] * u) + a[22] * v;
  out[(size_t)13 * R + i] = (a[19] * w + a[21] * u) + a[23] * v;
  out[(size_t)14 * R + i] = a[24];
  out[(size_t)15 * R + i] = 0.0f;
}

// rays: (8, R) planes [o.xyz, d.xyz, active, t_max]. out: (4, R) planes
// [t, u, v, dropped_min]; out_tri: (R,); attrs: (16, R) or null.
template <int STACK>
__global__ void __launch_bounds__(128) bvh_traverse_kernel(
    const float* __restrict__ rays, int R, const float* __restrict__ nodes,
    int n_internal, const float* __restrict__ leaf_rows,
    const float* __restrict__ attr_rows, float* __restrict__ out,
    int* __restrict__ out_tri, float* __restrict__ attrs) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float ox = rays[i], oy = rays[(size_t)R + i], oz = rays[(size_t)2 * R + i];
  float dx = rays[(size_t)3 * R + i], dy = rays[(size_t)4 * R + i],
        dz = rays[(size_t)5 * R + i];
  bool active = rays[(size_t)6 * R + i] != 0.0f;
  float t_max = rays[(size_t)7 * R + i];

  float best_t = CUDART_INF_F, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;

  if (active) {
    float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    int stack_e[STACK];
    float stack_d[STACK];
    int sp = 0;
    stack_e[0] = 0;  // the root; its own box is not stored
    stack_d[0] = 0.0f;
    sp = 1;
    while (sp > 0) {
      --sp;
      int e = stack_e[sp];
      // prune only strictly farther entries: an equal entry distance may
      // hold an equal-t hit with a lower triangle id (brute force's argmin)
      if (stack_d[sp] > best_t) continue;
      if (e < n_internal) {
        const float* row = nodes + (size_t)e * ROW;
        float cd[W];
        int cj[W];
        int n = 0;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float lo = -CUDART_INF_F, hi = CUDART_INF_F;
          slab_axis(row[j], row[3 * W + j], ox, ix, lo, hi);
          slab_axis(row[W + j], row[4 * W + j], oy, iy, lo, hi);
          slab_axis(row[2 * W + j], row[5 * W + j], oz, iz, lo, hi);
          float t_near = fmaxf(lo, EPS);
          float t_far = fminf(hi, t_max);
          if (t_near < t_far && t_near <= best_t) {
            // insertion sort, ascending distance, lower child first on ties
            int k = n++;
            while (k > 0 && cd[k - 1] > t_near) {
              cd[k] = cd[k - 1];
              cj[k] = cj[k - 1];
              --k;
            }
            cd[k] = t_near;
            cj[k] = j;
          }
        }
        // push far-to-near so the nearest child pops first
        for (int k = n - 1; k >= 0; --k) {
          stack_e[sp] = W * e + 1 + cj[k];
          stack_d[sp] = cd[k];
          ++sp;
        }
      } else {
        int blk = e - n_internal;
        const float* lr = leaf_rows + (size_t)blk * ROW;
#pragma unroll 2
        for (int k = 0; k < W; ++k) {
          float t, u, v;
          moller_trumbore(ox, oy, oz, dx, dy, dz, lr[k], lr[W + k],
                          lr[2 * W + k], lr[3 * W + k], lr[4 * W + k],
                          lr[5 * W + k], lr[6 * W + k], lr[7 * W + k],
                          lr[8 * W + k], t, u, v);
          int tri = blk * W + k;
          if (t < t_max && (t < best_t || (t == best_t && tri < best_tri))) {
            best_t = t;
            best_u = u;
            best_v = v;
            best_tri = tri;
          }
        }
      }
    }
  }

  out[i] = best_t;
  out[(size_t)R + i] = best_u;
  out[(size_t)2 * R + i] = best_v;
  out[(size_t)3 * R + i] = CUDART_INF_F;  // exact: nothing dropped
  out_tri[i] = best_tri;
  if (attrs != nullptr)
    interp_attrs(attr_rows, best_tri < 0 ? 0 : best_tri, best_u, best_v, attrs, R, i);
}

__global__ void __launch_bounds__(256) fetch_attrs_kernel(
    const int* __restrict__ tri, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ attr_rows,
    float* __restrict__ out, int R) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  int t = tri[i];
  interp_attrs(attr_rows, t < 0 ? 0 : t, u[i], v[i], out, R, i);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int rt_bvh_traverse(const float* rays, int R, const float* nodes,
                    int n_internal, int depth, const float* leaf_rows,
                    const float* attr_rows, float* out, int* out_tri,
                    float* attrs, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 block(128);
  dim3 grid((R + 127) / 128);
  int need = 7 * depth + 1;
  if (need <= 29)
    bvh_traverse_kernel<29><<<grid, block, 0, s>>>(rays, R, nodes, n_internal,
        leaf_rows, attr_rows, out, out_tri, attrs);
  else if (need <= 57)
    bvh_traverse_kernel<57><<<grid, block, 0, s>>>(rays, R, nodes, n_internal,
        leaf_rows, attr_rows, out, out_tri, attrs);
  else if (need <= 113)
    bvh_traverse_kernel<113><<<grid, block, 0, s>>>(rays, R, nodes, n_internal,
        leaf_rows, attr_rows, out, out_tri, attrs);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int rt_fetch_attrs(const int* tri, const float* u, const float* v,
                   const float* attr_rows, float* out, int R, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  fetch_attrs_kernel<<<(R + 255) / 256, 256, 0, s>>>(tri, u, v, attr_rows, out, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
