// BVH traversal (K1) and hit-attribute fetch (K2) for NVIDIA Hopper.
//
// Built by raytracing_c_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and bound with ctypes through the plain C entry points at the end.
// --fmad=false keeps a*b+c as two rounded operations, so Moller-Trumbore
// and the attribute interpolation round exactly like the plain PyTorch
// versions (ops/intersect.py, ops/traverse_cuda.py) and the hits agree bit
// for bit. The box test, which reaches no output, fuses explicitly
// (__fmaf_rn).
//
// K1 replaces the Pallas kernel
//   raytracing_c_tpu/ops/traverse_pallas.py: intersect_bvh_pallas ->
//   _traverse_kernel (per-lane body _traverse_stages, tile-wavefront body
//   _traverse_stages_tw, fused epilogue _interp_attrs).
//   The TPU kernel descends level-synchronously with top-k selection and
//   one-hot matmul fetches, because a TPU has no fast per-lane gather and
//   no divergent control flow; it is exact only together with its
//   dropped_min certificate and the repair tiers. A GPU thread can chase
//   pointers, so K1 is the reference's own algorithm (ray_bvh_node_hit,
//   raytracer.c:443-483): an ordered nearest-first descent of the 8-ary
//   tree, exact by construction, reporting dropped_min = +inf.
//
//   Two kernels compute it, over the same tables, with the same outputs;
//   the wrapper (ops/traverse_cuda.py) picks one by the launch's size:
//   - bvh_traverse_kernel, one thread per ray, for launches of WIDE_BELOW
//     (131,072) rays or more: on the render path the camera bounce and
//     bounce 1 of a full batch;
//   - bvh_traverse_wide_kernel, eight lanes per ray, for smaller ones:
//     bounces 2-7 of a batch, six of its eight launches.
//
//   What bounds them (PERF.md, section 6, has the times). A large launch
//   fills the card. Its secondary rays diverge: neighbouring rays walk
//   different paths of different lengths, so many of a warp's lanes idle
//   in a step, and the instructions issued per step bind: one thread per
//   ray issues the fewest. A small launch leaves the card mostly idle,
//   and its time is the chain of dependent loads of its longest walk. One
//   thread per ray waits on a load per node step and one per pair of a
//   leaf's triangles (its first form, which loaded a node's children one
//   after another, took as long on a few dozen rays as on 233,000); eight
//   lanes per ray load all of a node's children, or all of a leaf's
//   triangles, at once, and split the step's tests among them.
//
//   The tables (ops/traverse_cuda.py: build_k1_tables), built once per
//   scene: 256 bytes per node, 32 per child, each child as two 16-byte
//   loads (center.xyz half.x | half.yz ref -), occupied children first and
//   empty slots zero, and 48 bytes per occupied triangle (v0 id | e1 - |
//   e2 -, three 16-byte loads). The earlier kernel read 48 scalar floats
//   per node and 72 per leaf block from the 512-byte rows laid out for the
//   TPU's 128 lanes, empty slots included, and kept a stack and a sorted
//   child list, indexed at run time, in local memory. Common to both
//   kernels:
//   - a child's 32-bit reference carries its own occupancy mask (internal
//     child: node << 8 | mask) or its triangle range (leaf: 1 << 31 |
//     first << 4 | count), so empty children count for nothing and empty
//     triangle slots cost neither a load nor a test. The 23 bits of the
//     node index limit the tree to depth 8 (n_internal below 2^23); the
//     wrapper raises above it;
//   - boxes as center and half-extent, rounded outward: a slab is a
//     subtraction, a multiplication, two fused multiply-adds and two
//     min/max, with no NaN test (slab_axis), where the plane form needs
//     two subtractions, two multiplications, four min/max and a NaN test.
//     The center is taken relative to the origin before the scaling, so
//     a slab's rounding grows with the distance from the ray's origin to
//     the box, as in the plane form, not with the origin's distance from
//     the scene's zero: -o * inv, rounded once per ray, moves each slab by
//     up to |o| 2^-24, past the boxes' EPSILON padding once |o| passes
//     ~1.7e3, and there loses hits;
//   - a stack of at most one entry per internal level of the path, so at
//     most depth entries, none in local memory; an entry's children are
//     re-tested against the best hit when it is popped, so the pruning
//     (strictly farther than the best hit) needs no stored distances.
//   One thread per ray (k1_ray):
//   - a node step loads all eight child records before testing any, and
//     a leaf step two triangles at a time: one load latency per node step,
//     not eight, and one per pair of triangles;
//   - an entry is a node and its hit children not yet visited, in
//     entry-distance order from a 19-compare-exchange sort of (distance,
//     slot) keys; the deepest entry stays in registers, the others in the
//     thread's column of shared memory;
//   - "while-while" (Aila and Laine, HPG 2009): a lane runs node steps
//     until it has a leaf pending, then the warp runs leaf steps, so node
//     and leaf code alternate once per leaf, not once per step;
//   - a leaf step stops a triangle's test once u, then v, falls outside
//     (mt_hit), and computes u and v only for a new best hit;
//   - 64 threads per block.
//   Eight lanes per ray (bvh_traverse_wide_kernel): see its comment.
//   Measured for the thread-per-ray kernel and not kept, each no faster on
//   the bounce-1 rays: blocks of 32, 128 and 256 threads; fewer registers
//   (spills); four triangles at a time (80 registers); prefetching the
//   next triangle; one stack entry per hit child; persistent threads that
//   refill idle lanes from a ray queue (Aila and Laine): fewer warp steps,
//   the same time; 8-bit child boxes quantized against the node's box
//   (Ylitie, Karras and Laine, HPG 2017), a 64-byte node in four 16-byte
//   loads: a quarter of the node bytes, but slower, as decoding costs more
//   instructions than the loads saved; children in octant order with no
//   sort, nearest first only, or in table order: faster on camera rays,
//   slower on random ones. Four lanes per ray (two children each) was
//   slower than eight on small launches and than one on large ones.
//   ptxas -v (sm_90a, CUDA 12.8): bvh_traverse_kernel 64 registers, 0
//   bytes of stack frame, no spills, 3,584 bytes of shared memory per
//   block; bvh_traverse_wide_kernel 55 registers, 0 bytes of stack frame,
//   no spills, no shared memory; the earlier kernel 40 registers and a
//   320-byte stack frame at depth <= 4 (544 and 992 bytes for its deeper
//   instances), with 12 bytes of spills.
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

constexpr int ROW = 128;        // floats per attribute row
constexpr int NODE_F4 = 16;     // float4 per node record: 8 children x 2
constexpr int TRI_F4 = 3;       // float4 per triangle record
constexpr int K1_BLOCK = 64;    // threads per block
constexpr int MAX_STACK = 7;    // depth 8 - 1: one entry per internal level
constexpr unsigned LEAF_BIT = 0x80000000u;
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

// Moller-Trumbore's t alone, +inf on a miss: the same operations as
// moller_trumbore, leaving as soon as u, then v, falls outside the
// triangle, so a warp whose lanes all miss skips the rest.
__device__ __forceinline__ float mt_hit(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z) {
  float px = dy * e2z - dz * e2y;
  float py = dz * e2x - dx * e2z;
  float pz = dx * e2y - dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float inv_det = 1.0f / det;
  float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  float u = inv_det * (tx * px + ty * py + tz * pz);
  if (!((u >= -EPS) && (u <= one_plus_eps()))) return CUDART_INF_F;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = inv_det * (dx * qx + dy * qy + dz * qz);
  if (!((v >= -EPS) && (u + v <= one_plus_eps()))) return CUDART_INF_F;
  float t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
  return t >= EPS ? t : CUDART_INF_F;
}

// One slab axis of a box stored as its center c and half-extent h: the
// ray enters the slab at tc - h |inv| and leaves it at tc + h |inv|, with
// tc = (c - o) * inv, so that its rounding error is relative to |c - o|,
// never to |o|. Entry and exit need no min/max of two plane distances,
// and an infinite inv (a ray parallel to the slab) makes the entry -inf
// or NaN and the exit +inf or NaN, which fmaxf/fminf ignore: the axis is
// left unconstrained, so the traversal never loses a hit that the
// brute-force oracle finds.
__device__ __forceinline__ void slab_axis(float c, float h, float inv, float o,
                                          float& lo, float& hi) {
  float tc = (c - o) * inv;
  lo = fmaxf(lo, __fmaf_rn(-h, fabsf(inv), tc));
  hi = fminf(hi, __fmaf_rn(h, fabsf(inv), tc));
}

// 1 / d for the slab test, infinite once beyond 1e30 in magnitude: then
// (c - o) * inv cannot overflow for |c - o| < 3e8, and an infinite inv only ever
// leaves an axis unconstrained (NaN) or gives the right infinite t.
__device__ __forceinline__ float slab_inv(float d) {
  float inv = 1.0f / d;
  return fabsf(inv) > 1e30f ? copysignf(CUDART_INF_F, inv) : inv;
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

// Entry distance of a ray (origin o, inverse direction inv) into a child
// box a = [center.xyz, half.x], b = [half.yz, ...], or -1 when it
// misses the box, leaves it before EPSILON or after t_max, or enters it
// strictly farther than best_t (prune only strictly farther boxes: an
// equal one may hold an equal-t hit with a lower triangle id).
__device__ __forceinline__ float box_entry(float4 a, float4 b, float3 inv, float3 o,
                                           float t_max, float best_t) {
  float lo = EPS, hi = t_max;
  slab_axis(a.x, a.w, inv.x, o.x, lo, hi);
  slab_axis(a.y, b.x, inv.y, o.y, lo, hi);
  slab_axis(a.z, b.y, inv.z, o.z, lo, hi);
  return (lo < hi && lo <= best_t) ? lo : -1.0f;
}

__device__ __forceinline__ void cx(unsigned& a, unsigned& b) {
  unsigned lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// ---------------------------------------------------------------------------
// K1, one thread per ray (launches of WIDE_BELOW rays or more)
// ---------------------------------------------------------------------------

// K1 for ray i. rays: (8, R) planes [o.xyz, d.xyz, active, t_max].
// nodes, tris: the tables of build_k1_tables; root: the root's reference
// (0 << 8 | its occupancy mask). out: (4, R) planes [t, u, v,
// dropped_min]; out_tri: (R,); attrs: (16, R) or null. stack: this
// thread's column of the block's stack (stride K1_BLOCK).
//
// A stack entry is (node, the node's hit children not yet visited, in
// entry-distance order as 3-bit slots, their count). The entry of the
// deepest such node stays in registers (cur_*), the ones above it in
// shared memory. Visiting the next child of an entry re-tests that one
// box against the best hit so far.
__device__ __forceinline__ void k1_ray(
    int i, const float* __restrict__ rays, int R, const float4* __restrict__ nodes,
    unsigned root, const float4* __restrict__ tris,
    const float* __restrict__ attr_rows, float* __restrict__ out,
    int* __restrict__ out_tri, float* __restrict__ attrs, uint2* stack) {
  float ox = rays[i], oy = rays[(size_t)R + i], oz = rays[(size_t)2 * R + i];
  float dx = rays[(size_t)3 * R + i], dy = rays[(size_t)4 * R + i],
        dz = rays[(size_t)5 * R + i];
  bool active = rays[(size_t)6 * R + i] != 0.0f;
  float t_max = rays[(size_t)7 * R + i];

  float best_t = CUDART_INF_F, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;

  if (active && (root & 0xFFu)) {
    float3 inv = make_float3(slab_inv(dx), slab_inv(dy), slab_inv(dz));
    float3 org = make_float3(ox, oy, oz);
    unsigned fresh = root;  // a node to expand (its reference), or 0
    unsigned cur_node = 0, cur_list = 0, cur_n = 0;
    int sp = 0;
    unsigned leaf_first = 0, leaf_n = 0;
    while (true) {
      // node steps until this lane has a leaf pending or nothing is left
      while (leaf_n == 0) {
        unsigned ref;
        if (fresh) {
          // expand: test the occupied children, sort the hits by entry
          // distance (the low 3 bits of the key carry the child slot);
          unsigned node = fresh >> 8, m = fresh & 0xFFu;
          const float4* rec = nodes + (size_t)node * NODE_F4;
          // all eight records are loaded before any is tested, so their
          // loads are in flight together; an empty slot's record is zero
          // and the occupancy mask m drops its result
          float4 ca[8], cb[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            ca[k] = rec[2 * k];
            cb[k] = rec[2 * k + 1];
          }
          unsigned key[8];
          int n = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float t = box_entry(ca[k], cb[k], inv, org, t_max, best_t);
            bool hit = (m >> k & 1u) && t >= 0.0f;
            key[k] = hit ? (__float_as_uint(t) & ~7u) | k : 0xFFFFFFFFu;
            n += hit;
          }
          fresh = 0;
          if (n == 0) continue;
          cx(key[0], key[1]); cx(key[2], key[3]); cx(key[4], key[5]); cx(key[6], key[7]);
          cx(key[0], key[2]); cx(key[1], key[3]); cx(key[4], key[6]); cx(key[5], key[7]);
          cx(key[1], key[2]); cx(key[5], key[6]); cx(key[0], key[4]); cx(key[3], key[7]);
          cx(key[1], key[5]); cx(key[2], key[6]); cx(key[1], key[4]); cx(key[3], key[6]);
          cx(key[2], key[4]); cx(key[3], key[5]); cx(key[3], key[4]);
          ref = __float_as_uint(rec[2 * (key[0] & 7u) + 1].z);
          if (n > 1) {
            if (cur_n) stack[K1_BLOCK * sp++] = make_uint2(cur_node, cur_list << 4 | cur_n);
            cur_node = node;
            cur_n = n - 1;
            cur_list = 0;
#pragma unroll
            for (int k = 7; k >= 1; --k) cur_list = cur_list << 3 | (key[k] & 7u);
          }
        } else {
          // the next child of the deepest entry, re-tested
          if (cur_n == 0) {
            if (sp == 0) break;
            uint2 e = stack[K1_BLOCK * --sp];
            cur_node = e.x;
            cur_list = e.y >> 4;
            cur_n = e.y & 0xFu;
          }
          const float4* rec = nodes + (size_t)cur_node * NODE_F4 + 2 * (cur_list & 7u);
          cur_list >>= 3;
          --cur_n;
          float4 b = rec[1];
          if (box_entry(rec[0], b, inv, org, t_max, best_t) < 0.0f) continue;
          ref = __float_as_uint(b.z);
        }
        if (ref & LEAF_BIT) {
          leaf_first = (ref & ~LEAF_BIT) >> 4;
          leaf_n = ref & 0xFu;
        } else {
          fresh = ref;
        }
      }
      if (leaf_n == 0) break;
      // leaf steps: the pending block's occupied triangles, two loaded at
      // a time; u and v only for a new best hit
      const float4* tr = tris + (size_t)leaf_first * TRI_F4;
      for (; leaf_n > 0; leaf_n -= min(leaf_n, 2u), tr += 2 * TRI_F4) {
        float4 p[2], q[2], s[2];
        p[0] = tr[0];
        q[0] = tr[1];
        s[0] = tr[2];
        if (leaf_n > 1) {
          p[1] = tr[3];
          q[1] = tr[4];
          s[1] = tr[5];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j == 1 && leaf_n < 2) break;
          float t = mt_hit(ox, oy, oz, dx, dy, dz, p[j].x, p[j].y, p[j].z, q[j].x, q[j].y,
                           q[j].z, s[j].x, s[j].y, s[j].z);
          int tri = __float_as_int(p[j].w);
          if (t < t_max && (t < best_t || (t == best_t && tri < best_tri))) {
            moller_trumbore(ox, oy, oz, dx, dy, dz, p[j].x, p[j].y, p[j].z, q[j].x, q[j].y,
                            q[j].z, s[j].x, s[j].y, s[j].z, best_t, best_u, best_v);
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

__global__ void __launch_bounds__(K1_BLOCK) bvh_traverse_kernel(
    const float* __restrict__ rays, int R, const float4* __restrict__ nodes,
    unsigned root, const float4* __restrict__ tris,
    const float* __restrict__ attr_rows, float* __restrict__ out,
    int* __restrict__ out_tri, float* __restrict__ attrs) {
  __shared__ uint2 stack[MAX_STACK * K1_BLOCK];
  int i = blockIdx.x * K1_BLOCK + threadIdx.x;
  if (i < R)
    k1_ray(i, rays, R, nodes, root, tris, attr_rows, out, out_tri, attrs,
           stack + threadIdx.x);
}

// ---------------------------------------------------------------------------
// K1, eight lanes per ray (launches of fewer than WIDE_BELOW rays)
// ---------------------------------------------------------------------------

constexpr int WIDE_LANES = 8;     // lanes per ray: one per child, one per triangle slot
constexpr int WIDE_BLOCK = 128;   // threads per block: 16 rays
// a hint only (55 registers fit 9 blocks per SM): without it ptxas picks
// 48 registers and spills one to an 8-byte stack frame
constexpr int WIDE_MIN_BLOCKS = 4;

// Plane c of interp_attrs, in its operation order.
__device__ __forceinline__ float attr_plane(const float* __restrict__ a, float u, float v,
                                            unsigned c) {
  float w = (1.0f - u) - v;
  if (c < 3) return (a[c] * w + a[3 + c] * u) + a[6 + c] * v;
  if (c < 12) return a[6 + c];
  if (c == 12) return (a[18] * w + a[20] * u) + a[22] * v;
  if (c == 13) return (a[19] * w + a[21] * u) + a[23] * v;
  return c == 14 ? a[24] : 0.0f;
}

// The least of x over the ray's eight lanes.
__device__ __forceinline__ unsigned group_min(unsigned x, unsigned gm) {
#pragma unroll
  for (int d = 1; d < WIDE_LANES; d <<= 1) x = min(x, __shfl_xor_sync(gm, x, d, WIDE_LANES));
  return x;
}

__device__ __forceinline__ unsigned long long group_min64(unsigned long long x, unsigned gm) {
#pragma unroll
  for (int d = 1; d < WIDE_LANES; d <<= 1) {
    unsigned lo = __shfl_xor_sync(gm, (unsigned)x, d, WIDE_LANES);
    unsigned hi = __shfl_xor_sync(gm, (unsigned)(x >> 32), d, WIDE_LANES);
    unsigned long long y = (unsigned long long)hi << 32 | lo;
    x = y < x ? y : x;
  }
  return x;
}

// Lanes 8i..8i+7 of the grid walk ray i together, lane k taking child
// slot k of a node and triangle k of a leaf block, so that a node or leaf
// step issues its loads at once. A step: the lanes test the children of
// `node` in the mask m (all its occupied ones, or the hit ones still left
// of a stack entry, re-tested against the best hit), the least key
// (distance, slot) names the nearest, and the others that were hit are
// pushed as one entry (node << 8 | mask). Entry s of the stack lives in
// lane s's register: at most one per internal level, so depth <= 8. A
// leaf: each lane runs Moller-Trumbore on its triangle, and the least
// (t, triangle id) of the block, then against the best so far, wins.
// Same tables, arguments and outputs as bvh_traverse_kernel.
__global__ void __launch_bounds__(WIDE_BLOCK, WIDE_MIN_BLOCKS) bvh_traverse_wide_kernel(
    const float* __restrict__ rays, int R, const float4* __restrict__ nodes,
    unsigned root, const float4* __restrict__ tris,
    const float* __restrict__ attr_rows, float* __restrict__ out,
    int* __restrict__ out_tri, float* __restrict__ attrs) {
  const unsigned lane = threadIdx.x & 31u, k = lane & 7u, base = lane - k;
  const unsigned gm = 0xFFu << base;
  const int i = (int)(((size_t)blockIdx.x * WIDE_BLOCK + threadIdx.x) / WIDE_LANES);
  if (i >= R) return;  // the ray's eight lanes leave together
  float ox = rays[i], oy = rays[(size_t)R + i], oz = rays[(size_t)2 * R + i];
  float dx = rays[(size_t)3 * R + i], dy = rays[(size_t)4 * R + i],
        dz = rays[(size_t)5 * R + i];
  bool active = rays[(size_t)6 * R + i] != 0.0f;
  float t_max = rays[(size_t)7 * R + i];
  float best_t = CUDART_INF_F, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  unsigned long long best_key = ~0ull;  // (t bits, triangle id) of the best hit

  if (active && (root & 0xFFu)) {
    float3 inv = make_float3(slab_inv(dx), slab_inv(dy), slab_inv(dz));
    float3 org = make_float3(ox, oy, oz);
    unsigned node = root >> 8, m = root & 0xFFu;
    unsigned stack_entry = 0;  // entry k of the ray's stack
    int sp = 0;
    while (true) {
      float t = -1.0f;
      unsigned ref = 0;
      if (m >> k & 1u) {
        const float4* rec = nodes + (size_t)node * NODE_F4 + 2 * k;
        float4 a = rec[0], b = rec[1];
        t = box_entry(a, b, inv, org, t_max, best_t);
        ref = __float_as_uint(b.z);
      }
      unsigned hit = (__ballot_sync(gm, t >= 0.0f) >> base) & 0xFFu;
      if (hit) {
        unsigned j = group_min(t >= 0.0f ? (__float_as_uint(t) & ~7u) | k : 0xFFFFFFFFu, gm)
                     & 7u;
        ref = __shfl_sync(gm, ref, j, WIDE_LANES);
        unsigned rest = hit & ~(1u << j);
        if (rest) {
          if (k == (unsigned)sp) stack_entry = node << 8 | rest;
          ++sp;
        }
        if (!(ref & LEAF_BIT)) {
          node = ref >> 8;
          m = ref & 0xFFu;
          continue;
        }
        // a leaf block: lane k tests its k-th occupied triangle
        unsigned first = (ref & ~LEAF_BIT) >> 4, n = ref & 0xFu;
        unsigned long long key = ~0ull;
        float u = 0.0f, v = 0.0f;
        if (k < n) {
          const float4* tr = tris + (size_t)(first + k) * TRI_F4;
          float4 p = tr[0], q = tr[1], s = tr[2];
          float tt;
          moller_trumbore(ox, oy, oz, dx, dy, dz, p.x, p.y, p.z, q.x, q.y, q.z,
                          s.x, s.y, s.z, tt, u, v);
          if (tt < t_max)
            key = (unsigned long long)__float_as_uint(tt) << 32 | __float_as_uint(p.w);
        }
        unsigned long long g = group_min64(key, gm);
        if (g < best_key) {
          unsigned w = __ffs((__ballot_sync(gm, key == g) >> base) & 0xFFu) - 1;
          best_key = g;
          best_t = __uint_as_float((unsigned)(g >> 32));
          best_tri = (int)(unsigned)g;
          best_u = __shfl_sync(gm, u, w, WIDE_LANES);
          best_v = __shfl_sync(gm, v, w, WIDE_LANES);
        }
      }
      // pop: the next entry's children, re-tested in the next step
      if (sp == 0) break;
      --sp;
      unsigned e = __shfl_sync(gm, stack_entry, sp, WIDE_LANES);
      node = e >> 8;
      m = e & 0xFFu;
    }
  }

  if (k == 0) {
    out[i] = best_t;
    out[(size_t)R + i] = best_u;
    out[(size_t)2 * R + i] = best_v;
    out[(size_t)3 * R + i] = CUDART_INF_F;  // exact: nothing dropped
    out_tri[i] = best_tri;
  }
  if (attrs != nullptr) {  // lane k writes planes 2k and 2k + 1
    const float* a = attr_rows + (size_t)(best_tri < 0 ? 0 : best_tri) * ROW;
    attrs[(size_t)(2 * k) * R + i] = attr_plane(a, best_u, best_v, 2 * k);
    attrs[(size_t)(2 * k + 1) * R + i] = attr_plane(a, best_u, best_v, 2 * k + 1);
  }
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

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

// K1 with one thread per ray (wide = 0) or eight lanes per ray (wide = 1).
// Returns cudaGetLastError() after the launch (0 = launched).
int rt_bvh_traverse(const float* rays, int R, const float* nodes, unsigned root,
                    const float* tris, const float* attr_rows, float* out,
                    int* out_tri, float* attrs, int wide, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (wide) {
    long long threads = (long long)R * WIDE_LANES;
    bvh_traverse_wide_kernel<<<(int)((threads + WIDE_BLOCK - 1) / WIDE_BLOCK), WIDE_BLOCK, 0,
                               s>>>(rays, R, n4, root, t4, attr_rows, out, out_tri, attrs);
  } else {
    bvh_traverse_kernel<<<(R + K1_BLOCK - 1) / K1_BLOCK, K1_BLOCK, 0, s>>>(
        rays, R, n4, root, t4, attr_rows, out, out_tri, attrs);
  }
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
