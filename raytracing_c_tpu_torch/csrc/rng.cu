// The threefry2x32 draws (K5) for NVIDIA Hopper.
//
// Built by raytracing_c_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into librng.so and bound with ctypes through the rt_* functions below
// (ops/rng_cuda.py).
//
// K5 replaces no TPU kernel: the JAX package draws through jax.random,
// whose threefry XLA fuses into the consumer. In the port the draw was
// utils/rng.py's plain version, threefry2x32 as about 171 int64 PyTorch
// elementwise ops (the words live in int64, every add and shift masked to
// 32 bits), one launch each: about 530 launches a bounce of the compacted
// tracer, whose host dispatch took three quarters of a batch while the
// card idled (PERF.md, section 5). K5 computes the same words on uint32_t
// registers, one launch a draw:
//   - rt_fold_in: m keys x (one word or m words): threefry(key, (0, data)),
//     jax.random.fold_in;
//   - rt_split: m keys -> num subkeys each, threefry(key, (0, i)),
//     jax.random.split in its partitionable form;
//   - rt_random_bits and rt_uniform: m keys x n flat counters c, the block
//     threefry(key, (c >> 32, c & 0xFFFFFFFF)), bits0 ^ bits1; the uniform
//     takes the top 23 bits as the mantissa of a float in [1, 2), minus 1,
//     then max(f, 0), or in the bounded form max(lo, f * span + lo) with
//     the product and the sum in double (exact product, two roundings:
//     utils/rng.py rounds the same way);
//   - rt_bounce_uniforms, the compacted tracer's draw a bounce: for each
//     lane j the key threefry(threefry(key, (0, slot[j])), (0, bounce)) in
//     registers, then its nu uniform words of counters 0 .. nu - 1, written
//     as a contiguous (nu, n) float32 plane (the rows K4 takes as rand4 and
//     rand2). No per-lane key is written to memory.
// A key is two uint32 words held in int64 (utils/rng.py's layout): K5 reads
// the low 32 bits of each, as the plain version's masks keep them, and
// writes keys and bits back as int64 holding uint32 values.
//
// What bounds it on this card: integer instructions. One threefry block is
// 20 rounds of an add, a rotation (one funnel shift) and an xor, and five
// key injections of two adds: about 73 instructions (utils/bounds.py:
// THREEFRY_OPS), against 8 bytes of a lane's slot and 4 of each word it
// writes. A bounce over 262,144 lanes at nu = 3 is 5 blocks a lane, about
// 0.1 G instructions: a few microseconds. One thread per output (per lane
// for the bounce draw) keeps everything in registers; the writes of a row
// are coalesced across the warp.
//
// Bit-equality with the plain path (utils/rng.py run on the CPU, the
// oracle of tests/test_torch_cuda.py, itself held to jax.random by
// tests/test_torch_rng.py): uint32_t arithmetic wraps as the int64 masks
// do; the float steps are exact except the bounded form's, which rounds
// where the plain version does: __dmul_rn (exact) and __dadd_rn in
// double, then __double2float_rn.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K5_BLOCK = 256;

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// Four rounds with the rotations of even (A) and odd (B) injections
__device__ __forceinline__ void rounds_a(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
}

__device__ __forceinline__ void rounds_b(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
}

// Threefry-2x32, 20 rounds (Salmon et al. 2011), as utils/rng.py:
// threefry2x32: the counter (x0, x1) under the key (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds_a(x0, x1); x0 += k1; x1 += k2 + 1u;
  rounds_b(x0, x1); x0 += k2; x1 += k0 + 2u;
  rounds_a(x0, x1); x0 += k0; x1 += k1 + 3u;
  rounds_b(x0, x1); x0 += k1; x1 += k2 + 4u;
  rounds_a(x0, x1); x0 += k2; x1 += k0 + 5u;
}

// The uniform of a 32-bit word: the top 23 bits as the mantissa of a float
// in [1, 2), minus 1 (exact), and the plain version's clamp_min(f, 0)
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return fmaxf(__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f, 0.0f);
}

__global__ void __launch_bounds__(K5_BLOCK) k5_fold_in_kernel(
    const int64_t* __restrict__ keys, long long key_s, const int64_t* __restrict__ data,
    long long data_s, uint32_t scalar, long long m, int64_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * K5_BLOCK + threadIdx.x;
  if (i >= m) return;
  const int64_t* k = keys + i * key_s;
  uint32_t x0 = 0u, x1 = data ? (uint32_t)data[i * data_s] : scalar;
  threefry2x32((uint32_t)k[0], (uint32_t)k[1], x0, x1);
  out[2 * i] = (int64_t)x0;
  out[2 * i + 1] = (int64_t)x1;
}

// out[i, j] = threefry(key j, (0, i)) over num x m (row i of the subkeys)
__global__ void __launch_bounds__(K5_BLOCK) k5_split_kernel(
    const int64_t* __restrict__ keys, long long key_s, long long m, long long total,
    int64_t* __restrict__ out) {
  long long t = (long long)blockIdx.x * K5_BLOCK + threadIdx.x;
  if (t >= total) return;
  long long i = m == 1 ? t : t / m;
  const int64_t* k = keys + (t - i * m) * key_s;
  uint32_t x0 = 0u, x1 = (uint32_t)i;
  threefry2x32((uint32_t)k[0], (uint32_t)k[1], x0, x1);
  out[2 * t] = (int64_t)x0;
  out[2 * t + 1] = (int64_t)x1;
}

// MODE 0: the bits as int64; 1: the uniform on [0, 1); 2: the bounded form
template <int MODE>
__global__ void __launch_bounds__(K5_BLOCK) k5_bits_kernel(
    const int64_t* __restrict__ keys, long long key_s, long long n, long long total, float lo,
    float span, void* __restrict__ out) {
  long long t = (long long)blockIdx.x * K5_BLOCK + threadIdx.x;
  if (t >= total) return;
  long long j = n == total ? 0 : t / n;
  unsigned long long c = (unsigned long long)(t - j * n);
  const int64_t* k = keys + j * key_s;
  uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
  threefry2x32((uint32_t)k[0], (uint32_t)k[1], x0, x1);
  uint32_t bits = x0 ^ x1;
  if constexpr (MODE == 0) {
    static_cast<int64_t*>(out)[t] = (int64_t)bits;
  } else if constexpr (MODE == 1) {
    static_cast<float*>(out)[t] = unit_float(bits);
  } else {
    float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    float v = __double2float_rn(__dadd_rn(__dmul_rn((double)f, (double)span), (double)lo));
    static_cast<float*>(out)[t] = fmaxf(lo, v);
  }
}

// Lane j: k = threefry(threefry(key, (0, slot[j])), (0, bounce)), then the
// nu words out[c, j] of counters c < nu under k
__global__ void __launch_bounds__(K5_BLOCK) k5_bounce_uniforms_kernel(
    const int64_t* __restrict__ key, const int64_t* __restrict__ slot, long long slot_s,
    uint32_t bounce, int nu, long long n, float* __restrict__ out) {
  long long j = (long long)blockIdx.x * K5_BLOCK + threadIdx.x;
  if (j >= n) return;
  uint32_t a0 = 0u, a1 = (uint32_t)slot[j * slot_s];
  threefry2x32((uint32_t)key[0], (uint32_t)key[1], a0, a1);
  uint32_t b0 = 0u, b1 = bounce;
  threefry2x32(a0, a1, b0, b1);
  for (int c = 0; c < nu; ++c) {
    uint32_t x0 = 0u, x1 = (uint32_t)c;
    threefry2x32(b0, b1, x0, x1);
    out[(long long)c * n + j] = unit_float(x0 ^ x1);
  }
}

inline unsigned blocks(long long n) { return (unsigned)((n + K5_BLOCK - 1) / K5_BLOCK); }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = launched; nothing is
// launched for no output). keys: int64 rows of two words, row r at
// keys + r * key_s (key_s 0: one key for every row).

// out (m, 2): fold_in of key row i with data[i * data_s], or with `scalar`
// where data is null.
int rt_fold_in(const int64_t* keys, long long key_s, const int64_t* data, long long data_s,
               long long scalar, long long m, int64_t* out, void* stream) {
  if (m <= 0) return 0;
  k5_fold_in_kernel<<<blocks(m), K5_BLOCK, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      keys, key_s, data, data_s, (uint32_t)scalar, m, out);
  return (int)cudaGetLastError();
}

// out (num, m, 2): subkey i of key row j at out[i, j].
int rt_split(const int64_t* keys, long long key_s, long long m, long long num, int64_t* out,
             void* stream) {
  long long total = m * num;
  if (total <= 0) return 0;
  k5_split_kernel<<<blocks(total), K5_BLOCK, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      keys, key_s, m, total, out);
  return (int)cudaGetLastError();
}

// out (m, n) int64: the bits of counters 0 .. n - 1 under each key row.
int rt_random_bits(const int64_t* keys, long long key_s, long long m, long long n, int64_t* out,
                   void* stream) {
  long long total = m * n;
  if (total <= 0) return 0;
  k5_bits_kernel<0><<<blocks(total), K5_BLOCK, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      keys, key_s, n, total, 0.0f, 0.0f, out);
  return (int)cudaGetLastError();
}

// out (m, n) float32: the uniforms of counters 0 .. n - 1 under each key
// row, on [0, 1) or, with `bounded`, max(lo, f * span + lo).
int rt_uniform(const int64_t* keys, long long key_s, long long m, long long n, float lo,
               float span, int bounded, float* out, void* stream) {
  long long total = m * n;
  if (total <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bounded) {
    k5_bits_kernel<2><<<blocks(total), K5_BLOCK, 0, s>>>(keys, key_s, n, total, lo, span, out);
  } else {
    k5_bits_kernel<1><<<blocks(total), K5_BLOCK, 0, s>>>(keys, key_s, n, total, lo, span, out);
  }
  return (int)cudaGetLastError();
}

// out (nu, n) float32: lane j's nu uniforms under the key of (key, slot[j *
// slot_s], bounce).
int rt_bounce_uniforms(const int64_t* key, const int64_t* slot, long long slot_s,
                       long long bounce, int nu, long long n, float* out, void* stream) {
  if (n <= 0 || nu <= 0) return 0;
  k5_bounce_uniforms_kernel<<<blocks(n), K5_BLOCK, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      key, slot, slot_s, (uint32_t)bounce, nu, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
