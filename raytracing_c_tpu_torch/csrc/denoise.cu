// Firefly median denoiser (K3) for NVIDIA Hopper.
//
// Built by raytracing_c_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into libdenoise.so and bound with ctypes through rt_denoise_u8 below.
//
// K3 denoise_u8_kernel replaces the Pallas kernel
//   raytracing_c_tpu/ops/denoise_pallas.py: denoise_u8_pallas ->
//   _denoise_kernel (the reference's denoiser.c:47-127). Per pixel of an
//   interleaved (H, W, 3) u8 image: the 3x3 edge-clamped neighbourhood
//   scaled by 1/255.999, Rec.709 luminance of each sample, the luminance
//   median by a stable sort (its RGB travels with its key), the mean
//   luminance without the minimum and maximum, and a blend of the centre
//   toward the median by t = clamp(|med - orig| - 5 |med - mean|, 0,
//   0.0125) / 0.0125; out = (orig (1 - t) + med t) * 255.999, truncated.
//   The TPU kernel works on row blocks of three shifted row views with
//   lane rolls for the horizontal neighbours.
//
// Design: a block of 32 x 8 threads owns a 32 x 32 output tile. It loads
// the tile and a 1-pixel halo (34 x 34, edge-clamped) from the u8 image,
// consecutive threads on consecutive pixels, and converts each input pixel
// once into shared memory: r, g, b, luminance and a sort key (1.13
// conversions per output pixel). Each thread then walks down a column of
// four output rows with its 3 x 3 window in registers: a step reads one new
// row of three luminances and keys from shared memory and reuses the other
// six, with their row minima and maxima. Per pixel it sums the nine
// luminances in neighbourhood order, takes the minimum and maximum from the
// three rows', and selects the median with a 19-compare-exchange
// median-of-9 network (Devillard's opt_med9, the MEDIAN9_NETWORK of
// ops/denoise.py) on 32-bit keys, luminance above the neighbour's index.
// The keys are distinct, so the network picks the stable sort's fifth
// sample exactly; only the index travels through it, and the median's rgb
// and luminance are read back from shared memory. A warp stores one row:
// 96 consecutive bytes.
//
// The key: every luminance of a u8 pixel is 0 or lies in [2^-13, 1)
// (the least non-zero one is 0.0722 / 255.999 = 2.8e-4), where a float's
// bits rise with its value; max(bits - (0x39000000 - 1), 0) keeps the
// order in 27 bits, and shifted left by 4 it leaves room for the index.
// tests/test_torch_denoise.py checks the range on every u8 colour and the
// network on every 0-1 input.
//
// Bit-equality with the plain version (ops/denoise.py denoise_u8_plain):
//   - every constant is rounded once from the double PyTorch receives as a
//     Python float ((float)(1.0 / 255.999), not 1.0f / 255.999f);
//   - a u8 becomes a float exactly, as the bits 0x4B000000 | u minus 2^23;
//   - --fmad=false keeps the luminance and the blend as separate rounded
//     products and sums, as PyTorch's elementwise ops compute them;
//   - the 9 luminances are summed in neighbourhood order (dy, dx row-major)
//     and both divisions are true divisions, as in the plain version.
//
// Bound on this card at 1920x1080 (2,073,600 pixels), from
// raytracing_c_tpu_torch/utils/bounds.py (K3_OPS_PER_PIXEL): 6 bytes per
// pixel (12.4 MB, 3.7 us at 3.35 TB/s) against the operations of this
// design counted at one instruction each: per input pixel its conversion,
// luminance and key, shared by its 9 neighbours; per output pixel the
// keys' indices, the 9-sum, the minimum and maximum (a new row's and the
// three rows'), the mean, the network of 19 min/max pairs and the blend.
// Operations bind. The times are in PERF.md, section 6: the earlier
// thread-per-pixel kernel (9 conversions and a 36-compare-swap sort per
// pixel) took twice as long.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kScale = (float)(1.0 / 255.999);  // u8 -> f32
constexpr float kEncode = (float)255.999;         // f32 -> u8
constexpr float kL0 = (float)0.2126;  // Rec.709 luma, denoiser.c:12-14
constexpr float kL1 = (float)0.7152;
constexpr float kL2 = (float)0.0722;
constexpr float kThreshold = (float)0.0125;  // DENOISING_THRESHOLD, denoiser.c:9
constexpr float kWeight = 5.0f;              // NEIGHBOURHOOD_WEIGHT, denoiser.c:10

constexpr int TX = 32, TY = 8;              // threads per block
constexpr int ROWS = 4;                     // output rows per thread, consecutive
constexpr int HX = TX + 2, HY = TY * ROWS + 2;  // the 32 x 32 tile and its halo
constexpr unsigned kKeyBase = 0x39000000u - 1u;  // bits of 2^-13, less one

__device__ __forceinline__ float u8_to_float(unsigned u) {
  return __uint_as_float(0x4B000000u | u) - 8388608.0f;  // exact
}

__device__ __forceinline__ void cx(unsigned& a, unsigned& b) {
  unsigned lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// One output pixel, its neighbourhood's corner at tile row ty, column tx:
// the blend of the centre toward the median (neighbour m) and the store.
__device__ __forceinline__ void blend_store(
    const float (*s_r)[HX], const float (*s_g)[HX], const float (*s_b)[HX],
    const float (*s_lum)[HX], int tx, int ty, int m, float total, float lo, float hi,
    float centre, uint8_t* __restrict__ o) {
  int my = ty + m / 3, mx = tx + m % 3;
  float med = s_lum[my][mx];
  float mean = ((total - lo) - hi) / 7.0f;
  float noisiness = fabsf(med - mean);
  float diff = fabsf(med - centre) - noisiness * kWeight;
  float t = fminf(fmaxf(diff, 0.0f), kThreshold) / kThreshold;
  float keep = 1.0f - t;
  o[0] = (uint8_t)((s_r[ty + 1][tx + 1] * keep + s_r[my][mx] * t) * kEncode);
  o[1] = (uint8_t)((s_g[ty + 1][tx + 1] * keep + s_g[my][mx] * t) * kEncode);
  o[2] = (uint8_t)((s_b[ty + 1][tx + 1] * keep + s_b[my][mx] * t) * kEncode);
}

__global__ void __launch_bounds__(TX * TY) denoise_u8_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int H, int W) {
  __shared__ float s_r[HY][HX], s_g[HY][HX], s_b[HY][HX], s_lum[HY][HX];
  __shared__ unsigned s_key[HY][HX];
  int x0 = blockIdx.x * TX - 1, y0 = blockIdx.y * TY * ROWS - 1;
  for (int p = threadIdx.y * TX + threadIdx.x; p < HX * HY; p += TX * TY) {
    int hy = p / HX, hx = p - hy * HX;
    int yy = min(max(y0 + hy, 0), H - 1);
    int xx = min(max(x0 + hx, 0), W - 1);
    const uint8_t* q = in + ((size_t)yy * W + xx) * 3;
    float r = u8_to_float(q[0]) * kScale;
    float g = u8_to_float(q[1]) * kScale;
    float b = u8_to_float(q[2]) * kScale;
    float lum = (r * kL0 + g * kL1) + b * kL2;
    s_r[hy][hx] = r;
    s_g[hy][hx] = g;
    s_b[hy][hx] = b;
    s_lum[hy][hx] = lum;
    s_key[hy][hx] = (unsigned)max((int)(__float_as_uint(lum) - kKeyBase), 0) << 4;
  }
  __syncthreads();
  int tx = threadIdx.x, x = blockIdx.x * TX + tx;
  int r0 = threadIdx.y * ROWS;
  if (x >= W) return;
  // a window of 3 tile rows in registers, sliding down the thread's rows
  float l[3][3], rlo[3], rhi[3];
  unsigned key[3][3];
#pragma unroll
  for (int j = 0; j < ROWS + 2; ++j) {
    int w = j % 3;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      l[w][kx] = s_lum[r0 + j][tx + kx];
      key[w][kx] = s_key[r0 + j][tx + kx];
    }
    rlo[w] = fminf(fminf(l[w][0], l[w][1]), l[w][2]);
    rhi[w] = fmaxf(fmaxf(l[w][0], l[w][1]), l[w][2]);
    if (j < 2) continue;
    int row = j - 2, y = blockIdx.y * TY * ROWS + r0 + row;
    if (y >= H) break;
    int a0 = row % 3, a1 = (row + 1) % 3, a2 = (row + 2) % 3;
    unsigned p[9];
    float total = l[a0][0];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      int ky = k / 3, kx = k % 3, wy = ky == 0 ? a0 : ky == 1 ? a1 : a2;
      p[k] = key[wy][kx] | (unsigned)k;
      if (k) total = total + l[wy][kx];
    }
    float lo = fminf(fminf(rlo[a0], rlo[a1]), rlo[a2]);
    float hi = fmaxf(fmaxf(rhi[a0], rhi[a1]), rhi[a2]);
    // median of 9 (opt_med9): p[4] ends as the fifth smallest key
    cx(p[1], p[2]); cx(p[4], p[5]); cx(p[7], p[8]);
    cx(p[0], p[1]); cx(p[3], p[4]); cx(p[6], p[7]);
    cx(p[1], p[2]); cx(p[4], p[5]); cx(p[7], p[8]);
    cx(p[0], p[3]); cx(p[5], p[8]); cx(p[4], p[7]);
    cx(p[3], p[6]); cx(p[1], p[4]); cx(p[2], p[5]);
    cx(p[4], p[7]); cx(p[4], p[2]); cx(p[6], p[4]);
    cx(p[4], p[2]);
    blend_store(s_r, s_g, s_b, s_lum, tx, r0 + row, (int)(p[4] & 15u), total, lo, hi,
                l[a1][1], out + ((size_t)y * W + x) * 3);
  }
}

}  // namespace

extern "C" {

// in, out: (H, W, 3) u8, contiguous. Returns cudaGetLastError() after the
// launch (0 = launched).
int rt_denoise_u8(const uint8_t* in, uint8_t* out, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY * ROWS - 1) / (TY * ROWS));
  denoise_u8_kernel<<<grid, block, 0, s>>>(in, out, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
