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
//   lane rolls for the horizontal neighbours; here one thread owns one
//   output pixel and reads its 9 neighbours itself.
//
// Bit-equality with the plain version (ops/denoise.py denoise_u8_plain):
//   - the sort is odd-even transposition, 9 rounds, swapping only on a
//     strict '>', so it is stable like the plain version's stable sort and
//     equal-luminance ties pick the same median sample;
//   - every constant is rounded once from the double PyTorch receives as a
//     Python float ((float)(1.0 / 255.999), not 1.0f / 255.999f);
//   - --fmad=false keeps the luminance and the blend as separate rounded
//     products and sums, as PyTorch's elementwise ops compute them;
//   - the 9 luminances are summed in neighbourhood order (dy, dx row-major)
//     and both divisions are true divisions, as in the plain version.
//
// Bound on this card at 1920x1080 (2,073,600 pixels), from
// raytracing_c_tpu_torch/utils/bounds.py:
//   bytes: 3 in + 3 out per pixel = 12.4 MB, 3.7 us at 3.35 TB/s;
//   operations: the least the function needs is 196 per pixel (the
//   pixel's own conversion, scaling and luminance, 11, shared by its 9
//   neighbours; the 9-sum 8; min and max 16; the mean 3; a 19-compare-
//   exchange median-of-9 network on (luminance, index) keys, 7 each; the
//   blend 25) = 0.41 G. Built with --fmad=false, each is one instruction,
//   at 33.5 T/s (half of the 67 TFLOP/s, which counts an FMA as two):
//   12.1 us. Operations bind.
//   What this kernel does instead: each thread converts and weighs all 9
//   neighbours itself (9 luminances of 5, 54 conversions and scalings) and
//   sorts them with a 36-compare-swap odd-even network of 1 compare and 8
//   selects, about 459 instructions per pixel. Also left on the table:
//   every pixel is read by 9 threads through L1/L2 instead of once into a
//   shared-memory tile with a halo, and the 3-byte pixels make 27 byte
//   loads and 3 byte stores per thread.

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

__device__ __forceinline__ void cswap(float& a, float& b, bool s) {
  float lo = s ? b : a;
  float hi = s ? a : b;
  a = lo;
  b = hi;
}

__global__ void __launch_bounds__(256) denoise_u8_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;

  float lum[9], r[9], g[9], b[9];
  float total = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    int yy = min(max(y + dy, 0), H - 1);
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      int xx = min(max(x + dx, 0), W - 1);
      const uint8_t* p = in + ((size_t)yy * W + xx) * 3;
      int k = (dy + 1) * 3 + (dx + 1);
      r[k] = (float)p[0] * kScale;
      g[k] = (float)p[1] * kScale;
      b[k] = (float)p[2] * kScale;
      lum[k] = (r[k] * kL0 + g[k] * kL1) + b[k] * kL2;
      total = k == 0 ? lum[0] : total + lum[k];
    }
  }
  float orig_lum = lum[4], orig_r = r[4], orig_g = g[4], orig_b = b[4];

  // odd-even transposition sort keyed on luminance; RGB swaps with its key
#pragma unroll
  for (int rnd = 0; rnd < 9; ++rnd) {
#pragma unroll
    for (int i = rnd & 1; i < 8; i += 2) {
      bool s = lum[i] > lum[i + 1];
      cswap(lum[i], lum[i + 1], s);
      cswap(r[i], r[i + 1], s);
      cswap(g[i], g[i + 1], s);
      cswap(b[i], b[i + 1], s);
    }
  }

  float mean = ((total - lum[0]) - lum[8]) / 7.0f;
  float noisiness = fabsf(lum[4] - mean);
  float diff = fabsf(lum[4] - orig_lum) - noisiness * kWeight;
  float t = fminf(fmaxf(diff, 0.0f), kThreshold) / kThreshold;
  float keep = 1.0f - t;

  uint8_t* o = out + ((size_t)y * W + x) * 3;
  o[0] = (uint8_t)((orig_r * keep + r[4] * t) * kEncode);
  o[1] = (uint8_t)((orig_g * keep + g[4] * t) * kEncode);
  o[2] = (uint8_t)((orig_b * keep + b[4] * t) * kEncode);
}

}  // namespace

extern "C" {

// in, out: (H, W, 3) u8, contiguous. Returns cudaGetLastError() after the
// launch (0 = launched).
int rt_denoise_u8(const uint8_t* in, uint8_t* out, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 block(32, 8);
  dim3 grid((W + 31) / 32, (H + 7) / 8);
  denoise_u8_kernel<<<grid, block, 0, s>>>(in, out, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
