// The bounce's shade, background and advance (K4) for NVIDIA Hopper.
//
// Built by raytracing_c_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// into libshade.so and bound with ctypes through rt_shade_bounce and
// rt_nee_add below (ops/shade_cuda.py).
//
// K4 shade_bounce_kernel replaces no TPU kernel: the JAX package leaves
// this stage to XLA, which fuses it (raytracing_c_tpu/render/
// integrator.py: bounce_step). In the port it was plain PyTorch, one ATen
// launch per elementwise op: about 700 launches a bounce, whose host
// dispatch took 63-71% of a batch while the card idled (PERF.md,
// section 5). K4 is that code, render/integrator.py: _tail_plain from the
// `shade` span to the end of `advance`, in one launch, one thread per
// lane:
//   - the hit point o + d t, the unit shading normal, the backface test
//     and the shaded mask, from K1's epilogue or K2's 16 attribute planes
//     (sphere winners' planes are written in before the launch);
//   - the material row, the normal, albedo, metal-roughness and emissive
//     taps on the atlas's u8 planes (bilinear or nearest, repeat wrap,
//     edge clamp) with the sRGB decode (ops/texture.py, ops/disney.py:
//     shade);
//   - the view-aligned basis, sample_disney_brdf with both lobes, the
//     tint, the terminate flag and the debug-normal shader;
//   - with NEE: the light sample (the env map's alias table, or the
//     uniform sphere under a constant sky; ops/env_light.py), both
//     eval_disney_brdf calls, the MIS weight, the background at the light
//     direction, the shadow ray and its contribution throughput x
//     nee_partial; the shadow test itself stays outside (nonzero over the
//     shaded mask, K1), and rt_nee_add then adds the contribution on the
//     lanes it leaves unoccluded;
//   - the background of a miss (ops/background.py) with NEE's BRDF-side
//     MIS weight from prev_pdf;
//   - the advance: radiance, the continue decision, Russian roulette, the
//     epsilon-biased next origin and direction, prev_pdf and active.
// Each state plane and each row of the uniforms is read with its own
// stride: bounce 0's origin is an expanded scalar (stride 0), and the
// compacted tracer's draws are rows of a transposed (n, nu) tensor.
//
// Variants: a template on NEE, an env-light table (NEE only) and an
// equirect background, so that the render path's variant carries none of
// NEE's registers; the wrapper picks one of the 6. Russian roulette and
// nearest taps are fields of the argument, the same for every lane of a
// launch, so their branches never diverge within a warp.
//
// What bounds it on this card: utils/bounds.py: k4_work counts a launch's
// bytes (each lane's state and next state; a hit's two normals; a shaded
// lane's other attributes, draws and four 3-byte taps per map of its
// material; with NEE its draws, alias slot, light taps and shadow ray; a
// miss's background taps) and its operations (one per instruction, one
// per libm routine, so a floor), and chip_smoke.py's kernels line sets
// the larger beside the launch's device time. One thread per lane keeps
// every intermediate in registers; the loads a lane issues first (its
// state and attributes) are independent, and the taps of the albedo,
// metal-roughness and emissive maps depend only on the attributes, so
// they are in flight together.
//
// Bit-equality with the plain path (_tail_plain run on the card, the
// oracle of tests/test_torch_cuda.py). Every value is computed as the
// plain path's ATen kernels compute it:
//   - float32 throughout, one rounding per operation in the plain path's
//     order (--fmad=false: no contraction; dot products as ((x + y) + z));
//   - the same libm routines as ATen's float kernels: sinf, cosf, sqrtf,
//     rsqrtf, atan2f, asinf, floorf, powf (torch.pow(x, 5.0) and the sRGB
//     pow(x, 2.4), whose exponents come in as arguments so that powf stays
//     the general routine ATen calls; torch.pow(x, 2.0) is x * x in ATen);
//   - a tensor divided by a Python number is multiplied by the number's
//     reciprocal, taken in double and rounded to float (ATen's CUDA div
//     does so: x / 1.055 is x * (float)(1.0 / 1.055), which is not
//     x * (1.0f / 1.055f)); `1.0 / x` is a true division (reciprocal), a
//     tensor by a tensor a true division;
//   - every Python constant is rounded once from its double, as PyTorch
//     receives it ((float)0.9999, not 0.9999f);
//   - clamp_min, clamp_max, clamp and maximum pass NaN through, as ATen's;
//   - a float becomes an int by truncation (__float2int_rz: NaN -> 0, as
//     ATen's cast on the card);
//   - a value the plain path computes and then discards in a where() is
//     not computed here (the unselected texture taps, the basis' unused
//     crosses, the shading of lanes that are not shaded): the selected
//     values are the same. Both lobes of the sampler are evaluated, as
//     the plain path does, before the lobe is picked.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int K4_BLOCK = 128;
constexpr int ROW = 128;  // floats per material row

// Python constants, each rounded once from the double PyTorch receives.
constexpr double kPiD = 3.141592653589793;                   // math.pi
constexpr float kPiF = (float)kPiD;                          // disney.PI
constexpr float kTwoPiF = (float)(2.0 * (double)kPiF);       // 2.0 * PI
constexpr float kInvPiF = (float)(1.0 / (double)kPiF);       // x / PI
constexpr float kBgU = (float)(0.5 / kPiD);                  // background: 0.5 / pi
constexpr float kBgV = (float)(1.0 / kPiD);                  // 1.0 / pi
constexpr float kTwoPiD = (float)(2.0 * kPiD);               // env_light.TWO_PI
constexpr float kInv2PiSq = (float)(1.0 / (2.0 * kPiD * kPiD));  // env_light.INV_2PISQ
constexpr double kSpherePdfD = 1.0 / (4.0 * kPiD);
constexpr float kSpherePdf = (float)kSpherePdfD;             // UNIFORM_SPHERE_PDF
constexpr float kSpherePdfSq = (float)(kSpherePdfD * kSpherePdfD);
constexpr float kEps = (float)1.0e-4;                        // EPSILON
constexpr float kTexScale = (float)(1.0 / 255.999);          // u8 -> [0, 1]
constexpr float kL0 = (float)0.2126, kL1 = (float)0.7152, kL2 = (float)0.0722;  // LUMA
constexpr float kSrgbOff = (float)0.055;
constexpr float kInvSrgbDiv = (float)(1.0 / 1.055);          // x / 1.055
constexpr float kInvMetal = (float)(1.0 / 0.9);              // x / 0.9
constexpr float kF0 = (float)0.04;
constexpr float kF90 = (float)(1.0 / 0.04);
constexpr float kTiny38 = (float)1e-38, kTiny30 = (float)1e-30, kTiny20 = (float)1e-20;
constexpr float kMinPdf4 = (float)1e-5, kMinSinT = (float)1e-6;
constexpr float kMinCos = (float)0.001, kMaxNoh = (float)0.99, kAxis = (float)0.9999;
constexpr float kRoughMin = (float)0.001;
constexpr float kRrMin = (float)0.05;
constexpr float kSheenR = (float)0.3, kSheenG = (float)0.6;

// MROW_* columns of MaterialTable.rows (models/scene.py)
constexpr int M_BASE = 0, M_EMI = 3, M_ROUGH = 6, M_METAL = 7, M_NSTR = 8, M_SHEEN = 9,
              M_SHEENT = 10, M_ANISO = 11, M_TEX_ALBEDO = 12, M_TEX_NORMAL = 13,
              M_TEX_MR = 14, M_TEX_EMI = 15, M_KIND = 16;
constexpr int SHADER_DEBUG_NORMAL = 1;

// Output planes of the (n, R) float block and the (n, R) flag block.
constexpr int O_ORG = 0, O_DIR = 3, O_TP = 6, O_RAD = 9, O_PDF = 12, O_SORG = 13, O_WD = 16,
              O_NEE = 19;
constexpr int F_ACTIVE = 0, F_SHADED = 1;

}  // namespace

// One plane of R floats, element i at p[i * s] (s may be 0 or any stride).
struct K4Plane {
  const float* p;
  long long s;
};

// Everything one launch reads and writes; ops/shade_cuda.py: _Args mirrors it.
struct K4Args {
  long long R;
  K4Plane o[3], d[3], tp[3], rad[3], prev_pdf, t;
  const uint8_t* active;  // torch.bool
  long long active_s;
  const float* attrs;  // (16, R) planes: normal3 ng3 tangent3 bitangent3 uv_u uv_v mat 0
  long long attrs_s0, attrs_s1;
  const float* rand4;  // (>= 3, R): lobe, u1, u2[, rr]
  long long rand4_s0, rand4_s1;
  const float* rand2;  // (3, R) with NEE: alias slot, jitter u, jitter v
  long long rand2_s0, rand2_s1;
  const float* mat_rows;  // (n_mat, 128)
  long long n_mat;
  const uint8_t* tex_r;
  const uint8_t* tex_g;
  const uint8_t* tex_b;
  const int* tex_off;
  const int* tex_w;
  const int* tex_h;
  long long n_tex;
  const float* bg_color;  // (3,) for a constant sky
  long long bg_tex;       // the equirect map's texture
  const float* env_prob;  // the env-light table (NEE with a table)
  const long long* env_alias;
  const float* env_lum_p;
  long long env_w, env_h;
  float env_inv_w, env_inv_h;  // (float)(1.0 / w), (float)(1.0 / h)
  long long rr;       // Russian roulette on
  long long gamble;   // it plays this bounce (rr and bounce >= RR_START)
  long long nearest;  // nearest texel taps, else bilinear
  float pow5, srgb_exp;  // 5.0 and 2.4
  float* out;  // (22, R) with NEE, (12, R) without
  uint8_t* flags;  // (2, R): active, shaded
  long long R_out;
};

namespace {

// --- scalar helpers, with ATen's NaN semantics ------------------------------

__device__ __forceinline__ float clamp_min_(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum_(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ int to_i32(float x) { return __float2int_rz(x); }

// --- Vec3 (utils/vec3.py), in its operation order ----------------------------

__device__ __forceinline__ float3 v3(float x, float y, float z) { return make_float3(x, y, z); }
__device__ __forceinline__ float3 add(float3 a, float3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ float3 sub(float3 a, float3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ float3 mul(float3 a, float3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ float3 mul(float3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float3 adds(float3 a, float s) { return v3(a.x + s, a.y + s, a.z + s); }
__device__ __forceinline__ float3 neg(float3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(float3 a, float3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ float3 cross(float3 a, float3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float3 normalized(float3 a) {
  return mul(a, rsqrtf(clamp_min_(dot(a, a), kTiny38)));
}
__device__ __forceinline__ float3 sel(bool c, float3 a, float3 b) { return c ? a : b; }
// Vec3.lerp: self * (1 - t) + o * t
__device__ __forceinline__ float3 lerp(float3 a, float3 b, float t) {
  float k = 1.0f - t;
  return add(mul(a, k), mul(b, t));
}

__device__ __forceinline__ float ld(const K4Plane& p, long long i) { return p.p[i * p.s]; }
__device__ __forceinline__ float3 ld3(const K4Plane* p, long long i) {
  return v3(ld(p[0], i), ld(p[1], i), ld(p[2], i));
}

// --- textures (ops/texture.py) ----------------------------------------------

__device__ __forceinline__ float wrap01(float x) { return x - floorf(x); }

__device__ __forceinline__ float3 fetch(const K4Args& a, int off, int w, int x, int y) {
  long long idx = (long long)(int)((unsigned)off + (unsigned)y * (unsigned)w + (unsigned)x);
  return v3((float)__ldg(a.tex_r + idx) * kTexScale, (float)__ldg(a.tex_g + idx) * kTexScale,
            (float)__ldg(a.tex_b + idx) * kTexScale);
}

__device__ __forceinline__ float3 sample_tex(const K4Args& a, long long tex, float u, float v,
                                             bool nearest) {
  int k = (int)min(max(tex, 0ll), a.n_tex - 1);
  int off = __ldg(a.tex_off + k), w = __ldg(a.tex_w + k), h = __ldg(a.tex_h + k);
  float px = wrap01(u) * (float)w;
  float py = wrap01(v) * (float)h;
  int x0 = min(max(to_i32(px), 0), w - 1);
  int y0 = min(max(to_i32(py), 0), h - 1);
  if (nearest) return fetch(a, off, w, x0, y0);
  float fa = px - (float)x0;
  float fb = py - (float)y0;
  int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  float3 c0 = lerp(fetch(a, off, w, x0, y0), fetch(a, off, w, x1, y0), fa);
  float3 c1 = lerp(fetch(a, off, w, x0, y1), fetch(a, off, w, x1, y1), fa);
  return lerp(c0, c1, fb);
}

// color.srgb_to_linear: pow(clamp_min(c + 0.055, 0) / 1.055, 2.4)
__device__ __forceinline__ float srgb(float c, float e) {
  return powf(clamp_min_(c + kSrgbOff, 0.0f) * kInvSrgbDiv, e);
}
__device__ __forceinline__ float3 srgb3(float3 c, float e) {
  return v3(srgb(c.x, e), srgb(c.y, e), srgb(c.z, e));
}

// --- background (ops/background.py) and env light (ops/env_light.py) ---------

template <bool EQUIRECT>
__device__ __forceinline__ float3 background(const K4Args& a, float3 d) {
  if (EQUIRECT) {
    float u = atan2f(d.z, d.x) * kBgU + 0.5f;
    float v = 0.5f - asinf(clamp_(d.y, -1.0f, 1.0f)) * kBgV;
    return srgb3(sample_tex(a, a.bg_tex, u, v, false), a.srgb_exp);
  }
  return v3(a.bg_color[0], a.bg_color[1], a.bg_color[2]);
}

// env_light.eval_pdf
__device__ __forceinline__ float env_pdf(const K4Args& a, float3 d) {
  int w = (int)a.env_w, h = (int)a.env_h;
  float u = atan2f(d.z, d.x) * kBgU + 0.5f;
  float v = 0.5f - asinf(clamp_(d.y, -1.0f, 1.0f)) * kBgV;
  int x = min(max(to_i32(u * (float)w), 0), w - 1);
  int y = min(max(to_i32(v * (float)h), 0), h - 1);
  float sin_t = clamp_min_(cosf((0.5f - v) * kPiF), kMinSinT);
  float lp = __ldg(a.env_lum_p + (long long)(y * w + x));
  return (lp * (float)(a.env_w * a.env_h)) * kInv2PiSq / sin_t;
}

// env_light.sample: the direction, and its pdf in pdf
__device__ __forceinline__ float3 env_sample(const K4Args& a, float u_sel, float u_jx, float u_jy,
                                             float& pdf) {
  long long n = a.env_w * a.env_h;
  float r = u_sel * (float)n;
  int j = min(max(to_i32(r), 0), (int)(n - 1));
  float frac = r - (float)j;
  long long texel = frac < __ldg(a.env_prob + j) ? (long long)j : __ldg(a.env_alias + j);
  long long x = texel % a.env_w, y = texel / a.env_w;
  float u = ((float)x + u_jx) * a.env_inv_w;
  float v = ((float)y + u_jy) * a.env_inv_h;
  float sin_t = clamp_min_(cosf((0.5f - v) * kPiF), kMinSinT);
  pdf = (__ldg(a.env_lum_p + texel) * (float)n) * kInv2PiSq / sin_t;
  float phi = (u - 0.5f) * kTwoPiD;
  float ang = (0.5f - v) * kPiF;
  float rr = cosf(ang);
  return v3(rr * cosf(phi), sinf(ang), rr * sinf(phi));
}

// disney.sample_uniform_sphere
__device__ __forceinline__ float3 uniform_sphere(float u1, float u2) {
  float z = 1.0f - u1 * 2.0f;
  float r = sqrtf(clamp_min_(1.0f - z * z, 0.0f));
  float phi = u2 * kTwoPiF;
  return v3(r * cosf(phi), r * sinf(phi), z);
}

// --- Disney BRDF (ops/disney.py) ----------------------------------------------

__device__ __forceinline__ float luminance(float3 v) { return (v.x * kL0 + v.y * kL1) + v.z * kL2; }

__device__ __forceinline__ float pow5(float x, float e) {
  return powf(clamp_min_(1.0f - x, 0.0f), e);
}

// fresnel_schlick_scalar with f0 = 1
__device__ __forceinline__ float fresnel1(float f90, float theta, float e) {
  return (f90 - 1.0f) * pow5(theta, e) + 1.0f;
}

__device__ __forceinline__ float3 fresnel_rgb(float3 f0, float f90, float theta, float e) {
  float p = pow5(theta, e);
  return add(f0, mul(sub(v3(f90, f90, f90), f0), p));
}

__device__ __forceinline__ float distribution_ggx(float r, float noh) {
  float a2 = r * r;
  float x = (noh * noh) * (a2 * a2 - 1.0f) + 1.0f;
  return a2 / ((x * x) * kPiF);
}

__device__ __forceinline__ float smith_g(float ndotv, float alpha2) {
  float a = alpha2 * alpha2;
  float b = ndotv * ndotv;
  return (ndotv * 2.0f) / (ndotv + sqrtf(clamp_min_((a + b) - a * b, 0.0f)));
}

__device__ __forceinline__ float geometry_term(float nol, float nov, float r) {
  float a2 = r * r;
  return smith_g(nov, a2) * smith_g(nol, a2);
}

__device__ __forceinline__ float shadowed_f90(float3 f0) {
  return clamp_max_(luminance(f0) * kF90, 1.0f);
}

__device__ __forceinline__ float3 sheen_tint_color(float3 base) {
  float lum = (base.x * kSheenR + base.y * kSheenG) + base.z * 1.0f;
  float3 tint = mul(base, 1.0f / clamp_min_(lum, kTiny20));
  return lum > 0.0f ? tint : v3(1.0f, 1.0f, 1.0f);
}

__device__ __forceinline__ float3 evaluate_sheen(float sheen, float3 base, float sheen_tint,
                                                 float hol) {
  float3 col = lerp(v3(1.0f, 1.0f, 1.0f), sheen_tint_color(base), sheen_tint);
  float m = clamp_min_(1.0f - hol, 0.0f);
  float3 out = mul(col, sheen * ((((m * m) * m) * m) * m));
  return sheen > 0.0f ? out : v3(0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float3 eval_diffuse(float3 base, float nol, float nov, float loh,
                                               float r, float e) {
  float fd90 = (((r * 2.0f) * loh) * loh) + 0.5f;
  float fa = fresnel1(fd90, nol, e);
  float fb = fresnel1(fd90, nov, e);
  return mul(base, (fa * fb) * kInvPiF);
}

__device__ __forceinline__ float3 eval_specular(float r, float3 fresnel, float noh, float nov,
                                                float nol) {
  float d = distribution_ggx(r, noh);
  float g = geometry_term(nol, nov, r);
  return mul(fresnel, (d * g) / ((nol * 4.0f) * nov));
}

__device__ __forceinline__ float pdf_ggx_vndf(float noh, float nov, float r) {
  float d = distribution_ggx(r, noh);
  float g1 = smith_g(nov, r * r);
  return (d * g1) / clamp_min_(nov * 4.0f, kMinPdf4);
}

__device__ __forceinline__ float3 sample_cosine_hemisphere(float u1, float u2) {
  float angle = (u1 * 2.0f) * kPiF;
  float dist = sqrtf(u2);
  return v3(sinf(angle) * dist, cosf(angle) * dist,
            sqrtf(clamp_min_(1.0f - dist * dist, 0.0f)));
}

__device__ __forceinline__ float3 sample_ggx_vndf(float3 v, float ax, float ay, float u1,
                                                  float u2) {
  float3 vh = normalized(v3(v.x * ax, v.y * ay, v.z));
  float lensq = vh.x * vh.x + vh.y * vh.y;
  bool has = lensq > 0.0f;
  float inv_len = has ? 1.0f / sqrtf(clamp_min_(lensq, kTiny30)) : 0.0f;
  float3 t1 = has ? v3(-vh.y * inv_len, vh.x * inv_len, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  float3 t2 = cross(vh, t1);
  float r = sqrtf(u1);
  float phi = u2 * kTwoPiF;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  float s = (vh.z + 1.0f) * 0.5f;
  p2 = (1.0f - s) * sqrtf(clamp_min_(1.0f - p1 * p1, 0.0f)) + s * p2;
  float3 nh = add(add(mul(t1, p1), mul(t2, p2)),
                  mul(vh, sqrtf(clamp_min_((1.0f - p1 * p1) - p2 * p2, 0.0f))));
  return normalized(v3(nh.x * ax, nh.y * ay, clamp_min_(nh.z, 0.0f)));
}

struct Material {
  float3 base;
  float rough, metal, sheen, sheen_tint;
};

// sample_disney_brdf in tangent space: out_dir, rgb, pdf (both lobes)
__device__ __forceinline__ void sample_disney_brdf(const Material& m, float aniso2, float3 in,
                                                   float u_lobe, float u1, float u2, float e,
                                                   float3& out_dir, float3& rgb, float& pdf) {
  float alpha_x = ((m.rough * m.rough) * (1.0f - aniso2)) + aniso2;
  float alpha_y = m.rough * m.rough;
  float3 micro_n = sample_ggx_vndf(in, alpha_x, alpha_y, u1, u2);

  float3 f0 = lerp(v3(kF0, kF0, kF0), m.base, m.metal);
  float3 fresnel = fresnel_rgb(f0, shadowed_f90(f0), dot(in, micro_n), e);

  float dw = 1.0f - m.metal;
  float sw = luminance(fresnel);
  float inv_w = 1.0f / clamp_min_(dw + sw, kTiny20);
  dw = dw * inv_w;
  sw = sw * inv_w;

  bool pick_diffuse = u_lobe < dw;
  float nov = in.z;

  // diffuse lobe (cosine hemisphere)
  float3 out_d = sample_cosine_hemisphere(u1, u2);
  float3 half_d = normalized(add(out_d, in));
  float nol_d = out_d.z;
  bool ok_d = (nol_d > 0.0f) && (nov > 0.0f);
  float loh = dot(out_d, half_d);
  float pdf_d = nol_d * kInvPiF;
  float3 diff = add(mul(eval_diffuse(m.base, nol_d, nov, loh, m.rough, e),
                        sub(v3(1.0f, 1.0f, 1.0f), fresnel)),
                    evaluate_sheen(m.sheen, m.base, m.sheen_tint, loh));
  float3 rgb_d = mul(diff, ok_d ? nol_d : 0.0f);
  float a_d = ok_d ? dw * pdf_d : 0.0f;

  // specular lobe (VNDF reflection)
  float3 vi = neg(in);
  float3 out_s = sub(vi, mul(micro_n, dot(vi, micro_n) * 2.0f));
  float nol_s = out_s.z;
  bool ok_s = (nol_s > 0.0f) && (nov > 0.0f);
  float nol_sc = clamp_min_(nol_s, kMinCos);
  float nov_sc = clamp_min_(nov, kMinCos);
  float noh = clamp_max_(micro_n.z, kMaxNoh);
  float pdf_s = pdf_ggx_vndf(noh, nov_sc, m.rough);
  float3 spec = eval_specular(m.rough, fresnel, noh, nov_sc, nol_sc);
  float3 rgb_s = mul(spec, ok_s ? nol_sc : 0.0f);
  float a_s = ok_s ? sw * pdf_s : 0.0f;

  out_dir = normalized(sel(pick_diffuse, out_d, out_s));
  rgb = sel(pick_diffuse, rgb_d, rgb_s);
  pdf = pick_diffuse ? a_d : a_s;
}

// eval_disney_brdf: f_nol (both lobes x NoL) and the mixture pdf
__device__ __forceinline__ float3 eval_disney_brdf(const Material& m, float3 in, float3 out,
                                                   float e, float& pdf) {
  float nov = clamp_min_(in.z, kMinCos);
  float nol = out.z;
  bool ok = (nol > 0.0f) && (in.z > 0.0f);
  float nol_c = clamp_min_(nol, kMinCos);

  float3 h = normalized(add(in, out));
  float noh = clamp_max_(h.z, kMaxNoh);
  float loh = dot(out, h);

  float3 f0 = lerp(v3(kF0, kF0, kF0), m.base, m.metal);
  float3 fresnel = fresnel_rgb(f0, shadowed_f90(f0), dot(in, h), e);

  float dw = 1.0f - m.metal;
  float sw = luminance(fresnel);
  float inv_w = 1.0f / clamp_min_(dw + sw, kTiny20);
  dw = dw * inv_w;
  sw = sw * inv_w;

  float3 diff = add(mul(eval_diffuse(m.base, nol_c, nov, loh, m.rough, e),
                        sub(v3(1.0f, 1.0f, 1.0f), fresnel)),
                    evaluate_sheen(m.sheen, m.base, m.sheen_tint, loh));
  float3 spec = eval_specular(m.rough, fresnel, noh, nov, nol_c);
  float3 f_nol = mul(add(diff, spec), ok ? nol_c : 0.0f);
  float p = (dw * clamp_min_(nol, 0.0f)) * kInvPiF + sw * pdf_ggx_vndf(noh, nov, m.rough);
  pdf = ok ? p : 0.0f;
  return f_nol;
}

// --- the lane --------------------------------------------------------------------

__device__ __forceinline__ float attr(const K4Args& a, int c, long long i) {
  return a.attrs[c * a.attrs_s0 + i * a.attrs_s1];
}
__device__ __forceinline__ float3 attr3(const K4Args& a, int c, long long i) {
  return v3(attr(a, c, i), attr(a, c + 1, i), attr(a, c + 2, i));
}

__device__ __forceinline__ void store3(const K4Args& a, int plane, long long i, float3 v) {
  a.out[plane * a.R_out + i] = v.x;
  a.out[(plane + 1) * a.R_out + i] = v.y;
  a.out[(plane + 2) * a.R_out + i] = v.z;
}

template <bool NEE, bool ENV, bool EQUIRECT>
__device__ __forceinline__ void k4_lane(const K4Args& a, long long i) {
  const float e5 = a.pow5, e24 = a.srgb_exp;
  const bool nearest = a.nearest != 0;
  const float3 zero = v3(0.0f, 0.0f, 0.0f);
  float3 o = ld3(a.o, i), d = ld3(a.d, i), tp = ld3(a.tp, i), rad = ld3(a.rad, i);
  bool active = a.active[i * a.active_s] != 0;
  float t = ld(a.t, i);
  bool is_hit = active && isfinite(t);
  float3 point = add(o, mul(d, t));

  bool backface = false, shaded = false;
  float3 ng = zero;
  if (is_hit) {
    float3 nrm = attr3(a, 0, i);
    ng = attr3(a, 3, i);
    backface = (dot(ng, d) > 0.0f) || (dot(nrm, d) > 0.0f);
    shaded = !backface;
  }

  // shade (disney.shade) on the shaded lanes
  float3 out_dir = zero, tint = zero, emission = zero;
  bool terminate = false;
  float pdf_eval = CUDART_INF_F;
  float3 nee_dir = zero, nee_partial = zero;
  if (shaded) {
    float3 normal = normalized(attr3(a, 0, i));
    float3 tangent = attr3(a, 6, i), bitangent = attr3(a, 9, i);
    float uu = attr(a, 12, i), uv = attr(a, 13, i);
    int mat_id = to_i32(attr(a, 14, i));
    const float* mr =
        a.mat_rows + (long long)min(max(mat_id, 0), (int)(a.n_mat - 1)) * ROW;
    Material m;
    m.base = v3(__ldg(mr + M_BASE), __ldg(mr + M_BASE + 1), __ldg(mr + M_BASE + 2));
    emission = v3(__ldg(mr + M_EMI), __ldg(mr + M_EMI + 1), __ldg(mr + M_EMI + 2));
    float rough = __ldg(mr + M_ROUGH), metal = __ldg(mr + M_METAL);
    float nstr = __ldg(mr + M_NSTR);
    m.sheen = __ldg(mr + M_SHEEN);
    m.sheen_tint = __ldg(mr + M_SHEENT);
    float aniso = __ldg(mr + M_ANISO);
    int t_alb = to_i32(__ldg(mr + M_TEX_ALBEDO)), t_nrm = to_i32(__ldg(mr + M_TEX_NORMAL));
    int t_mr = to_i32(__ldg(mr + M_TEX_MR)), t_emi = to_i32(__ldg(mr + M_TEX_EMI));
    int kind = to_i32(__ldg(mr + M_KIND));

    float3 n = normal;
    if (t_nrm >= 0) {  // apply_normal_map
      float3 tex = sample_tex(a, t_nrm, uu, uv, nearest);
      float vx = tex.x * 2.0f - 1.0f;
      float vy = -(tex.y * 2.0f - 1.0f);
      float vz = tex.z * 2.0f - 1.0f;
      float3 mapped = add(add(mul(tangent, vx), mul(bitangent, vy)), mul(normal, vz));
      n = normalized(add(mul(mapped, nstr), mul(normal, 1.0f - nstr)));
    }
    if (t_alb >= 0) m.base = mul(m.base, srgb3(sample_tex(a, t_alb, uu, uv, nearest), e24));
    if (t_mr >= 0) {
      float3 tex = sample_tex(a, t_mr, uu, uv, nearest);
      rough = rough * tex.y;
      metal = metal * tex.z;
    }
    m.rough = clamp_(rough, kRoughMin, 1.0f);
    m.metal = clamp_max_(metal, (float)0.9) * kInvMetal;
    if (t_emi >= 0) emission = mul(emission, srgb3(sample_tex(a, t_emi, uu, uv, nearest), e24));

    // view-aligned tangent basis (disney.basis)
    float3 tb;
    if (fabsf(dot(n, d)) < kAxis) {
      tb = cross(n, d);
    } else if (fabsf(n.y) < kAxis) {
      tb = cross(n, v3(0.0f, 1.0f, 0.0f));
    } else {
      tb = cross(n, v3(1.0f, 0.0f, 0.0f));
    }
    tb = normalized(tb);
    float3 bb = cross(n, tb);
    float3 nd = neg(d);
    float3 in = v3(dot(nd, tb), dot(nd, bb), dot(nd, n));

    float3 out_t, rgb;
    float pdf;
    sample_disney_brdf(m, aniso * aniso, in, a.rand4[i * a.rand4_s1],
                       a.rand4[a.rand4_s0 + i * a.rand4_s1],
                       a.rand4[2 * a.rand4_s0 + i * a.rand4_s1], e5, out_t, rgb, pdf);
    out_dir = add(add(mul(tb, out_t.x), mul(bb, out_t.y)), mul(n, out_t.z));

    bool ok = pdf > 0.0f;
    float inv_pdf = ok ? 1.0f / (ok ? pdf : 1.0f) : 0.0f;
    tint = mul(rgb, inv_pdf);
    terminate = !ok;
    bool is_debug = kind == SHADER_DEBUG_NORMAL;
    if (is_debug) emission = adds(mul(n, 0.5f), 0.5f);
    terminate = terminate || is_debug;

    if (NEE) {
      float r0 = a.rand2[i * a.rand2_s1], r1 = a.rand2[a.rand2_s0 + i * a.rand2_s1];
      float pl, pl2;
      if (ENV) {
        float r2 = a.rand2[2 * a.rand2_s0 + i * a.rand2_s1];
        nee_dir = env_sample(a, r0, r1, r2, pl);
        pl2 = pl * pl;
      } else {
        nee_dir = uniform_sphere(r0, r1);
        pl = kSpherePdf;
        pl2 = kSpherePdfSq;
      }
      float3 wd_t = v3(dot(nee_dir, tb), dot(nee_dir, bb), dot(nee_dir, n));
      float pdf_ev;
      float3 f_nol = eval_disney_brdf(m, in, wd_t, e5, pdf_ev);
      float w_nee = pl2 / (pl2 + pdf_ev * pdf_ev);
      bool ok_l = pl > 0.0f;
      float inv_pl = ok_l ? 1.0f / (ok_l ? pl : 1.0f) : 0.0f;
      nee_partial = mul(mul(background<EQUIRECT>(a, nee_dir), f_nol),
                        is_debug ? 0.0f : w_nee * inv_pl);
      float pdf_out;
      eval_disney_brdf(m, in, out_t, e5, pdf_out);
      pdf_eval = is_debug ? CUDART_INF_F : pdf_out;
    }
  }
  rad = add(rad, shaded ? mul(tp, emission) : zero);

  // background of a miss (bounce_step's background span)
  bool miss = active && !is_hit;
  float prev = NEE ? ld(a.prev_pdf, i) : 0.0f;
  float3 bgc = zero;
  if (miss) {
    float3 bg = background<EQUIRECT>(a, d);
    if (NEE) {
      float pp2 = prev * prev;
      float pl2;
      if (ENV) {
        float pl = env_pdf(a, d);
        pl2 = pl * pl;
      } else {
        pl2 = kSpherePdfSq;
      }
      bg = mul(bg, isfinite(prev) ? pp2 / (pp2 + pl2) : 1.0f);
    }
    bgc = mul(tp, bg);
  }
  rad = add(rad, bgc);

  if (NEE) {
    if (shaded) {  // the shadow ray and its contribution; rt_nee_add adds it if unoccluded
      float s = dot(ng, nee_dir) < 0.0f ? -kEps : kEps;
      store3(a, O_SORG, i, add(point, mul(ng, s)));
      store3(a, O_WD, i, nee_dir);
      store3(a, O_NEE, i, mul(tp, nee_partial));
    } else {
      rad = add(rad, zero);  // the plain path adds a zero contribution here
    }
  }

  // advance
  bool cont = shaded && !terminate;
  float3 tp_next = cont ? mul(tp, tint) : tp;
  if (a.rr != 0) {
    float lum = maximum_(maximum_(tp_next.x, tp_next.y), tp_next.z);
    float p = clamp_(lum, kRrMin, 1.0f);
    bool gamble = cont && a.gamble != 0;
    bool kill = gamble && (a.rand4[3 * a.rand4_s0 + i * a.rand4_s1] >= p);
    cont = cont && !kill;
    tp_next = mul(tp_next, (gamble && !kill) ? 1.0f / p : 1.0f);
  }
  float3 new_o;
  if (backface) {
    new_o = add(point, mul(d, kEps));
  } else if (cont) {
    float bias = dot(ng, out_dir) < 0.0f ? -kEps : kEps;
    new_o = add(point, mul(ng, bias));
  } else {
    new_o = o;
  }
  store3(a, O_ORG, i, new_o);
  store3(a, O_DIR, i, cont ? out_dir : d);
  store3(a, O_TP, i, tp_next);
  store3(a, O_RAD, i, rad);
  if (NEE) a.out[O_PDF * a.R_out + i] = backface ? prev : (cont ? pdf_eval : CUDART_INF_F);
  a.flags[F_SHADED * a.R_out + i] = shaded;
  a.flags[F_ACTIVE * a.R_out + i] = cont || backface;
}

template <bool NEE, bool ENV, bool EQUIRECT>
// __grid_constant__: the lane reads the argument in place, with no copy to
// local memory for the planes it indexes.
__global__ void __launch_bounds__(K4_BLOCK) shade_bounce_kernel(const __grid_constant__ K4Args a) {
  long long i = (long long)blockIdx.x * K4_BLOCK + threadIdx.x;
  if (i < a.R) k4_lane<NEE, ENV, EQUIRECT>(a, i);
}

// The radiance of the lanes a shadow test left unoccluded (bounce_step's
// `lit`): rad[l] + (lit ? contrib[l] : 0) on each of the n shaded lanes l.
__global__ void __launch_bounds__(256) nee_add_kernel(float* __restrict__ rad,
                                                      const float* __restrict__ contrib,
                                                      long long plane, const long long* lanes,
                                                      const float* shot_t, long long t_s,
                                                      long long n) {
  long long k = (long long)blockIdx.x * 256 + threadIdx.x;
  if (k >= n) return;
  long long l = lanes[k];
  bool lit = !isfinite(shot_t[k * t_s]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    long long j = c * plane + l;
    rad[j] = rad[j] + (lit ? contrib[j] : 0.0f);
  }
}

// Variant flags (ops/shade_cuda.py)
constexpr int V_NEE = 1, V_ENV = 2, V_EQUIRECT = 4;

template <int F>
int launch_variant(int flags, const K4Args& a, cudaStream_t s) {
  if constexpr ((F & V_ENV) == 0 || (F & V_NEE) != 0) {
    if (flags == F) {
      long long blocks = (a.R + K4_BLOCK - 1) / K4_BLOCK;
      shade_bounce_kernel<(F & V_NEE) != 0, (F & V_ENV) != 0, (F & V_EQUIRECT) != 0>
          <<<(unsigned)blocks, K4_BLOCK, 0, s>>>(a);
      return (int)cudaGetLastError();
    }
  }
  if constexpr (F > 0) {
    return launch_variant<F - 1>(flags, a, s);
  } else {
    return -1;
  }
}

}  // namespace

extern "C" {

// K4 over a->R lanes, variant `flags`. Returns cudaGetLastError() after the
// launch (0 = launched), -1 for flags that name no variant.
int rt_shade_bounce(const K4Args* a, int flags, void* stream) {
  if (a->R <= 0) return 0;
  return launch_variant<7>(flags, *a, reinterpret_cast<cudaStream_t>(stream));
}

int rt_nee_add(float* rad, const float* contrib, long long plane, const long long* lanes,
               const float* shot_t, long long t_s, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  nee_add_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(rad, contrib, plane, lanes, shot_t,
                                                             t_s, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
