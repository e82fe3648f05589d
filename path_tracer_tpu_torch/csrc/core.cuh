// The core/ helpers that the OpenPBR layer walk (openpbr_walk.cu), the
// medium event (medium_event.cu), the basic models' samples
// (basic_sample.cu) and scatter's tail (scatter_tail.cu) call, for one
// lane: core/vec.py
// (normalize, safe_normalize, max4), core/sampling.py (the PCG stream of
// Rng, compute_tangent_vector, coordinate_frame, sample_direction_hg,
// ggx_roughness_alpha, ggx_smith_g1, ggx_visible_normal,
// ggx_distribution), core/optics.py
// (cauchy_empirical_ior, cos_theta_refracted, fresnel_dielectric,
// schlick_fresnel_metal) and core/spectrum.py
// (sample_parametric_spectrum).
//
// Each function takes the float32 operations of the PyTorch function it is
// named after in the same order, with Python's scalars rounded to float32
// as PyTorch rounds them (a division by a Python scalar as PyTorch's CUDA
// kernel takes it: times the scalar's reciprocal rounded to float32;
// `1.0 / x` as torch's reciprocal), the accurate sqrtf/sinf/cosf/powf, and
// NaN passed on where torch.clamp and torch.maximum pass it on. Built with
// -fmad=false (ops/build.py), every `a * b + c` rounds twice, as the plain
// version's separate tensor operations do.

#pragma once

#include <cstdint>

namespace pt {

// core/constants.py, in float32.
constexpr float EPSILON = 1e-9f;
constexpr float PI = 3.141592653f;
constexpr float TAU = 6.283185306f;

struct V3 {
  float x, y, z;
};

// A spectrum at the four hero wavelengths.
struct S4 {
  float v[4];
};

__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ S4 fill4(float s) { return {{s, s, s, s}}; }

// torch.clamp(x, min=lo), torch.clamp(x, max=hi) and torch.clamp(x, lo,
// hi): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// torch.maximum: NaN if either is.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// torch.sign: 0 for 0 and NaN.
__device__ __forceinline__ float sign(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

// ---- core/vec.py ---------------------------------------------------------

__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, 1.0f / sqrtf(dot(a, a)));
}

__device__ __forceinline__ V3 safe_normalize(V3 a) {
  const float lsq = dot(a, a);
  if (lsq < 1e-12f) return {0.0f, 0.0f, 1.0f};
  return scale(a, 1.0f / sqrtf(lsq));
}

__device__ __forceinline__ float max4(const S4& s) {
  return nan_max(nan_max(nan_max(s.v[0], s.v[1]), s.v[2]), s.v[3]);
}

// ---- core/sampling.py ----------------------------------------------------

// Rng.next_u32 and Rng.uniform: the PCG-style counter hash of the state,
// and its u32 -> float32 conversion rounded to nearest even.
__device__ __forceinline__ uint32_t next_u32(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  const uint32_t shift = (state >> 28) + 4u;
  const uint32_t w = ((state >> shift) ^ state) * 277803737u;
  return (w >> 22) ^ w;
}

__device__ __forceinline__ float uniform(uint32_t& state) {
  return __uint2float_rn(next_u32(state)) * (1.0f / 4294967296.0f);
}

// The state after `draws` more draws whose values nobody reads.
__device__ __forceinline__ void skip_draws(uint32_t& state, int draws) {
  for (int k = 0; k < draws; ++k) state = state * 747796405u + 2891336453u;
}

__device__ __forceinline__ V3 compute_tangent_vector(V3 n) {
  const V3 axis = fabsf(n.x) < 0.9f ? V3{1.0f, 0.0f, 0.0f}
                                    : V3{0.0f, 1.0f, 0.0f};
  return safe_normalize(cross(axis, n));
}

// The frame (x, y) that completes the unit vector z.
__device__ __forceinline__ void coordinate_frame(V3 z, V3& x, V3& y) {
  x = compute_tangent_vector(z);
  y = cross(x, z);
}

// Henyey-Greenstein, in the frame whose +Z is the incident direction; the
// plain version computes both z's and selects, which gives the same bits.
__device__ __forceinline__ V3 sample_direction_hg(float g, float u1,
                                                  float u2) {
  float z;
  if (fabsf(g) < 1e-3f) {
    z = 1.0f - 2.0f * u1;
  } else {
    const float s = (1.0f - g * g) / (1.0f + g - 2.0f * g * u1);
    z = -(1.0f + g * g - s * s) / (2.0f * g);
  }
  z = clamp(z, -1.0f, 1.0f);
  const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const float phi = u2 * TAU;
  return {r * cosf(phi), r * sinf(phi), z};
}

struct Alpha {
  float x, y;
};

__device__ __forceinline__ Alpha ggx_roughness_alpha(float roughness,
                                                     float anisotropy) {
  const float s = 1.0f - anisotropy;
  const float ax = roughness * roughness * sqrtf(2.0f / (1.0f + s * s));
  return {ax, s * ax};
}

__device__ __forceinline__ float ggx_smith_g1(V3 d, Alpha a) {
  const float dx2 = d.x * d.x, dy2 = d.y * d.y, dz2 = d.z * d.z;
  const float dz_safe = clamp_min(dz2, EPSILON);
  const float tan_term = (a.x * a.x * dx2 + a.y * a.y * dy2) / dz_safe;
  const float g1 = 2.0f / (1.0f + sqrtf(1.0f + tan_term));
  return dz2 < EPSILON ? 0.0f : g1;
}

__device__ __forceinline__ V3 ggx_visible_normal(V3 d, Alpha a, float u1,
                                                 float u2) {
  const V3 vz = safe_normalize({a.x * d.x, a.y * d.y, d.z});
  const float len_sq = vz.x * vz.x + vz.y * vz.y;
  const float inv_len = 1.0f / sqrtf(clamp_min(len_sq, 1e-20f));
  const V3 vx = len_sq > 0.0f ? V3{-vz.y * inv_len, vz.x * inv_len, 0.0f}
                              : V3{1.0f, 0.0f, 0.0f};
  const V3 vy = cross(vz, vx);
  const float r = sqrtf(u1);
  const float phi = TAU * u2;
  const float s = 0.5f * (1.0f + vz.z);
  const float tx = r * cosf(phi);
  const float ty = (1.0f - s) * sqrtf(clamp_min(1.0f - tx * tx, 0.0f)) +
                   s * r * sinf(phi);
  const float tz = sqrtf(clamp_min(1.0f - tx * tx - ty * ty, 0.0f));
  const V3 n = {tx * vx.x + ty * vy.x + tz * vz.x,
                tx * vx.y + ty * vy.y + tz * vz.y,
                tx * vx.z + ty * vy.z + tz * vz.z};
  return safe_normalize({a.x * n.x, a.y * n.y, clamp_min(n.z, 0.0f)});
}

__device__ __forceinline__ float ggx_distribution(V3 n, Alpha a) {
  const float inv_ax = 1.0f / a.x, inv_ay = 1.0f / a.y;
  const float b = n.x * n.x * inv_ax * inv_ax + n.y * n.y * inv_ay * inv_ay +
                  n.z * n.z;
  return 1.0f / (PI * a.x * a.y * b * b);
}

// ---- core/optics.py ------------------------------------------------------

// Python's double constants of the Cauchy formula (lc, ld, lf = 656.3,
// 587.6, 486.1 nm), rounded to float32 where the tensor code meets them:
// 1 / lf^2 - 1 / lc^2, and 1 / ld^2, which PyTorch's CUDA division by the
// scalar ld^2 multiplies by (the reciprocal of the double, rounded; the
// float32 reciprocal of float32 ld^2 is one ulp above it).
constexpr float CAUCHY_INV_SPAN = 0x1.006874p-19f;
constexpr float CAUCHY_INV_LD_SQ = 0x1.84ba7ap-19f;

__device__ __forceinline__ float cauchy_empirical_ior(float base_ior,
                                                      float abbe, float lam) {
  const float b = (base_ior - 1.0f) / (abbe * CAUCHY_INV_SPAN);
  const float a = base_ior - b * CAUCHY_INV_LD_SQ;
  return a + b / (lam * lam);
}

__device__ __forceinline__ float cos_theta_refracted(float eta,
                                                     float cos_theta) {
  const float cos2 = 1.0f - eta * eta * (1.0f - cos_theta * cos_theta);
  return -sign(cos_theta) * sqrtf(clamp_min(cos2, 0.0f));
}

__device__ __forceinline__ float fresnel_dielectric(float eta, float cos1,
                                                    float cos2) {
  const float ks = eta * cos1;
  const float sqrt_rs = (ks + cos2) / (ks - cos2);
  const float kp = eta * cos2;
  const float sqrt_rp = (kp + cos1) / (kp - cos1);
  return 0.5f * (sqrt_rs * sqrt_rs + sqrt_rp * sqrt_rp);
}

// Python's (1 - 1/7) ** 5 in float32, and the reciprocal of its
// (1/7) * (1 - 1/7) ** 6 taken in double and rounded: PyTorch's CUDA
// division by that Python scalar multiplies by it.
constexpr float SCHLICK_MAX_POW5 = 0x1.d9c4b0p-2f;
constexpr float SCHLICK_INV_DENOMINATOR = 0x1.1a6c12p+4f;

__device__ __forceinline__ float schlick_fresnel_metal(float base,
                                                       float specular,
                                                       float cos_theta) {
  const float one_minus = clamp_min(1.0f - cos_theta, 0.0f);
  const float f_schlick = base + (1.0f - base) * powf(one_minus, 5.0f);
  const float f_schlick_max = base + (1.0f - base) * SCHLICK_MAX_POW5;
  const float f_max = specular * f_schlick_max;
  const float nominator = cos_theta * powf(one_minus, 6.0f);
  return f_schlick -
         (nominator * SCHLICK_INV_DENOMINATOR) * (f_schlick_max - f_max);
}

// ---- core/spectrum.py ----------------------------------------------------

__device__ __forceinline__ float sample_parametric_spectrum(float b0, float b1,
                                                            float b2,
                                                            float lam) {
  const float x = (b0 * lam + b1) * lam + b2;
  return 0.5f + x / (2.0f * sqrtf(1.0f + x * x));
}

}  // namespace pt
