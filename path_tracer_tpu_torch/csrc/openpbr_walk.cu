// The OpenPBR BSDF sample as one kernel, one thread a lane:
// models/openpbr.py's `_compose_parameters` and the layer walk of
// `sample_bsdf` (openpbr.glsl.inc:66-158 and 463-515), up to
// MAX_LAYER_BOUNCES bounces.
//
// It replaces no Pallas kernel. The JAX package leaves the walk to XLA,
// which fuses it on the TPU; in PyTorch the same walk is some 5,300
// elementwise launches, each over every lane of the round, of which only
// the lanes whose material is OpenPBR keep the result (models/dispatch.py
// selects by type). The reference branches per GPU thread
// (scene.glsl.inc:687-764), and so does this kernel: each thread reads its
// lane's material type first, and the mask of lanes whose sample is used
// where the caller gives one (a ray that left the scene carries material
// slot 0, the fallback OpenPBR material, but has no surface to sample). A
// lane of another type or outside the mask steps its random stream past
// the walk's 24 draws, writes a sample that is not valid (zero throughput
// and density) and returns; an OpenPBR lane reads its material,
// composes its parameters and walks, computing at each bounce only the
// layer it is in, and draws all 24 uniforms whenever its walk ends, so
// that every lane's stream stays where the plain version leaves it.
//
// What bounds it: the bytes of every lane (its type, mask and RNG state
// read, the state and the four outputs written: 66 bytes a lane), and on the
// warps that hold an OpenPBR lane the walk's instructions, which the warp
// issues once for all its OpenPBR lanes together. The lanes stay in the
// order the round hands them over: gathering the OpenPBR lanes first would
// cost launches or a synchronise with the host, while the branch costs only
// the warps that hold one. Non-walking lanes touch their 66 bytes in
// coalesced rows; the walk is not unrolled, to keep its code and registers
// small.
//
// The arithmetic is the plain version's, in its order (core.cuh): float32
// throughout, the four hero wavelengths, the coat's absorption, the
// per-wavelength refraction densities and the specular-weight IOR remap.

#include <cuda_runtime.h>

#include "core.cuh"
#include "openpbr_walk.h"

namespace {

using namespace pt;

constexpr int MAX_LAYER_BOUNCES = 8;     // models/openpbr.py
constexpr int WALK_DRAWS = 3 * MAX_LAYER_BOUNCES;
constexpr int MATERIAL_TYPE_OPENPBR = 3;  // core/constants.py
constexpr int LAYER_EXTERNAL = -1;
constexpr int LAYER_COAT = 0;
constexpr int LAYER_BASE_SPECULAR = 1;
constexpr int LAYER_BASE_DIFFUSE = 2;
constexpr int THREADS = 128;

// _compose_parameters: the lane's stochastic layer composition and its
// spectral parameters.
struct Params {
  bool coat_present, base_is_metal, base_is_translucent;
  S4 base_reflectance;
  float base_diffuse_roughness;
  float coat_relative_ior;  // the primary wavelength's: all the coat reads
  S4 coat_transmittance;
  Alpha coat_alpha;
  float specular_weight;
  S4 specular_relative_ior;
  S4 specular_reflectance;
  Alpha spec_alpha;
};

// One layer's sample: the direction, the factors of throughput and
// density, and whether the walk dies.
struct Step {
  V3 in;
  S4 thr, den;
  bool dead;
};

__device__ __forceinline__ float at(const float* column, int row, int64_t n,
                                    int64_t i) {
  return column[row * n + i];
}

__device__ Params compose(const OpenpbrWalkArgs& a, int64_t i, float u_coat,
                          float u_metal, float u_trans) {
  const int64_t n = a.n;
  Params p;
  p.coat_present = u_coat < a.coat_weight[i];
  p.base_is_metal = u_metal < a.base_metalness[i];
  p.base_is_translucent =
      !p.base_is_metal && (u_trans < a.transmission_weight[i]);
  const float base_weight = a.base_weight[i];
  const float coat_ior = a.coat_ior[i];
  const float specular_ior = a.specular_ior[i];
  const float abbe = a.transmission_dispersion_abbe[i];
  const float c0 = at(a.coat_spectrum, 0, n, i);
  const float c1 = at(a.coat_spectrum, 1, n, i);
  const float c2 = at(a.coat_spectrum, 2, n, i);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lam = at(a.lam, j, n, i);
    const float exterior = at(a.exterior_ior, j, n, i);
    p.base_reflectance.v[j] = base_weight * at(a.base_reflectance, j, n, i);
    p.coat_transmittance.v[j] = sample_parametric_spectrum(c0, c1, c2, lam);
    const float ior = cauchy_empirical_ior(specular_ior, abbe, lam);
    p.specular_relative_ior.v[j] =
        p.coat_present ? coat_ior / ior : exterior / ior;
    p.specular_reflectance.v[j] = at(a.specular_reflectance, j, n, i);
  }
  p.coat_relative_ior = a.exterior_ior[i] / coat_ior;
  p.base_diffuse_roughness = a.base_diffuse_roughness[i];
  p.coat_alpha =
      ggx_roughness_alpha(a.coat_roughness[i], a.coat_roughness_anisotropy[i]);
  p.specular_weight = a.specular_weight[i];
  p.spec_alpha = ggx_roughness_alpha(a.roughness[i], a.roughness_anisotropy[i]);
  return p;
}

__device__ __forceinline__ V3 reflected(V3 normal, float cosine, V3 out) {
  const float k = 2.0f * cosine;
  return {k * normal.x - out.x, k * normal.y - out.y, k * normal.z - out.z};
}

__device__ __forceinline__ V3 refracted(V3 normal, float cosine,
                                        float refr_cos, float eta, V3 out) {
  const float k = eta * cosine + refr_cos;
  return {k * normal.x - eta * out.x, k * normal.y - eta * out.y,
          k * normal.z - eta * out.z};
}

// The GGX normal of a layer's sample, from the view on its own side.
__device__ __forceinline__ V3 layer_normal(V3 out, Alpha alpha, float u1,
                                           float u2) {
  const float sign_z = sign(out.z == 0.0f ? 1.0f : out.z);
  return ggx_visible_normal(scale(out, sign_z), alpha, u1, u2);
}

// The z of a direction kept 1e-6 away from 0, for the path length.
__device__ __forceinline__ float away_from_zero(float z) {
  return fabsf(z) < 1e-6f ? 1e-6f * sign(z + 1e-30f) : z;
}

// _coat_sample (openpbr.glsl.inc:194-283).
__device__ Step coat_sample(const Params& p, V3 out, float u1, float u2,
                            float u_choice) {
  if (!p.coat_present) return {neg(out), fill4(1.0f), fill4(1.0f), false};
  const V3 normal = layer_normal(out, p.coat_alpha, u1, u2);
  const float cosine = dot(normal, out);
  const float eta =
      out.z < 0.0f ? 1.0f / p.coat_relative_ior : p.coat_relative_ior;
  const float refr_cos = cos_theta_refracted(eta, cosine);
  const float reflectance = fresnel_dielectric(eta, cosine, refr_cos);
  const bool reflect = u_choice < reflectance;
  Step s;
  if (reflect) {
    s.in = reflected(normal, cosine, out);
    s.dead = s.in.z * out.z <= 0.0f;
  } else {
    s.in = refracted(normal, cosine, refr_cos, eta, out);
    s.dead = s.in.z * out.z > 0.0f;
  }
  // Absorption by the path length inside the coat (openpbr.glsl.inc:246-281).
  const float g1 = ggx_smith_g1(s.in, p.coat_alpha);
  const float oz = away_from_zero(out.z);
  const float iz = away_from_zero(s.in.z);
  float exponent;
  if (reflect)
    exponent = out.z < 0.0f ? -(0.5f / oz + 0.5f / iz) : 0.0f;
  else
    exponent = out.z < 0.0f ? -0.5f / oz : -0.5f / iz;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    s.thr.v[j] =
        g1 * powf(clamp_min(p.coat_transmittance.v[j], 1e-9f), exponent);
  s.den = fill4(1.0f);
  return s;
}

// The dielectric base's refraction: the primary wavelength's Fresnel for
// every wavelength, and on a rough base each secondary wavelength's density
// from its own half vector (models/openpbr.py says why).
__device__ void refraction_weights(const Params& p, V3 normal, V3 out, V3 in,
                                   const S4& rel, float reflectance,
                                   Step& s) {
  const float shadow = ggx_smith_g1(in, p.spec_alpha);
  if (!(p.spec_alpha.x * p.spec_alpha.y > EPSILON)) {
    s.thr = {{shadow, 0.0f, 0.0f, 0.0f}};
    s.den = {{1.0f, 0.0f, 0.0f, 0.0f}};
    return;
  }
  S4 dens;
  dens.v[0] = ggx_distribution(normal, p.spec_alpha);
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    V3 h = {in.x + out.x * rel.v[j], in.y + out.y * rel.v[j],
            in.z + out.z * rel.v[j]};
    const float lsq = h.x * h.x + h.y * h.y + h.z * h.z;
    if (lsq < 1e-12f) {
      h = {0.0f, 0.0f, 1.0f};
    } else {
      const float len = sqrtf(lsq);
      h = {h.x / len, h.y / len, h.z / len};
    }
    const float d = ggx_distribution(h, p.spec_alpha);
    dens.v[j] = dot(out, h) * dot(in, h) < 0.0f ? d : 0.0f;
  }
  const float peak = clamp_min(max4(dens), EPSILON);
  const float fres_t = 1.0f - reflectance;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float d = dens.v[j] / peak;
    s.thr.v[j] = d * fres_t * shadow;
    s.den.v[j] = d * fres_t;
  }
}

// _base_specular_sample (openpbr.glsl.inc:286-435).
__device__ Step base_specular_sample(const Params& p, V3 out, float u1,
                                     float u2, float u_choice) {
  const V3 normal = layer_normal(out, p.spec_alpha, u1, u2);
  const float cosine = dot(normal, out);
  Step s;
  s.den = fill4(1.0f);
  if (p.base_is_metal) {
    s.in = reflected(normal, cosine, out);
    s.dead = out.z * s.in.z <= 0.0f;
    const float shadow = ggx_smith_g1(out, p.spec_alpha);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s.thr.v[j] = p.specular_weight *
                   schlick_fresnel_metal(p.base_reflectance.v[j],
                                         p.specular_reflectance.v[j],
                                         fabsf(cosine)) *
                   shadow;
    return s;
  }
  // Specular-weight IOR remap (openpbr.glsl.inc:338-342).
  const float w = p.specular_weight;
  const float root_w = sqrtf(clamp(w, 0.0f, 1.0f));
  S4 rel;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float r0 = out.z < 0.0f ? 1.0f / p.specular_relative_ior.v[j]
                                  : p.specular_relative_ior.v[j];
    const float r = root_w * (1.0f - r0) / (1.0f + r0);
    rel.v[j] = w < 1.0f ? (1.0f - r) / (1.0f + r) : r0;
  }
  const float eta = rel.v[0];
  const float refr_cos = cos_theta_refracted(eta, cosine);
  const float reflectance = fresnel_dielectric(eta, cosine, refr_cos);
  if (u_choice < reflectance) {
    s.in = reflected(normal, cosine, out);
    s.dead = s.in.z * out.z <= 0.0f;
    const float shadow = ggx_smith_g1(s.in, p.spec_alpha);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s.thr.v[j] = (out.z > 0.0f ? p.specular_reflectance.v[j] : 1.0f) * shadow;
    return s;
  }
  s.in = refracted(normal, cosine, refr_cos, eta, out);
  s.dead = s.in.z * out.z > 0.0f;
  refraction_weights(p, normal, out, s.in, rel, reflectance, s);
  return s;
}

// _base_diffuse_sample (openpbr.glsl.inc:438-461): Oren-Nayar; a
// translucent base passes through.
__device__ Step base_diffuse_sample(const Params& p, V3 out, float u1,
                                    float u2) {
  if (p.base_is_translucent)
    return {neg(out), fill4(1.0f), fill4(1.0f), false};
  const float z = 2.0f * u1 - 1.0f;
  const float rr = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const float phi = TAU * u2;
  const V3 in = safe_normalize({rr * cosf(phi), rr * sinf(phi), z + 1.0f});
  const float s = dot(in, out) - in.z * out.z;
  const float t = s > 0.0f ? nan_max(in.z, out.z) : 1.0f;
  const float sigma_sq = p.base_diffuse_roughness * p.base_diffuse_roughness;
  const float a0 = 1.0f - 0.5f * sigma_sq / (sigma_sq + 0.33f);
  const float b = 0.45f * sigma_sq / (sigma_sq + 0.09f);
  const float bst = b * s / t;
  Step out_step;
  out_step.in = in;
  out_step.dead = false;
  out_step.den = fill4(1.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float br = p.base_reflectance.v[j];
    const float a = a0 + 0.17f * br * sigma_sq / (sigma_sq + 0.13f);
    out_step.thr.v[j] = br * (a + bst);
  }
  return out_step;
}

__global__ void __launch_bounds__(THREADS)
    openpbr_walk_kernel(const OpenpbrWalkArgs a) {
  const int64_t n = a.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const bool walks = i < n && a.type[i] == MATERIAL_TYPE_OPENPBR &&
                     (a.where == nullptr || a.where[i]);
  if (a.stats != nullptr) {
    const unsigned walking = __ballot_sync(0xffffffffu, walks);
    if ((threadIdx.x & 31) == 0 && walking != 0u) {
      auto* stats = reinterpret_cast<unsigned long long*>(a.stats);
      atomicAdd(stats, static_cast<unsigned long long>(__popc(walking)));
      atomicAdd(stats + 1, 1ull);
    }
  }
  if (i >= n) return;
  uint32_t state = static_cast<uint32_t>(a.rng_state[i]);
  if (!walks) {
    skip_draws(state, WALK_DRAWS);
    a.rng_state_out[i] = state;
    a.in_dir[i] = 0.0f;
    a.in_dir[n + i] = 0.0f;
    a.in_dir[2 * n + i] = 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a.throughput[j * n + i] = 0.0f;
      a.density[j * n + i] = 0.0f;
    }
    a.valid[i] = false;
    return;
  }

  const Params p = compose(a, i, a.u1[i], a.u2[i], a.u3[i]);
  const V3 view = {a.view[i], a.view[n + i], a.view[2 * n + i]};
  const int limit = a.layer_bounce_limit[i];
  int layer = (view.z > 0.0f && p.coat_present) ? LAYER_COAT
                                                : LAYER_BASE_SPECULAR;
  S4 throughput = fill4(1.0f), density = fill4(1.0f);
  V3 out = view, in = neg(view);
  bool dead = false;
#pragma unroll 1
  for (int bounce = 0; bounce < MAX_LAYER_BOUNCES; ++bounce) {
    const float b1 = uniform(state);
    const float b2 = uniform(state);
    const float b3 = uniform(state);
    if (layer == LAYER_EXTERNAL || bounce >= limit || dead) {
      // The walk has ended: the remaining bounces only draw.
      skip_draws(state, 3 * (MAX_LAYER_BOUNCES - 1 - bounce));
      break;
    }
    const Step s = layer == LAYER_COAT ? coat_sample(p, out, b1, b2, b3)
                   : layer == LAYER_BASE_SPECULAR
                       ? base_specular_sample(p, out, b1, b2, b3)
                       : base_diffuse_sample(p, out, b1, b2);
    in = s.in;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      throughput.v[j] = throughput.v[j] * s.thr.v[j];
      density.v[j] = density.v[j] * s.den.v[j];
    }
    dead = s.dead;
    const bool up = s.in.z >= 0.0f;
    layer = layer == LAYER_COAT ? (up ? LAYER_EXTERNAL : LAYER_BASE_SPECULAR)
            : layer == LAYER_BASE_SPECULAR
                ? (up ? LAYER_COAT : LAYER_BASE_DIFFUSE)
                : (up ? LAYER_BASE_SPECULAR : LAYER_EXTERNAL);
    out = neg(s.in);
  }

  a.rng_state_out[i] = state;
  a.in_dir[i] = in.x;
  a.in_dir[n + i] = in.y;
  a.in_dir[2 * n + i] = in.z;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a.throughput[j * n + i] = throughput.v[j];
    a.density[j * n + i] = density.v[j];
  }
  // A walk still inside the stack at the limit is terminated.
  a.valid[i] = !dead && max4(density) > EPSILON;
}

}  // namespace

extern "C" void openpbr_walk_launch(const OpenpbrWalkArgs* args,
                                    void* stream) {
  if (args->n == 0) return;
  const unsigned blocks =
      static_cast<unsigned>((args->n + THREADS - 1) / THREADS);
  openpbr_walk_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(*args);
}
