// The BSDF samples of the three basic models, one thread a lane: the
// cosine lobe of basic_diffuse, the GGX visible-normal reflection of
// basic_metal and the rough dispersive dielectric of basic_translucent
// (models/basic_*.py's sample_bsdf; basic_diffuse.glsl.inc:37-50,
// basic_metal.glsl.inc:86-141, basic_translucent.glsl.inc:172-339).
//
// Replaces, on the card, what models/dispatch.py's `sample_bsdf_plain`
// does in plain PyTorch for these models: each model of the scene's type
// set over every lane, then a torch.where a model and an output to select
// by type, some 570 elementwise launches a round in a scene with all three,
// each sending its (3, N) or (4, N) intermediate through device memory,
// for the few lanes of each type. It ports no Pallas kernel: the JAX
// package leaves the models to XLA.
//
// A lane computes only the lobe of its own material type, and only where
// its sample is used (the `where` mask: the surface events), so a warp of
// missed rays or volume events does no arithmetic. The work is small
// (about 120 bytes a sampling lane, a few hundred float operations for
// the translucent lobe's four half vectors), so the card's memory bounds
// it: loads and stores are in lane order, one (N,) row a component, and
// no intermediate goes to device memory. The kernel adapts lane by lane to
// the type and the mask it reads, with no variant to choose.
//
// The function is the plain version's, to the bit, in every output of
// every lane it samples: each step takes the float32 operations of the
// tensor code in its order (core.cuh; built with -fmad=false and without
// fast math), a branch the plain version computes and then drops with
// torch.where is not computed here, and a division by a Python scalar is a
// multiplication by its reciprocal, as PyTorch's CUDA kernel takes it. The
// translucent lobe's sums over a half vector's three components are
// torch.sum's: ((x + y) + z) + 0, which turns a -0 into +0.

#include <cuda_runtime.h>

#include "basic_sample.h"
#include "core.cuh"

namespace {

using namespace pt;

constexpr int BLOCK = 256;
constexpr int MATERIAL_TYPE_BASIC_DIFFUSE = 0;   // core/constants.py
constexpr int MATERIAL_TYPE_BASIC_METAL = 1;
constexpr int MATERIAL_TYPE_OPENPBR = 3;
constexpr int BINS = 3;                          // diffuse, metal, translucent
// 1 / PI of core/constants.py taken in double and rounded: the factor of
// basic_diffuse's `/ PI`.
constexpr float INV_PI = 0x1.45f306p-2f;

struct Sample {
  V3 scattered;
  S4 throughput, probability;
  bool valid;
};

__device__ __forceinline__ float load(const float* __restrict__ p, int64_t n,
                                      int64_t i, int row) {
  return p[row * n + i];
}

// torch.sum over a (3,) axis of a CUDA tensor: one thread sums the three in
// order into accumulators that start at 0, then adds the empty fourth.
__device__ __forceinline__ float sum3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + 0.0f;
}

// basic_diffuse.sample_bsdf and its evaluate_bsdf.
__device__ Sample diffuse_sample(const BasicSampleArgs& a, int64_t i,
                                 float u1, float u2) {
  const float z = 2.0f * u1 - 1.0f;
  const float r = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const float phi = TAU * u2;                     // 2.0 * PI * u2
  Sample s;
  s.scattered = safe_normalize({r * cosf(phi), r * sinf(phi), z + 1.0f});
  const float p = clamp_min(s.scattered.z, 0.0f) * INV_PI;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.probability.v[k] = p;
    s.throughput.v[k] = p * load(a.base_reflectance, a.n, i, k);
  }
  s.valid = true;
  return s;
}

// basic_metal.sample_bsdf.
__device__ Sample metal_sample(const BasicSampleArgs& a, int64_t i, V3 view,
                               float u1, float u2) {
  const Alpha alpha =
      ggx_roughness_alpha(a.roughness[i], a.roughness_anisotropy[i]);
  const bool rough = alpha.x * alpha.y > EPSILON;
  const V3 normal = ggx_visible_normal(view, alpha, u1, u2);
  const float cos_theta = clamp_max(dot(normal, view), 1.0f);
  const float twice = 2.0f * cos_theta;
  Sample s;
  s.scattered = {twice * normal.x - view.x, twice * normal.y - view.y,
                 twice * normal.z - view.z};
  s.valid = view.z > 0.0f && s.scattered.z > 0.0f;
  // The VNDF pdf on a rough surface, the Dirac coefficient 1 on a smooth.
  const float p = rough ? ggx_smith_g1(view, alpha) *
                              ggx_distribution(normal, alpha) /
                              (4.0f * clamp_min(view.z, 1e-8f))
                        : 1.0f;
  const float pg = p * ggx_smith_g1(s.scattered, alpha);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float f = schlick_fresnel_metal(
        load(a.base_reflectance, a.n, i, k),
        load(a.specular_reflectance, a.n, i, k), cos_theta);
    s.probability.v[k] = p;
    s.throughput.v[k] = pg * f;
  }
  return s;
}

// basic_translucent.sample_bsdf: the reflect or refract choice at the
// primary wavelength's Fresnel coefficient, then only the chosen branch.
__device__ Sample translucent_sample(const BasicSampleArgs& a, int64_t i,
                                     V3 view, float u1, float u2, float u3) {
  const int64_t n = a.n;
  // _params: the relative IOR a wavelength, and the roughness.
  const float base_ior = a.ior[i], abbe = a.abbe_number[i];
  const bool entering = view.z >= 0.0f;
  float eta[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float interior =
        cauchy_empirical_ior(base_ior, abbe, load(a.lam, n, i, k));
    const float exterior = load(a.exterior_ior, n, i, k);
    eta[k] = entering ? exterior / interior : interior / exterior;
  }
  const Alpha alpha =
      ggx_roughness_alpha(a.roughness[i], a.roughness_anisotropy[i]);
  const bool rough = alpha.x * alpha.y > EPSILON;
  const float eta0 = eta[0];

  const float sign_z = sign(view.z == 0.0f ? 1.0f : view.z);
  const V3 normal = ggx_visible_normal(scale(view, sign_z), alpha, u1, u2);
  const float cos_in = clamp(dot(normal, view), -1.0f, 1.0f);
  const float cos_refracted = cos_theta_refracted(eta0, cos_in);
  const float reflectance0 = fresnel_dielectric(eta0, cos_in, cos_refracted);
  const bool reflect = u3 < reflectance0;

  float gm = 0.0f, d = 0.0f;
  if (rough) {
    gm = ggx_smith_g1(view, alpha);
    d = ggx_distribution(normal, alpha);
  }
  Sample s;
  if (reflect) {
    const float twice = 2.0f * cos_in;
    s.scattered = {twice * normal.x - view.x, twice * normal.y - view.y,
                   twice * normal.z - view.z};
    s.valid = s.scattered.z * view.z > 0.0f;
    const float rough_factor =
        rough ? gm * d / (4.0f * clamp_min(fabsf(view.z), 1e-8f)) : 1.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float f = fresnel_dielectric(
          eta[k], cos_in, cos_theta_refracted(eta[k], cos_in));
      s.probability.v[k] = f * rough_factor;
    }
  } else {
    const float along = cos_refracted + eta0 * cos_in;
    s.scattered = {along * normal.x - eta0 * view.x,
                   along * normal.y - eta0 * view.y,
                   along * normal.z - eta0 * view.z};
    s.valid = s.scattered.z * view.z < 0.0f;
    if (rough) {
      // The primary wavelength keeps the sampled normal; the others take
      // the half vector of the same refraction at their own IOR.
      const float vz_safe = fabsf(view.z) < 1e-8f ? 1e-8f : view.z;
      const V3 out = s.scattered;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        V3 half = normal;
        float ci = cos_in, co = cos_refracted, dk = d;
        if (k > 0) {
          const V3 h = {out.x + view.x * eta[k], out.y + view.y * eta[k],
                        out.z + view.z * eta[k]};
          const float lsq = sum3(h, h);
          half = lsq < 1e-12f ? V3{0.0f, 0.0f, 1.0f}
                              : scale(h, 1.0f / sqrtf(lsq));
          ci = sum3(view, half);
          co = sum3(out, half);
          dk = ci * co < 0.0f ? ggx_distribution(half, alpha) : 0.0f;
        }
        const float f = fresnel_dielectric(eta[k], ci, co);
        const float denom = ci * eta[k] + co;
        const float j = fabsf(co) / (denom * denom);
        s.probability.v[k] =
            dk * (1.0f - f) * gm * j * fabsf(ci / vz_safe);
      }
    } else {
      // Smooth: the spectral collapse to the primary wavelength.
      s.probability = {{1.0f - reflectance0, 0.0f, 0.0f, 0.0f}};
    }
  }
  const float gs = ggx_smith_g1(s.scattered, alpha);
#pragma unroll
  for (int k = 0; k < 4; ++k) s.throughput.v[k] = s.probability.v[k] * gs;
  return s;
}

__device__ __forceinline__ void store(const BasicSampleArgs& a, int64_t i,
                                      const Sample& s) {
  const int64_t n = a.n;
  a.scattered[i] = s.scattered.x;
  a.scattered[n + i] = s.scattered.y;
  a.scattered[2 * n + i] = s.scattered.z;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a.throughput[k * n + i] = s.throughput.v[k];
    a.probability[k * n + i] = s.probability.v[k];
  }
  a.valid[i] = s.valid;
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK)
    basic_sample_kernel(const BasicSampleArgs a) {
  const int64_t n = a.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  int bin = -1;
  if (i < n) {
    const int type = a.type[i];
    const bool in_set =
        type >= 0 && type <= MATERIAL_TYPE_OPENPBR && ((a.models >> type) & 1);
    // An OpenPBR lane of a set with OpenPBR is the walk's.
    if (!(in_set && type == MATERIAL_TYPE_OPENPBR)) {
      if (a.where == nullptr || a.where[i]) {
        // A type outside the set takes the lowest model of the set, a
        // basic one: the wrapper launches only for a set that holds one.
        const int model = in_set ? type : __ffs(a.models) - 1;
        const float u1 = a.u1[i], u2 = a.u2[i];
        Sample s;
        if (model == MATERIAL_TYPE_BASIC_DIFFUSE) {
          s = diffuse_sample(a, i, u1, u2);
        } else {
          const V3 view = {a.view[i], a.view[n + i], a.view[2 * n + i]};
          s = model == MATERIAL_TYPE_BASIC_METAL
                  ? metal_sample(a, i, view, u1, u2)
                  : translucent_sample(a, i, view, u1, u2, a.u3[i]);
        }
        store(a, i, s);
        if (STATS) bin = model;
      } else if (!(a.models & BASIC_OPENPBR)) {
        // Not used: a sample that is not valid, as the walk writes.
        Sample s;
        s.scattered = {0.0f, 0.0f, 1.0f};
        s.throughput = fill4(0.0f);
        s.probability = fill4(0.0f);
        s.valid = false;
        store(a, i, s);
      }
    }
  }
  if (STATS) {
    // Summed over the block first: one global atomic a bin a block.
    __shared__ unsigned block_bins[BINS];
    if (threadIdx.x < BINS) block_bins[threadIdx.x] = 0;
    __syncthreads();
#pragma unroll
    for (int b = 0; b < BINS; ++b) {
      const unsigned count = __popc(__ballot_sync(0xffffffffu, bin == b));
      if ((threadIdx.x & 31) == 0 && count) atomicAdd(block_bins + b, count);
    }
    __syncthreads();
    if (threadIdx.x < BINS && block_bins[threadIdx.x])
      atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + threadIdx.x),
                (unsigned long long)block_bins[threadIdx.x]);
  }
}

}  // namespace

extern "C" void basic_sample_launch(const BasicSampleArgs* args,
                                    void* stream) {
  if (args->n <= 0) return;
  const unsigned grid = (unsigned)((args->n + BLOCK - 1) / BLOCK);
  auto* s = (cudaStream_t)stream;
  if (args->stats)
    basic_sample_kernel<true><<<grid, BLOCK, 0, s>>>(*args);
  else
    basic_sample_kernel<false><<<grid, BLOCK, 0, s>>>(*args);
}
