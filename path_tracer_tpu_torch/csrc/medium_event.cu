// The medium event of a scatter round, one thread a lane: the lane's
// innermost active shape and its medium, the absorbed throughput, the three
// draws, the free flight and its event masks, the volumetric branch (the
// Henyey-Greenstein direction, the new origin and the density-scaled
// throughput and probability) and the exterior IOR of the surface the ray
// hit (basic_scatter.glsl:123-164 and the medium lookups of :177-200).
//
// Replaces, on the card, what integrator/scatter.py's `medium_event_plain`
// does in plain PyTorch: the two `fetch_medium` gathers, each with both
// models' `load_medium` over every lane, then the free flight, the HG
// sample, `coordinate_frame` and the density normalisation, some 330
// elementwise launches a round with their draws, each sending its result
// through device memory. It ports no Pallas kernel: the JAX package leaves
// this layer to XLA.
//
// The layer moves a few hundred bytes a lane and does little arithmetic,
// so the card's memory bounds it; the kernel moves each byte once. Loads
// and stores are in lane order, one (N,) row a component, neighbouring
// threads on neighbouring words, and no intermediate goes to device memory.
// The material columns are small tables (a row a material slot) read
// through the read-only cache. A lane with no active shape is in the
// ambient medium (IOR 1, no absorption, the scene's scatter rate) and reads
// neither the tables nor its wavelengths; only a lane inside a shape
// gathers its material and evaluates the one model's medium it has. So the
// kernel adapts to the traffic lane by lane, with no variant to choose.
//
// The function is the plain version's, to the bit, in every output of
// every lane and in the stepped random state: each step takes the float32
// operations of the tensor code in its order (core.cuh; built with
// -fmad=false and without fast math, so IEEE division, sqrtf, expf, logf,
// cosf and sinf), and a branch the plain version computes and then drops
// with torch.where is not computed here, which leaves the selected bits as
// they are.

#include <cuda_runtime.h>

#include "core.cuh"
#include "medium_event.h"

namespace {

using namespace pt;

constexpr int BLOCK = 256;
constexpr int ACTIVE_SHAPE_LIMIT = 4;             // core/constants.py
constexpr int32_t SHAPE_INDEX_NONE = 0x7FFFFFFF;
constexpr int MATERIAL_TYPE_BASIC_TRANSLUCENT = 2;
constexpr int MATERIAL_TYPE_OPENPBR = 3;
constexpr float HIT_TIME_LIMIT = 1048576.0f;
constexpr int BINS = 3;                           // ambient, interior, volume

// A medium at the four hero wavelengths (dispatch.load_medium's fields).
struct Medium {
  S4 ior, absorption, scattering;
  float anisotropy;
};

// The ambient medium of fetch_medium's SHAPE_INDEX_NONE lanes.
__device__ __forceinline__ Medium ambient(float scatter_rate) {
  return {fill4(1.0f), fill4(0.0f), fill4(scatter_rate), 0.0f};
}

__device__ __forceinline__ float spectrum_at(const float* __restrict__ beta,
                                             int64_t m, int64_t n_materials,
                                             float lam) {
  return sample_parametric_spectrum(__ldg(beta + m),
                                    __ldg(beta + n_materials + m),
                                    __ldg(beta + 2 * n_materials + m), lam);
}

// fetch_medium for a shape that is not SHAPE_INDEX_NONE: its material's
// model's load_medium (basic_translucent.py and openpbr.py differ only in
// the columns they read), or the defaults for a model without a medium or
// one outside the scene's type set.
__device__ Medium shape_medium(const MediumEventArgs& a, int32_t shape,
                               const float (&lam)[4]) {
  const int64_t m = __ldg(a.shape_material + shape);
  const int type = __ldg(a.type + m);
  const bool translucent = type == MATERIAL_TYPE_BASIC_TRANSLUCENT &&
                           (a.models & MEDIUM_TRANSLUCENT);
  const bool openpbr = type == MATERIAL_TYPE_OPENPBR &&
                       (a.models & MEDIUM_OPENPBR);
  Medium out = {fill4(1.0f), fill4(0.0f), fill4(0.0f), 0.0f};
  if (!translucent && !openpbr) return out;
  const float base_ior = __ldg((translucent ? a.ior : a.specular_ior) + m);
  const float abbe = __ldg(
      (translucent ? a.abbe_number : a.transmission_dispersion_abbe) + m);
  const float* scatter_beta =
      translucent ? a.scattering_spectrum : a.transmission_scatter_spectrum;
  const float depth = __ldg(a.transmission_depth + m);
  const bool has_depth = depth > 0.0f;
  const float safe_depth = has_depth ? depth : 1.0f;
  const int64_t nm = a.n_materials;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out.ior.v[k] = cauchy_empirical_ior(base_ior, abbe, lam[k]);
    if (!has_depth) continue;
    const float transmission =
        spectrum_at(a.transmission_spectrum, m, nm, lam[k]);
    const float extinction =
        -logf(clamp_min(transmission, 1e-9f)) / safe_depth;
    const float scattering =
        spectrum_at(scatter_beta, m, nm, lam[k]) / safe_depth;
    out.absorption.v[k] = clamp_min(extinction - scattering, 0.0f);
    out.scattering.v[k] = scattering;
  }
  if (has_depth)
    out.anisotropy = __ldg((translucent ? a.scattering_anisotropy
                                        : a.transmission_scatter_anisotropy) +
                           m);
  return out;
}

__device__ __forceinline__ void load_lam(const MediumEventArgs& a, int64_t i,
                                         float (&lam)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) lam[k] = a.lam[k * a.n + i];
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK)
    medium_event_kernel(const MediumEventArgs a) {
  const int64_t n = a.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  int bin = -1;
  if (i < n) {
    // The innermost shape (the smallest index) and the exterior one: the
    // smallest of the others, SHAPE_INDEX_NONE where there is none.
    int32_t slots[ACTIVE_SHAPE_LIMIT];
    int32_t active = SHAPE_INDEX_NONE;
#pragma unroll
    for (int j = 0; j < ACTIVE_SHAPE_LIMIT; ++j) {
      slots[j] = a.active_shapes[j * n + i];
      active = min(active, slots[j]);
    }
    int32_t exterior = SHAPE_INDEX_NONE;
#pragma unroll
    for (int j = 0; j < ACTIVE_SHAPE_LIMIT; ++j)
      if (slots[j] != active) exterior = min(exterior, slots[j]);

    const float scatter_rate = __ldg(a.scatter_rate);
    float lam[4];
    Medium medium;
    if (active == SHAPE_INDEX_NONE) {
      medium = ambient(scatter_rate);
    } else {
      load_lam(a, i, lam);
      medium = shape_medium(a, active, lam);
    }

    const float time = a.time[i];
    S4 throughput;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      throughput.v[k] =
          a.throughput[k * n + i] * expf(-medium.absorption.v[k] * time);

    uint32_t state = static_cast<uint32_t>(a.rng_state[i]);
    const float u_scatter = uniform(state);
    const float u1 = uniform(state);
    const float u2 = uniform(state);
    a.rng_state_out[i] = state;

    // The free flight at the primary wavelength.
    const float rate0 = medium.scattering.v[0];
    const float scattering_time =
        rate0 > 0.0f
            ? -logf(clamp_min(u_scatter, 1e-12f)) / clamp_min(rate0, 1e-12f)
            : HIT_TIME_LIMIT;
    const bool medium_event = time >= scattering_time;
    const bool vol_scatter = medium_event && scattering_time < HIT_TIME_LIMIT;
    a.medium_event[i] = medium_event;
    a.vol_scatter[i] = vol_scatter;
    a.sky_hit[i] = medium_event && !vol_scatter;

    // The volumetric branch, for every lane: the caller selects it.
    const V3 d = {a.direction[i], a.direction[n + i], a.direction[2 * n + i]};
    const V3 hg = sample_direction_hg(medium.anisotropy, u1, u2);
    V3 vx, vy;
    coordinate_frame(d, vx, vy);
    const V3 vol_dir = normalize({hg.x * vx.x + hg.y * vy.x + hg.z * d.x,
                                  hg.x * vx.y + hg.y * vy.y + hg.z * d.y,
                                  hg.x * vx.z + hg.y * vy.z + hg.z * d.z});
    const float dv[3] = {d.x, d.y, d.z};
    const float dir_out[3] = {vol_dir.x, vol_dir.y, vol_dir.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.vol_origin[c * n + i] = a.origin[c * n + i] + dv[c] * scattering_time;
      a.vol_dir[c * n + i] = dir_out[c];
    }
    S4 density;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float s = medium.scattering.v[k];
      density.v[k] = s * expf(-s * scattering_time);
    }
    const float norm = clamp_min(max4(density), EPSILON);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float dk = density.v[k] / norm;
      a.throughput_out[k * n + i] = throughput.v[k];
      a.vol_throughput[k * n + i] = throughput.v[k] * dk;
      a.vol_probability[k * n + i] = a.probability[k * n + i] * dk;
    }

    // The exterior IOR: 1 off a real interface; the current medium's where
    // the ray enters the surface it hit, the exterior shape's where it
    // leaves it.
    const int32_t shape = a.shape[i];
    const V3 normal = {a.normal[i], a.normal[n + i], a.normal[2 * n + i]};
    const bool hit_exterior = -dot(d, normal) > 0.0f;
    const bool is_real = hit_exterior ? active > shape : active == shape;
    S4 exterior_ior = fill4(1.0f);
    if (is_real) {
      if (hit_exterior) {
        exterior_ior = medium.ior;
      } else if (exterior != SHAPE_INDEX_NONE) {
        // A lane with an exterior shape has an active one: `lam` is loaded.
        exterior_ior = shape_medium(a, exterior, lam).ior;
      }
    }
    a.priority[i] = active;
#pragma unroll
    for (int k = 0; k < 4; ++k) a.exterior_ior[k * n + i] = exterior_ior.v[k];
    if (STATS)
      bin = vol_scatter ? 2 : (active == SHAPE_INDEX_NONE ? 0 : 1);
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

extern "C" void medium_event_launch(const MediumEventArgs* args,
                                    void* stream) {
  if (args->n <= 0) return;
  const unsigned grid = (unsigned)((args->n + BLOCK - 1) / BLOCK);
  auto* s = (cudaStream_t)stream;
  if (args->stats)
    medium_event_kernel<true><<<grid, BLOCK, 0, s>>>(*args);
  else
    medium_event_kernel<false><<<grid, BLOCK, 0, s>>>(*args);
}
