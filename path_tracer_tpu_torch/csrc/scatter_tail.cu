// Scatter's own code after the BSDF sample, one thread a lane: the sky's
// radiance on the lanes that hit it (the default spectrum, or the skybox's
// equirect lookup through the layout's atlas table and filters), the CIE
// observer and the sky's or the surface's emission into the sample, the
// surface branch (real-interface test, the integrand's weights, the
// active-shape list's insert and remove), Russian roulette, the new ray
// and the three-way merge of the volume, sky and surface branches with the
// ghost override of stochastic transparency (basic_scatter.glsl:165-310).
//
// Replaces, on the card, what integrator/scatter.py's `scatter_tail_plain`
// does in plain PyTorch: some 360-430 elementwise launches a round, the sky
// lookup and the observer's lobes over every lane among them, each sending
// its result through device memory. It ports no Pallas kernel: the JAX
// package leaves this layer to XLA.
//
// The layer moves a few hundred bytes a lane and does little arithmetic,
// so the card's memory bounds it; the kernel moves each byte once. Loads
// and stores are in lane order, one (N,) row a component, neighbouring
// threads on neighbouring words, and no intermediate goes to device memory.
// A lane reads what its branch needs: only a sky lane looks the sky up
// (its atlas texels through the read-only cache), only a lane that scatters
// off a surface reads the hit frame and the integrand, only a volume lane
// the volumetric branch. The hero wavelengths are recomputed from the
// primary one. So the kernel adapts to the traffic lane by lane, and to the
// layout by its flags, with no variant to choose.
//
// The function is the plain version's, to the bit, in every output of
// every lane and in the stepped random state: each step takes the float32
// operations of the tensor code in its order (core.cuh; built with
// -fmad=false and without fast math, so IEEE division, sqrtf, expf, atan2f
// and asinf), Python's scalars rounded from their doubles as PyTorch rounds
// them, and a value the plain version computes and then drops with
// torch.where is not computed here, which leaves the selected bits as they
// are.

#include <cuda_runtime.h>

#include "core.cuh"
#include "scatter_tail.h"

namespace {

using namespace pt;

constexpr int BLOCK = 256;
constexpr int ACTIVE_SHAPE_LIMIT = 4;             // core/constants.py
constexpr int32_t SHAPE_INDEX_NONE = 0x7FFFFFFF;
constexpr int MATERIAL_TYPE_OPENPBR = 3;
constexpr int TEXTURE_FLAG_FILTER_NEAREST = 1;
constexpr float HIT_TIME_LIMIT = 1048576.0f;
constexpr int BINS = 4;                           // sky, volume, surface, ghost

// A Python float as PyTorch rounds it to meet a float32 tensor.
#define F(x) static_cast<float>(x)

// PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
// taken in double and rounded (core.cuh).
constexpr float INV_TAU = F(1.0 / 6.283185306);
constexpr float INV_PI = F(1.0 / 3.141592653);

// core/spectrum.py's hero_wavelength_cluster: the primary normalised
// wavelength rotated by quarters with wrap-around (torch.remainder by 1),
// the first kept as it is, then mapped onto [360, 830] nm.
__device__ __forceinline__ void hero_cluster(float nl0, float (&lam)[4]) {
  const float offsets[4] = {0.0f, 0.25f, 0.5f, 0.75f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float nl = nl0;
    if (k > 0) {
      nl = fmodf(nl0 + offsets[k], 1.0f);
      if (nl != 0.0f && nl < 0.0f) nl += 1.0f;
    }
    lam[k] = F(830.0 - 360.0) * nl + F(360.0);
  }
}

// One lobe of sample_standard_observer's multi-lobe fit.
__device__ __forceinline__ float lobe(float lam, double scale, double center,
                                      double slope_lo, double slope_hi) {
  const float t = (lam - F(center)) * (lam < F(center) ? F(slope_lo)
                                                       : F(slope_hi));
  return F(scale) * expf(F(-0.5) * t * t);
}

// sample_standard_observer at the four wavelengths: o[c][k], c = x, y, z.
__device__ __forceinline__ void standard_observer(const float (&lam)[4],
                                                  float (&o)[3][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float l = lam[k];
    o[0][k] = (lobe(l, 0.362, 442.0, 0.0624, 0.0374) +
               lobe(l, 1.056, 599.8, 0.0264, 0.0323)) -
              lobe(l, 0.065, 501.1, 0.0490, 0.0382);
    o[1][k] = lobe(l, 0.821, 568.8, 0.0213, 0.0247) +
              lobe(l, 0.286, 530.9, 0.0613, 0.0322);
    o[2][k] = lobe(l, 1.217, 437.0, 0.0845, 0.0278) +
              lobe(l, 0.681, 459.0, 0.0385, 0.0725);
  }
}

// sample + _observe(observer, weighted) / cluster_pdf, for each of x, y, z.
__device__ __forceinline__ void add_observed(const float (&o)[3][4],
                                             const float (&w)[4], float pdf,
                                             float (&sample)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    sample[c] = sample[c] + (((o[c][0] * w[0] + o[c][1] * w[1]) +
                              o[c][2] * w[2]) + o[c][3] * w[3]) / pdf;
}

struct Texel {
  float v[4];
};

__device__ __forceinline__ Texel load4(const float* __restrict__ p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// models/common.py's _bilinear of one channel.
__device__ __forceinline__ float bilinear(float c00, float c10, float c01,
                                          float c11, float fx, float fy) {
  return (c00 * (1.0f - fx) + c10 * fx) * (1.0f - fy) +
         (c01 * (1.0f - fx) + c11 * fx) * fy;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// What a sky lookup reads of the launch's arguments, passed by value: the
// out-of-line call then takes no copy of the whole argument block.
struct SkyTables {
  const int32_t* skybox_texture_index;
  const float* texture_meta;
  const float* atlas;
  const float* atlas_quad;
  const uint16_t* atlas_pair;
  int atlas_size, atlas_mode, flags;
};

// sample_skybox_radiance's texture tap: models/common.py's sample_texture
// for the skybox's one texture at (u, v), through the layout's table and
// filters. Kept out of line: only sky lanes call it.
__device__ __noinline__ Texel sky_texel(const SkyTables a, float uu,
                                        float vv) {
  const float* meta = a.texture_meta + 8 * (int64_t)__ldg(a.skybox_texture_index);
  const float pmin0 = __ldg(meta + 0), pmin1 = __ldg(meta + 1);
  const float pmax0 = __ldg(meta + 2), pmax1 = __ldg(meta + 3);
  const int64_t layer = static_cast<int32_t>(__ldg(meta + 4));
  const int flags = static_cast<int32_t>(__ldg(meta + 5));
  const float fu = uu - floorf(uu);
  const float fv = vv - floorf(vv);
  const float u = pmin0 + (pmax0 - pmin0) * fu;
  const float v = pmin1 + (pmax1 - pmin1) * fv;
  const int size = a.atlas_size;
  const float x = u * static_cast<float>(size) - 0.5f;
  const float y = v * static_cast<float>(size) - 0.5f;
  const bool has_bilinear = a.flags & TAIL_BILINEAR;
  const bool has_nearest = a.flags & TAIL_NEAREST;
  const bool use_nearest =
      has_nearest &&
      (!has_bilinear || (flags & TEXTURE_FLAG_FILTER_NEAREST) != 0);
  Texel out;
  if (a.atlas_mode != ATLAS_FLAT) {
    const int x0 = static_cast<int>(floorf(x));
    const int y0 = static_cast<int>(floorf(y));
    const int x0c = clampi(x0, 0, size - 1);
    const int y0c = clampi(y0, 0, size - 1);
    const int64_t row = (layer * size + y0c) * size;
    Texel c00, c10, c01, c11;
    if (a.atlas_mode == ATLAS_PAIR) {
      const int x1c = clampi(x0 + 1, 0, size - 1);
      const uint4 pl =
          __ldg(reinterpret_cast<const uint4*>(a.atlas_pair + 8 * (row + x0c)));
      const uint4 pr =
          __ldg(reinterpret_cast<const uint4*>(a.atlas_pair + 8 * (row + x1c)));
      const uint32_t l[4] = {pl.x, pl.y, pl.z, pl.w};
      const uint32_t r[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        c00.v[2 * k] = bf16_to_float(l[k] & 0xffffu);
        c00.v[2 * k + 1] = bf16_to_float(l[k] >> 16);
        c01.v[2 * k] = bf16_to_float(l[k + 2] & 0xffffu);
        c01.v[2 * k + 1] = bf16_to_float(l[k + 2] >> 16);
        c10.v[2 * k] = bf16_to_float(r[k] & 0xffffu);
        c10.v[2 * k + 1] = bf16_to_float(r[k] >> 16);
        c11.v[2 * k] = bf16_to_float(r[k + 2] & 0xffffu);
        c11.v[2 * k + 1] = bf16_to_float(r[k + 2] >> 16);
      }
    } else {
      const float* q = a.atlas_quad + 16 * (row + x0c);
      c00 = load4(q);
      c10 = load4(q + 4);
      c01 = load4(q + 8);
      c11 = load4(q + 12);
    }
    if (use_nearest) {
      const int xn = clampi(static_cast<int>(rintf(x)), 0, size - 1);
      const int yn = clampi(static_cast<int>(rintf(y)), 0, size - 1);
      const bool sx = xn > x0c, sy = yn > y0c;
      out = sx && sy ? c11 : sx ? c10 : sy ? c01 : c00;
    } else {
      // A zero fraction where floor clips below 0.
      const float fx = x0 < 0 ? 0.0f : x - static_cast<float>(x0);
      const float fy = y0 < 0 ? 0.0f : y - static_cast<float>(y0);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out.v[k] = bilinear(c00.v[k], c10.v[k], c01.v[k], c11.v[k], fx, fy);
    }
  } else {
    auto fetch = [&](int px, int py) {
      px = clampi(px, 0, size - 1);
      py = clampi(py, 0, size - 1);
      return load4(a.atlas + 4 * ((layer * size + py) * size + px));
    };
    if (use_nearest) {
      out = fetch(static_cast<int>(rintf(x)), static_cast<int>(rintf(y)));
    } else {
      const int x0 = static_cast<int>(floorf(x));
      const int y0 = static_cast<int>(floorf(y));
      const float fx = x - static_cast<float>(x0);
      const float fy = y - static_cast<float>(y0);
      const Texel c00 = fetch(x0, y0), c10 = fetch(x0 + 1, y0);
      const Texel c01 = fetch(x0, y0 + 1), c11 = fetch(x0 + 1, y0 + 1);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out.v[k] = bilinear(c00.v[k], c10.v[k], c01.v[k], c11.v[k], fx, fy);
    }
  }
  return out;
}

// sample_skybox_radiance at the lane's four wavelengths.
__device__ __forceinline__ void sky_radiance(const ScatterTailArgs& a, V3 d,
                                             const float (&lam)[4],
                                             float (&radiance)[4]) {
  Texel s = {{a.default_sky[0], a.default_sky[1], a.default_sky[2],
              a.default_sky[3]}};
  if (a.flags & TAIL_SKY_TEXTURE) {
    const float phi = atan2f(d.y, d.x);
    const float theta = asinf(clamp(d.z, -1.0f, 1.0f));
    const SkyTables tables = {a.skybox_texture_index, a.texture_meta, a.atlas,
                              a.atlas_quad, a.atlas_pair, a.atlas_size,
                              a.atlas_mode, a.flags};
    s = sky_texel(tables, 0.5f + phi * INV_TAU, 0.5f + theta * INV_PI);
  }
  const float brightness = __ldg(a.skybox_brightness);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    radiance[k] =
        s.v[3] * sample_parametric_spectrum(s.v[0], s.v[1], s.v[2], lam[k]) *
        brightness;
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK)
    scatter_tail_kernel(const ScatterTailArgs a) {
  const int64_t n = a.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  int bin = -1;
  if (i < n) {
    const bool medium = a.flags & TAIL_MEDIUM;
    const float time = a.time[i];
    const bool vol_scatter = medium && a.vol_scatter[i];
    const bool sky_hit = medium ? a.sky_hit[i] : time >= HIT_TIME_LIMIT;
    const bool surface_event = !(vol_scatter || sky_hit);
    const bool ghost = surface_event && (a.flags & TAIL_OPACITY) && a.ghost[i];
    const bool surface = surface_event && !ghost;

    float throughput[4], probability[4], sample[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      throughput[k] = a.throughput[k * n + i];
      probability[k] = a.probability[k * n + i];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) sample[c] = a.sample[c * n + i];
    const float ray_dir[3] = {a.direction[i], a.direction[n + i],
                              a.direction[2 * n + i]};
    const V3 d = {ray_dir[0], ray_dir[1], ray_dir[2]};

    int32_t slots[ACTIVE_SHAPE_LIMIT];
    const bool transmissive = a.flags & TAIL_TRANSMISSIVE;
    if (transmissive || (surface && !medium)) {
#pragma unroll
      for (int j = 0; j < ACTIVE_SHAPE_LIMIT; ++j)
        slots[j] = a.active_shapes[j * n + i];
    }

    uint32_t state = static_cast<uint32_t>(a.rng_state[i]);
    const float u_rr = uniform(state);
    a.rng_state_out[i] = state;
    const float term = a.termination_probability;

    float new_throughput[4], new_probability[4], new_origin[3], new_dir[3];
    bool alive;
    if (sky_hit || surface) {
      // The cluster's pdf and the observer feed the sky's sample and a
      // surface's emission.
      float lam[4], o[3][4];
      hero_cluster(a.lambda0[i], lam);
      const float cluster_pdf = clamp_min(
          ((probability[0] + probability[1]) + probability[2]) +
              probability[3],
          F(1e-20));
      if (sky_hit) {
        float radiance[4], w[4];
        sky_radiance(a, d, lam, radiance);
        standard_observer(lam, o);
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = radiance[k] * throughput[k];
        add_observed(o, w, cluster_pdf, sample);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          new_throughput[k] = throughput[k];
          new_probability[k] = 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          new_origin[c] = a.origin[c * n + i];
          new_dir[c] = ray_dir[c];
        }
        alive = false;
      } else {
        // The surface branch: tangent-space view, real-interface test.
        const V3 t = {a.tangent[i], a.tangent[n + i], a.tangent[2 * n + i]};
        const V3 b = {a.bitangent[i], a.bitangent[n + i],
                      a.bitangent[2 * n + i]};
        const V3 nn = {a.normal[i], a.normal[n + i], a.normal[2 * n + i]};
        const V3 view = {-dot(d, t), -dot(d, b), -dot(d, nn)};
        const bool hit_exterior = view.z > 0.0f;
        const int32_t shape = a.shape[i];
        int32_t priority;
        if (medium) {
          priority = a.priority[i];
        } else {
          priority = SHAPE_INDEX_NONE;
#pragma unroll
          for (int j = 0; j < ACTIVE_SHAPE_LIMIT; ++j)
            priority = min(priority, slots[j]);
        }
        const bool is_real =
            hit_exterior ? priority > shape : priority == shape;

        // Emission on real exterior hits (OpenPBR's; zero for the others).
        if (is_real && hit_exterior) {
          float w[4];
          const bool emits = (a.flags & TAIL_OPENPBR) &&
                             a.type[i] == MATERIAL_TYPE_OPENPBR;
          const float luminance = emits ? a.emission_luminance[i] : 0.0f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float e =
                emits ? a.emission_reflectance[k * n + i] * luminance : 0.0f;
            w[k] = e * throughput[k];
          }
          standard_observer(lam, o);
          add_observed(o, w, cluster_pdf, sample);
        }

        V3 in_dir;
        bool surf_valid = true;
        if (is_real) {
          float sp[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) sp[k] = a.s_probability[k * n + i];
          const float scale = 1.0f / clamp_min(
              nan_max(nan_max(nan_max(sp[0], sp[1]), sp[2]), sp[3]), EPSILON);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            new_throughput[k] =
                throughput[k] * a.s_throughput[k * n + i] * scale;
            new_probability[k] = probability[k] * sp[k] * scale;
          }
          in_dir = {a.scattered[i], a.scattered[n + i], a.scattered[2 * n + i]};
          surf_valid = a.s_valid[i];
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            new_throughput[k] = throughput[k];
            new_probability[k] = probability[k];
          }
          in_dir = neg(view);
        }

        // The active-shape list on a boundary crossing: insert into the
        // first free slot on entering, remove the first match on leaving.
        if (transmissive && in_dir.z * view.z < 0.0f) {
          if (hit_exterior) {
#pragma unroll
            for (int j = 0; j < ACTIVE_SHAPE_LIMIT; ++j)
              if (slots[j] == SHAPE_INDEX_NONE) {
                slots[j] = shape;
                break;
              }
          } else {
#pragma unroll
            for (int j = 0; j < ACTIVE_SHAPE_LIMIT; ++j)
              if (slots[j] == shape) {
                slots[j] = SHAPE_INDEX_NONE;
                break;
              }
          }
        }

        // Russian roulette, then the new ray off the surface.
        const float keep = 1.0f - term;
#pragma unroll
        for (int k = 0; k < 4; ++k) new_probability[k] = new_probability[k] * keep;
        const V3 dir = normalize(
            {(in_dir.x * t.x + in_dir.y * b.x) + in_dir.z * nn.x,
             (in_dir.x * t.y + in_dir.y * b.y) + in_dir.z * nn.y,
             (in_dir.x * t.z + in_dir.y * b.z) + in_dir.z * nn.z});
        const float eps = clamp_min(F(1e-4) * time, F(1e-3));
        const float dv[3] = {dir.x, dir.y, dir.z};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          new_origin[c] = a.position[c * n + i] + eps * dv[c];
          new_dir[c] = dv[c];
        }
        alive = surf_valid && u_rr >= term;
      }
    } else if (vol_scatter) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        new_throughput[k] = a.vol_throughput[k * n + i];
        new_probability[k] = a.vol_probability[k * n + i];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        new_origin[c] = a.vol_origin[c * n + i];
        new_dir[c] = a.vol_dir[c * n + i];
      }
      alive = true;
    } else {
      // A ghost: straight through the surface, the path's weights kept.
      const float eps = clamp_min(F(1e-4) * time, F(1e-3));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        new_throughput[k] = throughput[k];
        new_probability[k] = probability[k];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        new_dir[c] = ray_dir[c];
        new_origin[c] = a.position[c * n + i] + eps * new_dir[c];
      }
      alive = true;
    }
    alive = alive && nan_max(nan_max(nan_max(new_probability[0],
                                             new_probability[1]),
                                     new_probability[2]),
                             new_probability[3]) > EPSILON;

#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a.throughput_out[k * n + i] = new_throughput[k];
      a.probability_out[k * n + i] = new_probability[k];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.sample_out[c * n + i] = sample[c];
      a.origin_out[c * n + i] = new_origin[c];
      a.direction_out[c * n + i] = new_dir[c];
    }
    a.alive[i] = alive;
    if (transmissive) {
#pragma unroll
      for (int j = 0; j < ACTIVE_SHAPE_LIMIT; ++j)
        a.active_shapes_out[j * n + i] = slots[j];
    }
    if (STATS) bin = sky_hit ? 0 : vol_scatter ? 1 : surface ? 2 : 3;
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

extern "C" void scatter_tail_launch(const ScatterTailArgs* args,
                                    void* stream) {
  if (args->n <= 0) return;
  const unsigned grid = (unsigned)((args->n + BLOCK - 1) / BLOCK);
  auto* s = (cudaStream_t)stream;
  if (args->stats)
    scatter_tail_kernel<true><<<grid, BLOCK, 0, s>>>(*args);
  else
    scatter_tail_kernel<false><<<grid, BLOCK, 0, s>>>(*args);
}
