// The launch interface of scatter_tail.cu, shared with bindings.cpp. Every
// lane pointer is to a contiguous tensor of N lanes on the launch's device:
// (N,) unless noted, spectra (4, N), vectors (3, N), channels first. A
// pointer the layout's flags do not read is null. The fields follow
// ops/scatter_tail.py's LANE_INPUTS, TABLES and KERNEL_OUTPUTS.

#pragma once

#include <cstdint>

// The layout's flags (ops/scatter_tail.py's layout_flags): what the scene
// holds, as SceneLayout states it, and the texture filters of its sky.
enum ScatterTailFlags : int {
  TAIL_MEDIUM = 1,          // scene_has_medium: the medium event's outputs
  TAIL_TRANSMISSIVE = 2,    // has_transmissive: the active-shape bookkeeping
  TAIL_OPACITY = 4,         // has_opacity: the ghost mask
  TAIL_SKY_TEXTURE = 8,     // has_skybox_texture: the equirect lookup
  TAIL_OPENPBR = 16,        // OpenPBR in the type set: surface emission
  TAIL_BILINEAR = 32,       // texture_filter_modes[0]
  TAIL_NEAREST = 64,        // texture_filter_modes[1]
};

// The atlas table a sky lookup reads (SceneLayout.atlas_quad_fit).
enum ScatterTailAtlas : int {
  ATLAS_FLAT = 0,           // four corner taps of the (L*A*A, 4) atlas
  ATLAS_QUAD = 1,           // one (L*A*A, 16) float32 2x2 row
  ATLAS_PAIR = 2,           // two (L*A*A, 8) bfloat16 [c(x,y) | c(x,y+1)] rows
};

struct ScatterTailArgs {
  int64_t n;
  int flags;                              // ScatterTailFlags bits
  int atlas_mode;                         // ScatterTailAtlas
  int atlas_size;                         // the atlas layer's edge A
  float termination_probability;
  float default_sky[4];                   // the sky's spectrum without a texture
  // The path state and the ray.
  const float* lambda0;                   // normalised primary wavelength
  const float* throughput;                // (4, N): the medium event's, or the state's
  const float* probability;               // (4, N)
  const float* sample;                    // (3, N)
  const int32_t* active_shapes;           // (ACTIVE_SHAPE_LIMIT, N)
  const float* origin;                    // (3, N)
  const float* direction;                 // (3, N)
  const int64_t* rng_state;               // uint32 values, after the sample
  // The hit record.
  const float* time;
  const int32_t* shape;
  const float* position;                  // (3, N)
  const float* normal;                    // (3, N)
  const float* tangent;                   // (3, N)
  const float* bitangent;                 // (3, N)
  // The surface integrand (tangent space).
  const float* scattered;                 // (3, N)
  const float* s_throughput;              // (4, N)
  const float* s_probability;             // (4, N)
  const bool* s_valid;
  // TAIL_MEDIUM: the medium event's outputs.
  const int32_t* priority;
  const bool* vol_scatter;
  const bool* sky_hit;
  const float* vol_origin;                // (3, N)
  const float* vol_dir;                   // (3, N)
  const float* vol_throughput;            // (4, N)
  const float* vol_probability;           // (4, N)
  // TAIL_OPACITY: the lanes that pass through their surface.
  const bool* ghost;
  // TAIL_OPENPBR: the material's type and emission (fetch_ctx's columns).
  const int32_t* type;
  const float* emission_reflectance;      // (4, N)
  const float* emission_luminance;
  // The sky: brightness (), and with TAIL_SKY_TEXTURE its texture's index
  // (), the (T, 8) texture rows and the atlas table of `atlas_mode`.
  const float* skybox_brightness;
  const int32_t* skybox_texture_index;
  const float* texture_meta;
  const float* atlas;                     // (L*A*A, 4)
  const float* atlas_quad;                // (L*A*A, 16)
  const uint16_t* atlas_pair;             // (L*A*A, 8) bfloat16 bits
  // Outputs.
  float* throughput_out;                  // (4, N)
  float* probability_out;                 // (4, N)
  float* sample_out;                      // (3, N)
  int32_t* active_shapes_out;             // (ACTIVE_SHAPE_LIMIT, N); TAIL_TRANSMISSIVE
  float* origin_out;                      // (3, N)
  float* direction_out;                   // (3, N)
  bool* alive;
  int64_t* rng_state_out;                 // after the roulette draw
  // Null, or 4 counters the kernel adds to: lanes that hit the sky, that
  // scatter in a volume, that scatter off a surface, and that pass
  // through one (ghost).
  int64_t* stats;
};

// Queues the kernel on `stream` (a cudaStream_t). Reports nothing: the
// caller checks cudaGetLastError() right after.
extern "C" void scatter_tail_launch(const ScatterTailArgs* args, void* stream);
