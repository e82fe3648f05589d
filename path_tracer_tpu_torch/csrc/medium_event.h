// The launch interface of medium_event.cu, shared with bindings.cpp. Every
// lane pointer is to a contiguous tensor of N lanes on the launch's device:
// (N,) unless noted, spectra (4, N), vectors (3, N), channels first; the
// tables are the scene's, indexed by shape (S) or material slot (M). The
// fields follow ops/medium_event.py's KERNEL_INPUTS and KERNEL_OUTPUTS.

#pragma once

#include <cstdint>

// Which models' media the scene's type set holds (models/common.py's
// presence rule): a lane inside a shape whose material is of a model not
// in the set gets the default medium, as dispatch.load_medium gives it.
enum MediumEventModels : int {
  MEDIUM_TRANSLUCENT = 1,
  MEDIUM_OPENPBR = 2,
};

struct MediumEventArgs {
  int64_t n;
  int64_t n_shapes;                       // S
  int64_t n_materials;                    // M
  int models;                             // MediumEventModels bits
  // The lanes: the path state, the wavelengths, the ray and its hit.
  const int32_t* active_shapes;           // (ACTIVE_SHAPE_LIMIT, N)
  const float* lam;                       // (4, N) nm
  const float* throughput;                // (4, N)
  const float* probability;               // (4, N)
  const float* time;
  const int32_t* shape;
  const float* normal;                    // (3, N)
  const float* origin;                    // (3, N)
  const float* direction;                 // (3, N)
  const int64_t* rng_state;               // uint32 values
  // The tables.
  const int32_t* shape_material;          // (S,)
  const float* scatter_rate;              // (): the ambient medium's
  const int32_t* type;                    // (M,)
  const float* ior;                       // translucent
  const float* abbe_number;
  const float* transmission_spectrum;     // (3, M), both models
  const float* transmission_depth;        // both models
  const float* scattering_spectrum;       // (3, M)
  const float* scattering_anisotropy;
  const float* specular_ior;              // OpenPBR
  const float* transmission_dispersion_abbe;
  const float* transmission_scatter_spectrum;  // (3, M)
  const float* transmission_scatter_anisotropy;
  // Outputs.
  int32_t* priority;                      // the innermost active shape
  float* throughput_out;                  // (4, N) after absorption
  bool* medium_event;
  bool* vol_scatter;
  bool* sky_hit;
  float* vol_origin;                      // (3, N)
  float* vol_dir;                         // (3, N)
  float* vol_throughput;                  // (4, N)
  float* vol_probability;                 // (4, N)
  float* exterior_ior;                    // (4, N)
  int64_t* rng_state_out;                 // after the three draws
  // Null, or 3 counters the kernel adds to: lanes with no active shape,
  // lanes inside a shape's medium, and lanes that scatter in a volume.
  int64_t* stats;
};

// Queues the kernel on `stream` (a cudaStream_t). Reports nothing: the
// caller checks cudaGetLastError() right after.
extern "C" void medium_event_launch(const MediumEventArgs* args, void* stream);
