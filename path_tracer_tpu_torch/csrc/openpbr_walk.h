// The launch interface of openpbr_walk.cu, shared with bindings.cpp. Every
// pointer is to a contiguous tensor of N lanes on the launch's device:
// (N,) unless noted, spectra (4, N), vectors (3, N), channels first; the
// fields follow models/openpbr.py's KERNEL_INPUTS and KERNEL_OUTPUTS.

#pragma once

#include <cstdint>

struct OpenpbrWalkArgs {
  int64_t n;
  // The material context (models/common.py::fetch_ctx).
  const int32_t* type;
  const float* lam;                       // (4, N) nm
  const float* exterior_ior;              // (4, N)
  const float* base_weight;
  const float* base_reflectance;          // (4, N)
  const float* base_metalness;
  const float* base_diffuse_roughness;
  const float* specular_weight;
  const float* specular_reflectance;      // (4, N)
  const float* specular_ior;
  const float* roughness;
  const float* roughness_anisotropy;
  const float* transmission_weight;
  const float* transmission_dispersion_abbe;
  const float* coat_weight;
  const float* coat_spectrum;             // (3, N) spectrum coefficients
  const float* coat_ior;
  const float* coat_roughness;
  const float* coat_roughness_anisotropy;
  const int32_t* layer_bounce_limit;
  // The sample's own inputs.
  const float* view;                      // (3, N)
  const float* u1;
  const float* u2;
  const float* u3;
  const int64_t* rng_state;               // uint32 values
  // Null, or the lanes whose sample is used: a lane outside it does not
  // walk, whatever its type.
  const bool* where;
  // Outputs.
  float* in_dir;                          // (3, N)
  float* throughput;                      // (4, N)
  float* density;                         // (4, N)
  bool* valid;
  int64_t* rng_state_out;
  // Null, or 2 counters the kernel adds to: lanes walked, and warps with
  // at least one walking lane.
  int64_t* stats;
};

// Queues the walk on `stream` (a cudaStream_t). Reports nothing: the
// caller checks cudaGetLastError() right after.
extern "C" void openpbr_walk_launch(const OpenpbrWalkArgs* args, void* stream);
