// The launch interface of basic_sample.cu, shared with bindings.cpp. Every
// lane pointer is to a contiguous tensor of N lanes on the launch's device:
// (N,) unless noted, spectra (4, N), vectors (3, N), channels first. The
// fields follow ops/basic_sample.py's KERNEL_INPUTS and KERNEL_OUTPUTS.

#pragma once

#include <cstdint>

// The scene's material type set (SceneLayout.material_types), a bit a
// model: bit t is material type t (core/constants.py). A lane of a basic
// type in the set samples its own model; a lane of a type outside the set
// samples the lowest basic model in it (dispatch._select's rule); a lane of
// type OpenPBR, where OpenPBR is in the set, is the walk's and is not
// touched.
enum BasicSampleModels : int {
  BASIC_DIFFUSE = 1,
  BASIC_METAL = 2,
  BASIC_TRANSLUCENT = 4,
  BASIC_OPENPBR = 8,
};

struct BasicSampleArgs {
  int64_t n;
  int models;                             // BasicSampleModels bits
  const int32_t* type;
  // Null, or the lanes whose sample is used: a lane outside it samples
  // nothing.
  const bool* where;
  const float* view;                      // (3, N)
  const float* u1;
  const float* u2;
  const float* u3;
  // The material context (models/common.py::fetch_ctx); null where no
  // model of the set reads the column.
  const float* lam;                       // (4, N) nm; translucent
  const float* exterior_ior;              // (4, N); translucent
  const float* base_reflectance;          // (4, N); diffuse, metal
  const float* specular_reflectance;      // (4, N); metal
  const float* roughness;                 // metal, translucent
  const float* roughness_anisotropy;      // metal, translucent
  const float* ior;                       // translucent
  const float* abbe_number;               // translucent
  // Outputs. Without OpenPBR in the set every lane is written, a lane that
  // samples nothing with a sample that is not valid; with it, the walk's
  // outputs, which hold that sample on every lane the walk skipped, and
  // only the lanes that sample are written.
  float* scattered;                       // (3, N)
  float* throughput;                      // (4, N)
  float* probability;                     // (4, N)
  bool* valid;
  // Null, or 3 counters the kernel adds to: the lanes that sampled the
  // diffuse, the metal and the translucent model.
  int64_t* stats;
};

// Queues the kernel on `stream` (a cudaStream_t). Reports nothing: the
// caller checks cudaGetLastError() right after.
extern "C" void basic_sample_launch(const BasicSampleArgs* args, void* stream);
