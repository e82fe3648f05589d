// The launch interface of hit_attributes.cu, shared with bindings.cpp. Every
// lane pointer is to a contiguous tensor of N lanes on the launch's device:
// (N,) unless noted, vectors (3, N) and uvs (2, N), channels first; the
// fields follow ops/hit_attributes.py's KERNEL_INPUTS and KERNEL_OUTPUTS.

#pragma once

#include <cstdint>

// Where a mesh hit's attributes come from: the layout's packet mode.
enum HitAttributesMode : int {
  // No winners: a mesh hit is the portable traversal's, and its attributes
  // are the vertex tables' lerp by the barycentrics in `coords` (a layout
  // without instance slots has no mesh hit).
  HIT_ATTRIBUTES_NONE = 0,
  // 'inst': winners (t, face, fu, fv, inst), object-space attribute rows
  // and the instances' aux rows.
  HIT_ATTRIBUTES_INST = 1,
  // 'flat': winners (t, face, fu, fv) and world-space attribute rows.
  HIT_ATTRIBUTES_FLAT = 2,
};

struct HitAttributesArgs {
  int64_t n;
  int64_t n_shapes;       // S of the (4, 4, S) matrix tables
  int64_t n_faces;        // F of face_vertices (3, F)
  int64_t n_vertices;     // V of vertex_normals (3, V) and vertex_uvs (2, V)
  int64_t n_aux;          // rows of aux; with 1, every winner takes row 0
  // The rays and the hit record of the analytic pass.
  const float* origin;                    // (3, N)
  const float* direction;                 // (3, N)
  const float* time;
  const int32_t* shape;
  const int32_t* shape_type;
  const int32_t* primitive;
  const float* coords;                    // (3, N)
  // Per shape.
  const float* world_from_object;         // (4, 4, S)
  const float* object_from_world;         // (4, 4, S)
  const int32_t* material;                // (S,)
  // HIT_ATTRIBUTES_NONE: the vertex tables.
  const int32_t* face_vertices;           // (3, F)
  const float* vertex_normals;            // (3, V)
  const float* vertex_uvs;                // (2, V)
  // HIT_ATTRIBUTES_INST and _FLAT: the mesh kernel's winners, in lane order,
  // and the (rows, 16) attribute rows [n0 n1 n2 | uv0 uv1 uv2 | shape].
  const float* t;
  const int32_t* face;
  const float* fu;
  const float* fv;
  const int32_t* inst;                    // _INST only
  const float* attrs;
  const float* aux;                       // _INST: (I, 16) [inverse 3x3 | shape]
  // Outputs. The merged record's first four fields are written only where
  // winners are merged (_INST, _FLAT); without, the hit record's stand.
  float* time_out;
  int32_t* shape_out;
  int32_t* shape_type_out;
  int32_t* primitive_out;
  int32_t* material_out;
  float* position;                        // (3, N)
  float* normal;                          // (3, N)
  float* tangent;                         // (3, N)
  float* bitangent;                       // (3, N)
  float* uv;                              // (2, N)
  // Null, or 5 counters the kernel adds to: lanes that missed, and lanes
  // whose hit is a mesh, a plane, a sphere, a cube.
  int64_t* stats;
};

// Queues the kernel of `mode` on `stream` (a cudaStream_t). Reports nothing:
// the caller checks cudaGetLastError() right after.
extern "C" void hit_attributes_launch(const HitAttributesArgs* args, int mode,
                                      void* stream);
