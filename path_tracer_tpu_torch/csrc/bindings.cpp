// Python bindings of the CUDA kernels in this directory: the one source
// of the extension that includes PyTorch's headers. Each kernel file
// exports a plain C launch function; the Python wrappers (ops/*.py,
// models/openpbr.py) check devices, dtypes and shapes before they call in
// here.

#include <c10/cuda/CUDAException.h>
#include <torch/extension.h>

#include <vector>

#include "basic_sample.h"
#include "hit_attributes.h"
#include "medium_event.h"
#include "openpbr_walk.h"
#include "scatter_tail.h"

extern "C" int inst_trace_launch(const float* nodes, const float* tris,
                                 const float* inst_rows, const float* origin,
                                 const float* direction, const float* t_in,
                                 long long n, int tlas_rows, int leaf_fmt,
                                 float* t_out, int* face_out, float* fu_out,
                                 float* fv_out, int* inst_out, int* stats,
                                 int* warp_stats, void* stream);
extern "C" int wide_trace5_launch(const float* nodes, const float* tris,
                                  const float* origin, const float* direction,
                                  const float* t_in, long long n, int leaf_fmt,
                                  float* t_out, int* face_out, float* fu_out,
                                  float* fv_out, int* stats, int* warp_stats,
                                  void* stream);
extern "C" int wide_trace_launch(const float* nodes, const float* tris,
                                 const float* origin, const float* direction,
                                 const float* t_in, long long n, float* t_out,
                                 int* face_out, float* normal_out,
                                 float* uv_out, int* shape_out, int* stats,
                                 int* warp_stats, void* stream);
extern "C" int shape_trace_launch(
    const float* nodes, const float* rows, const float* planes, int n_planes,
    const float* origin, const float* direction, const float* t_in,
    const int* shape_in, const int* type_in, const int* prim_in,
    const float* coords_in, const int* complexity_in, long long n,
    float* t_out, int* shape_out, int* type_out, int* prim_out,
    float* coords_out, int* complexity_out, long long* stats, void* stream);

namespace {

int* stats_ptr(torch::Tensor& stats) {
  return stats.numel() ? stats.data_ptr<int>() : nullptr;
}

// Queues csrc/trace_inst.cu on `stream` (a cudaStream_t as an integer).
// Empty `stats` and `warp_stats` tensors mean no counters. Returns the
// cudaError_t of the launch.
int inst_trace(const torch::Tensor& nodes, const torch::Tensor& tris,
               const torch::Tensor& inst_rows, const torch::Tensor& origin,
               const torch::Tensor& direction, const torch::Tensor& t_in,
               int64_t tlas_rows, int64_t leaf_fmt, torch::Tensor& t,
               torch::Tensor& face, torch::Tensor& fu, torch::Tensor& fv,
               torch::Tensor& inst, torch::Tensor& stats,
               torch::Tensor& warp_stats, int64_t stream) {
  return inst_trace_launch(
      nodes.data_ptr<float>(), tris.data_ptr<float>(),
      inst_rows.data_ptr<float>(), origin.data_ptr<float>(),
      direction.data_ptr<float>(), t_in.data_ptr<float>(), t_in.numel(),
      static_cast<int>(tlas_rows), static_cast<int>(leaf_fmt),
      t.data_ptr<float>(), face.data_ptr<int>(), fu.data_ptr<float>(),
      fv.data_ptr<float>(), inst.data_ptr<int>(), stats_ptr(stats),
      stats_ptr(warp_stats), reinterpret_cast<void*>(stream));
}

// Queues csrc/trace_packet.cu; arguments as inst_trace without the
// instance rows.
int wide_trace5(const torch::Tensor& nodes, const torch::Tensor& tris,
                const torch::Tensor& origin, const torch::Tensor& direction,
                const torch::Tensor& t_in, int64_t leaf_fmt, torch::Tensor& t,
                torch::Tensor& face, torch::Tensor& fu, torch::Tensor& fv,
                torch::Tensor& stats, torch::Tensor& warp_stats,
                int64_t stream) {
  return wide_trace5_launch(
      nodes.data_ptr<float>(), tris.data_ptr<float>(),
      origin.data_ptr<float>(), direction.data_ptr<float>(),
      t_in.data_ptr<float>(), t_in.numel(), static_cast<int>(leaf_fmt),
      t.data_ptr<float>(), face.data_ptr<int>(), fu.data_ptr<float>(),
      fv.data_ptr<float>(), stats_ptr(stats), stats_ptr(warp_stats),
      reinterpret_cast<void*>(stream));
}

// Queues csrc/trace_wide.cu; normal is (3, N), uv (2, N); counters as
// inst_trace.
int wide_trace(const torch::Tensor& nodes, const torch::Tensor& tris,
               const torch::Tensor& origin, const torch::Tensor& direction,
               const torch::Tensor& t_in, torch::Tensor& t,
               torch::Tensor& face, torch::Tensor& normal, torch::Tensor& uv,
               torch::Tensor& shape, torch::Tensor& stats,
               torch::Tensor& warp_stats, int64_t stream) {
  return wide_trace_launch(
      nodes.data_ptr<float>(), tris.data_ptr<float>(),
      origin.data_ptr<float>(), direction.data_ptr<float>(),
      t_in.data_ptr<float>(), t_in.numel(), t.data_ptr<float>(),
      face.data_ptr<int>(), normal.data_ptr<float>(), uv.data_ptr<float>(),
      shape.data_ptr<int>(), stats_ptr(stats), stats_ptr(warp_stats),
      reinterpret_cast<void*>(stream));
}

// Queues csrc/shape_trace.cu: the hit record's fields in (t_in, shape,
// shape type, primitive, coords (3, N), complexity) and out, `stats` empty
// or the kernel's two int64 counters. Returns the cudaError_t of the
// launch.
int shape_trace(const torch::Tensor& nodes, const torch::Tensor& rows,
                const torch::Tensor& planes, const torch::Tensor& origin,
                const torch::Tensor& direction, const torch::Tensor& t_in,
                const torch::Tensor& shape_in, const torch::Tensor& type_in,
                const torch::Tensor& prim_in, const torch::Tensor& coords_in,
                const torch::Tensor& complexity_in, torch::Tensor& t_out,
                torch::Tensor& shape_out, torch::Tensor& type_out,
                torch::Tensor& prim_out, torch::Tensor& coords_out,
                torch::Tensor& complexity_out, torch::Tensor& stats,
                int64_t stream) {
  return shape_trace_launch(
      nodes.data_ptr<float>(), rows.data_ptr<float>(),
      planes.data_ptr<float>(), static_cast<int>(planes.size(0)),
      origin.data_ptr<float>(), direction.data_ptr<float>(),
      t_in.data_ptr<float>(), shape_in.data_ptr<int>(),
      type_in.data_ptr<int>(), prim_in.data_ptr<int>(),
      coords_in.data_ptr<float>(), complexity_in.data_ptr<int>(),
      t_in.numel(), t_out.data_ptr<float>(), shape_out.data_ptr<int>(),
      type_out.data_ptr<int>(), prim_out.data_ptr<int>(),
      coords_out.data_ptr<float>(), complexity_out.data_ptr<int>(),
      stats.numel() ? reinterpret_cast<long long*>(stats.data_ptr<int64_t>())
                    : nullptr,
      reinterpret_cast<void*>(stream));
}

// Queues csrc/hit_attributes.cu in `mode` (HitAttributesMode): `in` and
// `out` hold the tensors of ops/hit_attributes.py's KERNEL_INPUTS and
// KERNEL_OUTPUTS in their order (the fields of HitAttributesArgs; a field
// the mode does not read or write is an empty tensor), `stats` empty or the
// kernel's five int64 counters. Raises if the launch was refused.
void hit_attributes(int64_t mode, const std::vector<torch::Tensor>& in,
                    const std::vector<torch::Tensor>& out, int64_t n_aux,
                    torch::Tensor& stats, int64_t stream) {
  TORCH_CHECK(in.size() == 20 && out.size() == 10,
              "hit_attributes takes 20 inputs and 10 outputs");
  HitAttributesArgs a;
  a.n = in[2].numel();
  a.n_shapes = in[9].numel();
  a.n_faces = in[10].numel() / 3;
  a.n_vertices = in[11].numel() / 3;
  a.n_aux = n_aux;
  a.origin = in[0].data_ptr<float>();
  a.direction = in[1].data_ptr<float>();
  a.time = in[2].data_ptr<float>();
  a.shape = in[3].data_ptr<int32_t>();
  a.shape_type = in[4].data_ptr<int32_t>();
  a.primitive = in[5].data_ptr<int32_t>();
  a.coords = in[6].data_ptr<float>();
  a.world_from_object = in[7].data_ptr<float>();
  a.object_from_world = in[8].data_ptr<float>();
  a.material = in[9].data_ptr<int32_t>();
  a.face_vertices = in[10].data_ptr<int32_t>();
  a.vertex_normals = in[11].data_ptr<float>();
  a.vertex_uvs = in[12].data_ptr<float>();
  a.t = in[13].data_ptr<float>();
  a.face = in[14].data_ptr<int32_t>();
  a.fu = in[15].data_ptr<float>();
  a.fv = in[16].data_ptr<float>();
  a.inst = in[17].data_ptr<int32_t>();
  a.attrs = in[18].data_ptr<float>();
  a.aux = in[19].data_ptr<float>();
  a.time_out = out[0].data_ptr<float>();
  a.shape_out = out[1].data_ptr<int32_t>();
  a.shape_type_out = out[2].data_ptr<int32_t>();
  a.primitive_out = out[3].data_ptr<int32_t>();
  a.material_out = out[4].data_ptr<int32_t>();
  a.position = out[5].data_ptr<float>();
  a.normal = out[6].data_ptr<float>();
  a.tangent = out[7].data_ptr<float>();
  a.bitangent = out[8].data_ptr<float>();
  a.uv = out[9].data_ptr<float>();
  a.stats = stats.numel() ? stats.data_ptr<int64_t>() : nullptr;
  hit_attributes_launch(&a, static_cast<int>(mode),
                        reinterpret_cast<void*>(stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Queues csrc/openpbr_walk.cu: `in` and `out` hold the tensors of
// models/openpbr.py's KERNEL_INPUTS and KERNEL_OUTPUTS in their order (the
// fields of OpenpbrWalkArgs), `where` is empty or the (N,) bool mask of the
// lanes whose sample is used, `stats` empty or the kernel's two int64
// counters. Raises if the launch was refused.
void openpbr_walk(const std::vector<torch::Tensor>& in,
                  const std::vector<torch::Tensor>& out,
                  const torch::Tensor& where, torch::Tensor& stats,
                  int64_t stream) {
  TORCH_CHECK(in.size() == 25 && out.size() == 5,
              "openpbr_walk takes 25 inputs and 5 outputs");
  OpenpbrWalkArgs a;
  a.n = in[0].numel();
  a.type = in[0].data_ptr<int32_t>();
  a.lam = in[1].data_ptr<float>();
  a.exterior_ior = in[2].data_ptr<float>();
  a.base_weight = in[3].data_ptr<float>();
  a.base_reflectance = in[4].data_ptr<float>();
  a.base_metalness = in[5].data_ptr<float>();
  a.base_diffuse_roughness = in[6].data_ptr<float>();
  a.specular_weight = in[7].data_ptr<float>();
  a.specular_reflectance = in[8].data_ptr<float>();
  a.specular_ior = in[9].data_ptr<float>();
  a.roughness = in[10].data_ptr<float>();
  a.roughness_anisotropy = in[11].data_ptr<float>();
  a.transmission_weight = in[12].data_ptr<float>();
  a.transmission_dispersion_abbe = in[13].data_ptr<float>();
  a.coat_weight = in[14].data_ptr<float>();
  a.coat_spectrum = in[15].data_ptr<float>();
  a.coat_ior = in[16].data_ptr<float>();
  a.coat_roughness = in[17].data_ptr<float>();
  a.coat_roughness_anisotropy = in[18].data_ptr<float>();
  a.layer_bounce_limit = in[19].data_ptr<int32_t>();
  a.view = in[20].data_ptr<float>();
  a.u1 = in[21].data_ptr<float>();
  a.u2 = in[22].data_ptr<float>();
  a.u3 = in[23].data_ptr<float>();
  a.rng_state = in[24].data_ptr<int64_t>();
  a.where = where.numel() ? where.data_ptr<bool>() : nullptr;
  a.in_dir = out[0].data_ptr<float>();
  a.throughput = out[1].data_ptr<float>();
  a.density = out[2].data_ptr<float>();
  a.valid = out[3].data_ptr<bool>();
  a.rng_state_out = out[4].data_ptr<int64_t>();
  a.stats = stats.numel() ? stats.data_ptr<int64_t>() : nullptr;
  openpbr_walk_launch(&a, reinterpret_cast<void*>(stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Queues csrc/medium_event.cu: `in` and `out` hold the tensors of
// ops/medium_event.py's KERNEL_INPUTS and KERNEL_OUTPUTS in their order
// (the fields of MediumEventArgs), `models` the MediumEventModels bits of
// the scene's type set, `stats` empty or the kernel's three int64
// counters. Raises if the launch was refused.
void medium_event(const std::vector<torch::Tensor>& in,
                  const std::vector<torch::Tensor>& out, int64_t models,
                  torch::Tensor& stats, int64_t stream) {
  TORCH_CHECK(in.size() == 23 && out.size() == 11,
              "medium_event takes 23 inputs and 11 outputs");
  MediumEventArgs a;
  a.n = in[4].numel();
  a.n_shapes = in[10].numel();
  a.n_materials = in[12].numel();
  a.models = static_cast<int>(models);
  a.active_shapes = in[0].data_ptr<int32_t>();
  a.lam = in[1].data_ptr<float>();
  a.throughput = in[2].data_ptr<float>();
  a.probability = in[3].data_ptr<float>();
  a.time = in[4].data_ptr<float>();
  a.shape = in[5].data_ptr<int32_t>();
  a.normal = in[6].data_ptr<float>();
  a.origin = in[7].data_ptr<float>();
  a.direction = in[8].data_ptr<float>();
  a.rng_state = in[9].data_ptr<int64_t>();
  a.shape_material = in[10].data_ptr<int32_t>();
  a.scatter_rate = in[11].data_ptr<float>();
  a.type = in[12].data_ptr<int32_t>();
  a.ior = in[13].data_ptr<float>();
  a.abbe_number = in[14].data_ptr<float>();
  a.transmission_spectrum = in[15].data_ptr<float>();
  a.transmission_depth = in[16].data_ptr<float>();
  a.scattering_spectrum = in[17].data_ptr<float>();
  a.scattering_anisotropy = in[18].data_ptr<float>();
  a.specular_ior = in[19].data_ptr<float>();
  a.transmission_dispersion_abbe = in[20].data_ptr<float>();
  a.transmission_scatter_spectrum = in[21].data_ptr<float>();
  a.transmission_scatter_anisotropy = in[22].data_ptr<float>();
  a.priority = out[0].data_ptr<int32_t>();
  a.throughput_out = out[1].data_ptr<float>();
  a.medium_event = out[2].data_ptr<bool>();
  a.vol_scatter = out[3].data_ptr<bool>();
  a.sky_hit = out[4].data_ptr<bool>();
  a.vol_origin = out[5].data_ptr<float>();
  a.vol_dir = out[6].data_ptr<float>();
  a.vol_throughput = out[7].data_ptr<float>();
  a.vol_probability = out[8].data_ptr<float>();
  a.exterior_ior = out[9].data_ptr<float>();
  a.rng_state_out = out[10].data_ptr<int64_t>();
  a.stats = stats.numel() ? stats.data_ptr<int64_t>() : nullptr;
  medium_event_launch(&a, reinterpret_cast<void*>(stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Queues csrc/basic_sample.cu: `in` holds the tensors of
// ops/basic_sample.py's KERNEL_INPUTS in their order (the fields of
// BasicSampleArgs; a column no model of the set reads is an empty tensor),
// `out` those of KERNEL_OUTPUTS, `where` is empty or the (N,) bool mask of
// the lanes whose sample is used, `models` the BasicSampleModels bits of the
// scene's type set, `stats` empty or the kernel's three int64 counters.
// Raises if the launch was refused.
void basic_sample(const std::vector<torch::Tensor>& in,
                  const std::vector<torch::Tensor>& out,
                  const torch::Tensor& where, int64_t models,
                  torch::Tensor& stats, int64_t stream) {
  TORCH_CHECK(in.size() == 13 && out.size() == 4,
              "basic_sample takes 13 inputs and 4 outputs");
  auto column = [](const torch::Tensor& t) {
    return t.numel() ? t.data_ptr<float>() : nullptr;
  };
  BasicSampleArgs a;
  a.n = in[0].numel();
  a.models = static_cast<int>(models);
  a.type = in[0].data_ptr<int32_t>();
  a.where = where.numel() ? where.data_ptr<bool>() : nullptr;
  a.view = in[1].data_ptr<float>();
  a.u1 = in[2].data_ptr<float>();
  a.u2 = in[3].data_ptr<float>();
  a.u3 = in[4].data_ptr<float>();
  a.lam = column(in[5]);
  a.exterior_ior = column(in[6]);
  a.base_reflectance = column(in[7]);
  a.specular_reflectance = column(in[8]);
  a.roughness = column(in[9]);
  a.roughness_anisotropy = column(in[10]);
  a.ior = column(in[11]);
  a.abbe_number = column(in[12]);
  a.scattered = out[0].data_ptr<float>();
  a.throughput = out[1].data_ptr<float>();
  a.probability = out[2].data_ptr<float>();
  a.valid = out[3].data_ptr<bool>();
  a.stats = stats.numel() ? stats.data_ptr<int64_t>() : nullptr;
  basic_sample_launch(&a, reinterpret_cast<void*>(stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Queues csrc/scatter_tail.cu: `in` holds the tensors of
// ops/scatter_tail.py's LANE_INPUTS and TABLES in their order (the fields of
// ScatterTailArgs; one the layout's flags do not read is an empty tensor),
// `out` those of KERNEL_OUTPUTS (active_shapes empty without
// TAIL_TRANSMISSIVE), `flags` the ScatterTailFlags bits, `atlas_mode` and
// `atlas_size` the sky's table and layer edge, `default_sky` the four
// numbers of the sky's spectrum without a texture, `stats` empty or the
// kernel's four int64 counters. Raises if the launch was refused.
void scatter_tail(const std::vector<torch::Tensor>& in,
                  const std::vector<torch::Tensor>& out, int64_t flags,
                  int64_t atlas_mode, int64_t atlas_size,
                  double termination_probability,
                  const std::vector<double>& default_sky,
                  torch::Tensor& stats, int64_t stream) {
  TORCH_CHECK(in.size() == 35 && out.size() == 8 && default_sky.size() == 4,
              "scatter_tail takes 35 inputs, 8 outputs and 4 sky numbers");
  auto ptr = [](const torch::Tensor& t) {
    return t.numel() ? t.data_ptr() : nullptr;
  };
  auto f32 = [&](int k) { return static_cast<const float*>(ptr(in[k])); };
  auto i32 = [&](int k) { return static_cast<const int32_t*>(ptr(in[k])); };
  auto b8 = [&](int k) { return static_cast<const bool*>(ptr(in[k])); };
  ScatterTailArgs a;
  a.n = in[0].numel();
  a.flags = static_cast<int>(flags);
  a.atlas_mode = static_cast<int>(atlas_mode);
  a.atlas_size = static_cast<int>(atlas_size);
  a.termination_probability = static_cast<float>(termination_probability);
  for (int k = 0; k < 4; ++k)
    a.default_sky[k] = static_cast<float>(default_sky[k]);
  a.lambda0 = f32(0);
  a.throughput = f32(1);
  a.probability = f32(2);
  a.sample = f32(3);
  a.active_shapes = i32(4);
  a.origin = f32(5);
  a.direction = f32(6);
  a.rng_state = static_cast<const int64_t*>(ptr(in[7]));
  a.time = f32(8);
  a.shape = i32(9);
  a.position = f32(10);
  a.normal = f32(11);
  a.tangent = f32(12);
  a.bitangent = f32(13);
  a.scattered = f32(14);
  a.s_throughput = f32(15);
  a.s_probability = f32(16);
  a.s_valid = b8(17);
  a.priority = i32(18);
  a.vol_scatter = b8(19);
  a.sky_hit = b8(20);
  a.vol_origin = f32(21);
  a.vol_dir = f32(22);
  a.vol_throughput = f32(23);
  a.vol_probability = f32(24);
  a.ghost = b8(25);
  a.type = i32(26);
  a.emission_reflectance = f32(27);
  a.emission_luminance = f32(28);
  a.skybox_brightness = f32(29);
  a.skybox_texture_index = i32(30);
  a.texture_meta = f32(31);
  a.atlas = f32(32);
  a.atlas_quad = f32(33);
  a.atlas_pair = static_cast<const uint16_t*>(ptr(in[34]));
  a.throughput_out = out[0].data_ptr<float>();
  a.probability_out = out[1].data_ptr<float>();
  a.sample_out = out[2].data_ptr<float>();
  a.active_shapes_out =
      out[3].numel() ? out[3].data_ptr<int32_t>() : nullptr;
  a.origin_out = out[4].data_ptr<float>();
  a.direction_out = out[5].data_ptr<float>();
  a.alive = out[6].data_ptr<bool>();
  a.rng_state_out = out[7].data_ptr<int64_t>();
  a.stats = stats.numel() ? stats.data_ptr<int64_t>() : nullptr;
  scatter_tail_launch(&a, reinterpret_cast<void*>(stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("inst_trace", &inst_trace,
        "Instanced BVH8 closest-hit traversal (csrc/trace_inst.cu)");
  m.def("wide_trace5", &wide_trace5,
        "Flat BVH8 traversal, geometry-only leaves (csrc/trace_packet.cu)");
  m.def("wide_trace", &wide_trace,
        "Flat BVH8 traversal, attributes in the leaves (csrc/trace_wide.cu)");
  m.def("shape_trace", &shape_trace,
        "Closest analytic-shape hit over a shape BVH (csrc/shape_trace.cu)");
  m.def("hit_attributes", &hit_attributes,
        "The resolved hit record, one thread a lane (csrc/hit_attributes.cu)");
  m.def("medium_event", &medium_event,
        "The medium event of a scatter round, one thread a lane "
        "(csrc/medium_event.cu)");
  m.def("basic_sample", &basic_sample,
        "The basic models' BSDF samples, one thread a lane "
        "(csrc/basic_sample.cu)");
  m.def("scatter_tail", &scatter_tail,
        "Scatter's own code after the BSDF sample, one thread a lane "
        "(csrc/scatter_tail.cu)");
  m.def("openpbr_walk", &openpbr_walk,
        "The OpenPBR BSDF sample, one thread a lane (csrc/openpbr_walk.cu)");
}
