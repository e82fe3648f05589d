// Python bindings of the CUDA kernels in this directory: the one source
// of the extension that includes PyTorch's headers. Each kernel file
// exports a plain C launch function; the Python wrappers (ops/*.py)
// check devices, dtypes and shapes before they call in here.

#include <torch/extension.h>

extern "C" int inst_trace_launch(const float* nodes, const float* tris,
                                 const float* inst_rows, const float* origin,
                                 const float* direction, const float* t_in,
                                 long long n, int tlas_rows, int leaf_fmt,
                                 float* t_out, int* face_out, float* fu_out,
                                 float* fv_out, int* inst_out, int* stats,
                                 void* stream);

namespace {

// Queues csrc/trace_inst.cu on `stream` (a cudaStream_t as an integer);
// an empty `stats` tensor means no per-ray counters. Returns the
// cudaError_t of the launch.
int inst_trace(const torch::Tensor& nodes, const torch::Tensor& tris,
               const torch::Tensor& inst_rows, const torch::Tensor& origin,
               const torch::Tensor& direction, const torch::Tensor& t_in,
               int64_t tlas_rows, int64_t leaf_fmt, torch::Tensor& t,
               torch::Tensor& face, torch::Tensor& fu, torch::Tensor& fv,
               torch::Tensor& inst, torch::Tensor& stats, int64_t stream) {
  return inst_trace_launch(
      nodes.data_ptr<float>(), tris.data_ptr<float>(),
      inst_rows.data_ptr<float>(), origin.data_ptr<float>(),
      direction.data_ptr<float>(), t_in.data_ptr<float>(), t_in.numel(),
      static_cast<int>(tlas_rows), static_cast<int>(leaf_fmt),
      t.data_ptr<float>(), face.data_ptr<int>(), fu.data_ptr<float>(),
      fv.data_ptr<float>(), inst.data_ptr<int>(),
      stats.numel() ? stats.data_ptr<int>() : nullptr,
      reinterpret_cast<void*>(stream));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("inst_trace", &inst_trace,
        "Instanced BVH8 closest-hit traversal (csrc/trace_inst.cu)");
}
