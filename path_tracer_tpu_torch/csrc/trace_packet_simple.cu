// Closest-hit traversal of the world-flattened BVH8 with geometry-only
// leaves (v5), one thread per ray: the first, simple kernel of the port,
// kept as the baseline that trace_packet.cu is measured against
// (ops/trace_packet.py launches it only for variant='simple').
//
// It computes the function of the TPU kernel
// path_tracer_tpu/ops/trace_packet.py::_kernel on the 128-lane tables as
// they are: a per-thread stack of STACK_DEPTH ints in local memory, every
// row read straight from global memory with 16-byte __ldg loads, the axis
// and the metas of the entered children fetched after the slab test, and
// every popped node's row fetched whatever t has become since the push.
// trace_packet.cu's header says what was measured to bind this kernel.

#include "traverse.cuh"

namespace {

using namespace traverse;

constexpr int STACK_DEPTH = 96;
constexpr int LEAF_ROWS = 2;  // bvh8.LEAF_MAX / 8 rows of a leaf at most

template <bool STATS>
__global__ void __launch_bounds__(128)
wide_trace5_simple_kernel(const float* __restrict__ nodes,
                   const float* __restrict__ tris,
                   const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ t_in, long long n, int leaf_fmt,
                   float* __restrict__ t_out, int* __restrict__ face_out,
                   float* __restrict__ fu_out, float* __restrict__ fv_out,
                   int* __restrict__ stats, int* __restrict__ warp_stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int* ws = STATS ? warp_stats + (i / 32) * WARP_STATS : nullptr;

  float o[3], d[3], inv[3], oinv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = origin[c * n + i];
    d[c] = direction[c * n + i];
    inv[c] = safe_inv(d[c]);
    oinv[c] = o[c] * inv[c];
  }

  float t = t_in[i];
  int face = -1;
  float fu = 0.0f, fv = 0.0f;
  int n_interior = 0, n_leaf = 0, n_rows = 0, max_sp = 1;
  int n_tris = 0;  // filled slots of the leaf rows tested

  int stack[STACK_DEPTH];
  int sp = 1;
  stack[0] = 0;  // root

  while (sp > 0) {
    if (STATS) {
      note_pass(ws, WS_LOOP);
      max_sp = max(max_sp, sp);
    }
    const int v = stack[--sp];
    if (v >= 0) {
      ++n_interior;
      if (STATS) {
        note_pass(ws, WS_INTERIOR);
        note_rows(ws, WS_INTERIOR_ROWS, v);
      }
      const float* row = nodes + (size_t)v * ROW;
      const unsigned hit = slab_hits(row, inv, oinv, t);
      if (hit) {
        // Children are sorted ascending along `axis`: a ray flying forward
        // pushes them last to first, so the near child pops first.
        const int axis = exact_int(__ldg(row + AXIS_LANE));
        const bool flip = (axis == 0 ? d[0] : axis == 1 ? d[1] : d[2]) >= 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int ch = flip ? 7 - k : k;
          if ((hit >> ch) & 1u) {
            // Empty slots (meta == 0) have inverted boxes that can pass
            // the symmetric slab test; they are never pushed.
            const int m = exact_int(__ldg(row + META_LANE + ch));
            if (m != 0 && sp < STACK_DEPTH) stack[sp++] = m;
          }
        }
      }
    } else {
      // Leaf: v = -(count * LEAF_ROW_LIMIT + first_row), 8 triangles a row.
      ++n_leaf;
      const int u = -v;
      const int count = u / LEAF_ROW_LIMIT;
      const int leaf_row = u % LEAF_ROW_LIMIT;
      if (STATS) {
        note_pass(ws, WS_LEAF);
        note_rows(ws, WS_LEAF_ROWS, leaf_row);
      }
      for (int rr = 0; rr < LEAF_ROWS; ++rr) {
        if (rr > 0 && count <= 8 * rr) break;
        ++n_rows;
        if (STATS) n_tris += min(8, count - 8 * rr);
        const float* row = tris + (size_t)(leaf_row + rr) * ROW;
#pragma unroll 2
        for (int k = 0; k < 8; ++k) {
          float ft, hu, hv;
          const bool ok = leaf_triangle(leaf_fmt, row + GEOM_STRIDE * k, o, d,
                                        t, count > 8 * rr + k, ft, hu, hv);
          if (ok) {
            t = ft;
            face = (leaf_row + rr) * 8 + k;
            fu = hu;
            fv = hv;
          }
        }
      }
    }
  }

  t_out[i] = t;
  face_out[i] = face;
  fu_out[i] = fu;
  fv_out[i] = fv;
  if (STATS) {
    stats[i] = n_interior;
    stats[n + i] = n_leaf;
    stats[2 * n + i] = n_rows;
    stats[3 * n + i] = n_tris;
    stats[4 * n + i] = max_sp;
    stats[5 * n + i] = 0;  // no pop is culled here
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// `stats` ((6, n) per-ray counters) and `warp_stats` ((ceil(n / 32),
// WARP_STATS), zeroed by the caller) are both given or both null.
extern "C" int wide_trace5_simple_launch(const float* nodes, const float* tris,
                                  const float* origin, const float* direction,
                                  const float* t_in, long long n, int leaf_fmt,
                                  float* t_out, int* face_out, float* fu_out,
                                  float* fv_out, int* stats, int* warp_stats,
                                  void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const long long grid = (n + block - 1) / block;
  auto kernel = stats != nullptr ? wide_trace5_simple_kernel<true>
                                 : wide_trace5_simple_kernel<false>;
  kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      nodes, tris, origin, direction, t_in, n, leaf_fmt, t_out, face_out,
      fu_out, fv_out, stats, warp_stats);
  return (int)cudaGetLastError();
}
