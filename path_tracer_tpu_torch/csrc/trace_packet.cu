// Closest-hit traversal of the world-flattened BVH8 with geometry-only
// leaves (v5), one thread per ray.
//
// Replaces the TPU kernel path_tracer_tpu/ops/trace_packet.py::_kernel
// (called through wide_trace5 / _wide_trace5). It computes the same
// function on the same tables: node rows with eight child boxes, metas
// and the axis the children are sorted along, and leaf rows of eight
// triangles at a 16-lane stride in one of three geometry formats; out come
// t, face = (leaf_row + r) * 8 + k (-1 on a miss) and the barycentrics
// fu/fv. Normals, uvs and the shape index are gathered afterwards from the
// side table (ops/trace_packet.py::resolve_wide_attributes).
//
// What it does not copy: the TPU kernel walks 1024-ray packets, two
// interleaved per kernel instance, with one SMEM stack a packet, copies
// both tables into VMEM once, broadcasts every table lane across the
// packet, and pads the ray count to a packet group. Here each thread owns
// one ray of any N:
//   * a per-thread stack of STACK_DEPTH ints in local memory (pushes past
//     the depth are dropped, as on the TPU);
//   * node and leaf rows read straight from global memory through the
//     read-only path (16-byte __ldg loads); the flagship scene's tables are
//     a few MB and stay in the 50 MB L2;
//   * the push order of a node's children, which the TPU kernel flips by
//     the sign of the packet's summed direction along the node's axis,
//     follows the ray's own direction along that axis, and a child is
//     pushed only when this ray's own slab test enters it before its t.
// Ties on shared edges can therefore resolve differently from the packet
// kernel; the closest hit is the same.
//
// What bounds it on the H100: as for trace_inst.cu, not the compulsory
// bytes nor the slab and triangle flops but the rows each ray fetches
// through L1 and L2 (a node pop reads 192 B of boxes, the axis and the
// metas it pushes; a leaf row 8 x 48 B) and the divergence of a warp whose
// rays pop different rows. The caller sorts rays so that a warp's rays tend
// to pop the same rows; per-ray counters of interior pops, leaf pops and
// leaf rows give the rows, bytes and operations a run needed.

#include "traverse.cuh"

namespace {

using namespace traverse;

constexpr int STACK_DEPTH = 96;
constexpr int LEAF_ROWS = 2;  // bvh8.LEAF_MAX / 8 rows of a leaf at most

__global__ void __launch_bounds__(128)
wide_trace5_kernel(const float* __restrict__ nodes,
                   const float* __restrict__ tris,
                   const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ t_in, long long n, int leaf_fmt,
                   float* __restrict__ t_out, int* __restrict__ face_out,
                   float* __restrict__ fu_out, float* __restrict__ fv_out,
                   int* __restrict__ stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

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
  int n_interior = 0, n_leaf = 0, n_rows = 0;

  int stack[STACK_DEPTH];
  int sp = 1;
  stack[0] = 0;  // root

  while (sp > 0) {
    const int v = stack[--sp];
    if (v >= 0) {
      ++n_interior;
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
      for (int rr = 0; rr < LEAF_ROWS; ++rr) {
        if (rr > 0 && count <= 8 * rr) break;
        ++n_rows;
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
  if (stats != nullptr) {
    stats[i] = n_interior;
    stats[n + i] = n_leaf;
    stats[2 * n + i] = n_rows;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
extern "C" int wide_trace5_launch(const float* nodes, const float* tris,
                                  const float* origin, const float* direction,
                                  const float* t_in, long long n, int leaf_fmt,
                                  float* t_out, int* face_out, float* fu_out,
                                  float* fv_out, int* stats, void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const long long grid = (n + block - 1) / block;
  wide_trace5_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      nodes, tris, origin, direction, t_in, n, leaf_fmt, t_out, face_out,
      fu_out, fv_out, stats);
  return (int)cudaGetLastError();
}
