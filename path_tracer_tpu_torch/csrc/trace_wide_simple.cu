// Closest-hit traversal of the world-flattened BVH8 with attributes in the
// leaf rows (v3), one thread per ray: the first kernel of the port for
// this function, kept as the baseline that trace_wide.cu is measured
// against (ops/trace_wide.py launches it only for variant='simple').
//
// It computes the function of the TPU kernel
// path_tracer_tpu/ops/trace_wide.py::_kernel on the 128-lane tables as
// they are. A leaf row holds four triangles at a 32-lane stride: p0 p1 p2,
// n0 n1 n2, uv0 uv1 uv2 and the shape index. The kernel forms the edges
// (e1 = p1 - p0), runs Moller-Trumbore with the count test on every slot
// and lerps the winner's normal and uv from the same row each time a slot
// wins, so out come t, face = (tri_row + r) * 4 + k, the unnormalized
// normal (3, N), uv (2, N) and the shape index. On a miss face is -1 and
// normal, uv and shape are 0. A per-thread stack of STACK_DEPTH ints in
// local memory, every row read straight from global memory with 16-byte
// __ldg loads, the axis and the metas of the entered children fetched
// after the slab test, and every popped node's row fetched whatever t has
// become since the push. trace_wide.cu's header says what was measured to
// bind this kernel.

#include "traverse.cuh"

namespace {

using namespace traverse;

constexpr int STACK_DEPTH = 96;
constexpr int TRI_STRIDE = 32;
constexpr int TRIS_PER_ROW = 4;
constexpr int LEAF_ROWS = 4;  // bvh8.LEAF_MAX / 4 rows of a leaf at most

template <bool STATS>
__global__ void __launch_bounds__(128)
wide_trace_simple_kernel(const float* __restrict__ nodes,
                         const float* __restrict__ tris,
                         const float* __restrict__ origin,
                         const float* __restrict__ direction,
                         const float* __restrict__ t_in, long long n,
                         float* __restrict__ t_out, int* __restrict__ face_out,
                         float* __restrict__ normal_out,
                         float* __restrict__ uv_out,
                         int* __restrict__ shape_out, int* __restrict__ stats,
                         int* __restrict__ warp_stats) {
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
  int face = -1, shape = 0;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, tu = 0.0f, tv = 0.0f;
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
      // Leaf: v = -(count * LEAF_ROW_LIMIT + first_row), 4 triangles a row.
      ++n_leaf;
      const int u = -v;
      const int count = u / LEAF_ROW_LIMIT;
      const int tri_row = u % LEAF_ROW_LIMIT;
      if (STATS) {
        note_pass(ws, WS_LEAF);
        note_rows(ws, WS_LEAF_ROWS, tri_row);
      }
      for (int rr = 0; rr < LEAF_ROWS; ++rr) {
        if (rr > 0 && count <= TRIS_PER_ROW * rr) break;
        ++n_rows;
        n_tris += min(TRIS_PER_ROW, count - TRIS_PER_ROW * rr);
        const float* row = tris + (size_t)(tri_row + rr) * ROW;
#pragma unroll 2
        for (int k = 0; k < TRIS_PER_ROW; ++k) {
          const float* g = row + TRI_STRIDE * k;
          // p0 = g0.xyz, p1 = (g0.w, g1.xy), p2 = (g1.zw, g2.x).
          const float4 g0 = ld4(g), g1 = ld4(g + 4), g2 = ld4(g + 8);
          float ft, hu, hv;
          const bool ok = moller_trumbore(
              g0.x, g0.y, g0.z, g0.w - g0.x, g1.x - g0.y, g1.y - g0.z,
              g1.z - g0.x, g1.w - g0.y, g2.x - g0.z, o, d, t,
              count > TRIS_PER_ROW * rr + k, ft, hu, hv);
          if (ok) {
            // n0 = (g2.y, g2.z, g2.w), n1 = g3.xyz, n2 = (g3.w, g4.xy),
            // uv0 = g4.zw, uv1 = g5.xy, uv2 = g5.zw, shape = g6.x.
            const float4 g3 = ld4(g + 12), g4 = ld4(g + 16), g5 = ld4(g + 20);
            const float hw = 1.0f - hu - hv;
            t = ft;
            face = (tri_row + rr) * TRIS_PER_ROW + k;
            nx = hw * g2.y + hu * g3.x + hv * g3.w;
            ny = hw * g2.z + hu * g3.y + hv * g4.x;
            nz = hw * g2.w + hu * g3.z + hv * g4.y;
            tu = hw * g4.z + hu * g5.x + hv * g5.z;
            tv = hw * g4.w + hu * g5.y + hv * g5.w;
            shape = exact_int(__ldg(g + 24));
          }
        }
      }
    }
  }

  t_out[i] = t;
  face_out[i] = face;
  normal_out[i] = nx;
  normal_out[n + i] = ny;
  normal_out[2 * n + i] = nz;
  uv_out[i] = tu;
  uv_out[n + i] = tv;
  shape_out[i] = shape;
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
extern "C" int wide_trace_simple_launch(const float* nodes, const float* tris,
                                        const float* origin,
                                        const float* direction,
                                        const float* t_in, long long n,
                                        float* t_out, int* face_out,
                                        float* normal_out, float* uv_out,
                                        int* shape_out, int* stats,
                                        int* warp_stats, void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const long long grid = (n + block - 1) / block;
  auto kernel = stats != nullptr ? wide_trace_simple_kernel<true>
                                 : wide_trace_simple_kernel<false>;
  kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      nodes, tris, origin, direction, t_in, n, t_out, face_out, normal_out,
      uv_out, shape_out, stats, warp_stats);
  return (int)cudaGetLastError();
}
