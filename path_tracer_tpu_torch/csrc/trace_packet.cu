// Closest-hit traversal of the world-flattened BVH8 with geometry-only
// leaves (v5), one thread per ray, designed for Hopper.
//
// Replaces the TPU kernel path_tracer_tpu/ops/trace_packet.py::_kernel
// (called through wide_trace5 / _wide_trace5). It computes the same
// function on the same tree: node rows with eight child boxes, metas and
// the axis the children are sorted along, and leaf rows of eight triangles
// in one of three geometry formats; out come t, face = (leaf_row + r) * 8 +
// k (-1 on a miss) and the barycentrics fu/fv. It reads the 128-lane rows
// of scene/bvh8.py as they are (traverse.cuh says why). Normals, uvs and
// the shape index are gathered afterwards from the side table
// (ops/trace_packet.py::resolve_wide_attributes).
//
// What it does not copy: the TPU kernel walks 1024-ray packets, two
// interleaved per kernel instance, with one SMEM stack a packet, copies
// both tables into VMEM once, broadcasts every table lane across the
// packet, and pads the ray count to a packet group. Here each thread owns
// one ray of any N; the push order of a node's children, which the TPU
// kernel flips by the sign of the packet's summed direction along the
// node's axis, follows the ray's own direction along that axis, and a child
// is pushed only when this ray's own slab test enters it before its t. Ties
// on shared edges can therefore resolve differently from the packet kernel;
// the closest hit is the same. A traversal has no matrix product, so the
// tensor cores have no part in it.
//
// What binds it on the H100 is what binds trace_inst.cu, whose header has
// the account (measured by the kernels' own counters; numbers in PERF.md):
// not the rows (a warp's active lanes fetch 1.4-2.6 distinct node rows in a
// pass, 3.7 at most on unsorted bounce rays; a launch after an L2 flush is
// no slower) and not the stack (12 entries at most), but instruction issue
// at low SIMT utilisation (interior body 65% of a warp's lanes, leaf body
// 32%, a quarter of the lanes waiting for the warp's longest ray) with too
// few warps an SM to hide a pop's dependent loads. The design: 56
// registers, 9 blocks an SM, no spill (MIN_BLOCKS); only the filled slots
// of a leaf row tested; the entry distance on the stack and a pop dropped
// without its row when that distance lies beyond t * CULL_SLACK (the plain
// version does the same); the triangle tests outside the loop that pops;
// one round trip to memory a pop. Taken out after measuring: tables packed
// for the card (1-3% faster), a stack in shared memory, two push loops (one
// for each direction along the axis), threads that take a next ray when
// theirs ends. On bounce rays in lane order it runs at about 7.5 times its
// bound.

#include "traverse.cuh"

namespace {

using namespace traverse;

constexpr int STACK_DEPTH = 96;
constexpr int BLOCK = 128;
constexpr int MIN_BLOCKS = 9;         // blocks an SM the registers must allow
constexpr bool CULL_POPS = true;      // drop a pop whose entry is beyond t
constexpr int LEAF_ROWS = 2;  // bvh8.LEAF_MAX / 8 rows of a leaf at most

// The counters of a stats launch need registers of their own: only the
// launches that are timed are held to MIN_BLOCKS.
template <int FMT, bool STATS>
__global__ void __launch_bounds__(BLOCK, STATS ? 1 : MIN_BLOCKS)
wide_trace5_kernel(const float* __restrict__ nodes,
                   const float* __restrict__ tris,
                   const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ t_in, long long n,
                   float* __restrict__ t_out, int* __restrict__ face_out,
                   float* __restrict__ fu_out, float* __restrict__ fv_out,
                   int* __restrict__ stats, int* __restrict__ warp_stats) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
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
  int n_interior = 0, n_leaf = 0, n_rows = 0, n_culled = 0, max_sp = 1;
  int n_tris = 0;

  int2 stack[STACK_DEPTH];
  int sp = 1;
  stack[0] = make_int2(0, __float_as_int(0.0f));  // root

  auto test_leaf = [&](int v) {
    // Leaf: v = -(count * LEAF_ROW_LIMIT + first_row), 8 triangles a row.
    // Only the `count` filled slots are tested: a padded slot cannot hit
    // in any format.
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
      const float* row = tris + (size_t)(leaf_row + rr) * ROW;
      const int filled = min(8, count - 8 * rr);
      if (STATS) n_tris += filled;
#pragma unroll 1
      for (int k = 0; k < filled; ++k) {
        float ft, hu, hv;
        const bool ok = leaf_triangle(FMT, row + GEOM_STRIDE * k, o, d, t,
                                      true, ft, hu, hv);
        if (ok) {
          t = ft;
          face = (leaf_row + rr) * 8 + k;
          fu = hu;
          fv = hv;
        }
      }
    }
  };

  // Two loops, not one with three bodies: the inner one pops until the ray
  // holds a leaf, the outer one tests that leaf. The triangle tests stay
  // out of the loop that runs five times as often.
  while (true) {
    int pending = 0;
    while (sp > 0) {
      if (STATS) {
        note_pass(ws, WS_LOOP);
        max_sp = max(max_sp, sp);
      }
      const int2 top = stack[--sp];
      const int v = top.x;
      if (CULL_POPS && !(__int_as_float(top.y) < t * CULL_SLACK)) {
        // A hit closer than this box was found since the push: nothing in
        // the box (nor in its children, whose boxes lie inside it) can win.
        if (STATS) {
          ++n_culled;
          note_pass(ws, WS_CULL);
        }
      } else if (v >= 0) {
        ++n_interior;
        if (STATS) {
          note_pass(ws, WS_INTERIOR);
          note_rows(ws, WS_INTERIOR_ROWS, v);
        }
        const float* row = nodes + (size_t)v * ROW;
        // The axis rides along with the boxes and metas: one round trip to
        // memory a pop.
        const int axis = exact_int(__ldg(row + AXIS_LANE));
        float entry[8];
        int meta[8];
        const unsigned hit = slab_entries(row, inv, oinv, t, entry, meta);
        if (hit) {
          // Children are sorted ascending along `axis`: a ray flying forward
          // pushes them last to first, so the near child pops first.
          const bool flip =
              (axis == 0 ? d[0] : axis == 1 ? d[1] : d[2]) >= 0.0f;
          // Child ch goes to the slot that the entered children pushed
          // before it leave free.
#pragma unroll
          for (int ch = 0; ch < 8; ++ch) {
            if ((hit >> ch) & 1u) {
              const unsigned before =
                  flip ? hit >> (ch + 1) : hit & ((1u << ch) - 1u);
              stack_put<STACK_DEPTH>(stack, sp + __popc(before), meta[ch],
                                     entry[ch]);
            }
          }
          sp = min(sp + __popc(hit), STACK_DEPTH);
        }
      } else {
        pending = v;
        break;
      }
    }
    if (pending == 0) break;
    test_leaf(pending);
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
    stats[5 * n + i] = n_culled;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// `stats` ((6, n) per-ray
// counters) and `warp_stats` ((ceil(n / 32), WARP_STATS), zeroed by the
// caller) are both given or both null.
extern "C" int wide_trace5_launch(const float* nodes, const float* tris,
                                  const float* origin, const float* direction,
                                  const float* t_in, long long n, int leaf_fmt,
                                  float* t_out, int* face_out, float* fu_out,
                                  float* fv_out, int* stats, int* warp_stats,
                                  void* stream) {
  if (n <= 0) return 0;
  const long long grid = (n + BLOCK - 1) / BLOCK;
  const bool st = stats != nullptr;
  auto kernel =
      leaf_fmt == LEAF_FMT_MT
          ? (st ? wide_trace5_kernel<0, true> : wide_trace5_kernel<0, false>)
      : leaf_fmt == LEAF_FMT_BARY
          ? (st ? wide_trace5_kernel<1, true> : wide_trace5_kernel<1, false>)
          : (st ? wide_trace5_kernel<2, true> : wide_trace5_kernel<2, false>);
  kernel<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(
      nodes, tris, origin, direction, t_in, n,
      t_out, face_out, fu_out, fv_out, stats, warp_stats);
  return (int)cudaGetLastError();
}
