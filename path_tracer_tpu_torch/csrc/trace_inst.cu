// Closest-hit traversal of the two-level instanced BVH8, one thread per ray,
// designed for Hopper.
//
// Replaces the TPU kernel path_tracer_tpu/ops/trace_inst.py::_kernel
// (called through inst_trace / _inst_trace). It computes the same function
// on the same tree: the nodes table [TLAS rows | rebased per-mesh BVH8
// rows], the object-space 8-triangle leaf rows and the per-instance rows;
// out come t, face = (leaf_row + r) * 8 + k, the barycentrics fu/fv and the
// winning instance (-1 and face -1 on a miss). It reads the 128-lane rows
// of scene/bvh8.py as they are (traverse.cuh says why).
//
// What it does not copy: the TPU kernel traverses 3072-ray packets with one
// SMEM stack per packet, keeps the tables VMEM-resident and picks the push
// order from the packet's summed direction signs. Here each thread walks
// its own ray, as the Vulkan reference does (scene.glsl.inc:336-399): the
// ray's own direction octant picks the far-first child order stamped in the
// node row, and a child is pushed only when this ray's own slab test enters
// it before its current t. Ties on shared edges can therefore resolve
// differently from the packet kernel; the closest hit is the same. A
// traversal has no matrix product, so the tensor cores have no part in it.
//
// What binds it on the H100, as the kernels measured themselves
// (kernel_anatomy of chip_smoke.py, A/B builds of this source's variants;
// 2,073,600 viking hall rays, NVIDIA H100 80GB HBM3, 700 W; PERF.md has
// the numbers): not the rows. A warp's active lanes fetch 1.3-2.4 distinct
// node rows in one pass of the interior body even on unsorted bounce rays
// (3.4 at most),
// the tables (a few MB) stay in L1 and L2, a launch after the L2 was
// flushed takes no longer, and rows without the padding were no faster
// than two runs differ. Nor the stack: no ray goes
// deeper than 14 entries and 99.5% stay within 8. What binds it is
// instruction issue at low SIMT utilisation with too few warps to hide the
// chain of dependent loads of a pop: the interior body runs with 70% of a
// warp's lanes, the leaf body with 33% (22% on unsorted rays), a warp
// keeps 20-30% of its lanes waiting for its longest ray, the leaf body
// alone is 30-40% of the time, and the time fell by a fifth when 28
// instead of 16-20 warps fitted an SM and stopped falling at 32.
// The design answers that, in the order of what each step gave:
//   * registers before everything: one ray in registers, not the world
//     and the object ray (the world ray is read again from global memory
//     at the rare TLAS pops and instance entries), and MIN_BLOCKS holds the
//     timed instantiations to 72 registers, 7 blocks an SM, without a spill;
//   * only the filled slots of a leaf row are tested (a leaf of the hall
//     holds 7 triangles on average, a row has room for 8, a second row is
//     mostly padding);
//   * a stack entry carries the distance at which the ray enters the box,
//     and a pop whose entry lies beyond the ray's t by more than the slab
//     test's rounding (CULL_SLACK) is dropped without its row (0.9-1.2 pops a ray): the plain version does the
//     same, so the two still agree to the bit;
//   * the triangle tests stand outside the loop that pops (two loops, the
//     leaf loop not unrolled);
//   * boxes and metas of a pop are fetched together (not each meta when
//     its child is pushed), the push order of the ray's octant
//     after the slab test, only where a child is entered; the order is
//     inverted into ranks, and each entered child goes to the stack slot
//     its rank gives.
// Measured and taken out again: tables packed for the card (6-8% faster
// with the ranks precomputed, under the 9% by which two runs differ, and a
// second copy of every table), the first 16 (or 8) stack entries in shared
// memory (5% slower: the stack is shallow and shared memory is carved out
// of the L1 that holds the rows), pushing by a loop over the order with
// the children in a local array (8% slower), 64 or 256 threads a block (no
// gain), and threads that take the next ray of their block's share when
// theirs ends (1.3 to 6 times slower: refilled lanes are out of phase with
// their warp, and the SIMT utilisation of every body falls). At about 8
// times its bound (the float32 operations of the counted pops and
// triangles at full SIMT width) on bounce rays in lane order it is still
// bound by the same thing: utilisation.
//
// Integers stored in float32 lanes of the instance rows (the mesh root)
// are exact below 2^24 and are converted with an exact float -> int
// conversion, never by reinterpreting the bits.

#include "traverse.cuh"

namespace {

using namespace traverse;

constexpr int STACK_DEPTH = 128;
constexpr int BLOCK = 128;
constexpr int MIN_BLOCKS = 7;         // blocks an SM the registers must allow
constexpr bool CULL_POPS = true;      // drop a pop whose entry is beyond t
constexpr int INST_BASE = 1 << 22;
constexpr int LEAF_ROWS = 2;  // bvh8.LEAF_MAX / 8 rows of a leaf at most

struct Ray {
  float o[3], d[3], inv[3], oinv[3];
};

__device__ __forceinline__ void finish_ray(Ray& r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.inv[c] = safe_inv(r.d[c]);
    r.oinv[c] = r.o[c] * r.inv[c];
  }
}

// Octant of the ray's direction, bit set <=> component negative: which of
// a node row's eight push orders (lanes PERM_LANE..) the ray takes.
__device__ __forceinline__ int octant(const Ray& r) {
  return ((r.d[0] < 0.0f) << 2) | ((r.d[1] < 0.0f) << 1) | (r.d[2] < 0.0f);
}

// The counters of a stats launch need registers of their own: only the
// launches that are timed are held to MIN_BLOCKS.
template <int FMT, bool STATS>
__global__ void __launch_bounds__(BLOCK, STATS ? 1 : MIN_BLOCKS)
inst_trace_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ tris,
                  const float* __restrict__ inst_rows,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_in, long long n, int tlas_rows,
                  float* __restrict__ t_out, int* __restrict__ face_out,
                  float* __restrict__ fu_out, float* __restrict__ fv_out,
                  int* __restrict__ inst_out, int* __restrict__ stats,
                  int* __restrict__ warp_stats) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  int* ws = STATS ? warp_stats + (i / 32) * WARP_STATS : nullptr;

  // One ray in registers: the world ray on TLAS rows, the object-space ray
  // of instance `cur` below them. The world ray is read again from global
  // memory when the walk comes back to a TLAS row or enters an instance:
  // a second copy in registers would cost an eighth of the occupancy.
  Ray r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.o[c] = origin[c * n + i];
    r.d[c] = direction[c * n + i];
  }
  finish_ray(r);
  bool in_world = true;

  float t = t_in[i];
  int face = -1, inst = -1, cur = 0;
  float fu = 0.0f, fv = 0.0f;
  int n_interior = 0, n_leaf = 0, n_rows = 0, n_enter = 0, n_culled = 0;
  int n_tris = 0;
  int max_sp = 1;

  int2 stack[STACK_DEPTH];
  int sp = 1;
  stack[0] = make_int2(0, __float_as_int(0.0f));  // TLAS root

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
        const bool ok = leaf_triangle(FMT, row + GEOM_STRIDE * k, r.o, r.d, t,
                                      true, ft, hu, hv);
        if (ok) {
          t = ft;
          face = (leaf_row + rr) * 8 + k;
          fu = hu;
          fv = hv;
          inst = cur;
        }
      }
    }
  };

  // Two loops, not one with four bodies: the inner one pops until the ray
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
      const float entered = __int_as_float(top.y);
      if (CULL_POPS && !(entered < t * CULL_SLACK)) {
        // A hit closer than this box was found since the push: nothing in
        // the box (nor in its children, whose boxes lie inside it) can win.
        if (STATS) {
          ++n_culled;
          note_pass(ws, WS_CULL);
        }
      } else if (v >= INST_BASE) {
        // Instance tag: move the world ray to object space without
        // renormalizing the direction, so t stays in world units across
        // instances, and the mesh root inherits the distance to the
        // instance's box.
        ++n_enter;
        if (STATS) note_pass(ws, WS_TAG);
        cur = v - INST_BASE;
        const float* row = inst_rows + (size_t)cur * ROW;
        const float4 a = ld4(row), b = ld4(row + 4), c = ld4(row + 8);
        const float root = __ldg(row + 12);
        float wo[3], wd[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          wo[k] = origin[k * n + i];
          wd[k] = direction[k * n + i];
        }
        r.o[0] = a.x * wo[0] + a.y * wo[1] + a.z * wo[2] + a.w;
        r.o[1] = b.x * wo[0] + b.y * wo[1] + b.z * wo[2] + b.w;
        r.o[2] = c.x * wo[0] + c.y * wo[1] + c.z * wo[2] + c.w;
        r.d[0] = a.x * wd[0] + a.y * wd[1] + a.z * wd[2];
        r.d[1] = b.x * wd[0] + b.y * wd[1] + b.z * wd[2];
        r.d[2] = c.x * wd[0] + c.y * wd[1] + c.z * wd[2];
        finish_ray(r);
        in_world = false;
        stack_put<STACK_DEPTH>(stack, sp, exact_int(root), entered);
        sp = min(sp + 1, STACK_DEPTH);
      } else if (v >= 0) {
        // Interior node: TLAS rows use the world ray, mesh rows the object
        // ray.
        ++n_interior;
        if (STATS) {
          note_pass(ws, WS_INTERIOR);
          note_rows(ws, WS_INTERIOR_ROWS, v);
        }
        if (v < tlas_rows && !in_world) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            r.o[c] = origin[c * n + i];
            r.d[c] = direction[c * n + i];
          }
          finish_ray(r);
          in_world = true;
        }
        const float* row = nodes + (size_t)v * ROW;
        float entry[8];
        int meta[8];
        const unsigned hit = slab_entries(row, r.inv, r.oinv, t, entry, meta);
        if (hit) {
          // Child ch goes to the stack slot its rank among the entered
          // children gives: the far-first order of the octant, without a
          // loop that indexes registers by a computed child.
          // The push order of this ray's octant, inverted into ranks. It is
          // fetched only now and the octant is not kept in a register: at
          // MIN_BLOCKS blocks an SM either of the two spills.
          const int ranks = ranks_from_order(
              exact_int(__ldg(row + PERM_LANE + octant(r))));
          unsigned ranked = 0;
#pragma unroll
          for (int ch = 0; ch < 8; ++ch)
            ranked |= ((hit >> ch) & 1u) << ((ranks >> (3 * ch)) & 7);
#pragma unroll
          for (int ch = 0; ch < 8; ++ch) {
            if ((hit >> ch) & 1u) {
              const int rank = (ranks >> (3 * ch)) & 7;
              stack_put<STACK_DEPTH>(
                  stack, sp + __popc(ranked & ((1u << rank) - 1u)), meta[ch],
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
  inst_out[i] = inst;
  if (STATS) {
    stats[i] = n_interior;
    stats[n + i] = n_leaf;
    stats[2 * n + i] = n_rows;
    stats[3 * n + i] = n_enter;
    stats[4 * n + i] = n_tris;
    stats[5 * n + i] = max_sp;
    stats[6 * n + i] = n_culled;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// `stats` ((7, n) per-ray
// counters) and `warp_stats` ((ceil(n / 32), WARP_STATS), zeroed by the
// caller) are both given or both null.
extern "C" int inst_trace_launch(const float* nodes, const float* tris,
                                 const float* inst_rows, const float* origin,
                                 const float* direction, const float* t_in,
                                 long long n, int tlas_rows, int leaf_fmt,
                                 float* t_out, int* face_out,
                                 float* fu_out, float* fv_out, int* inst_out,
                                 int* stats, int* warp_stats, void* stream) {
  if (n <= 0) return 0;
  const long long grid = (n + BLOCK - 1) / BLOCK;
  const bool st = stats != nullptr;
  auto kernel =
      leaf_fmt == LEAF_FMT_MT
          ? (st ? inst_trace_kernel<0, true> : inst_trace_kernel<0, false>)
      : leaf_fmt == LEAF_FMT_BARY
          ? (st ? inst_trace_kernel<1, true> : inst_trace_kernel<1, false>)
          : (st ? inst_trace_kernel<2, true> : inst_trace_kernel<2, false>);
  kernel<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(
      nodes, tris, inst_rows, origin, direction,
      t_in, n, tlas_rows, t_out, face_out, fu_out, fv_out, inst_out, stats,
      warp_stats);
  return (int)cudaGetLastError();
}
