// Closest-hit traversal of the world-flattened BVH8 with attributes in the
// leaf rows (v3), one thread per ray, designed for Hopper.
//
// Replaces the TPU kernel path_tracer_tpu/ops/trace_wide.py::_kernel
// (called through wide_trace). Same node rows as trace_packet.cu; a leaf
// row holds four triangles at a 32-lane stride: p0 p1 p2, n0 n1 n2,
// uv0 uv1 uv2 and the shape index. The kernel forms the edges
// (e1 = p1 - p0), runs Moller-Trumbore on the filled slots and lerps the
// winner's normal and uv from its row once the ray is done, so out come t,
// face = (tri_row + r) * 4 + k, the unnormalized normal (3, N), uv (2, N)
// and the shape index. On a miss face is -1 and normal, uv and shape are 0.
//
// What it does not copy: the 1024-ray packets, the K=1 contraction that
// spread a row over the packet's lanes, the tables resident in VMEM and
// the padding of the ray count. Each thread owns one ray, its stack in
// local memory, its rows read through the read-only path, its push order
// taken from its own direction along the node's axis (trace_packet.cu).
//
// What binds it on the H100 is what binds the other two kernels (the
// header of trace_packet.cu has the account, PERF.md the numbers):
// instruction issue at low SIMT utilisation, with the heaviest leaves of
// the three (ten triangles a ray in rows of four, 128 bytes a triangle):
// without its leaf body the first kernel takes 45-48% less time, and a
// leaf pass of it keeps 22-32% of a warp's lanes busy. The design is
// trace_packet.cu's: MIN_BLOCKS blocks an SM at 56 registers without a
// spill; only the filled slots of a leaf row tested; the entry distance on
// the stack and a pop dropped without its row when that distance is not
// before t any more (the plain version does the same); one round trip to
// memory a pop; the triangle tests outside the loop that pops; and the
// winner's (face, hu, hv) kept in registers, its attributes read and
// lerped once, after the traversal, with the expressions of the plain
// version in its order.
//
// On top of it the leaf test is spread over the warp (WARP_LEAF): the
// lanes that hold a leaf hand its (ray, triangle) pairs to the warp, 32 a
// pass, and a segmented min-reduction gives each owner its winner. Always
// on it loses (every lane waits for the warp's slowest to reach a leaf,
// and a pass costs its shuffles: +7% on the bounce rays in lane order,
// +37% on primary rays, where the lanes' leaves are already in phase), so
// the warp takes it only where it needs fewer passes than its longest leaf
// needs a lane alone (WARP_PASS_COST), and otherwise each lane tests its
// own leaf's triangles one after another: 5-7% less time than the lane
// leaf alone on the bounce rays in lane order, the same on sorted rays,
// up to 5% more on primary rays.

#include "traverse.cuh"

namespace {

using namespace traverse;

constexpr int STACK_DEPTH = 96;
constexpr int BLOCK = 128;
constexpr int MIN_BLOCKS = 9;         // blocks an SM the registers must allow
constexpr bool CULL_POPS = true;      // drop a pop whose entry is beyond t
constexpr bool WARP_LEAF = true;      // the leaf test spread over the warp
// The warp spreads its leaves only where that takes fewer passes, each
// counted as WARP_PASS_COST triangle tests, than its longest leaf takes a
// lane alone; 0 spreads them always.
constexpr int WARP_PASS_COST = 3;
constexpr int TRI_STRIDE = 32;
constexpr int TRIS_PER_ROW = 4;
constexpr int LEAF_ROWS = 4;  // bvh8.LEAF_MAX / 4 rows of a leaf at most
constexpr int LEAF_MAX = LEAF_ROWS * TRIS_PER_ROW;
constexpr unsigned FULL = 0xffffffffu;

// Moller-Trumbore on the triangle at `g` of an attribute row, edges formed
// here: p0 = g0.xyz, p1 = (g0.w, g1.xy), p2 = (g1.zw, g2.x). Only filled
// slots are tested, so the count test is not needed.
__device__ __forceinline__ bool test_triangle(const float* g, const float o[3],
                                              const float d[3], float t,
                                              float& ft, float& hu,
                                              float& hv) {
  const float4 g0 = ld4(g), g1 = ld4(g + 4), g2 = ld4(g + 8);
  return moller_trumbore(g0.x, g0.y, g0.z, g0.w - g0.x, g1.x - g0.y,
                         g1.y - g0.z, g1.z - g0.x, g1.w - g0.y, g2.x - g0.z,
                         o, d, t, true, ft, hu, hv);
}

// Normal, uv and shape index of slot `face` at the barycentrics (hu, hv):
// n0 = (g2.y, g2.z, g2.w), n1 = g3.xyz, n2 = (g3.w, g4.xy), uv0 = g4.zw,
// uv1 = g5.xy, uv2 = g5.zw, shape = g6.x.
__device__ __forceinline__ void lerp_attributes(const float* __restrict__ tris,
                                                int face, float hu, float hv,
                                                float& nx, float& ny,
                                                float& nz, float& tu,
                                                float& tv, int& shape) {
  const float* g = tris + (size_t)(face / TRIS_PER_ROW) * ROW +
                   TRI_STRIDE * (face % TRIS_PER_ROW);
  const float4 g2 = ld4(g + 8), g3 = ld4(g + 12), g4 = ld4(g + 16),
               g5 = ld4(g + 20);
  const float hw = 1.0f - hu - hv;
  nx = hw * g2.y + hu * g3.x + hv * g3.w;
  ny = hw * g2.z + hu * g3.y + hv * g4.x;
  nz = hw * g2.w + hu * g3.z + hv * g4.y;
  tu = hw * g4.z + hu * g5.x + hv * g5.z;
  tv = hw * g4.w + hu * g5.y + hv * g5.w;
  shape = exact_int(__ldg(g + 24));
}

// The counters of a stats launch need registers of their own: only the
// launches that are timed are held to MIN_BLOCKS.
template <bool STATS>
__global__ void __launch_bounds__(BLOCK, STATS ? 1 : MIN_BLOCKS)
wide_trace_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ tris,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_in, long long n,
                  float* __restrict__ t_out, int* __restrict__ face_out,
                  float* __restrict__ normal_out, float* __restrict__ uv_out,
                  int* __restrict__ shape_out, int* __restrict__ stats,
                  int* __restrict__ warp_stats) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  // The warp-wide leaf test needs all 32 lanes: in the warp that holds the
  // last ray, the lanes past it stay as idle participants.
  if (WARP_LEAF ? (i & ~31LL) >= n : i >= n) return;
  const bool live = i < n;
  int* ws = STATS ? warp_stats + (i / 32) * WARP_STATS : nullptr;

  float o[3], d[3], inv[3], oinv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = live ? origin[c * n + i] : 0.0f;
    d[c] = live ? direction[c * n + i] : 1.0f;
    inv[c] = safe_inv(d[c]);
    oinv[c] = o[c] * inv[c];
  }

  float t = live ? t_in[i] : 0.0f;
  int face = -1;
  float fu = 0.0f, fv = 0.0f;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, tu = 0.0f, tv = 0.0f;
  int shape = 0;
  int n_interior = 0, n_leaf = 0, n_rows = 0, n_culled = 0, max_sp = 1;
  int n_tris = 0;  // filled slots of the leaf rows tested

  int2 stack[STACK_DEPTH];
  int sp = live ? 1 : 0;
  stack[0] = make_int2(0, __float_as_int(0.0f));  // root

  auto test_leaf = [&](int v) {
    // Leaf: v = -(count * LEAF_ROW_LIMIT + first_row), 4 triangles a row;
    // the `count` filled slots are tested in slot order.
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
      const float* row = tris + (size_t)(tri_row + rr) * ROW;
      const int filled = min(TRIS_PER_ROW, count - TRIS_PER_ROW * rr);
      n_tris += filled;
#pragma unroll 1
      for (int k = 0; k < filled; ++k) {
        float ft, hu, hv;
        if (test_triangle(row + TRI_STRIDE * k, o, d, t, ft, hu, hv)) {
          t = ft;
          face = (tri_row + rr) * TRIS_PER_ROW + k;
          fu = hu;
          fv = hv;
        }
      }
    }
  };

  // Called by all 32 lanes; v is the lane's leaf, or 0. Each lane with a
  // leaf owns the pairs (its ray, a triangle of its leaf). A pass tests 32
  // pairs, one a lane: the owners in lane order, a leaf's triangles on
  // consecutive lanes in slot order; a leaf that does not fit goes on in
  // the next pass. A lane fetches its owner's ray and t by shuffles and
  // runs the same triangle test. The sequential loop keeps a slot only
  // when ft < t, strictly, in slot order: the smallest ft and, on equal
  // ft, the lowest slot. So the segmented min over a leaf's lanes orders by
  // (ft, lane), and gives the same winner to the bit.
  auto test_leaves = [&](int v) {
    const int lane = threadIdx.x & 31;
    if (WARP_PASS_COST > 0) {
      // Few passes for the warp's pairs against its longest leaf: when the
      // lanes' leaves are about as long as one another, each lane tests its
      // own.
      const int own = v != 0 ? -v / LEAF_ROW_LIMIT : 0;
      const unsigned pairs = __reduce_add_sync(FULL, (unsigned)own);
      const unsigned longest = __reduce_max_sync(FULL, (unsigned)own);
      if ((pairs + 31) / 32 * WARP_PASS_COST >= longest) {
        if (v != 0) test_leaf(v);
        return;
      }
    }
    int count = 0, tri_row = 0;
    if (v != 0) {
      ++n_leaf;
      const int u = -v;
      count = u / LEAF_ROW_LIMIT;
      tri_row = u % LEAF_ROW_LIMIT;
      n_rows += (count + TRIS_PER_ROW - 1) / TRIS_PER_ROW;
      n_tris += count;
    }
    int next = 0;  // the first triangle of this lane's leaf not yet tested
    while (true) {
      const int rem = count - next;
      // Prefix sum over the lanes: `end` is one past the last pair slot of
      // this lane's leaf in this pass, `first` its first.
      int end = rem;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, end, off);
        if (lane >= off) end += y;
      }
      const int total = __shfl_sync(FULL, end, 31);
      if (total == 0) break;
      const int first = end - rem;
      // The owner of pair slot `lane`: the last lane whose first slot is
      // not after it (first slots rise with the lane).
      int owner = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(FULL, first, owner + step) <= lane) owner += step;
      }
      const int o_first = __shfl_sync(FULL, first, owner);
      const int o_end = __shfl_sync(FULL, end, owner);
      const int o_face =
          __shfl_sync(FULL, tri_row * TRIS_PER_ROW + next, owner);
      float po[3], pd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        po[c] = __shfl_sync(FULL, o[c], owner);
        pd[c] = __shfl_sync(FULL, d[c], owner);
      }
      const float pt = __shfl_sync(FULL, t, owner);
      const int pair_face = o_face + lane - o_first;
      float ft = __int_as_float(0x7f800000);  // +inf: no hit
      float hu = 0.0f, hv = 0.0f;
      if (lane < total) {
        if (STATS) {
          note_pass(ws, WS_LEAF);
          note_rows(ws, WS_LEAF_ROWS, pair_face / TRIS_PER_ROW);
        }
        float f, a, b;
        if (test_triangle(tris + (size_t)(pair_face / TRIS_PER_ROW) * ROW +
                              TRI_STRIDE * (pair_face % TRIS_PER_ROW),
                          po, pd, pt, f, a, b)) {
          ft = f;
          hu = a;
          hv = b;
        }
      }
      // Segmented min by (ft, lane): after the steps the first lane of a
      // leaf's pairs holds the leaf's. A hit has ft < pt, so it is finite.
      int best = lane;
#pragma unroll
      for (int off = 1; off < LEAF_MAX; off <<= 1) {
        const float f2 = __shfl_down_sync(FULL, ft, off);
        const int b2 = __shfl_down_sync(FULL, best, off);
        if (lane + off < o_end && f2 < ft) {
          ft = f2;
          best = b2;
        }
      }
      const float win_t = __shfl_sync(FULL, ft, first & 31);
      const int win = __shfl_sync(FULL, best, first & 31);
      const float win_u = __shfl_sync(FULL, hu, win);
      const float win_v = __shfl_sync(FULL, hv, win);
      if (rem > 0 && first < 32) {
        if (win_t < t) {
          t = win_t;
          face = tri_row * TRIS_PER_ROW + next + win - first;
          fu = win_u;
          fv = win_v;
        }
        next += min(rem, 32 - first);
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
    if (WARP_LEAF) {
      if (__ballot_sync(FULL, pending != 0) == 0) break;
      test_leaves(pending);
    } else {
      if (pending == 0) break;
      test_leaf(pending);
    }
  }

  // The winner's attributes, once a ray.
  if (face >= 0) lerp_attributes(tris, face, fu, fv, nx, ny, nz, tu, tv, shape);
  if (!live) return;
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
    stats[5 * n + i] = n_culled;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// `stats` ((6, n) per-ray counters) and `warp_stats` ((ceil(n / 32),
// WARP_STATS), zeroed by the caller) are both given or both null.
extern "C" int wide_trace_launch(const float* nodes, const float* tris,
                                 const float* origin, const float* direction,
                                 const float* t_in, long long n, float* t_out,
                                 int* face_out, float* normal_out,
                                 float* uv_out, int* shape_out, int* stats,
                                 int* warp_stats, void* stream) {
  if (n <= 0) return 0;
  const long long grid = (n + BLOCK - 1) / BLOCK;
  auto kernel = stats != nullptr ? wide_trace_kernel<true>
                                 : wide_trace_kernel<false>;
  kernel<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(
      nodes, tris, origin, direction, t_in, n, t_out, face_out, normal_out,
      uv_out, shape_out, stats, warp_stats);
  return (int)cudaGetLastError();
}
