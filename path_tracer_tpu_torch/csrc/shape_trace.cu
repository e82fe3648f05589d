// Closest hit among the analytic shapes (planes, spheres, cubes), one thread
// per ray.
//
// Replaces, on the card, the dense analytic intersection of
// ops/intersect.py::intersect_analytic, which tests every ray against every
// shape slot as (S, N) tensors and settles ties by a loop over the slots:
// at the hundreds of spheres of a real scene and millions of rays its
// temporaries do not fit the card. It ports no Pallas kernel. As the Vulkan
// reference does (a TLAS over the shapes' boxes, scene.cpp:1402-1492,
// scene.glsl.inc:468-520), each ray tests the planes one after the other
// (they are unbounded) and then walks a wide BVH over the padded world boxes
// of the sphere and cube slots (scene/compile.py::pack_shape_tables): the
// same 128-lane node rows as the instance TLAS, whose leaf metas are
// SHAPE_BASE + a row of the shape table.
//
// The function is the dense path's, to the bit:
//   * each shape's t comes from the float32 operations of `_intersect_plane`,
//     `_intersect_sphere` and `_intersect_cube`, in their order, on the ray
//     moved to object space as the dense path moves it, with the reach t_in
//     (the kernel is built with -fmad=false and without fast math);
//   * the winner is the lexicographic minimum of (t, tie rank), the rank
//     being the slot's position in the analytic groups taken in order: the
//     dense path's first group, then lowest slot, on equal t;
//   * a node is left out only when the ray enters its box beyond the best t
//     so far (or t_in) times CULL_SLACK, so a shape that ties is never culled,
//     and the boxes are padded so that they hold every hit the dense test
//     finds. The slab test here is (b - o) * inv, not traverse.cuh's
//     b * inv - o * inv: the latter's rounding grows with |o| / |d|.
// ops/intersect.py::traverse_shape_bvh is the same walk in plain PyTorch.

#include "traverse.cuh"

namespace {

using namespace traverse;

constexpr int STACK_DEPTH = 128;      // scene/compile.py SHAPE_STACK_DEPTH
constexpr int BLOCK = 128;
constexpr int SHAPE_BASE = 1 << 22;   // ops/trace_inst.py INST_BASE
constexpr int SHAPE_ROW = 16;         // floats a shape row
constexpr int TYPE_PLANE = 1, TYPE_SPHERE = 2;   // TYPE_CUBE = 3
constexpr float INF = 1e30f;          // core/constants.py INFINITY

__device__ __forceinline__ float where_small(float x) {
  return fabsf(x) < 1e-12f ? 1e-12f : x;
}

// One shape row against the world ray: the object-space ray (o, d) and
// the shape's t, INF on a miss. Operations in the dense path's order.
__device__ __forceinline__ float shape_test(const float* __restrict__ row,
                                            const float wo[3],
                                            const float wd[3], float reach,
                                            int type, float o[3],
                                            float d[3]) {
  const float4 r0 = ld4(row), r1 = ld4(row + 4), r2 = ld4(row + 8);
  o[0] = r0.x * wo[0] + r0.y * wo[1] + r0.z * wo[2] + r0.w;
  o[1] = r1.x * wo[0] + r1.y * wo[1] + r1.z * wo[2] + r1.w;
  o[2] = r2.x * wo[0] + r2.y * wo[1] + r2.z * wo[2] + r2.w;
  d[0] = r0.x * wd[0] + r0.y * wd[1] + r0.z * wd[2];
  d[1] = r1.x * wd[0] + r1.y * wd[1] + r1.z * wd[2];
  d[2] = r2.x * wd[0] + r2.y * wd[1] + r2.z * wd[2];
  if (type == TYPE_PLANE) {
    const float t = -o[2] / where_small(d[2]);
    return (t >= 0.0f && t <= reach) ? t : INF;
  }
  if (type == TYPE_SPHERE) {
    const float v = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float p = o[0] * d[0] + o[1] * d[1] + o[2] * d[2];
    const float q = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - 1.0f;
    const float d2 = p * p - q * v;
    bool ok = d2 >= 0.0f;
    const float sq = sqrtf(d2 < 0.0f ? 0.0f : d2);
    ok = ok && sq >= p;
    const float s0 = -p - sq;
    const float s1 = -p + sq;
    const float s = s0 < 0.0f ? s1 : s0;
    ok = ok && s >= 0.0f && s <= v * reach;
    return ok ? s / (v < 1e-20f ? 1e-20f : v) : INF;
  }
  float entry = 0.0f, exit_ = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float inv = 1.0f / where_small(d[c]);
    const float t0 = (-1.0f - o[c]) * inv;
    const float t1 = (1.0f - o[c]) * inv;
    const float lo = t0 < t1 ? t0 : t1, hi = t0 < t1 ? t1 : t0;
    entry = c == 0 ? lo : (entry < lo ? lo : entry);
    exit_ = c == 0 ? hi : (exit_ < hi ? exit_ : hi);
  }
  const float t = entry < 0.0f ? exit_ : entry;
  return (exit_ >= entry && exit_ > 0.0f && t < reach) ? t : INF;
}

// Slab test of a node row's eight child boxes: bit ch is set when the ray
// enters the non-empty child ch at or before `limit`; entry distances and
// metas are left in registers.
__device__ __forceinline__ unsigned shape_slab(const float* __restrict__ row,
                                               const float o[3],
                                               const float inv[3], float limit,
                                               float entry[8], int meta[8]) {
  float b[48];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float4 x = ld4(row + 4 * j);
    b[4 * j] = x.x;
    b[4 * j + 1] = x.y;
    b[4 * j + 2] = x.z;
    b[4 * j + 3] = x.w;
  }
  const float4 m0 = ld4(row + META_LANE), m1 = ld4(row + META_LANE + 4);
  meta[0] = exact_int(m0.x); meta[1] = exact_int(m0.y);
  meta[2] = exact_int(m0.z); meta[3] = exact_int(m0.w);
  meta[4] = exact_int(m1.x); meta[5] = exact_int(m1.y);
  meta[6] = exact_int(m1.z); meta[7] = exact_int(m1.w);
  unsigned hit = 0;
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) {
    const float tx0 = (b[ch] - o[0]) * inv[0];
    const float ty0 = (b[8 + ch] - o[1]) * inv[1];
    const float tz0 = (b[16 + ch] - o[2]) * inv[2];
    const float tx1 = (b[24 + ch] - o[0]) * inv[0];
    const float ty1 = (b[32 + ch] - o[1]) * inv[1];
    const float tz1 = (b[40 + ch] - o[2]) * inv[2];
    entry[ch] =
        fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float exit_ =
        fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    const bool ok = (exit_ >= entry[ch]) && (exit_ >= 0.0f) &&
                    (entry[ch] <= limit) && (meta[ch] != 0);
    hit |= (unsigned)ok << ch;
  }
  return hit;
}

// STATS adds the nodes and the shapes tested, summed over rays, to
// stats[0] and stats[1].
template <bool STATS>
__global__ void __launch_bounds__(BLOCK)
shape_trace_kernel(const float* __restrict__ nodes,
                   const float* __restrict__ rows,
                   const float* __restrict__ planes, int n_planes,
                   const float* __restrict__ origin,
                   const float* __restrict__ direction,
                   const float* __restrict__ t_in,
                   const int* __restrict__ shape_in,
                   const int* __restrict__ type_in,
                   const int* __restrict__ prim_in,
                   const float* __restrict__ coords_in,
                   const int* __restrict__ complexity_in, long long n,
                   float* __restrict__ t_out, int* __restrict__ shape_out,
                   int* __restrict__ type_out, int* __restrict__ prim_out,
                   float* __restrict__ coords_out,
                   int* __restrict__ complexity_out,
                   unsigned long long* __restrict__ stats) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (!STATS && i >= n) return;
  int n_nodes = 0, n_tests = 0;
  if (i < n) {
    float wo[3], wd[3], inv[3], o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wo[c] = origin[c * n + i];
      wd[c] = direction[c * n + i];
      inv[c] = safe_inv(wd[c]);
    }
    const float reach = t_in[i];
    float best = INF;
    int best_rank = 0x7fffffff;
    const float* best_row = nullptr;

    auto consider = [&](const float* row) {
      const float4 meta = ld4(row + 12);  // type, shape, rank, pad
      const float t = shape_test(row, wo, wd, reach, exact_int(meta.x), o, d);
      const int rank = exact_int(meta.z);
      ++n_tests;
      if (t < best || (t == best && rank < best_rank)) {
        best = t;
        best_rank = rank;
        best_row = row;
      }
    };

#pragma unroll 1
    for (int k = 0; k < n_planes; ++k) consider(planes + (size_t)k * SHAPE_ROW);

    int2 stack[STACK_DEPTH];
    int sp = 1;
    stack[0] = make_int2(0, __float_as_int(0.0f));
    // The octant's push order: far children first, the nearest on top.
    const int oct = ((wd[0] < 0.0f) << 2) | ((wd[1] < 0.0f) << 1) |
                    (wd[2] < 0.0f);
    while (sp > 0) {
      const int2 top = stack[--sp];
      const float limit = (best < reach ? best : reach) * CULL_SLACK;
      if (!(__int_as_float(top.y) <= limit)) continue;
      if (top.x >= SHAPE_BASE) {
        consider(rows + (size_t)(top.x - SHAPE_BASE) * SHAPE_ROW);
        continue;
      }
      ++n_nodes;
      const float* row = nodes + (size_t)top.x * ROW;
      float entry[8];
      int meta[8];
      const unsigned hit = shape_slab(row, wo, inv, limit, entry, meta);
      if (!hit) continue;
      const int ranks = ranks_from_order(exact_int(__ldg(row + PERM_LANE + oct)));
      unsigned ranked = 0;
#pragma unroll
      for (int ch = 0; ch < 8; ++ch)
        ranked |= ((hit >> ch) & 1u) << ((ranks >> (3 * ch)) & 7);
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        if ((hit >> ch) & 1u) {
          const int rank = (ranks >> (3 * ch)) & 7;
          stack_put<STACK_DEPTH>(stack,
                                 sp + __popc(ranked & ((1u << rank) - 1u)),
                                 meta[ch], entry[ch]);
        }
      }
      sp = min(sp + __popc(hit), STACK_DEPTH);
    }

    if (best < reach) {
      const float4 meta = ld4(best_row + 12);
      shape_test(best_row, wo, wd, reach, exact_int(meta.x), o, d);
      t_out[i] = best;
      shape_out[i] = exact_int(meta.y);
      type_out[i] = exact_int(meta.x);
      prim_out[i] = 0;
#pragma unroll
      for (int c = 0; c < 3; ++c) coords_out[c * n + i] = o[c] + d[c] * best;
    } else {
      t_out[i] = reach;
      shape_out[i] = shape_in[i];
      type_out[i] = type_in[i];
      prim_out[i] = prim_in[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) coords_out[c * n + i] = coords_in[c * n + i];
    }
    complexity_out[i] = complexity_in[i] + n_nodes + n_tests;
  }
  if (STATS) {
    const unsigned nodes_w = __reduce_add_sync(0xffffffffu, (unsigned)n_nodes);
    const unsigned tests_w = __reduce_add_sync(0xffffffffu, (unsigned)n_tests);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats, (unsigned long long)nodes_w);
      atomicAdd(stats + 1, (unsigned long long)tests_w);
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// `stats` is null, or two int64 counters the kernel adds to.
extern "C" int shape_trace_launch(
    const float* nodes, const float* rows, const float* planes, int n_planes,
    const float* origin, const float* direction, const float* t_in,
    const int* shape_in, const int* type_in, const int* prim_in,
    const float* coords_in, const int* complexity_in, long long n,
    float* t_out, int* shape_out, int* type_out, int* prim_out,
    float* coords_out, int* complexity_out, long long* stats, void* stream) {
  if (n <= 0) return 0;
  const long long grid = (n + BLOCK - 1) / BLOCK;
  auto* st = reinterpret_cast<unsigned long long*>(stats);
  auto kernel = st ? shape_trace_kernel<true> : shape_trace_kernel<false>;
  kernel<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(
      nodes, rows, planes, n_planes, origin, direction, t_in, shape_in,
      type_in, prim_in, coords_in, complexity_in, n, t_out, shape_out,
      type_out, prim_out, coords_out, complexity_out, st);
  return (int)cudaGetLastError();
}
