// Pieces shared by the BVH8 traversal kernels of this directory: the table
// layout, the slab test of a node row's eight child boxes, the triangle
// tests of the three leaf geometry formats, the stack entry and the
// counters with which a kernel measures itself.
//
// All kernels read the 128-lane float32 rows of scene/bvh8.py as they are.
// The lane count was the TPU's vector width and half of a row is padding,
// but rows packed for this card (a 256-byte node row with integer metas and
// precomputed push ranks, a 384-byte leaf row) measured 1-3% (trace_packet.cu)
// and 6-8% (trace_inst.cu) faster, under the 9% by which two runs differ:
// a warp's lanes mostly fetch the same row, so the padding is never read
// and costs nothing. The three BVH8 kernels (trace_inst.cu,
// trace_packet.cu, trace_wide.cu) test a node row with `slab_entries`.
//
// Every expression here is written in the order of its plain PyTorch
// version (ops/trace_inst.py: safe_inv, leaf_tests; the slab test of the
// *_plain traversals). The kernels are built with -fmad=false and without
// fast math, so kernel and plain version round alike and agree to the bit,
// and the NaN of 0/0 that makes a padded 'bary' or 'woop' slot fail every
// comparison survives.

#pragma once

#include <cuda_runtime.h>

namespace traverse {

constexpr int ROW = 128;              // float32 lanes of a table row
constexpr int META_LANE = 48;         // child metas, lanes 48..55
constexpr int AXIS_LANE = 64;         // axis the children are sorted along
constexpr int PERM_LANE = 65;         // per-octant push orders, lanes 65..72
constexpr int LEAF_ROW_LIMIT = 1 << 19;
constexpr int GEOM_STRIDE = 16;       // lanes per triangle of a geometry row
constexpr float BIG = 1.0e9f;
constexpr float PASS_LIMIT = 0.5f * BIG;
constexpr int LEAF_FMT_MT = 0;
constexpr int LEAF_FMT_BARY = 1;      // LEAF_FMT_WOOP = 2 is the third

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-8f ? (d >= 0.0f ? 1e-8f : -1e-8f) : d);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Integers ride in float32 lanes, exact below 2^24: convert, never
// reinterpret.
__device__ __forceinline__ int exact_int(float f) { return __float2int_rn(f); }

// Moller-Trumbore on p0 and the two edges. `slot_ok` is the count test
// that guards the padded (all-zero) slots of a leaf row.
__device__ __forceinline__ bool moller_trumbore(
    float p0x, float p0y, float p0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, const float o[3], const float d[3],
    float t, bool slot_ok, float& ft, float& hu, float& hv) {
  const float pvx = d[1] * e2z - d[2] * e2y;
  const float pvy = d[2] * e2x - d[0] * e2z;
  const float pvz = d[0] * e2y - d[1] * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  bool ok = fabsf(det) >= 1e-9f;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const float sx = o[0] - p0x, sy = o[1] - p0y, sz = o[2] - p0z;
  hu = inv_det * (sx * pvx + sy * pvy + sz * pvz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  hv = inv_det * (d[0] * qx + d[1] * qy + d[2] * qz);
  ft = inv_det * (e2x * qx + e2y * qy + e2z * qz);
  ok = ok && (hu >= 0.0f) && (hu <= 1.0f) && (hv >= 0.0f) &&
       (hu + hv <= 1.0f);
  return ok && (ft >= 0.0f) && (ft < t) && slot_ok;
}

// One triangle of a geometry row (12 of its 16 lanes) in leaf format
// `fmt`. Only 'mt' reads `slot_ok`: a padded slot of the other two formats
// is all zero, its ft is 0/0 = NaN and every comparison fails.
__device__ __forceinline__ bool leaf_triangle(int fmt, const float* g,
                                              const float o[3],
                                              const float d[3], float t,
                                              bool slot_ok, float& ft,
                                              float& hu, float& hv) {
  const float4 g0 = ld4(g), g1 = ld4(g + 4), g2 = ld4(g + 8);
  if (fmt == LEAF_FMT_MT) {
    // p0 = g0.xyz, e1 = (g0.w, g1.xy), e2 = (g1.zw, g2.x).
    return moller_trumbore(g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w,
                           g2.x, o, d, t, slot_ok, ft, hu, hv);
  }
  if (fmt == LEAF_FMT_BARY) {
    // n = g0.xyz, d0 = g0.w, gu|cu = g1, gv|cv = g2.
    const float nd = g0.x * d[0] + g0.y * d[1] + g0.z * d[2];
    const float no = g0.x * o[0] + g0.y * o[1] + g0.z * o[2];
    ft = (g0.w - no) / nd;
    const float hx = o[0] + ft * d[0];
    const float hy = o[1] + ft * d[1];
    const float hz = o[2] + ft * d[2];
    hu = g1.x * hx + g1.y * hy + g1.z * hz + g1.w;
    hv = g2.x * hx + g2.y * hy + g2.z * hz + g2.w;
  } else {
    // 'woop': M row-major = (g0, g1, g2.x), c = -M p0 = g2.yzw; the ray
    // in the unit triangle's frame is o' = M o + c, d' = M d.
    const float opx = g0.x * o[0] + g0.y * o[1] + g0.z * o[2] + g2.y;
    const float opy = g0.w * o[0] + g1.x * o[1] + g1.y * o[2] + g2.z;
    const float opz = g1.z * o[0] + g1.w * o[1] + g2.x * o[2] + g2.w;
    const float dpx = g0.x * d[0] + g0.y * d[1] + g0.z * d[2];
    const float dpy = g0.w * d[0] + g1.x * d[1] + g1.y * d[2];
    const float dpz = g1.z * d[0] + g1.w * d[1] + g2.x * d[2];
    ft = -opz / dpz;
    hu = opx + ft * dpx;
    hv = opy + ft * dpy;
  }
  return (hu >= 0.0f) && (hv >= 0.0f) && (hu + hv <= 1.0f) && (ft >= 0.0f) &&
         (ft < t);
}

// ---- one round trip a pop ---------------------------------------------------

// Ranks from a push-order word (lanes PERM_LANE + octant of a node row):
// the order holds the child pushed k-th in bits 3k..3k+2, the ranks hold in
// bits 3c..3c+2 the position at which child c is pushed.
__device__ __forceinline__ int ranks_from_order(int order) {
  int ranks = 0;
#pragma unroll
  for (int k = 1; k < 8; ++k) ranks |= k << (3 * ((order >> (3 * k)) & 7));
  return ranks;
}

// A node row in one round trip: the twelve box loads and the two meta loads
// are independent, so they are all in flight before the first is used. The
// eight child boxes sit in lanes 0..47, coordinate-major (lo_x[8] lo_y[8]
// lo_z[8] hi_x[8] hi_y[8] hi_z[8]), and are tested against one ray given as
// inv = 1/d and oinv = o/d. Besides the hit mask (bit ch set when the ray
// enters the non-empty child ch before t) it leaves each child's entry
// distance and meta in registers.
__device__ __forceinline__ unsigned slab_entries(const float* __restrict__ row,
                                                 const float inv[3],
                                                 const float oinv[3], float t,
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
    const float tx0 = b[ch] * inv[0] - oinv[0];
    const float ty0 = b[8 + ch] * inv[1] - oinv[1];
    const float tz0 = b[16 + ch] * inv[2] - oinv[2];
    const float tx1 = b[24 + ch] * inv[0] - oinv[0];
    const float ty1 = b[32 + ch] * inv[1] - oinv[1];
    const float tz1 = b[40 + ch] * inv[2] - oinv[2];
    entry[ch] =
        fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float exit_ =
        fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    // Empty slots (meta == 0) have inverted boxes that can pass the
    // symmetric slab test; they are never pushed.
    const bool ok = (exit_ >= entry[ch]) && (exit_ > 0.0f) &&
                    (entry[ch] < t) && (entry[ch] < PASS_LIMIT) &&
                    (meta[ch] != 0);
    hit |= (unsigned)ok << ch;
  }
  return hit;
}

// ---- the per-thread stack ------------------------------------------------

// A stack entry: the node (or leaf code, or instance tag) and the distance
// at which the ray enters its box, kept so that a pop can be dropped
// without its row once a closer hit is known. The stack is a per-thread
// array in local memory; entries at depth >= DEPTH are dropped.
// The pop cull drops an entry only when its entry distance lies beyond the
// ray's t by more than the slab test's rounding: `!(entry < t * CULL_SLACK)`.
// Without the slack, a hit one ulp before the rounded entry of the one leaf
// that holds its triangle was lost (1 of 2,073,600 viking hall rays);
// 1 + 2^-23, the smallest slack above 1 in float32, keeps every hit of the
// viking hall's and the terrain's rays (chip_smoke.py, `pop_cull`). The
// plain versions use the same constant (ops/trace_inst.py CULL_SLACK).
constexpr float CULL_SLACK = 1.0f + 1.0f / 8388608.0f;

template <int DEPTH>
__device__ __forceinline__ void stack_put(int2* stack, int k, int v,
                                          float entry) {
  if (k < DEPTH) stack[k] = make_int2(v, __float_as_int(entry));
}

// ---- a kernel's measurement of itself (stats launches only) ---------------

// Counters one warp keeps for its 32 rays, in `warp_stats[warp * WARP_STATS
// + ...]`: for each body of the loop the times the warp ran it and the lanes
// that were active in it, the loop iterations of the warp, and for the
// interior and leaf bodies the distinct table rows its active lanes fetched.
constexpr int WARP_STATS = 12;
constexpr int WS_LOOP = 0;            // loop iterations, then active lanes
constexpr int WS_TAG = 2, WS_INTERIOR = 4, WS_LEAF = 6;
constexpr int WS_INTERIOR_ROWS = 8, WS_LEAF_ROWS = 9;
constexpr int WS_CULL = 10;           // culled pops: times, then lanes

// Called by every lane that is in a body: the first active lane adds one
// pass and the count of active lanes to the warp's counters.
__device__ __forceinline__ void note_pass(int* ws, int body) {
  const unsigned act = __activemask();
  if ((threadIdx.x & 31) == __ffs(act) - 1) {
    atomicAdd(ws + body, 1);
    atomicAdd(ws + body + 1, __popc(act));
  }
}

// Adds the number of distinct `row` values among the active lanes: 1 when
// the whole warp reads one row (a broadcast), up to 32 when every lane
// reads its own.
__device__ __forceinline__ void note_rows(int* ws, int slot, int row) {
  const unsigned act = __activemask();
  const unsigned peers = __match_any_sync(act, row);
  const unsigned leaders =
      __ballot_sync(act, (threadIdx.x & 31) == __ffs(peers) - 1);
  if ((threadIdx.x & 31) == __ffs(act) - 1) atomicAdd(ws + slot, __popc(leaders));
}

}  // namespace traverse
