// Closest-hit traversal of the two-level instanced BVH8, one thread per ray.
//
// Replaces the TPU kernel path_tracer_tpu/ops/trace_inst.py::_kernel
// (called through inst_trace / _inst_trace). It computes the same
// function on the same tables: the nodes table [TLAS rows | rebased
// per-mesh BVH8 rows], the object-space 8-triangle leaf rows and the
// per-instance rows; out come t, face = (leaf_row + r) * 8 + k, the
// barycentrics fu/fv and the winning instance (-1 and face -1 on a miss).
//
// What it does not copy: the TPU kernel traverses 3072-ray packets with
// one SMEM stack per packet, keeps the tables VMEM-resident (or streams
// them from HBM with per-pop DMAs) and picks the push order from the
// packet's summed direction signs. On Hopper each thread traverses its
// own ray, as the Vulkan reference does (scene.glsl.inc:336-399):
//   * a per-thread stack of STACK_DEPTH ints in local memory (pushes
//     past the depth are dropped, as on the TPU);
//   * node and leaf rows read straight from global memory through the
//     read-only path (16-byte __ldg loads); the tables of the flagship
//     scene are a few MB and stay in the 50 MB L2;
//   * the ray's own direction octant picks the far-first child order
//     stamped in the node row, and a child is pushed only when this
//     ray's own slab test enters it before its current t.
// Ties on shared edges can therefore resolve differently from the
// packet kernel; the closest hit is the same.
//
// What bounds it on the H100: not its compulsory bytes (tables and rays
// read once) nor its slab and triangle flops, which take a few hundredths
// of a millisecond for a 2M-ray wavefront, but the rows each ray fetches
// (a node pop reads 192 B of bounds plus its push order and metas, a leaf
// row 8 x 48 B) through L1 and L2, and the divergence of a warp whose 32
// rays pop different rows.
// The design keeps a pop's row in registers (one row per pop, read
// once), culls each child against the ray's own t, and lets the caller
// sort rays by (octant, origin cell, direction) so the rays of a warp
// tend to pop the same rows. Per-ray counters of interior pops, leaf
// pops, leaf rows tested and instance entries give the rows, bytes and
// operations a run needed.
//
// Integers stored in float32 lanes (child metas, octant orders,
// instance tags, leaf codes, the mesh root) are exact below 2^24 and
// are converted with an exact float -> int conversion, never by
// reinterpreting the bits.

#include <cuda_runtime.h>

namespace {

constexpr int STACK_DEPTH = 128;
constexpr int INST_BASE = 1 << 22;
constexpr int LEAF_ROW_LIMIT = 1 << 19;
constexpr int LEAF_ROWS = 2;  // bvh8.LEAF_MAX / 8 rows of a leaf at most
constexpr int ROW = 128;
constexpr int META_LANE = 48;
constexpr int PERM_LANE = 65;
constexpr int GEOM_STRIDE = 16;
constexpr float BIG = 1.0e9f;
constexpr float PASS_LIMIT = 0.5f * BIG;
constexpr int LEAF_FMT_MT = 0;

struct Ray {
  float o[3], d[3], inv[3], oinv[3];
  int oct;
};

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-8f ? (d >= 0.0f ? 1e-8f : -1e-8f) : d);
}

__device__ __forceinline__ void finish_ray(Ray& r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.inv[c] = safe_inv(r.d[c]);
    r.oinv[c] = r.o[c] * r.inv[c];
  }
  // Octant bit set <=> direction component negative (bvh8 PERM_LANE).
  r.oct = ((r.d[0] < 0.0f) << 2) | ((r.d[1] < 0.0f) << 1) | (r.d[2] < 0.0f);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ int exact_int(float f) { return __float2int_rn(f); }

__global__ void __launch_bounds__(128)
inst_trace_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ tris,
                  const float* __restrict__ inst_rows,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_in, long long n, int tlas_rows,
                  int leaf_fmt, float* __restrict__ t_out,
                  int* __restrict__ face_out, float* __restrict__ fu_out,
                  float* __restrict__ fv_out, int* __restrict__ inst_out,
                  int* __restrict__ stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Ray w, r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w.o[c] = origin[c * n + i];
    w.d[c] = direction[c * n + i];
  }
  finish_ray(w);
  r = w;

  float t = t_in[i];
  int face = -1, inst = -1, cur = 0;
  float fu = 0.0f, fv = 0.0f;
  int n_interior = 0, n_leaf = 0, n_rows = 0, n_enter = 0;

  int stack[STACK_DEPTH];
  int sp = 1;
  stack[0] = 0;  // TLAS root

  while (sp > 0) {
    const int v = stack[--sp];
    if (v >= INST_BASE) {
      // Instance tag: move the ray to object space without renormalizing
      // the direction, so t stays in world units across instances.
      ++n_enter;
      cur = v - INST_BASE;
      const float* row = inst_rows + (size_t)cur * ROW;
      const float4 a = ld4(row), b = ld4(row + 4), c = ld4(row + 8);
      const float root = __ldg(row + 12);
      r.o[0] = a.x * w.o[0] + a.y * w.o[1] + a.z * w.o[2] + a.w;
      r.o[1] = b.x * w.o[0] + b.y * w.o[1] + b.z * w.o[2] + b.w;
      r.o[2] = c.x * w.o[0] + c.y * w.o[1] + c.z * w.o[2] + c.w;
      r.d[0] = a.x * w.d[0] + a.y * w.d[1] + a.z * w.d[2];
      r.d[1] = b.x * w.d[0] + b.y * w.d[1] + b.z * w.d[2];
      r.d[2] = c.x * w.d[0] + c.y * w.d[1] + c.z * w.d[2];
      finish_ray(r);
      if (sp < STACK_DEPTH) stack[sp++] = exact_int(root);
    } else if (v >= 0) {
      // Interior node: TLAS rows use the world ray, mesh rows the object ray.
      ++n_interior;
      const bool world = v < tlas_rows;
      float inv[3], oinv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        inv[c] = world ? w.inv[c] : r.inv[c];
        oinv[c] = world ? w.oinv[c] : r.oinv[c];
      }
      const int oct = world ? w.oct : r.oct;
      const float* row = nodes + (size_t)v * ROW;
      float b[48];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const float4 x = ld4(row + 4 * j);
        b[4 * j] = x.x;
        b[4 * j + 1] = x.y;
        b[4 * j + 2] = x.z;
        b[4 * j + 3] = x.w;
      }
      unsigned hit = 0;
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        const float tx0 = b[ch] * inv[0] - oinv[0];
        const float ty0 = b[8 + ch] * inv[1] - oinv[1];
        const float tz0 = b[16 + ch] * inv[2] - oinv[2];
        const float tx1 = b[24 + ch] * inv[0] - oinv[0];
        const float ty1 = b[32 + ch] * inv[1] - oinv[1];
        const float tz1 = b[40 + ch] * inv[2] - oinv[2];
        const float entry = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                  fminf(tz0, tz1));
        const float exit_ = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                  fmaxf(tz0, tz1));
        const bool ok = (exit_ >= entry) && (exit_ > 0.0f) && (entry < t) &&
                        (entry < PASS_LIMIT);
        hit |= (unsigned)ok << ch;
      }
      if (hit) {
        const int perm = exact_int(__ldg(row + PERM_LANE + oct));
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int ch = (perm >> (3 * k)) & 7;
          if ((hit >> ch) & 1u) {
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
          const float* g = row + GEOM_STRIDE * k;
          const float4 g0 = ld4(g), g1 = ld4(g + 4), g2 = ld4(g + 8);
          float ft, hu, hv;
          bool ok;
          if (leaf_fmt == LEAF_FMT_MT) {
            // p0 = g0.xyz, e1 = (g0.w, g1.xy), e2 = (g1.zw, g2.x).
            const float e1x = g0.w, e1y = g1.x, e1z = g1.y;
            const float e2x = g1.z, e2y = g1.w, e2z = g2.x;
            const float pvx = r.d[1] * e2z - r.d[2] * e2y;
            const float pvy = r.d[2] * e2x - r.d[0] * e2z;
            const float pvz = r.d[0] * e2y - r.d[1] * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            ok = fabsf(det) >= 1e-9f;
            const float inv_det = 1.0f / (ok ? det : 1.0f);
            const float sx = r.o[0] - g0.x, sy = r.o[1] - g0.y,
                        sz = r.o[2] - g0.z;
            hu = inv_det * (sx * pvx + sy * pvy + sz * pvz);
            const float qx = sy * e1z - sz * e1y;
            const float qy = sz * e1x - sx * e1z;
            const float qz = sx * e1y - sy * e1x;
            hv = inv_det * (r.d[0] * qx + r.d[1] * qy + r.d[2] * qz);
            ft = inv_det * (e2x * qx + e2y * qy + e2z * qz);
            ok = ok && (hu >= 0.0f) && (hu <= 1.0f) && (hv >= 0.0f) &&
                 (hu + hv <= 1.0f);
            ok = ok && (ft >= 0.0f) && (ft < t) && (count > 8 * rr + k);
          } else {
            // 'bary': n = g0.xyz, d0 = g0.w, gu|cu = g1, gv|cv = g2. Padded
            // slots are all zero: ft = 0/0 = NaN fails every comparison.
            const float nd = g0.x * r.d[0] + g0.y * r.d[1] + g0.z * r.d[2];
            const float no = g0.x * r.o[0] + g0.y * r.o[1] + g0.z * r.o[2];
            ft = (g0.w - no) / nd;
            const float hx = r.o[0] + ft * r.d[0];
            const float hy = r.o[1] + ft * r.d[1];
            const float hz = r.o[2] + ft * r.d[2];
            hu = g1.x * hx + g1.y * hy + g1.z * hz + g1.w;
            hv = g2.x * hx + g2.y * hy + g2.z * hz + g2.w;
            ok = (hu >= 0.0f) && (hv >= 0.0f) && (hu + hv <= 1.0f) &&
                 (ft >= 0.0f) && (ft < t);
          }
          if (ok) {
            t = ft;
            face = (leaf_row + rr) * 8 + k;
            fu = hu;
            fv = hv;
            inst = cur;
          }
        }
      }
    }
  }

  t_out[i] = t;
  face_out[i] = face;
  fu_out[i] = fu;
  fv_out[i] = fv;
  inst_out[i] = inst;
  if (stats != nullptr) {
    stats[i] = n_interior;
    stats[n + i] = n_leaf;
    stats[2 * n + i] = n_rows;
    stats[3 * n + i] = n_enter;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
extern "C" int inst_trace_launch(const float* nodes, const float* tris,
                                 const float* inst_rows, const float* origin,
                                 const float* direction, const float* t_in,
                                 long long n, int tlas_rows, int leaf_fmt,
                                 float* t_out, int* face_out,
                                 float* fu_out, float* fv_out, int* inst_out,
                                 int* stats, void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const long long grid = (n + block - 1) / block;
  inst_trace_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      nodes, tris, inst_rows, origin, direction, t_in, n, tlas_rows, leaf_fmt,
      t_out, face_out, fu_out, fv_out, inst_out, stats);
  return (int)cudaGetLastError();
}
