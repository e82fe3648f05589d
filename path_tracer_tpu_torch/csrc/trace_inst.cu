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

#include "traverse.cuh"

namespace {

using namespace traverse;

constexpr int STACK_DEPTH = 128;
constexpr int INST_BASE = 1 << 22;
constexpr int LEAF_ROWS = 2;  // bvh8.LEAF_MAX / 8 rows of a leaf at most

struct Ray {
  float o[3], d[3], inv[3], oinv[3];
  int oct;
};

__device__ __forceinline__ void finish_ray(Ray& r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.inv[c] = safe_inv(r.d[c]);
    r.oinv[c] = r.o[c] * r.inv[c];
  }
  // Octant bit set <=> direction component negative (bvh8 PERM_LANE).
  r.oct = ((r.d[0] < 0.0f) << 2) | ((r.d[1] < 0.0f) << 1) | (r.d[2] < 0.0f);
}

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
      const unsigned hit = slab_hits(row, inv, oinv, t);
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
          float ft, hu, hv;
          const bool ok = leaf_triangle(leaf_fmt, row + GEOM_STRIDE * k, r.o,
                                        r.d, t, count > 8 * rr + k, ft, hu, hv);
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
