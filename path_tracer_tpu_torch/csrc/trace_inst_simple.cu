// Closest-hit traversal of the two-level instanced BVH8, one thread per
// ray: the first, simple kernel of the port, kept as the baseline that
// trace_inst.cu is measured against (ops/trace_inst.py launches it only
// for variant='simple').
//
// It computes the function of the TPU kernel
// path_tracer_tpu/ops/trace_inst.py::_kernel on the 128-lane tables as
// they are: a per-thread stack of STACK_DEPTH ints in local memory, every
// row read straight from global memory with 16-byte __ldg loads, the push
// order and the metas of the entered children fetched after the slab test,
// a child pushed when this ray's own slab test enters it before its t, and
// every popped node's row fetched whatever t has become since the push.
// trace_inst.cu's header says what was measured to bind this kernel.

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

template <bool STATS>
__global__ void __launch_bounds__(128)
inst_trace_simple_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ tris,
                  const float* __restrict__ inst_rows,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_in, long long n, int tlas_rows,
                  int leaf_fmt, float* __restrict__ t_out,
                  int* __restrict__ face_out, float* __restrict__ fu_out,
                  float* __restrict__ fv_out, int* __restrict__ inst_out,
                  int* __restrict__ stats, int* __restrict__ warp_stats) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int* ws = STATS ? warp_stats + (i / 32) * WARP_STATS : nullptr;

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
  int n_interior = 0, n_leaf = 0, n_rows = 0, n_enter = 0, max_sp = 1;
  int n_tris = 0;  // filled slots of the leaf rows tested

  int stack[STACK_DEPTH];
  int sp = 1;
  stack[0] = 0;  // TLAS root

  while (sp > 0) {
    if (STATS) {
      note_pass(ws, WS_LOOP);
      max_sp = max(max_sp, sp);
    }
    const int v = stack[--sp];
    if (v >= INST_BASE) {
      // Instance tag: move the ray to object space without renormalizing
      // the direction, so t stays in world units across instances.
      ++n_enter;
      if (STATS) note_pass(ws, WS_TAG);
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
      if (STATS) {
        note_pass(ws, WS_INTERIOR);
        note_rows(ws, WS_INTERIOR_ROWS, v);
      }
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
  if (STATS) {
    stats[i] = n_interior;
    stats[n + i] = n_leaf;
    stats[2 * n + i] = n_rows;
    stats[3 * n + i] = n_enter;
    stats[4 * n + i] = n_tris;
    stats[5 * n + i] = max_sp;
    stats[6 * n + i] = 0;  // no pop is culled here
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// `stats` ((7, n) per-ray counters) and `warp_stats` ((ceil(n / 32),
// WARP_STATS), zeroed by the caller) are both given or both null.
extern "C" int inst_trace_simple_launch(const float* nodes, const float* tris,
                                 const float* inst_rows, const float* origin,
                                 const float* direction, const float* t_in,
                                 long long n, int tlas_rows, int leaf_fmt,
                                 float* t_out, int* face_out,
                                 float* fu_out, float* fv_out, int* inst_out,
                                 int* stats, int* warp_stats, void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const long long grid = (n + block - 1) / block;
  auto kernel = stats != nullptr ? inst_trace_simple_kernel<true>
                                 : inst_trace_simple_kernel<false>;
  kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      nodes, tris, inst_rows, origin, direction, t_in, n, tlas_rows, leaf_fmt,
      t_out, face_out, fu_out, fv_out, inst_out, stats, warp_stats);
  return (int)cudaGetLastError();
}
