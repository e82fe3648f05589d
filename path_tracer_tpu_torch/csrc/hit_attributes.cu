// The hit record's attributes, one thread a lane: the mesh kernel's winners
// merged into the hit record, then the position, normal, tangent frame, uv
// and material of every lane.
//
// Replaces, on the card, the plain PyTorch chain that ops/intersect.py's
// `trace` runs after its traversals (`resolve_attributes_plain`: the
// torch.where merge of the winners, with trace_inst.resolve_inst_attributes
// or trace_packet.resolve_wide_attributes, then `resolve_hit_attributes`).
// It ports no Pallas kernel: the JAX package leaves this layer to XLA. The
// chain computes every shape type's branch on every lane and sends each
// intermediate through device memory, in some 290 elementwise launches. The
// layer does little arithmetic on a few hundred bytes a lane, so the card's
// memory bounds it; the kernel moves each byte once: loads and stores in
// lane order (one (N,) row a component, neighbouring threads on neighbouring
// words), a mesh hit's 64-byte attribute row in four 16-byte loads, the
// small per-shape tables through the read-only cache, nothing kept in device
// memory between the steps, and only the branch of the lane's own shape
// type.
//
// The function is the chain's, to the bit, in every field of every lane:
// each step takes the float32 operations of the tensor code in its order
// (core.cuh's helpers; built with -fmad=false and without fast math, so
// IEEE division and sqrtf), Python's scalars rounded to float32 as PyTorch
// rounds them, and a division by a Python scalar taken as PyTorch's CUDA
// kernel takes it: times the scalar's float32 reciprocal.

#include "core.cuh"
#include "hit_attributes.h"

namespace {

using pt::V3;

constexpr int BLOCK = 256;
constexpr int SHAPE_INDEX_NONE = 0x7FFFFFFF;   // core/constants.py
constexpr int TYPE_MESH = 0, TYPE_PLANE = 1, TYPE_SPHERE = 2, TYPE_CUBE = 3;
constexpr int BINS = 5;                        // miss, then TYPE_* + 1
// `(atan2 + PI) / TAU`: PyTorch's CUDA division by a Python scalar
// multiplies by the scalar's float32 reciprocal.
constexpr float INV_TAU = 1.0f / pt::TAU;

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// m[r][c] of shape s in a (4, 4, S) matrix table.
__device__ __forceinline__ float m_at(const float* __restrict__ m, int64_t s,
                                      int64_t n_shapes, int r, int c) {
  return __ldg(m + (r * 4 + c) * n_shapes + s);
}

// core/vec.py::transform_normal: normalize(n^T M_inv).
__device__ __forceinline__ V3 transform_normal(V3 n,
                                               const float* __restrict__ m,
                                               int64_t s, int64_t n_shapes) {
  auto col = [&](int i) {
    return m_at(m, s, n_shapes, 0, i) * n.x + m_at(m, s, n_shapes, 1, i) * n.y +
           m_at(m, s, n_shapes, 2, i) * n.z;
  };
  return pt::safe_normalize({col(0), col(1), col(2)});
}

// core/vec.py::transform_vector: the 3x3 part of M times v.
__device__ __forceinline__ V3 transform_vector(const float* __restrict__ m,
                                               int64_t s, int64_t n_shapes,
                                               V3 v) {
  auto row = [&](int i) {
    return m_at(m, s, n_shapes, i, 0) * v.x + m_at(m, s, n_shapes, i, 1) * v.y +
           m_at(m, s, n_shapes, i, 2) * v.z;
  };
  return {row(0), row(1), row(2)};
}

// core/sampling.py::compute_tangent_vector.
__device__ __forceinline__ V3 tangent_of(V3 n) {
  const V3 axis = fabsf(n.x) < 0.9f ? V3{1.0f, 0.0f, 0.0f}
                                    : V3{0.0f, 1.0f, 0.0f};
  return pt::safe_normalize(pt::cross(axis, n));
}

template <int MODE, bool STATS>
__global__ void __launch_bounds__(BLOCK)
hit_attributes_kernel(const HitAttributesArgs a) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (!STATS && i >= a.n) return;
  int bin = -1;
  if (i < a.n) {
    const int64_t n = a.n;
    float t = a.time[i];
    int shape = a.shape[i], type = a.shape_type[i];
    V3 mesh_normal = {0.0f, 0.0f, 0.0f};
    float mesh_u = 0.0f, mesh_v = 0.0f;

    // The merge: a winner of the mesh kernel improves the hit.
    if (MODE != HIT_ATTRIBUTES_NONE) {
      int prim = a.primitive[i];
      const int face = a.face[i];
      if (face >= 0) {
        const float fu = a.fu[i], fv = a.fv[i];
        const float fw = 1.0f - fu - fv;
        const float* row = a.attrs + (int64_t)face * 16;
        const float4 r0 = ld4(row), r1 = ld4(row + 4), r2 = ld4(row + 8),
                     r3 = ld4(row + 12);
        // [n0 (0-2) n1 (3-5) n2 (6-8) | uv0 (9-10) uv1 (11-12) uv2 (13-14) |
        //  shape (15)]
        V3 nrm = {fw * r0.x + fu * r0.w + fv * r1.z,
                  fw * r0.y + fu * r1.x + fv * r1.w,
                  fw * r0.z + fu * r1.y + fv * r2.x};
        mesh_u = fw * r2.y + fu * r2.w + fv * r3.y;
        mesh_v = fw * r2.z + fu * r3.x + fv * r3.z;
        if (MODE == HIT_ATTRIBUTES_INST) {
          // The row-vector product with the instance's inverse-world 3x3.
          const float* aux = a.aux + (a.n_aux == 1 ? 0 : (int64_t)a.inst[i]) * 16;
          const float4 x0 = ld4(aux), x1 = ld4(aux + 4), x2 = ld4(aux + 8);
          nrm = {nrm.x * x0.x + nrm.y * x0.w + nrm.z * x1.z,
                 nrm.x * x0.y + nrm.y * x1.x + nrm.z * x1.w,
                 nrm.x * x0.z + nrm.y * x1.y + nrm.z * x2.x};
          shape = (int)x2.y;
        } else {
          shape = (int)r3.w;
        }
        mesh_normal = pt::safe_normalize(nrm);
        t = a.t[i];
        type = TYPE_MESH;
        prim = face;
      }
      a.time_out[i] = t;
      a.shape_out[i] = shape;
      a.shape_type_out[i] = type;
      a.primitive_out[i] = prim;
    }

    const bool valid = shape != SHAPE_INDEX_NONE;
    const int64_t s = valid ? shape : 0;
    a.material_out[i] = valid ? __ldg(a.material + s) : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      a.position[c * n + i] = a.origin[c * n + i] + a.direction[c * n + i] * t;

    V3 normal, tangent;
    float u, v;
    if (type == TYPE_MESH && MODE != HIT_ATTRIBUTES_NONE) {
      normal = mesh_normal;
      u = mesh_u;
      v = mesh_v;
      tangent = tangent_of(normal);
    } else {
      const V3 p = {a.coords[i], a.coords[n + i], a.coords[2 * n + i]};
      if (type == TYPE_MESH) {
        // The portable traversal's hit: the vertex tables' lerp.
        const int64_t prim = a.primitive[i];
        const int64_t nf = a.n_faces, nv = a.n_vertices;
        const int64_t v0 = a.face_vertices[prim],
                      v1 = a.face_vertices[nf + prim],
                      v2 = a.face_vertices[2 * nf + prim];
        const float* vn = a.vertex_normals;
        const float* vt = a.vertex_uvs;
        const V3 lerp = {
            vn[v0] * p.x + vn[v1] * p.y + vn[v2] * p.z,
            vn[nv + v0] * p.x + vn[nv + v1] * p.y + vn[nv + v2] * p.z,
            vn[2 * nv + v0] * p.x + vn[2 * nv + v1] * p.y +
                vn[2 * nv + v2] * p.z};
        u = vt[v0] * p.x + vt[v1] * p.y + vt[v2] * p.z;
        v = vt[nv + v0] * p.x + vt[nv + v1] * p.y + vt[nv + v2] * p.z;
        normal = transform_normal(pt::safe_normalize(lerp),
                                  a.object_from_world, s, a.n_shapes);
        tangent = tangent_of(normal);
      } else {
        V3 n_obj, t_obj;
        if (type == TYPE_PLANE) {
          n_obj = {0.0f, 0.0f, 1.0f};
          t_obj = {1.0f, 0.0f, 0.0f};
          u = p.x - floorf(p.x);
          v = p.y - floorf(p.y);
        } else if (type == TYPE_SPHERE) {
          n_obj = p;
          t_obj = pt::cross(p, V3{-p.y, p.x, 0.0f});
          u = (atan2f(p.y, p.x) + pt::PI) * INV_TAU;
          v = (p.z + 1.0f) * 0.5f;
        } else {
          const float qx = fabsf(p.x), qy = fabsf(p.y), qz = fabsf(p.z);
          const bool ax = qx >= qy && qx >= qz;
          const bool ay = !ax && qy >= qx && qy >= qz;
          const float sx = pt::sign(p.x), sy = pt::sign(p.y),
                      sz = pt::sign(p.z);
          if (ax) {
            n_obj = {sx, 0.0f, 0.0f};
            t_obj = {0.0f, sx, 0.0f};
            u = 0.5f * (1.0f + p.y);
            v = 0.5f * (1.0f + p.z);
          } else if (ay) {
            n_obj = {0.0f, sy, 0.0f};
            t_obj = {0.0f, 0.0f, sy};
            u = 0.5f * (1.0f + p.x);
            v = 0.5f * (1.0f + p.z);
          } else {
            n_obj = {0.0f, 0.0f, sz};
            t_obj = {sz, 0.0f, 0.0f};
            u = 0.5f * (1.0f + p.x);
            v = 0.5f * (1.0f + p.y);
          }
        }
        normal = transform_normal(n_obj, a.object_from_world, s, a.n_shapes);
        tangent = pt::safe_normalize(
            transform_vector(a.world_from_object, s, a.n_shapes, t_obj));
      }
    }
    // Re-orthogonalise (non-uniform instance scales).
    V3 bitangent = pt::cross(normal, tangent);
    tangent = pt::safe_normalize(pt::cross(bitangent, normal));
    bitangent = pt::cross(normal, tangent);

    const V3 rows[3] = {normal, tangent, bitangent};
    float* const outs[3] = {a.normal, a.tangent, a.bitangent};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      outs[k][i] = rows[k].x;
      outs[k][n + i] = rows[k].y;
      outs[k][2 * n + i] = rows[k].z;
    }
    a.uv[i] = u;
    a.uv[n + i] = v;
    if (STATS)
      bin = !valid ? 0 : (type >= TYPE_MESH && type <= TYPE_CUBE ? type + 1 : -1);
  }
  if (STATS) {
    // Summed over the block first: one global atomic a bin a block, not a
    // warp, keeps the counters' cost off the traced round.
    __shared__ unsigned block_bins[BINS];
    if (threadIdx.x < BINS) block_bins[threadIdx.x] = 0;
    __syncthreads();
#pragma unroll
    for (int b = 0; b < BINS; ++b) {
      const unsigned count = __popc(__ballot_sync(0xffffffffu, bin == b));
      if ((threadIdx.x & 31) == 0 && count) atomicAdd(block_bins + b, count);
    }
    __syncthreads();
    if (threadIdx.x < BINS && block_bins[threadIdx.x])
      atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + threadIdx.x),
                (unsigned long long)block_bins[threadIdx.x]);
  }
}

template <int MODE>
void launch(const HitAttributesArgs& a, unsigned grid, cudaStream_t stream) {
  if (a.stats)
    hit_attributes_kernel<MODE, true><<<grid, BLOCK, 0, stream>>>(a);
  else
    hit_attributes_kernel<MODE, false><<<grid, BLOCK, 0, stream>>>(a);
}

}  // namespace

extern "C" void hit_attributes_launch(const HitAttributesArgs* args, int mode,
                                      void* stream) {
  if (args->n <= 0) return;
  const unsigned grid = (unsigned)((args->n + BLOCK - 1) / BLOCK);
  auto* s = (cudaStream_t)stream;
  if (mode == HIT_ATTRIBUTES_INST)
    launch<HIT_ATTRIBUTES_INST>(*args, grid, s);
  else if (mode == HIT_ATTRIBUTES_FLAT)
    launch<HIT_ATTRIBUTES_FLAT>(*args, grid, s);
  else
    launch<HIT_ATTRIBUTES_NONE>(*args, grid, s);
}
