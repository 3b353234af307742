// Shared device helpers for the octic_vits_tpu_torch kernels (sm_90a).
//
// The matrix products use the warp-level `mma.sync.m16n8k16` bf16 tensor-core
// instruction with f32 accumulators, fed from shared memory by `ldmatrix`;
// tiles are staged with `cp.async` (16-byte chunks, zero-filled at ragged
// edges). Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (row g, k 2t..2t+1), a1 = (row g+8, k 2t..),
//                         a2 = (row g, k 2t+8..),   a3 = (row g+8, k 2t+8..)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, col g), b1 = (k 2t+8.., col g)
//   C (16x8, f32):        c0,c1 = (row g, cols 2t, 2t+1), c2,c3 = (row g+8, ..)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; `valid == false` writes 16 zero bytes
// (src-size 0) so ragged tiles need no separate clearing pass.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// c += a * b for one m16n8k16 tile (bf16 inputs, f32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half: the element
// with the smaller column index, as the fragments expect).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the unsigned type of V bf16 elements: the vector load of V elements
template <int V>
struct VecOf;
template <>
struct VecOf<8> {
  typedef uint4 T;
};
template <>
struct VecOf<4> {
  typedef uint2 T;
};
template <>
struct VecOf<2> {
  typedef uint32_t T;
};
template <>
struct VecOf<1> {
  typedef unsigned short T;
};

// exact-erf GELU (the plain versions use torch.erf; erff is within 2 ulp).
__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// d/du of gelu_erf: Phi(u) + u phi(u).
__device__ __forceinline__ float gelu_erf_grad(float u) {
  return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) +
         u * 0.39894228040143268f * expf(-0.5f * u * u);
}

// The isotypic -> regular butterfly on one octet, in place: slot order
// (A1, A2, B1, B2, E11, E21, E12, E22) in, the eight regular coordinates out.
// Same arithmetic as octic_vits_tpu/d8/group.py:isotypic_to_regular.
__device__ __forceinline__ void iso_to_reg(float (&v)[8]) {
  const float c = 0.35355339059327376f;  // sqrt(2) / 4
  const float s0 = v[0] + v[1], d0 = v[0] - v[1];
  const float s1 = v[2] + v[3], d1 = v[2] - v[3];
  const float s2 = v[4] + v[5], d2 = v[4] - v[5];
  const float s3 = v[6] + v[7], d3 = v[6] - v[7];
  const float u0 = s0 + s1, v0 = s0 - s1;
  const float u1 = d0 + d1, v1 = d0 - d1;
  const float u2 = s2 + d3, v2 = s2 - d3;
  const float u3 = d2 + s3, v3 = d2 - s3;
  v[0] = c * (u0 + u2);
  v[1] = c * (v0 + v3);
  v[2] = c * (u0 - u2);
  v[3] = c * (v0 - v3);
  v[4] = c * (u1 - u3);
  v[5] = c * (v1 - v2);
  v[6] = c * (u1 + u3);
  v[7] = c * (v1 + v2);
}

// The regular -> isotypic butterfly (the inverse, = the transpose), in place.
// Same arithmetic as octic_vits_tpu/d8/group.py:regular_to_isotypic.
__device__ __forceinline__ void reg_to_iso(float (&v)[8]) {
  const float c = 0.35355339059327376f;
  const float s0 = v[0] + v[1], d0 = v[0] - v[1];
  const float s1 = v[2] + v[3], d1 = v[2] - v[3];
  const float s2 = v[4] + v[5], d2 = v[4] - v[5];
  const float s3 = v[6] + v[7], d3 = v[6] - v[7];
  const float u0 = s0 + s1, v0 = s1 - s0;
  const float u1 = d0 + d1, w1 = d0 - d1;
  const float u2 = s2 + s3, v2 = s3 - s2;
  const float u3 = d2 + d3, w3 = d2 - d3;
  v[0] = c * (u0 + u2);
  v[1] = c * (u0 - u2);
  v[2] = c * (u1 + u3);
  v[3] = c * (u1 - u3);
  v[4] = c * (v2 - v0);
  v[5] = c * (w1 + w3);
  v[6] = c * (w1 - w3);
  v[7] = c * (v2 + v0);
}

// D8 GELU on one (token, channel) octet in isotypic slot order
// (A1, A2, B1, B2, E11, E21, E12, E22): isotypic -> regular butterfly,
// pointwise GELU, regular -> isotypic butterfly.
__device__ __forceinline__ void gelu_d8_octet(float (&v)[8]) {
  iso_to_reg(v);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = gelu_erf(v[i]);
  reg_to_iso(v);
}

}  // namespace ovt

#define OVT_EXPORT extern "C" __attribute__((visibility("default")))
