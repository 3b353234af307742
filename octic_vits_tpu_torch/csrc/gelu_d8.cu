// K-gelu-d8: the D8-equivariant GELU on the flat-E tuple, forward and
// backward.
//
// Replaces octic_vits_tpu/ops/pallas_gelu.py:gelu_d8_pallas (`_fwd_kernel`
// :105, `_bwd_kernel` :121).
//
// Math, per token m and channel j < c of x = (a1, a2, b1, b2 [M,c], ef [M,4c]
// = [E11 | E12 | E21 | E22]): the octet (a1, a2, b1, b2, E11, E21, E12, E22)
// at j goes through S (isotypic -> regular), exact-erf GELU, and S^-1 = S^T
// (regular -> isotypic): y = S^T gelu(S x). Backward, with g the cotangent:
// dx = S^T (gelu'(S x) * (S g)), from the saved input alone.
//
// What bounds it on the H100: bytes. On the ViT-H/14 MLP hidden at B=32
// (M = 8224, c = 640) the forward reads and writes 84 MB each way (168 MB),
// the backward reads 168 MB and writes 84 MB, against ~60 FLOP a value.
//
// What the design does about it: one thread owns 8 consecutive channels of
// one token across all eight slots, so each slot is one 16-byte load and one
// 16-byte store (c % 8 == 0) and consecutive threads read consecutive
// addresses; every value is read once and written once, with the two
// butterflies and the GELU in registers (f32, erff and expf).
#include "common.cuh"

namespace ovt {
namespace geld8 {

constexpr int THREADS = 256;

struct Args {
  const bf16* x[8];  // slot pointers at the token's row start, isotypic order
  const bf16* g[8];  // the cotangent, the same layout (backward)
  bf16* y[8];
  int M, c;
};

// slot s of row m in isotypic order (A1, A2, B1, B2, E11, E21, E12, E22):
// the four 1-d arrays, then the E columns 0, 2c, c, 3c of ef
__device__ __forceinline__ size_t slot_off(int s, int m, int c) {
  if (s < 4) return (size_t)m * c;
  const int col[4] = {0, 2, 1, 3};
  return (size_t)m * 4 * c + col[s - 4] * c;
}

template <bool BWD>
__global__ void __launch_bounds__(THREADS) gelu_d8_kernel(const Args a) {
  const int q = a.c >> 3;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)a.M * q) return;
  const int m = (int)(idx / q), j0 = (int)(idx % q) * 8;
  uint4 xr[8], gr[8], yr[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const size_t off = slot_off(s, m, a.c) + j0;
    xr[s] = *reinterpret_cast<const uint4*>(a.x[s] + off);
    if (BWD) gr[s] = *reinterpret_cast<const uint4*>(a.g[s] + off);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {  // channel pairs j0 + 2t, j0 + 2t + 1
    float lo[8], hi[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&xr[s])[t]);
      lo[s] = f.x;
      hi[s] = f.y;
    }
    if (BWD) {
      float glo[8], ghi[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&gr[s])[t]);
        glo[s] = f.x;
        ghi[s] = f.y;
      }
      iso_to_reg(lo);
      iso_to_reg(hi);
      iso_to_reg(glo);
      iso_to_reg(ghi);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        lo[s] = gelu_erf_grad(lo[s]) * glo[s];
        hi[s] = gelu_erf_grad(hi[s]) * ghi[s];
      }
      reg_to_iso(lo);
      reg_to_iso(hi);
    } else {
      gelu_d8_octet(lo);
      gelu_d8_octet(hi);
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) reinterpret_cast<uint32_t*>(&yr[s])[t] = pack_bf16x2(lo[s], hi[s]);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s)
    *reinterpret_cast<uint4*>(a.y[s] + slot_off(s, m, a.c) + j0) = yr[s];
}

}  // namespace geld8
}  // namespace ovt

// x0..x3 [M,c], xef [M,4c] bf16; g0..g3, gef the cotangent (backward) or
// null; y0..y3, yef the output (forward) or the input gradient (backward).
// c % 8 == 0, every pointer 16-byte aligned (checked by the Python wrapper).
OVT_EXPORT int ovt_gelu_d8(const void* x0, const void* x1, const void* x2, const void* x3,
                           const void* xef, const void* g0, const void* g1, const void* g2,
                           const void* g3, const void* gef, void* y0, void* y1, void* y2,
                           void* y3, void* yef, int M, int c, int bwd, void* stream) {
  using namespace ovt::geld8;
  using ovt::bf16;
  const void* xs[5] = {x0, x1, x2, x3, xef};
  const void* gs[5] = {g0, g1, g2, g3, gef};
  void* ys[5] = {y0, y1, y2, y3, yef};
  Args a;
  for (int s = 0; s < 8; ++s) {  // E slots share the ef base; slot_off adds the column
    const int i = s < 4 ? s : 4;
    a.x[s] = static_cast<const bf16*>(xs[i]);
    a.g[s] = static_cast<const bf16*>(gs[i]);
    a.y[s] = static_cast<bf16*>(ys[i]);
  }
  a.M = M;
  a.c = c;
  const long long n = (long long)M * (c / 8);
  const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bwd) gelu_d8_kernel<true><<<grid, THREADS, 0, s>>>(a);
  else gelu_d8_kernel<false><<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
