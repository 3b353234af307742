// K-lin-d8-bwd: the linear transpose and the weight gradients of the
// block-diagonal D8 qkv map, the last of the three launches of the backward
// of the fused octic qkv + attention (ops/attention.py:
// octic_attention_fused_qkv_bwd; the first two recompute the qkv with
// K-lin-d8 and run K-attn-bwd on it).
//
// Replaces octic_vits_tpu/ops/pallas_attention.py:_octic_qkv_attn_bwd_kernel
// (called by _fused_bwd_kernel_call, the custom VJP _fused_bwd_rule of
// octic_attention_fused_qkv): the part of that TPU kernel after the
// attention backward, which folds dx and the f32 weight-gradient sums in.
// Also the backward of the packed variant (pallas_attention.py:
// _fused_packed_bwd_rule): x_g and ef are then column views of one packed
// [M, C] container and dx lands in place in one packed [M, C] gradient,
// through the row strides ldx, ldxe (inputs) and ldd, ldde (dx).
//
// Math, for tokens m < M (x_g [M,C], ef [M,4C] = [row0 | row1], the qkv
// cotangents dq_g [M,F] and de_r [M,2F], w1 [4,C,F], we [2C,2F]):
//   dx_g[m]    = dq_g[m] . w1[g]^T              (K = F)
//   def[m]     = [de_0[m] . we^T | de_1[m] . we^T]   (K = 2F)
//   dw1[g]     = sum_m x_g[m]^T dq_g[m]
//   dwe        = sum_r sum_m row_r[m]^T de_r[m]
//   dbias      = sum_m dq_0[m]                  (the A1 bias, when present)
// bf16 operands, f32 accumulation; dx and the weight gradients are written in
// bf16 (the weights' dtype), as _fused_bwd_kernel_call returns them.
//
// What bounds it on the H100: at hybrid ViT-L/16 global crops (M = 64 * 197
// = 12608, C = 128, F = 384) dx and dW are 72 M C^2 FLOP each, 29.7 GFLOP
// together (30 us at 989 TFLOP/s); it reads x (25.8 MB) and dqkv (77.5 MB)
// and writes dx (25.8 MB), 129 MB or 39 us at 3.35 TB/s. Memory-bound, ~40 us,
// with the tensor cores close behind; the operand traffic from L2 into the
// SMs (each 128 x 128 tile reads its rows and columns of the operands) is
// ~3.6x the HBM bytes.
//
// What the design does about it (csrc/lin_d8_bwd_sm90.cuh):
//   - one persistent launch, one CTA an SM, a producer warp keeping TMA
//     loads in flight through a 6-stage ring of 64-wide k blocks, two consumer
//     warpgroups on m64n128k16 wgmma from shared memory (setmaxnreg 40/232);
//   - the work is cut into units of one 128 x 128 output tile each: dx units
//     (128 tokens x 128 input channels of one 1-d slot or E row, K = F or 2F,
//     written by TMA stores through the output row strides) and dW units
//     (128 x 128 of one weight gradient over the tokens of one slab, K = the
//     slab; x and dq are both token-major, so the product sets the transpose
//     bit on A and B, wgmma_ss_tt, and nothing is transposed in memory);
//   - the token axis is cut into `slabs` slabs of whole 128-token tiles, each
//     slab's dq small enough to stay in L2 (ops/linear.py:BWD_SLAB_BYTES); a
//     CTA walks its units slab by slab, so a slab's dq crosses HBM once for
//     its dx and dW units together;
//   - which CTA takes which unit is the launch plan's (ops/linear.py:
//     lin_d8_bwd_plan, a table in device memory): per slab, the longest units
//     first, each to the least-loaded CTA;
//   - each dW unit writes an f32 partial of its slab (the A1 units of the
//     first channel tile also sum dq_0 for dbias), and a second launch sums
//     them in slab order and rounds to bf16. No atomics, so the result is
//     bitwise the same whatever the schedule.
// The dx and dW products of a token tile are separate units: a unit holding
// both would need the E row's 2F-wide dW accumulators beside the dx ones.
#include "lin_d8_bwd_sm90.cuh"

namespace {

using namespace ovt::lind8bwd;

// a 2-D map over rows of `cols` bf16 values (row stride ld elements), 128-byte swizzle
int map2(CUtensorMap* m, const void* p, int cols, int rows, int ld, int box0, int box1) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * 2};
  const uint32_t box[2] = {(uint32_t)box0, (uint32_t)box1};
  return ovt::encode_bf16_map(m, p, 2, dims, strides, box, 128);
}

}  // namespace

// x0..x3 [M,C] (row stride ldx), xef [M,4C] (ldxe), w1 [4,C,F], we [2C,2F],
// dq0..dq3 [M,F], de0, de1 [M,2F] -> dx0..dx3 [M,C] (ldd), dxef [M,4C]
// (ldde), dw1 [4,C,F], dwe [2C,2F], dbias [F] (null: no bias). All bf16 with
// unit channel stride, every start 16-byte aligned, the row strides
// multiples of 8, dq and de contiguous, C % 8 == 0 and F % 8 == 0 (checked by
// the Python wrapper). The launch plan (ops/linear.py:lin_d8_bwd_plan):
// `table` (int32 in device memory: grid + 1 unit offsets, then `units` int4
// units from index `units_at`), `grid` persistent CTAs, `slabs` slabs of
// `slab_tokens` tokens and `smem` bytes, which must be this kernel's;
// `scratch` holds slabs * (tiles * 128 * 128 + 4 * 128 ceil(F / 128)) f32.
// Returns the cudaError_t of the launches or an ERR_* code.
OVT_EXPORT int ovt_lin_d8_bwd(const void* x0, const void* x1, const void* x2, const void* x3,
                              const void* xef, const void* w1, const void* we, const void* dq0,
                              const void* dq1, const void* dq2, const void* dq3, const void* de0,
                              const void* de1, void* dx0, void* dx1, void* dx2, void* dx3,
                              void* dxef, void* dw1, void* dwe, void* dbias, void* scratch,
                              const void* table, int M, int C, int F, int ldx, int ldxe, int ldd,
                              int ldde, int grid, int slabs, int slab_tokens, int units,
                              int units_at, int smem, void* stream) {
  using ovt::bf16;
  Args a = {};
  a.M = M;
  a.c = C;
  a.F = F;
  a.ni1 = (C + BM - 1) / BM;
  a.nj1 = (F + BN - 1) / BN;
  a.nie = (2 * C + BM - 1) / BM;
  a.nje = (2 * F + BN - 1) / BN;
  const int tiles = 4 * a.ni1 * a.nj1 + 2 * a.nie * a.nje;
  const int m_tiles = (M + BM - 1) / BM;
  const int dx_units = m_tiles * (4 * a.ni1 + 2 * a.nie);
  if (smem != SMEM_BYTES || grid < 1 || slab_tokens < BM || slab_tokens % BM != 0 ||
      slabs != (M + slab_tokens - 1) / slab_tokens || units != slabs * tiles + dx_units ||
      grid > units || units_at < grid + 1 || units_at % 4 != 0)
    return ovt::ERR_PLAN;
  a.table = static_cast<const int*>(table);
  a.part = static_cast<float*>(scratch);
  a.slab_stride = (long long)tiles * TILE + BIAS_PARTS * a.nj1 * BN;
  a.slab_tokens = slab_tokens;
  a.units_at = units_at;
  a.bias = dbias != nullptr;

  Maps maps = {};
  const void* xs[4] = {x0, x1, x2, x3};
  const void* dqs[4] = {dq0, dq1, dq2, dq3};
  const void* des[2] = {de0, de1};
  void* dxs[4] = {dx0, dx1, dx2, dx3};
  int err = 0;
  for (int g = 0; g < 4 && err == 0; ++g) err = map2(&maps.dq[g], dqs[g], F, M, F, 64, 64);
  for (int r = 0; r < 2 && err == 0; ++r) err = map2(&maps.de[r], des[r], 2 * F, M, 2 * F, 64, 64);
  for (int g = 0; g < 4 && err == 0; ++g) err = map2(&maps.x[g], xs[g], C, M, ldx, 64, 64);
  for (int r = 0; r < 2 && err == 0; ++r)
    err = map2(&maps.xe[r], static_cast<const bf16*>(xef) + r * 2 * C, 2 * C, M, ldxe, 64, 64);
  if (err == 0) {
    const uint64_t dims[3] = {(uint64_t)F, (uint64_t)C, 4};
    const uint64_t strides[2] = {(uint64_t)F * 2, (uint64_t)C * F * 2};
    const uint32_t box[3] = {64, BN, 1};
    err = ovt::encode_bf16_map(&maps.w1, w1, 3, dims, strides, box, 128);
  }
  if (err == 0) err = map2(&maps.we, we, 2 * F, 2 * C, 2 * F, 64, BN);
  for (int g = 0; g < 4 && err == 0; ++g) err = map2(&maps.dx[g], dxs[g], C, M, ldd, 64, 64);
  if (err == 0) {
    const uint64_t dims[3] = {(uint64_t)(2 * C), 2, (uint64_t)M};
    const uint64_t strides[2] = {(uint64_t)C * 4, (uint64_t)ldde * 2};
    const uint32_t box[3] = {64, 1, 64};
    err = ovt::encode_bf16_map(&maps.dxe, dxef, 3, dims, strides, box, 128);
  }
  if (err != 0) return err;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static const cudaError_t attr = cudaFuncSetAttribute(
      lin_d8_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  lin_d8_bwd_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(maps, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long threads = (long long)(4 * a.ni1 * a.nj1 + a.nie * a.nje) * (TILE / 4) +
                            (dbias != nullptr ? F : 0);
  reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      a, slabs, static_cast<bf16*>(dw1), static_cast<bf16*>(dwe), static_cast<bf16*>(dbias));
  return cudaGetLastError();
}
