// K-lin-d8: block-diagonal D8-equivariant linear map over the flat-E tuple,
// with an optional D8-GELU epilogue or LayerScale + residual epilogue.
//
// Replaces the block-diagonal products of
//   octic_vits_tpu/ops/pallas_linear.py:linear_d8_fused (`_kernel`, with
//     `use_epilogue` :95-105): the train path's octic fc1 (GELU epilogue) and
//     fc2, and the proj and fc2 of `fuse_block_epilogues`, which write
//     y = r + ls * linear(x); its backward is plain torch (ops/linear.py);
//   octic_vits_tpu/ops/pallas_mlp_branch.py:mlp_branch_d8 (`_mlp_branch_kernel`,
//     its fc1 + GELU and its fc2 + LayerScale + residual; ops/mlp_branch.py);
//   octic_vits_tpu/ops/pallas_linear.py:mlp_d8_fused (`_mlp_kernel`): fc1
//     with the GELU epilogue, then fc2 (two launches here);
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention_fused_qkv
//     (`_octic_qkv_attn_kernel`, its qkv half): the qkv 5-tuple, no epilogue;
//   the packed-container variants of the last two,
//     pallas_attention.py:octic_attention_fused_qkv_packed
//     (`_octic_qkv_attn_kernel_packed`) and
//     pallas_linear.py:mlp_d8_fused_packed (`_mlp_kernel_packed`): the five
//     inputs are column views of ONE packed [M, C] container
//     [A1|A2|B1|B2|E row0|E row1] (x_g at column g C, ef at 4C, row stride 8C)
//     and the MLP's fc2 writes the packed [M, 8F] output in place, through the
//     row strides below. The TPU kernels slice the views in VMEM; here each
//     view is read in place from HBM and nothing is copied;
//   octic_vits_tpu/ops/pallas_linear.py:linear_d8_qkv_wide (`_wide_kernel`):
//     the qkv 5-tuple stored as ONE [M, 3C'] output whose columns are
//     (s, head, [a1|a2|b1|b2|e0|e1]) (C' = 8F/3), so the wide attention
//     gathers each head as one slice;
//   the wide-1d qkv of octic_vits_tpu/layers/d8_layers.py:AttentionD8
//     (`use_wide_qkv`, :950-989, a column-permuted block-diagonal XLA dot
//     there): the four 1-d outputs stored as ONE [M, 4F] buffer with columns
//     (s, head, [a1|a2|b1|b2], d1), the E output as usual.
//   Both are grouped-column stores in the epilogue: output column j of a 1-d
//   irrep goes to (j / g1) * s1 + j % g1 of its base pointer, column j of an
//   E row's [e_r1 | e_r2] to (j / ge) * se + j % ge (the plain layout is g1 =
//   F, ge = 2F). The grouped stores are bf16x2 stores (2-byte ones for odd
//   groups), so the wide layouts' 20-byte groups need no 16-byte alignment.
//
// Math, for every token m and output channel j < F (x_g [M,C] with row stride
// ldx, ef [M,4C] = [row0 | row1] with row stride ldxe, w1 [4,C,F], we [2C,2F],
// A1 bias [F]; the outputs y_g with row stride ldy, the E rows' outputs ye_r
// with ldye; in the plain layout y_g [M,F] and ye_0, ye_1 the two halves of
// yef [M,4F]):
//   y_g[m,j]  = x_g[m,:] . w1[g][:,j]         (+ bias[j] for g = 0, A1)
//   e11 = row0 . we[:,j]    e12 = row0 . we[:,F+j]
//   e21 = row1 . we[:,j]    e22 = row1 . we[:,F+j]
//   ye_0[m] = [e11 | e12],  ye_1[m] = [e21 | e22]
// With the GELU epilogue the octet (a1,a2,b1,b2,e11,e21,e12,e22) of each
// (m, j) goes through the isotypic->regular butterfly, erf GELU and back.
// With the LayerScale epilogue (ls1 [4,F], lse [2F], residual r [M,F] x 4 and
// ref [M,4F]): y_g = r_g + ls1[g] * y_g, yef = ref + [lse | lse] * yef, in
// f32 before the one store. The two epilogues exclude each other.
//
// What bounds it on the H100: at ViT-H/14, B=64 (M = 16448, C = 160) the
// MLP fc1 (F = 640) is 40.4 GFLOP and writes a 168 MB bf16 hidden; fc2 reads
// it back. About 200 FLOP per byte: near the card's ridge, so both the
// tensor cores and HBM matter; the qkv (F = 480) is the same shape class.
//
// Each output tile reads its A rows (x and the E rows, 8C values a token)
// and its weight columns (8C a channel) from L2, so the tile's shape, not
// the tensor cores, sets the on-chip traffic: a 64 x 32 tile moves 0.95 GB
// through L2 for the qkv at H/14 B=64, a 64 x 64 tile 0.67 GB.
//
// What the design does about it (csrc/lin_d8_sm90.cuh): a persistent CTA
// an SM walks 64-token x 64-channel tiles ACROSS ALL EIGHT SLOTS, one
// M-tile's channel tiles in a row (the A rows stay in L2). A producer warp
// issues TMA loads into a 3-stage ring of 32-wide k blocks: 6 A boxes (x_a1..
// x_b2, E row 0, E row 1; 64B swizzle) and 12 B boxes (w1[0..3], we[:, j],
// we[:, F + j], each in two 32-channel halves; the weights are [C, F]
// row-major, so B is MN-major and the wgmmas set the transpose bit); the k
// blocks past C carry only the 2 E rows and the 4 we boxes. Two consumer
// warpgroups take the two 32-channel halves and share the A boxes: each holds
// all eight m64n32 products of its half in registers (128 f32 a thread, under
// setmaxnreg), so a thread holds the whole octet of each of its (m, j): the
// bias, the D8-GELU butterfly and the LayerScale + residual run on the
// accumulators, with no f32 staging pass. The bf16 results are staged once
// in shared memory (64B swizzle) and leave by TMA store, one box a product
// (the tuple store, rows and channels past the arrays clipped), or, for the
// grouped-column maps, whose 20- and 40-byte runs no TMA box can hold, by
// bf16x2 stores of consecutive channel pairs from consecutive threads. The
// producer runs ahead into the next tile while the consumers' epilogue runs.
// The launch plan is ops/linear.py:lin_d8_plan, checked here (ERR_PLAN).
// The hidden still round-trips HBM between fc1 and fc2 (the TPU kernel keeps
// it in VMEM). The mma.sync core that ran here before (csrc/lin_d8_core.cuh)
// stays for the tile probes and as the parent yardstick
// (csrc/lin_d8_probe.cu:ovt_lin_d8_sync).
#include "lin_d8_sm90.cuh"

namespace {

using namespace ovt::lind8w;

template <int EPI, bool GROUPED>
int run(const Maps& maps, const Args& a, int grid, cudaStream_t s) {
  static const cudaError_t err = cudaFuncSetAttribute(
      lin_d8_kernel<EPI, GROUPED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  lin_d8_kernel<EPI, GROUPED><<<grid, THREADS, SMEM_BYTES, s>>>(maps, a);
  return cudaGetLastError();
}

// a 2-D map over rows of `cols` bf16 values (row stride ld elements)
int map2(CUtensorMap* m, const void* p, int cols, int rows, int ld, int box0, int box1) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * 2};
  const uint32_t box[2] = {(uint32_t)box0, (uint32_t)box1};
  return ovt::encode_bf16_map(m, p, 2, dims, strides, box, 64);
}

}  // namespace

// x0..x3 [M,C] (row stride ldx), xef [M,4C] (ldxe), w1 [4,C,F], we [2C,2F],
// bias [F] or null; the outputs y0..y3 (row stride ldy) and ye0, ye1 (ldye)
// with the grouped-column maps (g1, s1) and (ge, se) of the header (the
// plain layout: y_g [M,F], ye0 and ye1 the halves of yef [M,4F], g1 = F, ge
// = 2F); the LayerScale epilogue's ls1 [4,F], lse [2F], r0..r3 [M,F] and ref
// [M,4F] (contiguous), or all null; all bf16 with unit channel stride, every
// view's start and row stride 16-byte aligned (the plain layout's outputs
// too; the grouped ones 4-byte aligned for pairs), C % 8 == 0 and F % 8 == 0
// (checked by the Python wrapper). The launch plan (ops/linear.py:
// lin_d8_plan): `grid` persistent CTAs and `smem` bytes, which must be this
// kernel's. Returns the cudaError_t of the launch or an ERR_* code.
OVT_EXPORT int ovt_lin_d8(const void* x0, const void* x1, const void* x2, const void* x3,
                          const void* xef, const void* w1, const void* we, const void* bias,
                          void* y0, void* y1, void* y2, void* y3, void* ye0, void* ye1,
                          const void* ls1, const void* lse, const void* r0, const void* r1,
                          const void* r2, const void* r3, const void* ref, int M, int C, int F,
                          int gelu, int ldx, int ldxe, int ldy, int ldye, int g1, int s1, int ge,
                          int se, int grid, int smem, void* stream) {
  using ovt::bf16;
  if (g1 <= 0 || ge <= 0 || (gelu && ls1 != nullptr)) return cudaErrorInvalidValue;
  Args a = {};
  a.MT = (M + BM - 1) / BM;
  a.NT = (F + BN - 1) / BN;
  a.KT1 = (C + BK - 1) / BK;
  a.KTE = (2 * C + BK - 1) / BK;
  if (smem != SMEM_BYTES || grid < 1 || grid > a.MT * a.NT) return ovt::ERR_PLAN;
  // the plain layout keeps the TMA store; the others take the grouped store
  const bool grouped = !(g1 >= F && ge >= 2 * F);
  if (grouped && (gelu || ls1 != nullptr)) return cudaErrorInvalidValue;
  a.bias = static_cast<const bf16*>(bias);
  a.ls1 = static_cast<const bf16*>(ls1);
  a.lse = static_cast<const bf16*>(lse);
  const void* rs[4] = {r0, r1, r2, r3};
  void* ys[4] = {y0, y1, y2, y3};
  const void* xs[4] = {x0, x1, x2, x3};
  for (int g = 0; g < 4; ++g) {
    a.r[g] = static_cast<const bf16*>(rs[g]);
    a.y[g] = static_cast<bf16*>(ys[g]);
  }
  a.ref = static_cast<const bf16*>(ref);
  a.ye[0] = static_cast<bf16*>(ye0);
  a.ye[1] = static_cast<bf16*>(ye1);
  a.g1 = g1;
  a.s1 = s1;
  a.ge = ge;
  a.se = se;
  a.M = M;
  a.C = C;
  a.F = F;
  a.ldy = ldy;
  a.ldye = ldye;
  a.pairs = g1 % 2 == 0 && ge % 2 == 0 && s1 % 2 == 0 && se % 2 == 0 && ldy % 2 == 0 &&
            ldye % 2 == 0;
  for (int g = 0; g < 4; ++g) a.pairs = a.pairs && reinterpret_cast<uintptr_t>(ys[g]) % 4 == 0;
  a.pairs = a.pairs && reinterpret_cast<uintptr_t>(ye0) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(ye1) % 4 == 0;

  Maps maps = {};
  int err = 0;
  for (int g = 0; g < 4 && err == 0; ++g) err = map2(&maps.a[g], xs[g], C, M, ldx, BK, BM);
  if (err == 0) err = map2(&maps.a[4], xef, 2 * C, M, ldxe, BK, BM);
  if (err == 0)
    err = map2(&maps.a[5], static_cast<const bf16*>(xef) + 2 * C, 2 * C, M, ldxe, BK, BM);
  if (err == 0) {
    const uint64_t dims[3] = {(uint64_t)F, (uint64_t)C, 4};
    const uint64_t strides[2] = {(uint64_t)F * 2, (uint64_t)C * F * 2};
    const uint32_t box[3] = {BNW, BK, 1};
    err = ovt::encode_bf16_map(&maps.w1, w1, 3, dims, strides, box, 64);
  }
  if (err == 0) err = map2(&maps.we, we, 2 * F, 2 * C, 2 * F, BNW, BK);
  if (ls1 != nullptr) {  // the residual, prefetched into the staging: r_g [M, F], ref [M, 4F]
    for (int g = 0; g < 4 && err == 0; ++g) err = map2(&maps.r[g], rs[g], F, M, F, BNW, BM);
    if (err == 0) {
      const uint64_t dims[3] = {(uint64_t)F, 4, (uint64_t)M};
      const uint64_t strides[2] = {(uint64_t)F * 2, (uint64_t)F * 8};
      const uint32_t box[3] = {BNW, 1, BM};
      err = ovt::encode_bf16_map(&maps.ref, ref, 3, dims, strides, box, 64);
    }
  }
  if (!grouped) {
    for (int g = 0; g < 4 && err == 0; ++g) err = map2(&maps.y[g], ys[g], F, M, ldy, BNW, BM);
    void* yes[2] = {ye0, ye1};
    for (int r = 0; r < 2 && err == 0; ++r) {
      const uint64_t dims[3] = {(uint64_t)F, 2, (uint64_t)M};
      const uint64_t strides[2] = {(uint64_t)F * 2, (uint64_t)ldye * 2};
      const uint32_t box[3] = {BNW, 1, BM};
      err = ovt::encode_bf16_map(&maps.ye[r], yes[r], 3, dims, strides, box, 64);
    }
  }
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grouped) return run<NONE, true>(maps, a, grid, s);
  if (gelu) return run<GELU, false>(maps, a, grid, s);
  if (ls1 != nullptr) return run<LS, false>(maps, a, grid, s);
  return run<NONE, false>(maps, a, grid, s);
}
