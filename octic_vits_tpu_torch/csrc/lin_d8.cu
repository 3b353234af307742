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
//   F, ge = 2F). The stores are 2-byte stores, so the wide layouts' 20-byte
//   groups need no 16-byte alignment; only the inputs are read with cp.async.
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
// What the design does about it: one CTA owns a 64-token x 32-channel tile
// ACROSS ALL EIGHT SLOTS, so the D8-GELU octet of each (m, j) meets in one
// CTA and the epilogue needs no second pass over HBM. 8 warps: warp w
// computes half the rows of 1-d slot w/2 (K = C) and of E slot w/2 (K = 2C),
// which balances the 1-d and E work exactly. Operands (6 A tiles and 6 B
// tiles a stage) are staged with a 2-stage cp.async pipeline; m16n8k16 bf16
// MMAs accumulate in f32; the accumulators go through shared memory once
// for the epilogue. The hidden still round-trips HBM between fc1 and fc2
// (the TPU kernel keeps it in VMEM): fusing the two launches is the first
// perf item in ROADMAP.md.
// The device code is in csrc/lin_d8_core.cuh, which csrc/lin_d8_probe.cu
// (the tile sweep) shares.
#include "lin_d8_core.cuh"

// x0..x3 [M,C] (row stride ldx), xef [M,4C] (ldxe), w1 [4,C,F], we [2C,2F],
// bias [F] or null; the outputs y0..y3 (row stride ldy) and ye0, ye1 (ldye)
// with the grouped-column maps (g1, s1) and (ge, se) of the header (the
// plain layout: y_g [M,F], ye0 and ye1 the halves of yef [M,4F], g1 = F, ge
// = 2F); the LayerScale epilogue's ls1 [4,F], lse [2F], r0..r3 [M,F] and ref
// [M,4F] (contiguous), or all null; all bf16 with unit channel stride, every
// input's start 16-byte aligned, ldx and ldxe multiples of 8, C % 8 == 0 and
// F % 8 == 0 (checked by the Python wrapper).
OVT_EXPORT int ovt_lin_d8(const void* x0, const void* x1, const void* x2, const void* x3,
                          const void* xef, const void* w1, const void* we, const void* bias,
                          void* y0, void* y1, void* y2, void* y3, void* ye0, void* ye1,
                          const void* ls1, const void* lse, const void* r0, const void* r1,
                          const void* r2, const void* r3, const void* ref, int M, int C, int F,
                          int gelu, int ldx, int ldxe, int ldy, int ldye, int g1, int s1, int ge,
                          int se, void* stream) {
  using namespace ovt::lind8;
  using ovt::bf16;
  constexpr int BM = 64, BN = 32;  // the model paths' tile
  Args a;
  a.x[0] = static_cast<const bf16*>(x0);
  a.x[1] = static_cast<const bf16*>(x1);
  a.x[2] = static_cast<const bf16*>(x2);
  a.x[3] = static_cast<const bf16*>(x3);
  a.xef = static_cast<const bf16*>(xef);
  a.w1 = static_cast<const bf16*>(w1);
  a.we = static_cast<const bf16*>(we);
  a.bias = static_cast<const bf16*>(bias);
  a.y[0] = static_cast<bf16*>(y0);
  a.y[1] = static_cast<bf16*>(y1);
  a.y[2] = static_cast<bf16*>(y2);
  a.y[3] = static_cast<bf16*>(y3);
  a.ye[0] = static_cast<bf16*>(ye0);
  a.ye[1] = static_cast<bf16*>(ye1);
  if (g1 <= 0 || ge <= 0) return cudaErrorInvalidValue;
  a.g1 = g1;
  a.s1 = s1;
  a.ge = ge;
  a.se = se;
  a.ls1 = static_cast<const bf16*>(ls1);
  a.lse = static_cast<const bf16*>(lse);
  a.r[0] = static_cast<const bf16*>(r0);
  a.r[1] = static_cast<const bf16*>(r1);
  a.r[2] = static_cast<const bf16*>(r2);
  a.r[3] = static_cast<const bf16*>(r3);
  a.ref = static_cast<const bf16*>(ref);
  if (gelu && ls1 != nullptr) return cudaErrorInvalidValue;
  a.M = M;
  a.C = C;
  a.F = F;
  a.ldx = ldx;
  a.ldxe = ldxe;
  a.ldy = ldy;
  a.ldye = ldye;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the plain layout keeps the store without the column tables
  const bool grouped = !(g1 >= F && ge >= 2 * F);
  if (grouped && gelu) return cudaErrorInvalidValue;
  return gelu ? launch<true, false, BM, BN>(a, s)
              : grouped ? launch<false, true, BM, BN>(a, s) : launch<false, false, BM, BN>(a, s);
}
