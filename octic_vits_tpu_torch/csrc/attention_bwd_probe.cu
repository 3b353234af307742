// Probes of the octic attention backward (kernel row 14c): K-attn-bwd
// (csrc/attention_bwd_core.cuh) with one of its tables swapped, so that the
// difference of two times is the cost of one part of the shipped kernel.
//
// Replaces
//   scripts/r3_attn_bwd_ablate.py:k_octic_bwd_widestore (call :795): the
//     octic backward whose dq, dk, dv are stored per (s, head) contiguously
//     into one [B,N,3C] (columns (3, H, [a1|a2|b1|b2|e0|e1]), row 13's qkv
//     layout) instead of being scattered into the six irrep arrays at d1- and
//     de-wide granularity: the scatter tax;
//   scripts/r3_attn_bwd_ablate.py:k_octic_bwd_wideg (call :812): the octic
//     backward whose cotangent arrives pre-assembled, one [B,N,C] in per-head
//     [a1|a2|b1|b2|e0|e1] order, instead of six arrays: the g-assembly tax.
// What bounds them on the H100 is what bounds K-attn-bwd (csrc/attention_bwd.cu):
// 10 b n^2 c products over 7 b n c bf16 values, below the card's ridge; the
// probes change only where the bytes come from and go to. Each is K-attn-bwd
// with its gradient table (wide-store: one segment of dh channels a head) or
// its cotangent table (wide-g: one segment) set to the wide layout; every
// other line of device code is the shipped kernel's.
#include "attention_bwd_core.cuh"

using namespace ovt::attn_bwd;

namespace {

void set_octic_qkv(Args& A, const void* const* ins, const int* lq, void* const* ds, int H, int d1,
                   int de) {
  A.qkv.nseg = 6;
  for (int i = 0; i < 6; ++i) set_qkv_3h(A, i, ins[i], lq[i], ds ? ds[i] : nullptr,
                                         i < 4 ? d1 : de, H);
}

}  // namespace

// The octic qkv (q1..q4 [B,N,3*H*d1], e0, e1 [B,N,3*H*de], each with its own
// token row stride) and the six cotangents (as ovt_attention_octic_bwd_sync) ->
// dwide [B,N,3*H*dh] contiguous, head h of s at column (s*H + h)*dh, its dh
// channels in the order a1|a2|b1|b2|e0|e1. lse and dsum f32 scratch [B,H,N].
OVT_EXPORT int ovt_attention_octic_bwd_widestore(
    const void* q1, const void* q2, const void* q3, const void* q4, const void* e0,
    const void* e1, int lq1, int lq2, int lq3, int lq4, int le0, int le1, const void* g1,
    const void* g2, const void* g3, const void* g4, const void* ge0, const void* ge1, int lg1,
    int lg2, int lg3, int lg4, int lge0, int lge1, void* dwide, void* lse, void* dsum, int B,
    int N, int H, int d1, int de, void* stream) {
  Args A = {};
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lq[6] = {lq1, lq2, lq3, lq4, le0, le1};
  set_octic_qkv(A, ins, lq, nullptr, H, d1, de);
  const int dh = 4 * d1 + 2 * de;
  A.d_nseg = 1;
  A.d_width[0] = A.d_hs[0] = dh;
  for (int s = 0; s < 3; ++s) {
    A.d[0][s] = static_cast<ovt::bf16*>(dwide) + (size_t)s * H * dh;
    A.d_ld[0][s] = 3 * H * dh;
  }
  const void* const gs[6] = {g1, g2, g3, g4, ge0, ge1};
  const int lg[6] = {lg1, lg2, lg3, lg4, lge0, lge1};
  set_octic_g(A, gs, lg, d1, de);
  set_common(A, lse, dsum, N, H, dh);
  return dispatch(A, B, static_cast<cudaStream_t>(stream));
}

// The octic qkv as above and the cotangent gw [B,N,H*dh] (token row stride
// ld_gw), head h's dh channels at column h*dh in the order a1|a2|b1|b2|e0|e1
// -> the six gradients d1..d4, de0, de1, contiguous, shaped as the qkv arrays.
OVT_EXPORT int ovt_attention_octic_bwd_wideg(
    const void* q1, const void* q2, const void* q3, const void* q4, const void* e0,
    const void* e1, int lq1, int lq2, int lq3, int lq4, int le0, int le1, const void* gw,
    int ld_gw, void* d1p, void* d2p, void* d3p, void* d4p, void* de0, void* de1, void* lse,
    void* dsum, int B, int N, int H, int d1, int de, void* stream) {
  Args A = {};
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lq[6] = {lq1, lq2, lq3, lq4, le0, le1};
  void* const ds[6] = {d1p, d2p, d3p, d4p, de0, de1};
  set_octic_qkv(A, ins, lq, ds, H, d1, de);
  const int dh = 4 * d1 + 2 * de;
  A.g.nseg = 1;
  A.g.p[0][0] = static_cast<const ovt::bf16*>(gw);
  A.g.ld[0][0] = ld_gw;
  A.g.width[0] = A.g.hs[0] = dh;
  set_common(A, lse, dsum, N, H, dh);
  return dispatch(A, B, static_cast<cudaStream_t>(stream));
}

// ---- The yardstick of the model paths' backward (ops.attention_bwd_sync):
// this core in the standard and octic layouts, as the model paths ran it
// before the TMA + wgmma redesign (csrc/attention_bwd.cu), with the form
// forced by the caller; and the head-major probe of kernel row 14a.

// qkv [B,N,3*H*dh] contiguous in (3, H, dh) column order, g [B,N,H*dh] with
// token row stride ld_g, dqkv [B,N,3*H*dh] contiguous; lse and dsum f32
// scratch [B,H,N]; `streamed` the form of the launch plan
// (ops/attention.py:attention_bwd_plan: 0 whole-head staging, 1 the streamed
// form), as in every entry point below but the head-major one (whole-head).
// Returns the cudaError_t of the launches, or ERR_PLAN for a whole-head plan
// of a head that does not fit.
OVT_EXPORT int ovt_attention_std_bwd_sync(const void* qkv, const void* g, int ld_g, void* dqkv,
                                          void* lse, void* dsum, int B, int N, int H, int dh,
                                          int streamed, void* stream) {
  Args A = {};
  A.streamed = streamed;
  A.qkv.nseg = 1;
  set_qkv_3h(A, 0, qkv, 3 * H * dh, dqkv, dh, H);
  A.g.nseg = 1;
  A.g.p[0][0] = static_cast<const ovt::bf16*>(g);
  A.g.ld[0][0] = ld_g;
  A.g.width[0] = A.g.hs[0] = dh;
  set_common(A, lse, dsum, N, H, dh);
  return dispatch(A, B, static_cast<cudaStream_t>(stream));
}

// The octic head layout (see ovt_attention_octic_rows in csrc/attention.cu):
// q1..q4 [B,N,3*H*d1] and e0, e1 [B,N,3*H*de], each with its own token row
// stride; g1..g4 [B,N,H*d1] and ge0, ge1 [B,N,H*de], each with its own row
// stride; d1..d4, de0, de1 contiguous, shaped as q1..q4, e0, e1.
OVT_EXPORT int ovt_attention_octic_bwd_sync(
    const void* q1, const void* q2, const void* q3, const void* q4, const void* e0,
    const void* e1, int lq1, int lq2, int lq3, int lq4, int le0, int le1, const void* g1,
    const void* g2, const void* g3, const void* g4, const void* ge0, const void* ge1, int lg1,
    int lg2, int lg3, int lg4, int lge0, int lge1, void* d1p, void* d2p, void* d3p, void* d4p,
    void* de0, void* de1, void* lse, void* dsum, int B, int N, int H, int d1, int de,
    int streamed, void* stream) {
  Args A = {};
  A.streamed = streamed;
  A.qkv.nseg = 6;
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lq[6] = {lq1, lq2, lq3, lq4, le0, le1};
  void* ds[6] = {d1p, d2p, d3p, d4p, de0, de1};
  for (int i = 0; i < 6; ++i)
    set_qkv_3h(A, i, ins[i], lq[i], ds[i], i < 4 ? d1 : de, H);
  const void* const gs[6] = {g1, g2, g3, g4, ge0, ge1};
  const int lg[6] = {lg1, lg2, lg3, lg4, lge0, lge1};
  set_octic_g(A, gs, lg, d1, de);
  set_common(A, lse, dsum, N, H, 4 * d1 + 2 * de);
  return dispatch(A, B, static_cast<cudaStream_t>(stream));
}

// Head-major layout (scripts/r3_attn_headmajor.py:headmajor_attention_bwd):
// qkv and dqkv [B,3,H,N,dh], g [B,H,N,dh], all contiguous: each (s, head) is
// an [N, dh] block, so the head stride is N*dh and the batch strides
// 3*H*N*dh and H*N*dh. lse and dsum f32 scratch [B,H,N].
OVT_EXPORT int ovt_attention_headmajor_bwd(const void* qkv, const void* g, void* dqkv, void* lse,
                                           void* dsum, int B, int N, int H, int dh,
                                           void* stream) {
  Args A = {};
  const size_t blk = (size_t)N * dh;
  A.qkv.nseg = 1;
  for (int s = 0; s < 3; ++s) {
    A.qkv.p[0][s] = static_cast<const ovt::bf16*>(qkv) + s * H * blk;
    A.qkv.ld[0][s] = dh;
    A.qkv.bs[0][s] = 3 * H * blk;
    A.d[0][s] = static_cast<ovt::bf16*>(dqkv) + s * H * blk;
    A.d_ld[0][s] = dh;
    A.d_bs[0][s] = 3 * H * blk;
  }
  A.qkv.width[0] = dh;
  A.qkv.hs[0] = static_cast<int>(blk);
  A.g.nseg = 1;
  A.g.p[0][0] = static_cast<const ovt::bf16*>(g);
  A.g.ld[0][0] = dh;
  A.g.bs[0][0] = H * blk;
  A.g.width[0] = dh;
  A.g.hs[0] = static_cast<int>(blk);
  set_common(A, lse, dsum, N, H, dh);
  return dispatch(A, B, static_cast<cudaStream_t>(stream));
}
