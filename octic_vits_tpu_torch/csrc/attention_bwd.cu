// K-attn-bwd: the gradient of softmax(Q K^T * scale) V with respect to q, k
// and v for each (batch, head), recomputing the probabilities from q and k
// (the only residual is the qkv, as in the JAX custom VJP). Per head:
//   P  = softmax(s Q K^T)        dV = P^T dO        dP = dO V^T
//   dS = P o (dP - rowsum(dP o P)) s                dQ = dS K      dK = dS^T Q
//
// Replaces
//   octic_vits_tpu/ops/pallas_attention.py:standard_attention backward
//     (`_std_bwd_rule`, `_std_bwd_kernel`): qkv [B,N,3C] in (3, H, dh) order
//     and g [B,N,C] -> dqkv [B,N,3C];
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention backward
//     (`_octic_bwd_rule`, `_octic_bwd_kernel`): the six irrep qkv arrays
//     (a1..b2 [B,N,3C/8] in (3, H, d1) order, e0, e1 [B,N,3C/4] in (3, H, de)
//     order) and the six output cotangents -> the six input gradients;
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention_wide1d backward
//     (`_w1d_bwd_rule`, `_octic_w1d_bwd_kernel`): q1d, k1d, v1d [B,N,C/2]
//     (columns (H, [a1|a2|b1|b2], d1)), e0, e1 and the six cotangents ->
//     dq1d, dk1d, dv1d in the wide layout and de0, de1;
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention_wide backward
//     (`_octic_wide_bwd_rule`, `_octic_wide_bwd_kernel`): qkv [B,N,3C] with
//     columns (3, H, [a1|a2|b1|b2|e0|e1]) and the six cotangents -> dqkv;
//   scripts/r3_attn_headmajor.py:headmajor_attention_bwd (`_hm_bwd_kernel`,
//     a probe of kernel row 14a): qkv [B,3,H,N,dh] head-major and g
//     [B,H,N,dh] -> dqkv [B,3,H,N,dh], through the tables' batch strides.
// Three tables describe a layout, as in the forward (csrc/attention.cu): the
// gather of q, k and v (a base pointer per s, row and batch strides, widths,
// head strides), the cotangent g in the six-irrep output layout, and dq, dk, dv
// in the gather's layout (or a layout of its own: the wide-store probe of
// csrc/attention_bwd_probe.cu). Each (s, head) column slice of every gradient
// is written exactly once: no zeroing, no accumulation across heads. The
// device code is csrc/attention_bwd_core.cuh; this file holds the model
// paths' entry points.
//
// What bounds it on the H100: at ViT-H/14, B=32 (N = 257, H = 16, dh = 80)
// the backward is 5 products of 2 * 32*16 * 257^2 * 80 FLOP each per pass
// structure below (~27 GFLOP a layer, ~2.5x the forward) over 63 MB of qkv
// and 21 MB of g: below the card's ridge, and, as in the forward, each head
// is small and its octic pieces are 20- and 40-byte, not 16-byte aligned.
// q, k, v and dO of one head, zero-padded to 272 tokens x 88 channels, take
// 191 KB of the 227 KB of shared memory: there is no room for f32 dK and dV
// accumulators of the whole head, so the Pallas one-step schedule does not
// carry over.
//
// What the design does about it: two kernels in FlashAttention-2 style, one
// CTA of 8 warps per (head, batch), each gathering the head's q, k, v and dO
// rows once into shared memory with the widest load the segments allow.
// Where a head does not fit (N above 320 at dh = 80, 384 at dh = 64; dh =
// 128 from N = 257), the streamed form runs instead (the op's plan picks
// it): a CTA owns 128 query rows (query pass) or 128 key rows (key pass) and
// 64-row tiles of the other operands stream through shared memory, as
// csrc/attention_group.cu does at G = 1; its sums keep the same order of
// terms over the keys and queries, so its numerics are the whole-head form's.
// 1. Query pass: each warp owns 16 query rows; a first sweep over 64-key
//    blocks carries the online max, the softmax sum and the online sum of
//    exp(s - m) * dP (so rowsum(dP o P) needs no third sweep); a second sweep
//    recomputes P and dP, forms dS and accumulates dQ in MMA fragments. The
//    row log-sum-exp and rowsum(dP o P) go to f32 scratch [B,H,N].
// 2. Key pass: each warp owns 16 key rows and sweeps 32-query blocks,
//    recomputing P^T and dS^T from the scratch statistics, and accumulates
//    dV = P^T dO and dK = dS^T Q in registers. No atomics, so the sums have
//    a fixed order. The transposed operands come from the row tiles through
//    ldmatrix.trans. P and dS are rounded to bf16 only as MMA operands, as
//    in the JAX bf16 path; scores, softmax statistics and sums are f32.
#include "attention_bwd_core.cuh"

// qkv [B,N,3*H*dh] contiguous in (3, H, dh) column order, g [B,N,H*dh] with
// token row stride ld_g, dqkv [B,N,3*H*dh] contiguous; lse and dsum f32
// scratch [B,H,N]; `streamed` the form of the launch plan
// (ops/attention.py:attention_bwd_plan: 0 whole-head staging, 1 the streamed
// form), as in every entry point below but the head-major one (whole-head).
// Returns the cudaError_t of the launches, or ERR_PLAN for a whole-head plan
// of a head that does not fit.
OVT_EXPORT int ovt_attention_std_bwd(const void* qkv, const void* g, int ld_g, void* dqkv,
                                     void* lse, void* dsum, int B, int N, int H, int dh,
                                     int streamed, void* stream) {
  ovt::attn_bwd::Args A = {};
  A.streamed = streamed;
  A.qkv.nseg = 1;
  ovt::attn_bwd::set_qkv_3h(A, 0, qkv, 3 * H * dh, dqkv, dh, H);
  A.g.nseg = 1;
  A.g.p[0][0] = static_cast<const ovt::bf16*>(g);
  A.g.ld[0][0] = ld_g;
  A.g.width[0] = A.g.hs[0] = dh;
  ovt::attn_bwd::set_common(A, lse, dsum, N, H, dh);
  return ovt::attn_bwd::dispatch(A, B, static_cast<cudaStream_t>(stream));
}

// Octic head layout (see ovt_attention_octic_rows in csrc/attention.cu):
// q1..q4 [B,N,3*H*d1] and e0, e1 [B,N,3*H*de], each with its own token row
// stride; g1..g4 [B,N,H*d1] and ge0, ge1 [B,N,H*de], each with its own row
// stride; d1..d4, de0, de1 contiguous, shaped as q1..q4, e0, e1.
OVT_EXPORT int ovt_attention_octic_bwd(
    const void* q1, const void* q2, const void* q3, const void* q4, const void* e0,
    const void* e1, int lq1, int lq2, int lq3, int lq4, int le0, int le1, const void* g1,
    const void* g2, const void* g3, const void* g4, const void* ge0, const void* ge1, int lg1,
    int lg2, int lg3, int lg4, int lge0, int lge1, void* d1p, void* d2p, void* d3p, void* d4p,
    void* de0, void* de1, void* lse, void* dsum, int B, int N, int H, int d1, int de,
    int streamed, void* stream) {
  ovt::attn_bwd::Args A = {};
  A.streamed = streamed;
  A.qkv.nseg = 6;
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lq[6] = {lq1, lq2, lq3, lq4, le0, le1};
  void* ds[6] = {d1p, d2p, d3p, d4p, de0, de1};
  for (int i = 0; i < 6; ++i)
    ovt::attn_bwd::set_qkv_3h(A, i, ins[i], lq[i], ds[i], i < 4 ? d1 : de, H);
  const void* const gs[6] = {g1, g2, g3, g4, ge0, ge1};
  const int lg[6] = {lg1, lg2, lg3, lg4, lge0, lge1};
  ovt::attn_bwd::set_octic_g(A, gs, lg, d1, de);
  ovt::attn_bwd::set_common(A, lse, dsum, N, H, 4 * d1 + 2 * de);
  return ovt::attn_bwd::dispatch(A, B, static_cast<cudaStream_t>(stream));
}

// Wide-1d octic layout (see ovt_attention_wide1d_pieces in
// csrc/attention_octic.cu): q1d, k1d, v1d [B,N,4*H*d1] and e0, e1
// [B,N,3*H*de], each with its own token row stride; the six cotangents as in ovt_attention_octic_bwd; dq1d, dk1d, dv1d
// [B,N,4*H*d1] and de0, de1 [B,N,3*H*de] contiguous.
OVT_EXPORT int ovt_attention_wide1d_bwd(
    const void* q1d, const void* k1d, const void* v1d, const void* e0, const void* e1, int lq,
    int lk, int lv, int le0, int le1, const void* g1, const void* g2, const void* g3,
    const void* g4, const void* ge0, const void* ge1, int lg1, int lg2, int lg3, int lg4,
    int lge0, int lge1, void* dq1d, void* dk1d, void* dv1d, void* de0, void* de1, void* lse,
    void* dsum, int B, int N, int H, int d1, int de, int streamed, void* stream) {
  ovt::attn_bwd::Args A = {};
  A.streamed = streamed;
  A.qkv.nseg = 3;
  const void* one[3] = {q1d, k1d, v1d};
  const int l1[3] = {lq, lk, lv};
  void* d1s[3] = {dq1d, dk1d, dv1d};
  for (int s = 0; s < 3; ++s) {
    A.qkv.p[0][s] = static_cast<const ovt::bf16*>(one[s]);
    A.qkv.ld[0][s] = l1[s];
    A.d[0][s] = static_cast<ovt::bf16*>(d1s[s]);
    A.d_ld[0][s] = 4 * H * d1;
  }
  A.qkv.width[0] = A.qkv.hs[0] = 4 * d1;
  ovt::attn_bwd::set_qkv_3h(A, 1, e0, le0, de0, de, H);
  ovt::attn_bwd::set_qkv_3h(A, 2, e1, le1, de1, de, H);
  const void* const gs[6] = {g1, g2, g3, g4, ge0, ge1};
  const int lg[6] = {lg1, lg2, lg3, lg4, lge0, lge1};
  ovt::attn_bwd::set_octic_g(A, gs, lg, d1, de);
  ovt::attn_bwd::set_common(A, lse, dsum, N, H, 4 * d1 + 2 * de);
  return ovt::attn_bwd::dispatch(A, B, static_cast<cudaStream_t>(stream));
}

// Wide octic layout (see ovt_attention_std_octic in csrc/attention_octic.cu): qkv
// [B,N,3*H*dh] contiguous, dh = 4*d1 + 2*de; the six cotangents as in
// ovt_attention_octic_bwd; dqkv [B,N,3*H*dh] contiguous.
OVT_EXPORT int ovt_attention_wide_bwd(const void* qkv, const void* g1, const void* g2,
                                      const void* g3, const void* g4, const void* ge0,
                                      const void* ge1, int lg1, int lg2, int lg3, int lg4,
                                      int lge0, int lge1, void* dqkv, void* lse, void* dsum,
                                      int B, int N, int H, int d1, int de, int streamed,
                                      void* stream) {
  ovt::attn_bwd::Args A = {};
  A.streamed = streamed;
  const int dh = 4 * d1 + 2 * de;
  A.qkv.nseg = 1;
  ovt::attn_bwd::set_qkv_3h(A, 0, qkv, 3 * H * dh, dqkv, dh, H);
  const void* const gs[6] = {g1, g2, g3, g4, ge0, ge1};
  const int lg[6] = {lg1, lg2, lg3, lg4, lge0, lge1};
  ovt::attn_bwd::set_octic_g(A, gs, lg, d1, de);
  ovt::attn_bwd::set_common(A, lse, dsum, N, H, dh);
  return ovt::attn_bwd::dispatch(A, B, static_cast<cudaStream_t>(stream));
}

// Head-major layout (scripts/r3_attn_headmajor.py:headmajor_attention_bwd):
// qkv and dqkv [B,3,H,N,dh], g [B,H,N,dh], all contiguous: each (s, head) is
// an [N, dh] block, so the head stride is N*dh and the batch strides
// 3*H*N*dh and H*N*dh. lse and dsum f32 scratch [B,H,N].
OVT_EXPORT int ovt_attention_headmajor_bwd(const void* qkv, const void* g, void* dqkv, void* lse,
                                           void* dsum, int B, int N, int H, int dh,
                                           void* stream) {
  ovt::attn_bwd::Args A = {};
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
  ovt::attn_bwd::set_common(A, lse, dsum, N, H, dh);
  return ovt::attn_bwd::dispatch(A, B, static_cast<cudaStream_t>(stream));
}
