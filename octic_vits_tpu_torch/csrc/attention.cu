// K-attn: softmax(Q K^T * scale) V for each (batch, head), with the head's
// channels gathered from the producer's natural layout and the output
// scattered back into the consumer's layout. The model paths' forwards are
// the streamed TMA + wgmma kernels (csrc/attention_std.cu,
// csrc/attention_octic.cu); this whole-head core serves the probes: row 5's
// octic layout below (ops/attention_probe.py:whole_head_octic_attention, the
// yardstick of the streamed octic forward) and, through
// csrc/attention_probe.cu, the probes of rows 14a-14c.
//
// Replaced, until the streamed kernels took their place (its time is the
// yardstick of csrc/attention_octic.cu's):
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention (`_octic_fwd_kernel`)
//     and the attention half of octic_attention_fused_qkv (`_qkv_attn_store`,
//     `_group_attn_fwd`): head h's dh = 4*d1 + 2*de channels are a1|a2|b1|b2
//     at column (s*H + h)*d1 of the four 1-d qkv arrays [B,N,3C/8] plus
//     e0|e1 at column (s*H + h)*de of the two E rows [B,N,3C/4] (each with
//     its own row stride: on the train path they are the two column halves
//     of one flat-E qkv); the output goes back to 4 x [B,N,C/8] +
//     2 x [B,N,C/4] in irrep layout. The backward is csrc/attention_bwd.cu.
// One kernel serves every layout: a gather table says where each segment of
// a head's channels lies (a base pointer per s, a row stride, a batch
// stride, a width and a head stride or a per-head column table) and a
// scatter table where the output's segments go. The device code is in
// csrc/attention_core.cuh, which csrc/attention_probe.cu shares.
//
// What bounds it on the H100: at ViT-H/14, B=64 (N = 257, H = 16, dh = 80)
// one layer is 2 * 2 * 64*16 * 257^2 * 80 = 10.8 GFLOP over 126 MB of qkv:
// ~86 FLOP per byte, below the ridge, and each head's data is small and
// (in octic mode) cut into 20- and 40-byte pieces that are not 16-byte
// aligned. So the gather and the latency of many small CTAs matter more
// than the MMA rate.
//
// What the design does about it: one CTA of 8 warps per (head, batch)
// gathers the head's q, k and v^T once into shared memory (any head layout,
// zero-padded to a multiple of 16 tokens and of 16 channels; 141 KB at
// ViT-H). Each segment is gathered with the widest load that it allows (16
// bytes for the standard and wide layouts and for the wide-1d layout's
// 80-byte 1-d slice, 8 bytes for the octic 40-byte E pieces, 4 bytes for its
// 20-byte 1-d pieces), so one narrow segment does not narrow the others,
// with four loads in flight per thread: a first version that gathered with
// one dependent 2-byte load per loop trip, 5 times per head, was bound by
// load latency (3.2 ms per layer at ViT-H B=64, PERF.md). One head's whole
// [257, 257] f32 score tile (264 KB) would not fit, so each warp takes 16
// query rows at a time and runs an online softmax over 64-key blocks
// (FlashAttention-2 style) with scores, probabilities and output kept in
// m16n8k16 MMA fragments in registers. Scores and the softmax are f32; the
// probabilities are rounded to bf16 only as the P.V operand.
#include "attention_core.cuh"

// K-attn: stage FULL, one head a CTA
static int k_attn(ovt::attn::Layout& L, int B, void* stream) {
  return ovt::attn::dispatch<ovt::attn::FULL, ovt::attn::ONE_HEAD>(
      L, B, static_cast<cudaStream_t>(stream));
}

// Octic head layout, each input with its own token row stride (elements):
// q1..q4 [B,N,3*H*d1] (the 1-d qkv, (3, H, d1) column order), e0 and e1
// [B,N,3*H*de] (the two E rows, (3, H, de) order; on the train path they
// are the two halves of one flat-E qkv [B,N,6*H*de], so ld = 6*H*de);
// o1..o4 [B,N,H*d1], oe0, oe1 [B,N,H*de] contiguous. Head dim
// dh = 4*d1 + 2*de and the scale is dh^-0.5 (= (C/H)^-0.5).
OVT_EXPORT int ovt_attention_octic_rows(const void* q1, const void* q2, const void* q3,
                                        const void* q4, const void* e0, const void* e1, int ld1,
                                        int ld2, int ld3, int ld4, int lde0, int lde1, void* o1,
                                        void* o2, void* o3, void* o4, void* oe0, void* oe1, int B,
                                        int N, int H, int d1, int de, void* stream) {
  ovt::attn::Layout L = {};
  L.in.nseg = 6;
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lds[6] = {ld1, ld2, ld3, ld4, lde0, lde1};
  for (int i = 0; i < 6; ++i) ovt::attn::set_gather_3h(L.in, i, ins[i], lds[i], i < 4 ? d1 : de, H);
  void* const outs[6] = {o1, o2, o3, o4, oe0, oe1};
  ovt::attn::set_octic_scatter(L.out, outs, H, d1, de);
  L.N = N;
  L.H = H;
  L.dh = 4 * d1 + 2 * de;
  return k_attn(L, B, stream);
}
