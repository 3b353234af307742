// The forward-attention probes of K-attn: K-attn (csrc/attention_core.cuh)
// instantiated with another stage or schedule, or fed another layout, so
// that the differences of their times split K-attn's time into its gather,
// scores, softmax, P.V and store, and test its operand layout and schedule.
//
// Replaces the Pallas probes of the TPU kernel's time (kernel row 14a):
//   scripts/profile_attn_kernel.py:_call_synth with `_aligned_loads_kernel`,
//     `_aligned_all_kernel` and `_aligned_all_variant` (no softmax, cheap
//     softmax): q, k, v of head h an aligned "fake" 80-column slice at column
//     128 * (h % 3) of a1, a2 and b1 (the per-head column table), the octic
//     scatter or one store at column h * 128;
//   scripts/r3_attn_ablate.py:_call_std with `k_scores_only`,
//     `k_scores_softmax`, `k_full`, `k_interleave2` and `k_phased` (stages
//     SCORES, PROBS, FULL; schedules TWO_HEADS and TWO_PASS), and `mk_pad`
//     with `k_padded_scores`, `k_padded_full`, `k_padded_octic_store` (the
//     128-padded qkv [B,N,3*H*128], its 80 real channels gathered);
//   scripts/r3_attn_bh.py:call_std_bh, call_octic_bh (the padded qkv on a
//     grid of (batch, head), which K-attn's grid already is);
//   scripts/r3_attn_headmajor.py:headmajor_attention (the head-major qkv
//     [B,3,H,N,dh] -> [B,H,N,dh]: batch strides in the gather and scatter).
//     Its backward is ovt_attention_headmajor_bwd in csrc/attention_bwd.cu.
//
// What bounds them on the H100: as K-attn (csrc/attention.cu), the gather and
// the latency of many small CTAs, not the MMA rate; SCORES and PROBS drop the
// P.V products, NOSM and CHEAP the f32 exp. What the design does about it:
// nothing new, by intent. Each probe differs from K-attn only in what its
// name says, so that the difference of two times is the cost of that part.
// Only head dims 64 and 80 are instantiated (ViT-L and ViT-H).
#include "attention_core.cuh"

namespace {

using namespace ovt::attn;

template <int STAGE, int SCHED>
int run(Layout& L, int B, cudaStream_t stream) {
  finish(L);
  switch (L.dh) {
    case 64: return launch<64, STAGE, SCHED>(L, B, stream);
    case 80: return launch<80, STAGE, SCHED>(L, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One probe launch. q, k, v [.., dh channels of head h at column hcol[h]
// (hcol, a host array of H ints, when not null) or h * hs_in, token rows
// ld_in and batch rows bs_in elements apart] -> with octic = 0, one output
// whose head h takes dh channels at column h * hs_out, token rows ld_out and
// batch rows bs_out apart, channels [dh, pad_to) written with the stage's
// value at v = 0; with octic = 1, the octic scatter o0..o3 [B,N,H*dh/8],
// o4, o5 [B,N,H*dh/4], contiguous. stage: 0 FULL, 1 SCORES, 2 PROBS, 3 NOSM,
// 4 CHEAP, 5 LOADS; sched: 0 one head a CTA, 1 two heads (FULL, H even,
// 4-byte aligned channel pairs), 2 two-pass softmax (FULL). Returns the
// cudaError_t of the launch.
OVT_EXPORT int ovt_attention_probe(const void* q, const void* k, const void* v, int ld_in,
                                   int bs_in, int hs_in, const int* hcol, void* o0, void* o1,
                                   void* o2, void* o3, void* o4, void* o5, int ld_out, int bs_out,
                                   int hs_out, int pad_to, int octic, int B, int N, int H, int dh,
                                   int stage, int sched, void* stream) {
  Layout L = {};
  L.in.nseg = 1;
  const void* qkv[3] = {q, k, v};
  for (int s = 0; s < 3; ++s) {
    L.in.p[0][s] = static_cast<const ovt::bf16*>(qkv[s]);
    L.in.ld[0][s] = ld_in;
    L.in.bs[0][s] = bs_in;
  }
  L.in.width[0] = dh;
  L.in.hs[0] = hs_in;
  if (hcol != nullptr) {
    if (H > MAX_HEADS) return cudaErrorInvalidValue;
    L.in.has_hcol = 1;
    for (int h = 0; h < H; ++h) L.in.hcol[h] = hcol[h];
  }
  if (octic) {
    void* const outs[6] = {o0, o1, o2, o3, o4, o5};
    set_octic_scatter(L.out, outs, H, dh / 8, dh / 4);
  } else {
    L.out.nseg = 1;
    L.out.p[0] = static_cast<ovt::bf16*>(o0);
    L.out.ld[0] = ld_out;
    L.out.bs[0] = bs_out;
    L.out.width[0] = dh;
    L.out.hs[0] = hs_out;
    L.out.pad_to = pad_to;
  }
  L.N = N;
  L.H = H;
  L.dh = dh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sched != ONE_HEAD && stage != FULL) return cudaErrorInvalidValue;
  if (sched == TWO_HEADS) {
    bool ok = H % 2 == 0 && ld_in % 2 == 0 && bs_in % 2 == 0 && hs_in % 2 == 0;
    for (int s = 0; s < 3; ++s) ok = ok && reinterpret_cast<uintptr_t>(qkv[s]) % 4 == 0;
    for (int h = 0; hcol != nullptr && h < H; ++h) ok = ok && hcol[h] % 2 == 0;
    if (!ok) return cudaErrorInvalidValue;
    return run<FULL, TWO_HEADS>(L, B, st);
  }
  if (sched == TWO_PASS) return run<FULL, TWO_PASS>(L, B, st);
  switch (stage) {
    case FULL: return run<FULL, ONE_HEAD>(L, B, st);
    case SCORES: return run<SCORES, ONE_HEAD>(L, B, st);
    case PROBS: return run<PROBS, ONE_HEAD>(L, B, st);
    case NOSM: return run<NOSM, ONE_HEAD>(L, B, st);
    case CHEAP: return run<CHEAP, ONE_HEAD>(L, B, st);
    case LOADS: return run<LOADS, ONE_HEAD>(L, B, st);
    default: return cudaErrorInvalidValue;
  }
}
