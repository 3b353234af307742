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
// and the Pallas probes of kernel row 14b, scripts/r3_attn_experiments.py:
//   `_std_split_kernel` (main's run_std_split) and `_octic_split_kernel`
//     (through _call_octic): the cls-split keys [N-1 | 1] (template SPLIT of
//     csrc/attention_core.cuh) on the standard and the octic layouts;
//   `_std_multib_kernel` and `_octic_multib_kernel` (through
//     _call_octic_multib) with nb = 2: two images a CTA (schedule TWO_IMAGES);
//   `_octic_hoist_kernel` (split False or True): phase 1, the octic
//     assembly of every (s, head) slice into a 128-padded scratch, is
//     hoist_kernel below; phase 2 is probe l's padded octic attention on it.
//
// What bounds them on the H100: as K-attn (csrc/attention.cu), the gather and
// the latency of many small CTAs, not the MMA rate; SCORES and PROBS drop the
// P.V products, NOSM and CHEAP the f32 exp. What the design does about it:
// nothing new, by intent. Each probe differs from K-attn only in what its
// name says, so that the difference of two times is the cost of that part.
// The hoist assembly is bound by its bytes (the six arrays read once, the
// padded qkv written once); it moves 16 bytes a thread into the padded
// layout, from 4-byte pairs of the octic pieces (20- and 40-byte slices). On
// the TPU the scratch is VMEM ([N, H*128] x 3 for one image); one image's
// scratch here (3.2 MB at ViT-H) does not fit in one SM's shared memory, so
// it is written to HBM and read back by the attention.
// Only head dims 64 and 80 are instantiated (ViT-L and ViT-H).
#include "attention_core.cuh"

namespace {

using namespace ovt::attn;
using ovt::bf16;

template <int STAGE, int SCHED, int SPLIT = 0>
int run(Layout& L, int B, cudaStream_t stream) {
  finish(L);
  switch (L.dh) {
    case 64: return launch<64, STAGE, SCHED, SPLIT>(L, B, stream);
    case 80: return launch<80, STAGE, SCHED, SPLIT>(L, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// whether every gather segment's channel pairs are 4-byte aligned words, as
// the query fragments that TWO_HEADS and TWO_IMAGES load from device memory
// need
bool pairs_aligned(const Gather& G, int H) {
  bool ok = true;
  for (int i = 0; i < G.nseg; ++i) {
    ok = ok && G.width[i] % 2 == 0 && G.hs[i] % 2 == 0;
    for (int s = 0; s < 3; ++s)
      ok = ok && G.ld[i][s] % 2 == 0 && G.bs[i][s] % 2 == 0 &&
           reinterpret_cast<uintptr_t>(G.p[i][s]) % 4 == 0;
  }
  for (int h = 0; G.has_hcol && h < H; ++h) ok = ok && G.hcol[h] % 2 == 0;
  return ok;
}

// stage FULL with the schedule and the cls-split of the arguments
int run_full(Layout& L, int B, int sched, int split, cudaStream_t st) {
  if (split && (sched != ONE_HEAD || L.N < 2)) return cudaErrorInvalidValue;
  if (sched == TWO_HEADS || sched == TWO_IMAGES) {
    // the batch strides are the default N * ld unless set
    Gather G = L.in;
    for (int i = 0; i < G.nseg; ++i)
      for (int s = 0; s < 3; ++s)
        if (G.bs[i][s] == 0) G.bs[i][s] = (size_t)L.N * G.ld[i][s];
    if (!pairs_aligned(G, L.H)) return cudaErrorInvalidValue;
    if (sched == TWO_HEADS) return L.H % 2 ? cudaErrorInvalidValue : run<FULL, TWO_HEADS>(L, B, st);
    return B % 2 ? cudaErrorInvalidValue : run<FULL, TWO_IMAGES>(L, B, st);
  }
  if (sched == TWO_PASS) return run<FULL, TWO_PASS>(L, B, st);
  if (sched != ONE_HEAD) return cudaErrorInvalidValue;
  return split ? run<FULL, ONE_HEAD, 1>(L, B, st) : run<FULL, ONE_HEAD>(L, B, st);
}

}  // namespace

// (a named namespace: nvcc's host stub of a kernel in an unnamed namespace
// clashes with the unnamed namespace of csrc/attention_core.cuh)
namespace ovt {
namespace hoist {

// Phase 1 of the hoisted octic attention: the padded qkv out [B, N, 3*H*P]
// whose slot (s, h) at column (s*H + h)*P holds head h's dh = 4*d1 + 2*de
// channels a1|a2|b1|b2|e0|e1 of q (s = 0), k (1) or v (2), then zeros to P.
// One thread a 16-byte chunk of out; each channel pair is one 4-byte load.
struct Hoist {
  const bf16* in[6];  // the four 1-d qkv arrays [B,N,3*H*d1], the two E rows [B,N,3*H*de]
  int ld[6];          // their token row strides (elements)
  bf16* out;
  int rows, H, d1, de, P;
};

__global__ void __launch_bounds__(256) hoist_kernel(const Hoist a) {
  const int chunks = 3 * a.H * a.P / 8;  // 16-byte chunks of one token row
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)a.rows * chunks) return;
  const size_t row = idx / chunks;
  const int c = static_cast<int>(idx - row * chunks);
  const int slot = c / (a.P / 8), d0 = (c - slot * (a.P / 8)) * 8;  // slot = s*H + h
  const int dh = 4 * a.d1 + 2 * a.de;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = d0 + 2 * k;
    w[k] = 0u;
    if (d >= dh) continue;
    int i, col;
    if (d < 4 * a.d1) {
      i = d / a.d1;
      col = slot * a.d1 + d - i * a.d1;
    } else {
      const int r = (d - 4 * a.d1) / a.de;
      i = 4 + r;
      col = slot * a.de + d - 4 * a.d1 - r * a.de;
    }
    // array i by selects, not by a runtime index into the kernel's
    // parameters (which would copy them to local memory)
    const bf16* src = a.in[0];
    int ld = a.ld[0];
#pragma unroll
    for (int j = 1; j < 6; ++j)
      if (i == j) {
        src = a.in[j];
        ld = a.ld[j];
      }
    w[k] = *reinterpret_cast<const uint32_t*>(src + row * ld + col);
  }
  *reinterpret_cast<uint4*>(a.out + row * (3 * a.H * a.P) + c * 8) = make_uint4(w[0], w[1], w[2],
                                                                                w[3]);
}

}  // namespace hoist
}  // namespace ovt

// One probe launch. q, k, v [.., dh channels of head h at column hcol[h]
// (hcol, a host array of H ints, when not null) or h * hs_in, token rows
// ld_in and batch rows bs_in elements apart] -> with octic = 0, one output
// whose head h takes dh channels at column h * hs_out, token rows ld_out and
// batch rows bs_out apart, channels [dh, pad_to) written with the stage's
// value at v = 0; with octic = 1, the octic scatter o0..o3 [B,N,H*dh/8],
// o4, o5 [B,N,H*dh/4], contiguous. stage: 0 FULL, 1 SCORES, 2 PROBS, 3 NOSM,
// 4 CHEAP, 5 LOADS; sched: 0 one head a CTA, 1 two heads (FULL, H even,
// 4-byte aligned channel pairs), 2 two-pass softmax (FULL), 3 two images
// (FULL, B even, 4-byte aligned channel pairs); split: 1 for the cls-split
// keys (FULL, one head a CTA, N >= 2). Returns the cudaError_t of the launch.
OVT_EXPORT int ovt_attention_probe(const void* q, const void* k, const void* v, int ld_in,
                                   int bs_in, int hs_in, const int* hcol, void* o0, void* o1,
                                   void* o2, void* o3, void* o4, void* o5, int ld_out, int bs_out,
                                   int hs_out, int pad_to, int octic, int B, int N, int H, int dh,
                                   int stage, int sched, int split, void* stream) {
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
  if ((sched != ONE_HEAD || split) && stage != FULL) return cudaErrorInvalidValue;
  if (stage == FULL) return run_full(L, B, sched, split, st);
  switch (stage) {
    case SCORES: return run<SCORES, ONE_HEAD>(L, B, st);
    case PROBS: return run<PROBS, ONE_HEAD>(L, B, st);
    case NOSM: return run<NOSM, ONE_HEAD>(L, B, st);
    case CHEAP: return run<CHEAP, ONE_HEAD>(L, B, st);
    case LOADS: return run<LOADS, ONE_HEAD>(L, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// The octic head layout of ovt_attention_octic_rows (csrc/attention.cu): the
// four 1-d qkv arrays q1..q4 [B,N,3*H*d1] and the two E rows e0, e1
// [B,N,3*H*de], each with its token row stride; the octic scatter o1..o4
// [B,N,H*d1], oe0, oe1 [B,N,H*de], contiguous. Stage FULL with sched 0 (one
// head a CTA) or 3 (two images), split 0 or 1 as in ovt_attention_probe.
OVT_EXPORT int ovt_attention_probe_octic(const void* q1, const void* q2, const void* q3,
                                         const void* q4, const void* e0, const void* e1, int ld1,
                                         int ld2, int ld3, int ld4, int lde0, int lde1, void* o1,
                                         void* o2, void* o3, void* o4, void* oe0, void* oe1, int B,
                                         int N, int H, int d1, int de, int sched, int split,
                                         void* stream) {
  Layout L = {};
  L.in.nseg = 6;
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lds[6] = {ld1, ld2, ld3, ld4, lde0, lde1};
  for (int i = 0; i < 6; ++i) set_gather_3h(L.in, i, ins[i], lds[i], i < 4 ? d1 : de, H);
  void* const outs[6] = {o1, o2, o3, o4, oe0, oe1};
  set_octic_scatter(L.out, outs, H, d1, de);
  L.N = N;
  L.H = H;
  L.dh = 4 * d1 + 2 * de;
  if (sched != ONE_HEAD && sched != TWO_IMAGES) return cudaErrorInvalidValue;
  return run_full(L, B, sched, split, static_cast<cudaStream_t>(stream));
}

// The hoist assembly (phase 1 of `_octic_hoist_kernel`): q1..q4, e0, e1 as in
// ovt_attention_probe_octic (d1 and de even, every row stride even, every
// start 4-byte aligned) -> out [B,N,3*H*P] contiguous and 16-byte aligned,
// P a multiple of 8 and >= 4*d1 + 2*de. Returns the cudaError_t of the launch.
OVT_EXPORT int ovt_hoist_octic(const void* q1, const void* q2, const void* q3, const void* q4,
                               const void* e0, const void* e1, int ld1, int ld2, int ld3, int ld4,
                               int lde0, int lde1, void* out, int B, int N, int H, int d1, int de,
                               int P, void* stream) {
  ovt::hoist::Hoist a;
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lds[6] = {ld1, ld2, ld3, ld4, lde0, lde1};
  bool ok = d1 % 2 == 0 && de % 2 == 0 && P % 8 == 0 && 4 * d1 + 2 * de <= P &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = 0; i < 6; ++i) {
    a.in[i] = static_cast<const ovt::bf16*>(ins[i]);
    a.ld[i] = lds[i];
    ok = ok && lds[i] % 2 == 0 && reinterpret_cast<uintptr_t>(ins[i]) % 4 == 0;
  }
  if (!ok) return cudaErrorInvalidValue;
  a.out = static_cast<ovt::bf16*>(out);
  a.rows = B * N;
  a.H = H;
  a.d1 = d1;
  a.de = de;
  a.P = P;
  const size_t chunks = (size_t)B * N * (3 * H * P / 8);
  if (chunks == 0) return cudaSuccess;
  ovt::hoist::hoist_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
