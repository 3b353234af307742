// K-attn's device code: softmax(Q K^T * scale) V for each (batch, head), with
// the head's channels gathered from the producer's layout and the output
// scattered into the consumer's. csrc/attention.cu instantiates it for the
// model paths (stage FULL, one head a CTA); csrc/attention_probe.cu for the
// probes of the kernel's time (the other stages and schedules below), so the
// probes run this code and not a copy of it. See csrc/attention.cu for what
// it replaces, what bounds it on the H100 and why it is built this way.
//
// Everything here has internal linkage: each source that includes it keeps
// its own instantiations.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace ovt {
namespace attn {
namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32, KB = 64, UNROLL = 4;
constexpr int MAX_SEG = 6, MAX_HEADS = 64;

// What a CTA computes after the scores s = q k^T * scale of its rows (the
// probes of scripts/r3_attn_ablate.py and scripts/profile_attn_kernel.py):
//   FULL    softmax(s) v: K-attn (f32 online softmax, P rounded to bf16 for P.V)
//   SCORES  rowmax(s) + v: the scores and an online row max, no exp, no P.V
//   PROBS   (rowmax(p) + 1 / sum p) + v, rowmax(p) = 1: FULL without P.V
//   NOSM    bf16(s) v: no max, no exp, no normalisation
//   CHEAP   FULL with p = exp(bf16(s - m)) taken in bf16 (bf16x2 exp)
//   LOADS   v: the gather and the store only (the floor of the H100 split)
enum Stage { FULL = 0, SCORES = 1, PROBS = 2, NOSM = 3, CHEAP = 4, LOADS = 5 };
// How a CTA is scheduled: one head (K-attn); two heads whose chains
// interleave in each warp, with K and v^T of both in shared memory and the
// query rows loaded straight into fragments; one head with a two-pass
// softmax (each warp's score rows to shared memory, then exp and sum, then
// P.V, no online rescale); two images (the same head of batch rows 2y and
// 2y + 1), interleaved and staged as TWO_HEADS (scripts/r3_attn_experiments.py
// `_std_multib_kernel`, `_octic_multib_kernel` with nb = 2).
enum Sched { ONE_HEAD = 0, TWO_HEADS = 1, TWO_PASS = 2, TWO_IMAGES = 3 };
// SPLIT (the cls-split of scripts/r3_attn_experiments.py:_attn_head_split,
// stage FULL): the 64-key blocks cover keys [0, N - 1) only, and key N - 1 is
// a rank-1 update: its score an f32 dot product on the CUDA cores, its
// probability kept in f32 (never rounded to bf16) and folded into the online
// max, sum and output before the first block. At N = 257 the blocks end at
// key 256, so the fifth block, which held one real key, goes away.

// the batch row and the head of chain j of this CTA
template <int SCHED>
__device__ __forceinline__ int chain_batch(int j) {
  return SCHED == TWO_IMAGES ? 2 * (int)blockIdx.y + j : (int)blockIdx.y;
}
template <int SCHED>
__device__ __forceinline__ int chain_head(int j) {
  return SCHED == TWO_HEADS ? 2 * (int)blockIdx.x + j : (int)blockIdx.x;
}

// Where head h's dh channels of q (s = 0), k (1) and v (2) lie: segment i
// holds `width[i]` consecutive channels of the head at column h * hs[i] (or
// hcol[h], when has_hcol) of the array p[i][s], whose token rows are ld[i][s]
// elements apart and whose batch rows bs[i][s] apart (N * ld[i][s] unless
// set). The segments follow each other in the head's channel order.
struct Gather {
  int nseg;
  const bf16* p[MAX_SEG][3];
  int ld[MAX_SEG][3];
  size_t bs[MAX_SEG][3];
  int width[MAX_SEG], hs[MAX_SEG];
  int vec[MAX_SEG];  // elements per load of the segment: 8, 4, 2 or 1 (chosen by the host)
  int has_hcol;      // 1: head h starts at column hcol[h] of every segment's arrays
  int hcol[MAX_HEADS];
};

// Where head h's dh output channels go: segment i receives `width[i]`
// channels at column h * hs[i] of p[i], token rows ld[i] apart, batch rows
// bs[i] apart (N * ld[i] unless set). With one segment and pad_to > dh the
// channels [dh, pad_to) are written too, with the stage's value at v = 0.
struct Scatter {
  int nseg;
  bf16* p[MAX_SEG];
  int ld[MAX_SEG], width[MAX_SEG], hs[MAX_SEG];
  size_t bs[MAX_SEG];
  int pad_to;
};

struct Layout {
  Gather in;
  Scatter out;
  int N, H, dh;
  float scale;
};

__device__ __forceinline__ size_t head_col(const Gather& G, int i, int h) {
  return G.has_hcol ? (size_t)G.hcol[h] : (size_t)h * G.hs[i];
}

// Gather one segment of q, k and v (s = S0..2; `width` channels of each from
// src[s], the head's column in token row 0 of the CTA's batch row, token rows
// ld[s] apart) into channels [d_off, d_off + width) of q and k ([kpad][DS]
// rows) and, transposed, of v^T ([DHP][VS]); rows >= N are zero. One loop
// covers the operands, so a narrow segment still keeps UNROLL loads of V
// elements in flight per thread. Consecutive threads take consecutive
// tokens, which keeps the transposed 2-byte stores into v^T free of bank
// conflicts.
template <int DHP, int V, int S0>
__device__ __forceinline__ void gather_seg(const bf16* const* src, const int* ld, int width,
                                           int d_off, int N, int kpad, bf16* qs, bf16* ks,
                                           bf16* vt, int VS) {
  typedef typename VecOf<V>::T Vec;
  constexpr int DS = DHP + 8;
  const int per_s = kpad * (width / V), total = (3 - S0) * per_s;
  for (int base = threadIdx.x; base < total; base += THREADS * UNROLL) {
    Vec v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * THREADS;
      const int si = idx / per_s, s = S0 + si, r = idx - si * per_s;
      const int c = r / kpad, n = r - c * kpad;
      v[u] = Vec{};
      if (idx < total && n < N)
        v[u] = *reinterpret_cast<const Vec*>(src[s] + (size_t)n * ld[s] + c * V);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * THREADS;
      if (idx >= total) continue;
      const int si = idx / per_s, s = S0 + si, r = idx - si * per_s;
      const int c = r / kpad, n = r - c * kpad, d0 = d_off + c * V;
      if (s == 2) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[u]);
#pragma unroll
        for (int i = 0; i < V; ++i) vt[(d0 + i) * VS + n] = e[i];
      } else {
        *reinterpret_cast<Vec*>((s == 0 ? qs : ks) + n * DS + d0) = v[u];
      }
    }
  }
}

// Gather q (unless S0 = 1), k and v of head h (batch b) into shared memory:
// q and k as [kpad][DS] rows, v transposed as [DHP][VS]; rows >= N and
// channels >= dh are zero. Each segment takes its own load width.
template <int DHP, int S0 = 0>
__device__ __forceinline__ void gather_head(const Layout& L, int b, int h, int kpad, bf16* qs,
                                            bf16* ks, bf16* vt, int VS) {
  constexpr int DS = DHP + 8;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kpad * (DHP - L.dh); i += THREADS) {
    const int d = L.dh + i / kpad, n = i % kpad;
    if (S0 == 0) qs[n * DS + d] = zero;
    ks[n * DS + d] = zero;
    vt[d * VS + n] = zero;
  }
  const Gather& G = L.in;
  int d_off = 0;
  for (int i = 0; i < G.nseg; ++i) {
    const bf16* src[3];
    const size_t col = head_col(G, i, h);
#pragma unroll
    for (int s = 0; s < 3; ++s) src[s] = G.p[i][s] + b * G.bs[i][s] + col;
    const int w = G.width[i];
    const int* ld = G.ld[i];
    switch (G.vec[i]) {
      case 8: gather_seg<DHP, 8, S0>(src, ld, w, d_off, L.N, kpad, qs, ks, vt, VS); break;
      case 4: gather_seg<DHP, 4, S0>(src, ld, w, d_off, L.N, kpad, qs, ks, vt, VS); break;
      case 2: gather_seg<DHP, 2, S0>(src, ld, w, d_off, L.N, kpad, qs, ks, vt, VS); break;
      default: gather_seg<DHP, 1, S0>(src, ld, w, d_off, L.N, kpad, qs, ks, vt, VS); break;
    }
    d_off += w;
  }
}

// A fragments of 16 query rows from r0 (all DHP channels) of a [kpad][DS] tile
template <int DHP>
__device__ __forceinline__ void q_frags_smem(uint32_t (&qf)[DHP / 16][4], const bf16* qs, int r0,
                                             int lane) {
  constexpr int DS = DHP + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < DHP / 16; ++kc) {
    const bf16* p = qs + (r0 + g) * DS + kc * 16 + 2 * t;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(p + 8 * DS);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(p + 8 * DS + 8);
  }
}

// The same fragments straight from device memory (one-segment layouts whose
// channel pairs are 4-byte aligned): rows >= N and channels >= dh are zero
template <int DHP>
__device__ __forceinline__ void q_frags_global(uint32_t (&qf)[DHP / 16][4], const Layout& L,
                                               int b, int h, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* base = L.in.p[0][0] + b * L.in.bs[0][0] + head_col(L.in, 0, h);
  const int ld = L.in.ld[0][0];
#pragma unroll
  for (int kc = 0; kc < DHP / 16; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = r0 + g + (j & 1) * 8, d = kc * 16 + 2 * t + (j >> 1) * 8;
      qf[kc][j] = n < L.N && d < L.dh
                      ? *reinterpret_cast<const uint32_t*>(base + (size_t)n * ld + d)
                      : 0u;
    }
}

// The same fragments of any gather table (TWO_IMAGES, whose octic layout has
// six segments): each channel pair's segment is looked up. Every segment's
// width, head column, row and batch strides are even and its base 4-byte
// aligned (checked by the host). TWO_HEADS keeps the one-segment loader
// above: with this one, probe i ran ~6% slower (ViT-H/14 B=64, H100).
template <int DHP>
__device__ __forceinline__ void q_frags_segs(uint32_t (&qf)[DHP / 16][4], const Layout& L, int b,
                                             int h, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const Gather& G = L.in;
#pragma unroll
  for (int kc = 0; kc < DHP / 16; ++kc)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int d = kc * 16 + 2 * t + hf * 8;
      const bf16* base = nullptr;
      int ld = 0;
      if (d < L.dh) {
        int i = 0, off = 0;
        while (i < G.nseg - 1 && d >= off + G.width[i]) off += G.width[i++];
        base = G.p[i][0] + b * G.bs[i][0] + head_col(G, i, h) + (d - off);
        ld = G.ld[i][0];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = r0 + g + r * 8;
        qf[kc][hf * 2 + r] = base != nullptr && n < L.N
                                 ? *reinterpret_cast<const uint32_t*>(base + (size_t)n * ld)
                                 : 0u;
      }
    }
}

// The chains of one warp's 16 query rows of NH heads (NH = 2: the two
// heads' chains advance together, one 64-key block of each in turn, so one
// head's softmax can overlap the other's products): scores into m16n8
// fragments, then the stage's softmax and P.V. On return o[j] holds head j's
// unnormalised output (FULL, CHEAP, NOSM), mrow[j] its row max (in log2
// units for FULL and PROBS, natural for SCORES and CHEAP) and lrow[j] its
// row sum of p, both reduced over the lane quad (rows g and g + 8). With
// SPLIT (FULL) key N - 1 enters first, as the rank-1 update described above.
template <int DHP, int STAGE, int NH, int SPLIT = 0>
__device__ __forceinline__ void head_chain(const uint32_t (&qf)[NH][DHP / 16][4],
                                           bf16* const (&ks)[NH], bf16* const (&vt)[NH], int VS,
                                           int N, int kpad, float scale, int lane,
                                           float (&o)[NH][DHP / 8][4], float (&mrow)[NH][2],
                                           float (&lrow)[NH][2]) {
  constexpr int DS = DHP + 8, KC = DHP / 16, NT = DHP / 8;
  const int g = lane >> 2, t = lane & 3;
  // FULL and PROBS take the softmax in base 2; the other stages keep s natural
  const float sl = (STAGE == FULL || STAGE == PROBS) ? scale * 1.4426950408889634f : scale;
#pragma unroll
  for (int j = 0; j < NH; ++j) {
#pragma unroll
    for (int i = 0; i < NT; ++i) o[j][i][0] = o[j][i][1] = o[j][i][2] = o[j][i][3] = 0.f;
    mrow[j][0] = mrow[j][1] = -CUDART_INF_F;
    lrow[j][0] = lrow[j][1] = 0.f;
  }
  if constexpr (STAGE == LOADS) return;
  // the keys the 64-key blocks cover, and their end rounded up to 16
  const int nk = SPLIT ? N - 1 : N;
  const int kend = SPLIT ? (nk + 15) / 16 * 16 : kpad;
  if constexpr (SPLIT) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      // s_last = q . k[N-1] in f32 (the products of bf16 values are exact),
      // summed over the lane quad; p_last = exp2(s_last - m) = 1 at m = s_last
      const bf16* kl = ks[j] + (N - 1) * DS;
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 k2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(kl + kc * 16 + 2 * t + hf * 8));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 q2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&qf[j][kc][hf * 2 + r]));
            part[r] += q2.x * k2.x + q2.y * k2.y;
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
        mrow[j][r] = part[r] * sl;
        lrow[j][r] = t == 0 ? 1.f : 0.f;  // p_last = 1, in one of the quad's partial sums
      }
      // o = p_last v[N-1], in f32
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[j][i][e] = __bfloat162float(vt[j][(i * 8 + 2 * t + (e & 1)) * VS + N - 1]);
    }
  }

  for (int kb = 0; kb < kend; kb += KB) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      // every block holds at least one real key (kpad - 16 < N), so the
      // running max stays finite
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        if (kb + nt * 8 < kend) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            const bf16* p = ks[j] + (kb + nt * 8 + g) * DS + kc * 16 + 2 * t;
            mma_bf16(s[nt], qf[j][kc], *reinterpret_cast<const uint32_t*>(p),
                     *reinterpret_cast<const uint32_t*>(p + 8));
          }
        }
      }
      uint32_t pb[8][2];  // CHEAP: the bf16 probabilities, (row g, row g + 8) pairs
      if constexpr (STAGE == NOSM) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + nt * 8 + 2 * t + (e & 1);
            s[nt][e] = key < nk ? s[nt][e] * sl : 0.f;
          }
      } else {
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + nt * 8 + 2 * t + (e & 1);
            s[nt][e] = key < nk ? s[nt][e] * sl : -CUDART_INF_F;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mnew = fmaxf(mrow[j][r], mx[r]);
          if constexpr (STAGE == CHEAP)
            alpha[r] = __expf(mrow[j][r] - mnew);
          else
            alpha[r] = exp2f(mrow[j][r] - mnew);
          mrow[j][r] = mnew;
          lrow[j][r] *= alpha[r];
        }
        if constexpr (STAGE == SCORES) continue;
        if constexpr (STAGE == CHEAP) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const __nv_bfloat162 p = h2exp(__floats2bfloat162_rn(
                  s[nt][2 * r] - mrow[j][r], s[nt][2 * r + 1] - mrow[j][r]));
              lrow[j][r] += __low2float(p) + __high2float(p);
              pb[nt][r] = *reinterpret_cast<const uint32_t*>(&p);
            }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[nt][e] = exp2f(s[nt][e] - mrow[j][e >> 1]);
              lrow[j][e >> 1] += s[nt][e];
            }
        }
        if constexpr (STAGE == PROBS) continue;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          o[j][i][0] *= alpha[0];
          o[j][i][1] *= alpha[0];
          o[j][i][2] *= alpha[1];
          o[j][i][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kc = 0; kc < KB / 16; ++kc) {
        if (kb + kc * 16 >= kend) break;
        uint32_t pf[4];
        if constexpr (STAGE == CHEAP) {
          pf[0] = pb[2 * kc][0];
          pf[1] = pb[2 * kc][1];
          pf[2] = pb[2 * kc + 1][0];
          pf[3] = pb[2 * kc + 1][1];
        } else {
          pf[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
          pf[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
          pf[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
          pf[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const bf16* p = vt[j] + (i * 8 + g) * VS + kb + kc * 16 + 2 * t;
          mma_bf16(o[j][i], pf, *reinterpret_cast<const uint32_t*>(p),
                   *reinterpret_cast<const uint32_t*>(p + 8));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lrow[j][r] += __shfl_xor_sync(0xffffffffu, lrow[j][r], 1);
      lrow[j][r] += __shfl_xor_sync(0xffffffffu, lrow[j][r], 2);
    }
}

// The two-pass chain (FULL): the warp's score rows (bf16, log2 units) go to
// its scratch sc [16][SS]; their max is taken over all keys; a second pass
// replaces them by p = exp2(s - m) and sums p; a third runs P.V from the
// scratch. Returns as head_chain.
template <int DHP>
__device__ __forceinline__ void head_chain_two_pass(const uint32_t (&qf)[DHP / 16][4],
                                                    const bf16* ks, const bf16* vt, int VS,
                                                    bf16* sc, int SS, int N, int kpad, float scale,
                                                    int lane, float (&o)[DHP / 8][4],
                                                    float (&mrow)[2], float (&lrow)[2]) {
  constexpr int DS = DHP + 8, KC = DHP / 16, NT = DHP / 8;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = scale * 1.4426950408889634f;
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  for (int kb = 0; kb < kpad; kb += KB) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (kb + nt * 8 >= kpad) break;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const bf16* p = ks + (kb + nt * 8 + g) * DS + kc * 16 + 2 * t;
        mma_bf16(s, qf[kc], *reinterpret_cast<const uint32_t*>(p),
                 *reinterpret_cast<const uint32_t*>(p + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nt * 8 + 2 * t + (e & 1);
        s[e] = key < N ? s[e] * sl2 : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
      }
      const int col = kb + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(sc + g * SS + col) = pack_bf16x2(s[0], s[1]);
      *reinterpret_cast<uint32_t*>(sc + (g + 8) * SS + col) = pack_bf16x2(s[2], s[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mrow[r] = mx[r];
    lrow[r] = 0.f;
  }
  __syncwarp();
  for (int c = 2 * t; c < kpad; c += 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t* q = reinterpret_cast<uint32_t*>(sc + (g + 8 * r) * SS + c);
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(q);
      const float p0 = exp2f(__low2float(v) - mrow[r]), p1 = exp2f(__high2float(v) - mrow[r]);
      lrow[r] += p0 + p1;
      *q = pack_bf16x2(p0, p1);
    }
  __syncwarp();
  for (int kc = 0; kc * 16 < kpad; ++kc) {
    uint32_t pf[4];
    const bf16* p = sc + g * SS + kc * 16 + 2 * t;
    pf[0] = *reinterpret_cast<const uint32_t*>(p);
    pf[1] = *reinterpret_cast<const uint32_t*>(p + 8 * SS);
    pf[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    pf[3] = *reinterpret_cast<const uint32_t*>(p + 8 * SS + 8);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const bf16* v = vt + (i * 8 + g) * VS + kc * 16 + 2 * t;
      mma_bf16(o[i], pf, *reinterpret_cast<const uint32_t*>(v),
               *reinterpret_cast<const uint32_t*>(v + 8));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  __syncwarp();
}

// Write the warp's 16 rows from r0 of one head through the scatter table
// (ob: each segment's base for the CTA's batch row and this head): the
// stage's value of each (row, channel), from o, the row statistics and, for
// SCORES, PROBS and LOADS, v^T in shared memory; then the pad channels, if any.
template <int DHP, int STAGE>
__device__ __forceinline__ void store_rows(const Layout& L, const unsigned char* seg_of,
                                           const unsigned char* w_of, bf16* const* ob,
                                           const bf16* vt, int VS, const float (&o)[DHP / 8][4],
                                           const float (&mrow)[2], const float (&lrow)[2], int r0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int N = L.N, dh = L.dh;
  // per row: the factor of o, and the value a channel takes before adding v
  float f[2], base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    f[r] = (STAGE == FULL || STAGE == CHEAP) ? 1.f / lrow[r] : 1.f;
    base[r] = STAGE == SCORES ? mrow[r] : STAGE == PROBS ? 1.f + 1.f / lrow[r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DHP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = r0 + g + (e >> 1) * 8;
      const int d = i * 8 + 2 * t + (e & 1);
      if (n < N && d < dh) {
        float val;
        if constexpr (STAGE == SCORES || STAGE == PROBS || STAGE == LOADS)
          val = base[e >> 1] + __bfloat162float(vt[d * VS + n]);
        else
          val = o[i][e] * f[e >> 1];
        const int sg = seg_of[d];
        ob[sg][(size_t)n * L.out.ld[sg] + w_of[d]] = __float2bfloat16(val);
      }
    }
  if (L.out.pad_to > dh) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = r0 + g + r * 8;
      if (n >= N) continue;
      bf16* row = ob[0] + (size_t)n * L.out.ld[0];
      for (int d = dh + t; d < L.out.pad_to; d += 4) row[d] = __float2bfloat16(base[r]);
    }
  }
}

// output channel -> (scatter segment, channel within it)
template <int DHP>
__device__ __forceinline__ void scatter_tables(const Scatter& S, unsigned char* seg_of,
                                               unsigned char* w_of) {
  for (int d = threadIdx.x; d < DHP; d += THREADS) {
    int i = 0, base = 0;
    while (i < S.nseg - 1 && d >= base + S.width[i]) base += S.width[i++];
    seg_of[d] = static_cast<unsigned char>(i);
    w_of[d] = static_cast<unsigned char>(d - base);
  }
}

// One CTA of 8 warps per (head, batch) (per (head pair, batch) for
// TWO_HEADS, per (head, batch pair) for TWO_IMAGES). K-attn is
// <DHP, FULL, ONE_HEAD, 0>.
template <int DHP, int STAGE, int SCHED, int SPLIT = 0>
__global__ void __launch_bounds__(THREADS) attention_kernel(const Layout L) {
  constexpr int DS = DHP + 8;  // q and k smem row stride (bank-conflict-free 32-bit loads)
  constexpr int NH = (SCHED == TWO_HEADS || SCHED == TWO_IMAGES) ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = L.N;
  const int kpad = (N + 15) / 16 * 16;
  const int VS = kpad + 8;  // v^T smem row stride
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  bf16* ks[NH];
  bf16* vt[NH];
  bf16* qs = nullptr;
  bf16* next = reinterpret_cast<bf16*>(smem_raw);
  if constexpr (NH == 2) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      ks[j] = next;
      vt[j] = ks[j] + kpad * DS;
      next = vt[j] + DHP * VS;
    }
  } else {
    ks[0] = next;
    qs = ks[0] + kpad * DS;
    vt[0] = qs + kpad * DS;
    next = vt[0] + DHP * VS;
  }
  unsigned char* seg_of = reinterpret_cast<unsigned char*>(next);
  unsigned char* w_of = seg_of + DHP;
  bf16** obase = reinterpret_cast<bf16**>(w_of + DHP);  // [NH][MAX_SEG]
  bf16* scratch = reinterpret_cast<bf16*>(obase + NH * MAX_SEG);  // TWO_PASS: [WARPS][16][SS]
  const int SS = kpad + 8;

  scatter_tables<DHP>(L.out, seg_of, w_of);
  for (int i = tid; i < NH * L.out.nseg; i += THREADS) {
    const int j = i / L.out.nseg, sg = i - j * L.out.nseg;
    obase[j * MAX_SEG + sg] = L.out.p[sg] + chain_batch<SCHED>(j) * L.out.bs[sg] +
                              (size_t)chain_head<SCHED>(j) * L.out.hs[sg];
  }
  if constexpr (NH == 2) {
#pragma unroll
    for (int j = 0; j < NH; ++j)
      gather_head<DHP, 1>(L, chain_batch<SCHED>(j), chain_head<SCHED>(j), kpad, nullptr, ks[j],
                          vt[j], VS);
  } else {
    gather_head<DHP>(L, blockIdx.y, blockIdx.x, kpad, qs, ks[0], vt[0], VS);
  }
  __syncthreads();

  constexpr int KC = DHP / 16, NT = DHP / 8;
  // each warp owns 16 query rows at a time
  for (int r0 = warp * 16; r0 < kpad; r0 += WARPS * 16) {
    uint32_t qf[NH][KC][4];
    float o[NH][NT][4], mrow[NH][2], lrow[NH][2];
    if constexpr (SCHED == TWO_HEADS) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
        q_frags_global<DHP>(qf[j], L, blockIdx.y, chain_head<SCHED>(j), r0, lane);
    } else if constexpr (SCHED == TWO_IMAGES) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
        q_frags_segs<DHP>(qf[j], L, chain_batch<SCHED>(j), blockIdx.x, r0, lane);
    } else {
      q_frags_smem<DHP>(qf[0], qs, r0, lane);
    }
    if constexpr (SCHED == TWO_PASS)
      head_chain_two_pass<DHP>(qf[0], ks[0], vt[0], VS, scratch + (size_t)warp * 16 * SS, SS, N,
                               kpad, L.scale, lane, o[0], mrow[0], lrow[0]);
    else
      head_chain<DHP, STAGE, NH, SPLIT>(qf, ks, vt, VS, N, kpad, L.scale, lane, o, mrow, lrow);
#pragma unroll
    for (int j = 0; j < NH; ++j)
      store_rows<DHP, STAGE>(L, seg_of, w_of, obase + j * MAX_SEG, vt[j], VS, o[j], mrow[j],
                             lrow[j], r0, lane);
  }
}

// shared memory of one CTA: k (and q) rows and v^T of each head, the
// channel tables, the output base pointers, the two-pass score scratch
template <int DHP, int SCHED>
__host__ __device__ constexpr int smem_bytes(int n) {
  return (SCHED == TWO_HEADS || SCHED == TWO_IMAGES)
             ? 2 * ((n + 15) / 16 * 16 * (DHP + 8) + DHP * ((n + 15) / 16 * 16 + 8)) * 2 +
                   2 * DHP + 2 * MAX_SEG * 8
             : (2 * ((n + 15) / 16 * 16) * (DHP + 8) + DHP * ((n + 15) / 16 * 16 + 8)) * 2 +
                   2 * DHP + MAX_SEG * 8 +
                   (SCHED == TWO_PASS ? WARPS * 16 * ((n + 15) / 16 * 16 + 8) * 2 : 0);
}

template <int DHP, int STAGE, int SCHED, int SPLIT = 0>
int launch(const Layout& L, int B, cudaStream_t stream) {
  const int smem = smem_bytes<DHP, SCHED>(L.N);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<DHP, STAGE, SCHED, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(SCHED == TWO_HEADS ? L.H / 2 : L.H, SCHED == TWO_IMAGES ? B / 2 : B);
  attention_kernel<DHP, STAGE, SCHED, SPLIT><<<grid, THREADS, smem, stream>>>(L);
  return cudaGetLastError();
}

// per gather segment, the widest load (elements) that its width, head
// columns, channel offset in the head, row and batch strides and base
// addresses allow
void choose_vec(Gather& G, int H) {
  int d_off = 0;
  for (int i = 0; i < G.nseg; ++i) {
    int v = 8;
    for (; v > 1; v /= 2) {
      bool ok = G.width[i] % v == 0 && d_off % v == 0;
      if (G.has_hcol)
        for (int h = 0; h < H; ++h) ok = ok && G.hcol[h] % v == 0;
      else
        ok = ok && G.hs[i] % v == 0;
      for (int s = 0; s < 3; ++s)
        ok = ok && G.ld[i][s] % v == 0 && G.bs[i][s] % v == 0 &&
             reinterpret_cast<uintptr_t>(G.p[i][s]) % (2 * v) == 0;
      if (ok) break;
    }
    G.vec[i] = v;
    d_off += G.width[i];
  }
}

// unset batch strides -> N * ld (the token-major layouts), the load widths
// and the scale
void finish(Layout& L) {
  for (int i = 0; i < L.in.nseg; ++i)
    for (int s = 0; s < 3; ++s)
      if (L.in.bs[i][s] == 0) L.in.bs[i][s] = (size_t)L.N * L.in.ld[i][s];
  for (int i = 0; i < L.out.nseg; ++i)
    if (L.out.bs[i] == 0) L.out.bs[i] = (size_t)L.N * L.out.ld[i];
  choose_vec(L.in, L.H);
  L.scale = 1.0f / sqrtf(static_cast<float>(L.dh));
}

template <int STAGE, int SCHED>
int dispatch(Layout& L, int B, cudaStream_t stream) {
  finish(L);
  switch ((L.dh + 15) / 16 * 16) {
    case 16: return launch<16, STAGE, SCHED>(L, B, stream);
    case 32: return launch<32, STAGE, SCHED>(L, B, stream);
    case 48: return launch<48, STAGE, SCHED>(L, B, stream);
    case 64: return launch<64, STAGE, SCHED>(L, B, stream);
    case 80: return launch<80, STAGE, SCHED>(L, B, stream);
    case 96: return launch<96, STAGE, SCHED>(L, B, stream);
    case 128: return launch<128, STAGE, SCHED>(L, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// gather segment i: one array [B,N,3*H*width] in (3, H, width) column order
// (the standard and the octic layouts): the s-th block at column s*H*width
void set_gather_3h(Gather& G, int i, const void* p, int ld, int width, int H) {
  for (int s = 0; s < 3; ++s) {
    G.p[i][s] = static_cast<const bf16*>(p) + (size_t)s * H * width;
    G.ld[i][s] = ld;
  }
  G.width[i] = width;
  G.hs[i] = width;
}

// the octic scatter: o1..o4 [B,N,H*d1], oe0, oe1 [B,N,H*de], contiguous
void set_octic_scatter(Scatter& S, void* const* outs, int H, int d1, int de) {
  S.nseg = 6;
  for (int i = 0; i < 6; ++i) {
    const int w = i < 4 ? d1 : de;
    S.p[i] = static_cast<bf16*>(outs[i]);
    S.ld[i] = H * w;
    S.width[i] = w;
    S.hs[i] = w;
  }
}

}  // namespace
}  // namespace attn
}  // namespace ovt
