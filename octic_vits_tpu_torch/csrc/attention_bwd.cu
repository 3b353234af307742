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
// in the gather's layout. Each (s, head) column slice of every gradient is
// written exactly once: no zeroing, no accumulation across heads.
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
#include <math_constants.h>

#include "common.cuh"

namespace ovt {
namespace attn_bwd {

constexpr int WARPS = 8, THREADS = WARPS * 32, KB = 64, QB = 32, UNROLL = 4;
constexpr int MAX_SEG = 6;

// Head h's channels of one operand: segment i holds `width[i]` consecutive
// channels of the head at column h * hs[i] of the array p[i][s] (s = 0, 1, 2
// for q, k, v; the cotangent uses s = 0 only), token rows ld[i][s] elements
// apart, batch rows bs[i][s] (N * ld[i][s] unless set).
struct Heads {
  int nseg;
  const bf16* p[MAX_SEG][3];
  int ld[MAX_SEG][3];
  size_t bs[MAX_SEG][3];
  int width[MAX_SEG], hs[MAX_SEG];
  int vec[MAX_SEG];  // elements per gather load, chosen by the host
};

struct Args {
  Heads qkv;                // q, k, v
  Heads g;                  // the output cotangent, in the six-irrep output layout
  bf16* d[MAX_SEG][3];      // dq, dk, dv: the layout of qkv (its widths and head strides)
  int d_ld[MAX_SEG][3];
  size_t d_bs[MAX_SEG][3];  // their batch strides (N * d_ld unless set)
  float* lse;   // [B,H,N] scratch: log2-sum-exp2 of the scaled scores
  float* dsum;  // [B,H,N] scratch: rowsum(dP o P)
  int N, H, dh;
  int pair_out;  // 1: the gradients take 4-byte bf16x2 stores
  float scale;
};

// rows [kpad][DS] of one segment of one operand (`width` channels from
// `src`, the head's column in row 0 of batch 0, token rows `ld` and batch
// rows `bs` apart) at channels
// [d_off, d_off + width); rows >= N are zero. Each thread keeps one V-element
// chunk of the row and steps over the rows, UNROLL loads in flight, so the
// loop has no division; consecutive threads take consecutive chunks of a row.
template <int DHP, int V>
__device__ __forceinline__ void gather_seg(const bf16* src, int ld, size_t bs, int width,
                                           int d_off, int b, int N, int kpad, bf16* dst) {
  typedef typename VecOf<V>::T Vec;
  constexpr int DS = DHP + 8;
  const int cpr = width / V, rows = THREADS / cpr;
  if (threadIdx.x >= rows * cpr) return;
  const int c = threadIdx.x % cpr;
  const bf16* from = src + b * bs + c * V;
  bf16* to = dst + d_off + c * V;
  for (int n = threadIdx.x / cpr; n < kpad; n += rows * UNROLL) {
    Vec v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = n + u * rows;
      v[u] = Vec{};
      if (m < N) v[u] = *reinterpret_cast<const Vec*>(from + (size_t)m * ld);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = n + u * rows;
      if (m < kpad) *reinterpret_cast<Vec*>(to + m * DS) = v[u];
    }
  }
}

// rows [kpad][DS] of operand s of table T for head h; rows >= N and channels
// >= dh are zero. Each segment takes its own load width.
template <int DHP>
__device__ __forceinline__ void gather_rows(const Heads& T, int s, const Args& A, int b, int h,
                                            int kpad, bf16* dst) {
  constexpr int DS = DHP + 8;
  const bf16 zero = __float2bfloat16(0.f);
  const int pad = DHP - A.dh;
  for (int i = threadIdx.x; i < kpad * pad; i += THREADS)
    dst[(i / pad) * DS + A.dh + i % pad] = zero;
  int d_off = 0;
  for (int i = 0; i < T.nseg; ++i) {
    const bf16* src = T.p[i][s] + (size_t)h * T.hs[i];
    const int ld = T.ld[i][s], w = T.width[i];
    const size_t bs = T.bs[i][s];
    switch (T.vec[i]) {
      case 8: gather_seg<DHP, 8>(src, ld, bs, w, d_off, b, A.N, kpad, dst); break;
      case 4: gather_seg<DHP, 4>(src, ld, bs, w, d_off, b, A.N, kpad, dst); break;
      case 2: gather_seg<DHP, 2>(src, ld, bs, w, d_off, b, A.N, kpad, dst); break;
      default: gather_seg<DHP, 1>(src, ld, bs, w, d_off, b, A.N, kpad, dst); break;
    }
    d_off += w;
  }
}

// shared memory: q, k, v, dO rows [kpad][DHP+8] bf16, the statistics
// [2][kpad] f32, the channel -> (segment, offset) tables
__host__ __device__ constexpr int smem_bytes(int kpad, int dhp) {
  return 4 * kpad * (dhp + 8) * 2 + 2 * kpad * 4 + 2 * dhp;
}

struct Smem {
  bf16 *qs, *ks, *vs, *gs;
  float *lse, *dsum;
  unsigned char *seg_of, *w_of;
};

// carve shared memory, build the channel table and gather the head
template <int DHP>
__device__ __forceinline__ Smem load_head(const Args& A, unsigned char* raw, int kpad, int b,
                                          int h) {
  constexpr int DS = DHP + 8;
  Smem S;
  S.qs = reinterpret_cast<bf16*>(raw);
  S.ks = S.qs + kpad * DS;
  S.vs = S.ks + kpad * DS;
  S.gs = S.vs + kpad * DS;
  S.lse = reinterpret_cast<float*>(S.gs + kpad * DS);
  S.dsum = S.lse + kpad;
  S.seg_of = reinterpret_cast<unsigned char*>(S.dsum + kpad);
  S.w_of = S.seg_of + DHP;
  // channel of q, k, v -> (gather segment, channel within it), for the stores
  for (int d = threadIdx.x; d < DHP; d += THREADS) {
    int i = 0, base = 0;
    while (i < A.qkv.nseg - 1 && d >= base + A.qkv.width[i]) base += A.qkv.width[i++];
    S.seg_of[d] = static_cast<unsigned char>(i);
    S.w_of[d] = static_cast<unsigned char>(d - base);
  }
  gather_rows<DHP>(A.qkv, 0, A, b, h, kpad, S.qs);
  gather_rows<DHP>(A.qkv, 1, A, b, h, kpad, S.ks);
  gather_rows<DHP>(A.qkv, 2, A, b, h, kpad, S.vs);
  gather_rows<DHP>(A.g, 0, A, b, h, kpad, S.gs);
  return S;
}

// A fragments (16 rows from r0, all DHP channels) of a row tile
template <int DHP>
__device__ __forceinline__ void load_a(uint32_t (&f)[DHP / 16][4], const bf16* rows, int r0,
                                       int lane) {
  constexpr int DS = DHP + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < DHP / 16; ++kc) {
    const bf16* p = rows + (r0 + g) * DS + kc * 16 + 2 * t;
    f[kc][0] = *reinterpret_cast<const uint32_t*>(p);
    f[kc][1] = *reinterpret_cast<const uint32_t*>(p + 8 * DS);
    f[kc][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    f[kc][3] = *reinterpret_cast<const uint32_t*>(p + 8 * DS + 8);
  }
}

// c += A(16 x DHP) * rows[n0..n0+8)^T: one m16n8 tile of a "row-times-row"
// product (scores, dP), the B operand read as 32-bit pairs from row tiles
template <int DHP>
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[DHP / 16][4],
                                         const bf16* rows, int n0, int lane) {
  constexpr int DS = DHP + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < DHP / 16; ++kc) {
    const bf16* p = rows + (n0 + g) * DS + kc * 16 + 2 * t;
    mma_bf16(c, a[kc], *reinterpret_cast<const uint32_t*>(p),
             *reinterpret_cast<const uint32_t*>(p + 8));
  }
}

// acc[DHP/8] += A(16 x 16) * rows[k0..k0+16)[0..DHP): the B operand is the
// row tile itself (k = token), read transposed with ldmatrix.trans
template <int DHP>
__device__ __forceinline__ void mma_trans(float (&acc)[DHP / 8][4], const uint32_t (&a)[4],
                                          const bf16* rows, int k0, int lane) {
  constexpr int DS = DHP + 8;
#pragma unroll
  for (int nj = 0; nj < DHP / 16; ++nj) {
    uint32_t bfr[4];
    ldmatrix_x4_trans(bfr, rows + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS + nj * 16 +
                               (lane >> 4) * 8);
    mma_bf16(acc[2 * nj], a, bfr[0], bfr[1]);
    mma_bf16(acc[2 * nj + 1], a, bfr[2], bfr[3]);
  }
}

// C fragments of two adjacent n-tiles -> one A fragment (16 x 16), bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// write the accumulator tile of 16 rows from r0 into gradient slice s
template <int DHP>
__device__ __forceinline__ void store_rows(const Args& A, const Smem& S, const float (&acc)[DHP / 8][4],
                                           int s, int b, int h, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < DHP / 8; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = r0 + g + hf * 8;
      const int d = i * 8 + 2 * t;  // even; dh is a multiple of 8
      if (n >= A.N || d >= A.dh) continue;
      const int sg = S.seg_of[d];
      bf16* dst = A.d[sg][s] + b * A.d_bs[sg][s] + (size_t)n * A.d_ld[sg][s] +
                  (size_t)h * A.qkv.hs[sg] + S.w_of[d];
      const float v0 = acc[i][2 * hf], v1 = acc[i][2 * hf + 1];
      if (A.pair_out) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v0, v1);
      } else {
        dst[0] = __float2bfloat16(v0);
        const int sg1 = S.seg_of[d + 1];
        A.d[sg1][s][b * A.d_bs[sg1][s] + (size_t)n * A.d_ld[sg1][s] +
                    (size_t)h * A.qkv.hs[sg1] + S.w_of[d + 1]] = __float2bfloat16(v1);
      }
    }
}

// Query pass: dQ, and the row statistics into scratch.
template <int DHP>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(const Args A) {
  constexpr int KC = DHP / 16, NT = DHP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = A.N, kpad = (N + 15) / 16 * 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3, g = lane >> 2;
  const Smem S = load_head<DHP>(A, smem_raw, kpad, b, h);
  __syncthreads();
  const float sl2 = A.scale * 1.4426950408889634f;

  for (int r0 = warp * 16; r0 < kpad; r0 += WARPS * 16) {
    uint32_t qf[KC][4], gf[KC][4];
    load_a<DHP>(qf, S.qs, r0, lane);
    load_a<DHP>(gf, S.gs, r0, lane);

    // sweep 1: online max m, sum l of exp2(s - m), and sum of exp2(s - m) dP
    float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F}, lrow[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
    for (int kb = 0; kb < kpad; kb += KB) {
      float s[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        if (kb + nt * 8 < kpad) {
          mma_rows<DHP>(s[nt], qf, S.ks, kb + nt * 8, lane);
          mma_rows<DHP>(dp[nt], gf, S.vs, kb + nt * 8, lane);
        }
      }
      // every block holds a real key (kb <= kpad - 16 < N): the max is finite
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + nt * 8 + 2 * t + (e & 1);
          s[nt][e] = key < N ? s[nt][e] * sl2 : -CUDART_INF_F;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mnew = fmaxf(mrow[r], mx[r]);
        const float alpha = exp2f(mrow[r] - mnew);
        mrow[r] = mnew;
        lrow[r] *= alpha;
        drow[r] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[nt][e] - mrow[e >> 1]);
          lrow[e >> 1] += p;
          drow[e >> 1] += p * dp[nt][e];
        }
    }
    float lse[2], dsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
      drow[r] += __shfl_xor_sync(0xffffffffu, drow[r], 1);
      drow[r] += __shfl_xor_sync(0xffffffffu, drow[r], 2);
      lse[r] = mrow[r] + log2f(lrow[r]);
      dsum[r] = drow[r] / lrow[r];
    }

    // sweep 2: P, dP -> dS -> dQ += dS K
    float dq[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
    for (int kb = 0; kb < kpad; kb += KB) {
      float s[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        if (kb + nt * 8 < kpad) {
          mma_rows<DHP>(s[nt], qf, S.ks, kb + nt * 8, lane);
          mma_rows<DHP>(dp[nt], gf, S.vs, kb + nt * 8, lane);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + nt * 8 + 2 * t + (e & 1), r = e >> 1;
          const float p = key < N ? exp2f(s[nt][e] * sl2 - lse[r]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - dsum[r]) * A.scale;
        }
#pragma unroll
      for (int kc = 0; kc < KB / 16; ++kc) {
        if (kb + kc * 16 >= kpad) break;
        uint32_t af[4];
        c_to_a(af, s[2 * kc], s[2 * kc + 1]);
        mma_trans<DHP>(dq, af, S.ks, kb + kc * 16, lane);
      }
    }
    store_rows<DHP>(A, S, dq, 0, b, h, r0, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = r0 + g + r * 8;
        if (n < N) {
          const size_t o = ((size_t)b * A.H + h) * N + n;
          A.lse[o] = lse[r];
          A.dsum[o] = dsum[r];
        }
      }
    }
  }
}

// Key pass: dK and dV from the statistics of the query pass.
template <int DHP>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(const Args A) {
  constexpr int KC = DHP / 16, NT = DHP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = A.N, kpad = (N + 15) / 16 * 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const Smem S = load_head<DHP>(A, smem_raw, kpad, b, h);
  for (int n = threadIdx.x; n < kpad; n += THREADS) {
    const size_t o = ((size_t)b * A.H + h) * N + n;
    S.lse[n] = n < N ? A.lse[o] : 0.f;
    S.dsum[n] = n < N ? A.dsum[o] : 0.f;
  }
  __syncthreads();
  const float sl2 = A.scale * 1.4426950408889634f;

  for (int j0 = warp * 16; j0 < kpad; j0 += WARPS * 16) {
    uint32_t kf[KC][4], vf[KC][4];
    load_a<DHP>(kf, S.ks, j0, lane);
    load_a<DHP>(vf, S.vs, j0, lane);
    float dk[NT][4], dv[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

    for (int ib = 0; ib < kpad; ib += QB) {
      // transposed tiles: rows = this warp's keys, columns = queries
      float st[QB / 8][4], dpt[QB / 8][4];
#pragma unroll
      for (int nt = 0; nt < QB / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
        if (ib + nt * 8 < kpad) {
          mma_rows<DHP>(st[nt], kf, S.qs, ib + nt * 8, lane);
          mma_rows<DHP>(dpt[nt], vf, S.gs, ib + nt * 8, lane);
        }
      }
#pragma unroll
      for (int nt = 0; nt < QB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = ib + nt * 8 + 2 * t + (e & 1);
          const float p = q < N ? exp2f(st[nt][e] * sl2 - S.lse[q]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - S.dsum[q]) * A.scale;
        }
#pragma unroll
      for (int kc = 0; kc < QB / 16; ++kc) {
        if (ib + kc * 16 >= kpad) break;
        uint32_t pa[4], da[4];
        c_to_a(pa, st[2 * kc], st[2 * kc + 1]);
        c_to_a(da, dpt[2 * kc], dpt[2 * kc + 1]);
        mma_trans<DHP>(dv, pa, S.gs, ib + kc * 16, lane);
        mma_trans<DHP>(dk, da, S.qs, ib + kc * 16, lane);
      }
    }
    store_rows<DHP>(A, S, dk, 1, b, h, j0, lane);
    store_rows<DHP>(A, S, dv, 2, b, h, j0, lane);
  }
}

template <int DHP>
int launch(const Args& A, int B, cudaStream_t stream) {
  const int kpad = (A.N + 15) / 16 * 16;
  const int smem = smem_bytes(kpad, DHP);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<DHP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<DHP><<<dim3(A.H, B), THREADS, smem, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<DHP><<<dim3(A.H, B), THREADS, smem, stream>>>(A);
  return cudaGetLastError();
}

// per segment, the widest load (elements) that its width, head stride,
// channel offset in the head, row strides and base addresses allow, as in the
// forward (csrc/attention.cu:choose_vec); `ns` arrays per segment (3 for q,
// k, v; 1 for the cotangent)
void choose_vec(Heads& T, int ns) {
  int d_off = 0;
  for (int i = 0; i < T.nseg; ++i) {
    int v = 8;
    for (; v > 1; v /= 2) {
      bool ok = T.width[i] % v == 0 && T.hs[i] % v == 0 && d_off % v == 0;
      for (int s = 0; s < ns; ++s)
        ok = ok && T.ld[i][s] % v == 0 && T.bs[i][s] % v == 0 &&
             reinterpret_cast<uintptr_t>(T.p[i][s]) % (2 * v) == 0;
      if (ok) break;
    }
    T.vec[i] = v;
    d_off += T.width[i];
  }
}

// unset batch strides -> N * ld (the token-major layouts)
void default_batch_strides(Args& A) {
  for (int i = 0; i < MAX_SEG; ++i)
    for (int s = 0; s < 3; ++s) {
      if (A.qkv.bs[i][s] == 0) A.qkv.bs[i][s] = (size_t)A.N * A.qkv.ld[i][s];
      if (A.g.bs[i][s] == 0) A.g.bs[i][s] = (size_t)A.N * A.g.ld[i][s];
      if (A.d_bs[i][s] == 0) A.d_bs[i][s] = (size_t)A.N * A.d_ld[i][s];
    }
}

int dispatch(Args& A, int B, cudaStream_t stream) {
  default_batch_strides(A);
  choose_vec(A.qkv, 3);
  choose_vec(A.g, 1);
  A.pair_out = 1;
  for (int i = 0; i < A.qkv.nseg; ++i) {
    A.pair_out = A.pair_out && A.qkv.width[i] % 2 == 0 && A.qkv.hs[i] % 2 == 0;
    for (int s = 0; s < 3; ++s)
      A.pair_out = A.pair_out && A.d_ld[i][s] % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(A.d[i][s]) % 4 == 0;
  }
  A.scale = 1.0f / sqrtf(static_cast<float>(A.dh));
  switch ((A.dh + 15) / 16 * 16) {
    case 16: return launch<16>(A, B, stream);
    case 32: return launch<32>(A, B, stream);
    case 48: return launch<48>(A, B, stream);
    case 64: return launch<64>(A, B, stream);
    case 80: return launch<80>(A, B, stream);
    case 96: return launch<96>(A, B, stream);
    case 128: return launch<128>(A, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// segment i of q, k, v and of their gradients: one array [B,N,3*H*width] in
// (3, H, width) column order each (the standard and the octic layouts)
void set_qkv_3h(Args& A, int i, const void* p, int ld, void* d, int width, int H) {
  for (int s = 0; s < 3; ++s) {
    A.qkv.p[i][s] = static_cast<const bf16*>(p) + (size_t)s * H * width;
    A.qkv.ld[i][s] = ld;
    A.d[i][s] = static_cast<bf16*>(d) + (size_t)s * H * width;
    A.d_ld[i][s] = 3 * H * width;
  }
  A.qkv.width[i] = width;
  A.qkv.hs[i] = width;
}

// the cotangent in the octic output layout: g1..g4 [B,N,H*d1], ge0, ge1
// [B,N,H*de], each with its own row stride
void set_octic_g(Args& A, const void* const* gs, const int* lg, int d1, int de) {
  A.g.nseg = 6;
  for (int i = 0; i < 6; ++i) {
    A.g.p[i][0] = static_cast<const bf16*>(gs[i]);
    A.g.ld[i][0] = lg[i];
    A.g.width[i] = A.g.hs[i] = i < 4 ? d1 : de;
  }
}

void set_common(Args& A, void* lse, void* dsum, int N, int H, int dh) {
  A.lse = static_cast<float*>(lse);
  A.dsum = static_cast<float*>(dsum);
  A.N = N;
  A.H = H;
  A.dh = dh;
}

}  // namespace attn_bwd
}  // namespace ovt

// qkv [B,N,3*H*dh] contiguous in (3, H, dh) column order, g [B,N,H*dh] with
// token row stride ld_g, dqkv [B,N,3*H*dh] contiguous; lse and dsum f32
// scratch [B,H,N]. Returns the cudaError_t of the launches.
OVT_EXPORT int ovt_attention_std_bwd(const void* qkv, const void* g, int ld_g, void* dqkv,
                                     void* lse, void* dsum, int B, int N, int H, int dh,
                                     void* stream) {
  ovt::attn_bwd::Args A = {};
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
    void* stream) {
  ovt::attn_bwd::Args A = {};
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

// Wide-1d octic layout (see ovt_attention_wide1d in csrc/attention.cu): q1d,
// k1d, v1d [B,N,4*H*d1] and e0, e1 [B,N,3*H*de], each with its own token row
// stride; the six cotangents as in ovt_attention_octic_bwd; dq1d, dk1d, dv1d
// [B,N,4*H*d1] and de0, de1 [B,N,3*H*de] contiguous.
OVT_EXPORT int ovt_attention_wide1d_bwd(
    const void* q1d, const void* k1d, const void* v1d, const void* e0, const void* e1, int lq,
    int lk, int lv, int le0, int le1, const void* g1, const void* g2, const void* g3,
    const void* g4, const void* ge0, const void* ge1, int lg1, int lg2, int lg3, int lg4,
    int lge0, int lge1, void* dq1d, void* dk1d, void* dv1d, void* de0, void* de1, void* lse,
    void* dsum, int B, int N, int H, int d1, int de, void* stream) {
  ovt::attn_bwd::Args A = {};
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

// Wide octic layout (see ovt_attention_wide in csrc/attention.cu): qkv
// [B,N,3*H*dh] contiguous, dh = 4*d1 + 2*de; the six cotangents as in
// ovt_attention_octic_bwd; dqkv [B,N,3*H*dh] contiguous.
OVT_EXPORT int ovt_attention_wide_bwd(const void* qkv, const void* g1, const void* g2,
                                      const void* g3, const void* g4, const void* ge0,
                                      const void* ge1, int lg1, int lg2, int lg3, int lg4,
                                      int lge0, int lge1, void* dqkv, void* lse, void* dsum,
                                      int B, int N, int H, int d1, int de, void* stream) {
  ovt::attn_bwd::Args A = {};
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
