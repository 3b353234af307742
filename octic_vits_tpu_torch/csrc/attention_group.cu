// K-attn-group: softmax(Q K^T * scale) V and its backward for a group of G
// heads a CTA, with 64-key tiles of the group's k and v streamed through
// shared memory under an online softmax (probes of kernel row 14c).
//
// Replaces (scripts/r3_attn_bwd_ablate.py, at its layouts; shapes B, N, C, H):
//   k_std_pack_fwd (call :839, P = 2, 4): standard attention over qkv [B,N,3C]
//     in (3, H, dh) order, P heads a step, ONE row max shared by the P heads'
//     scores, one P*dh-wide store -> out [B,N,C];
//   k_std_pack_bwd (call :865): its backward (the shared max again) -> dqkv;
//   k_std_maskpair_fwd / _bwd (calls :883, :895): head pairs loaded and stored
//     2*dh wide, each head's scores q_pair . (k_pair o mask_h)^T over the full
//     2*dh contraction (the other head's channels masked to zero);
//   k_octic_maskpair_fwd, k_octic_maskquad_fwd (call :926) and their
//     backwards k_octic_maskpair_bwd, k_octic_maskquad_bwd (calls :926, :779):
//     the same masked contraction over pairs and quads of heads of the six
//     octic arrays (a1..b2 [B,N,3C/8] in (3, H, d1) order, e0, e1 [B,N,3C/4]
//     in (3, H, de) order), each group's piece of each array loaded and stored
//     as one G-wide slice.
// Template parameters: G (1, 2, 4 heads a CTA), MASKED (each head's scores and
// products over the whole G*dh contraction, the other heads' channels zero, as
// the TPU kernels compute them: the zero terms are computed, G times the
// products of one head), SHARED (one row max over the G heads' scores, as the
// pack kernels take it; the softmax is then shifted by the group's max and not
// by the head's own, which only matters where a head's scores lie far below
// the group's). G = 1 is the family's own baseline, one head a CTA.
//
// What bounds it on the H100: the function is K-attn's (4 b n^2 c products
// forward, 10 backward, over 4 and 7 b n c bf16 values: below the card's
// ridge); MASKED does G times the products. What the design does about the
// card: K-attn stages one head (N = 257, dh = 80) in ~141 KB of shared
// memory, so a pair (~185 KB) or a quad (~371 KB) of heads does not fit, and
// the TPU's block-placed [P N, P dh] scratches (164 KB a pair, 658 KB a quad)
// and their zeroing at grid step 0 have no meaning across CTAs. So each CTA
// takes a block of query rows (the dq pass and the forward) or key rows (the
// dk/dv pass) of its group and streams 64-row tiles of the other operands
// through shared memory (a quad's k and v tile: ~84 KB). Each warp owns 16 rows
// of one head of the group (warp w: head w % G), so its accumulators are one
// head's, however wide the group. Rows go between device memory and shared
// memory as one G-wide slice of each array per row, with the widest vector
// the slice's width and alignment allow (16-byte loads for a standard group
// or an octic quad, 8-byte for an octic pair, 4-byte for one octic head), and
// land in shared memory head by head (each head's dh channels contiguous).
// The backward is FlashAttention-2 style, as K-attn-bwd's mma.sync core
// (csrc/attention_bwd_core.cuh): a query pass (two sweeps over key tiles: the
// row statistics, then dQ) writes
// the row log-sum-exp and rowsum(dP o P) to [B,H,N] f32 scratch; a key pass
// (one sweep over 32-row query tiles) accumulates dK and dV. No atomics: every
// sum has a fixed order. P and dS are rounded to bf16 only as MMA operands.
#include <math_constants.h>

#include "common.cuh"

namespace ovt {
namespace attn_group {
namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32, KT = 64, QT = 32, DH = 80, MAX_SEG = 6;
constexpr float LOG2E = 1.4426950408889634f;

// One operand's layout: segment i holds `width[i]` channels a head, head h's
// at column h * width[i] of p[i][s] (s = 0, 1, 2 for q, k, v; 0 alone for the
// output and the cotangent), token rows ld[i][s] apart, batch rows bs[i][s]
// apart. The segments follow each other in the head's channel order.
struct Table {
  int nseg;
  bf16* p[MAX_SEG][3];
  int ld[MAX_SEG][3];
  size_t bs[MAX_SEG][3];
  int width[MAX_SEG];
  int vec[MAX_SEG];  // elements per load or store of the group's slice, chosen by the host
};

struct Args {
  Table in;   // q, k, v
  Table out;  // forward: the output; backward: the cotangent dO
  Table d;    // backward: dq, dk, dv, in the layout of `in`
  float* lse;   // [B,H,N] scratch: log2-sum-exp2 of the scaled scores
  float* dsum;  // [B,H,N] scratch: rowsum(dP o P)
  int N, H;
  float scale;
};

// The group's slice of one segment (G * w channels from `row`, the segment's
// column of head h0 in token row 0 of the batch row) for token rows
// [row0, row0 + nrows) <-> shared memory rows [nrows][SW], head j's channels
// at [j * DH + off, j * DH + off + w). Rows >= N load as zero and are not
// stored. Consecutive threads take consecutive vectors of a row, one vector
// each. (Keeping one column a thread and four rows' loads in flight, as the
// K-attn gathers do, took the forward kernels from 127-134 registers to
// 164-188, one CTA an SM instead of two, and 1.4x the time on the H100.)
template <int G, int V, bool LOAD>
__device__ __forceinline__ void move_seg(bf16* row, int ld, int w, int off, int row0, int nrows,
                                         int N, bf16* sm) {
  typedef typename VecOf<V>::T Vec;
  constexpr int SW = G * DH + 8;
  const int cpr = G * w / V;
  for (int idx = threadIdx.x; idx < nrows * cpr; idx += THREADS) {
    const int r = idx / cpr, c = idx - r * cpr, n = row0 + r;
    Vec v{};
    bf16* e = reinterpret_cast<bf16*>(&v);
    if (LOAD) {
      if (n < N) v = *reinterpret_cast<const Vec*>(row + (size_t)n * ld + c * V);
    } else if (n >= N) {
      continue;
    }
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const int col = c * V + j, head = col / w;
      uint32_t* s = reinterpret_cast<uint32_t*>(sm + r * SW + head * DH + off + col - head * w);
      uint32_t* x = reinterpret_cast<uint32_t*>(e + j);
      if (LOAD)
        *s = *x;
      else
        *x = *s;
    }
    if (!LOAD) *reinterpret_cast<Vec*>(row + (size_t)n * ld + c * V) = v;
  }
}

// every segment of operand s of table T for the group of heads from h0
template <int G, bool LOAD>
__device__ __forceinline__ void move_rows(const Table& T, int s, int b, int h0, int row0,
                                          int nrows, int N, bf16* sm) {
  int off = 0;
  for (int i = 0; i < T.nseg; ++i) {
    const int w = T.width[i];
    bf16* row = T.p[i][s] + b * T.bs[i][s] + (size_t)h0 * w;
    const int ld = T.ld[i][s];
    switch (T.vec[i]) {
      case 8: move_seg<G, 8, LOAD>(row, ld, w, off, row0, nrows, N, sm); break;
      case 4: move_seg<G, 4, LOAD>(row, ld, w, off, row0, nrows, N, sm); break;
      default: move_seg<G, 2, LOAD>(row, ld, w, off, row0, nrows, N, sm); break;
    }
    off += w;
  }
}

// A fragment (16 rows from r0, channels [c0, c0 + 16)) of a row tile
template <int SW>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* rows, int r0, int c0,
                                       int lane) {
  const bf16* p = rows + (r0 + (lane >> 2)) * SW + c0 + 2 * (lane & 3);
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 8 * SW);
  f[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  f[3] = *reinterpret_cast<const uint32_t*>(p + 8 * SW + 8);
}

// c += A(16 x 16, channels [c0, c0 + 16)) * rows[n0..n0+8)^T over one k-chunk
template <int SW>
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[4], const bf16* rows,
                                         int n0, int c0, int lane) {
  const bf16* p = rows + (n0 + (lane >> 2)) * SW + c0 + 2 * (lane & 3);
  mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(p), *reinterpret_cast<const uint32_t*>(p + 8));
}

// (c0, c1) += A(16 x 16) * rows[k0..k0+16)[c0..c0+16): the B operand is the
// row tile itself (k = token), read transposed with ldmatrix.trans
template <int SW>
__device__ __forceinline__ void mma_trans2(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                           const bf16* rows, int k0, int col, int lane) {
  uint32_t bfr[4];
  ldmatrix_x4_trans(bfr, rows + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SW + col +
                             (lane >> 4) * 8);
  mma_bf16(c0, a, bfr[0], bfr[1]);
  mma_bf16(c1, a, bfr[2], bfr[3]);
}

__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

template <int N_>
__device__ __forceinline__ void zero(float (&c)[N_][4]) {
#pragma unroll
  for (int i = 0; i < N_; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// Scores s = q . k^T of the warp's 16 rows (its head hw; fragments qf) against
// the 64 rows of a k tile, and with `dp`, dP = dO . v^T from the fragments gf.
// MASKED adds the other heads' channels of the contraction: q's against zero
// (k masked to head hw) and zero (dO masked) against v's.
template <int G, int MASKED, bool DP>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], float (&dp)[8][4],
                                            const uint32_t (&qf)[DH / 16][4],
                                            const uint32_t (&gf)[DH / 16][4], const bf16* qs,
                                            const bf16* ks, const bf16* vs, int r0, int hw,
                                            int lane) {
  constexpr int SW = G * DH + 8, KC = DH / 16;
  zero(s);
  if (DP) zero(dp);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      mma_rows<SW>(s[nt], qf[kc], ks, nt * 8, hw * DH + kc * 16, lane);
      if (DP) mma_rows<SW>(dp[nt], gf[kc], vs, nt * 8, hw * DH + kc * 16, lane);
    }
  if constexpr (MASKED && G > 1) {
    const uint32_t z[4] = {0u, 0u, 0u, 0u};
    for (int j = 0; j < G; ++j) {
      if (j == hw) continue;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        frag_a<SW>(a, qs, r0, j * DH + kc * 16, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mma_bf16(s[nt], a, 0u, 0u);
          if (DP) mma_rows<SW>(dp[nt], z, vs, nt * 8, j * DH + kc * 16, lane);
        }
      }
    }
  }
}

// the row max of the warp's scores over the lane quad and, with SHARED, over
// the G warps that hold the same rows of the group's other heads
template <int G, int SHARED>
__device__ __forceinline__ void row_max(float (&mx)[2], float* red, int warp, int rt, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  if constexpr (SHARED && G > 1) {
    const int g = lane >> 2;
    if ((lane & 3) == 0) {
      red[warp * 16 + g] = mx[0];
      red[warp * 16 + g + 8] = mx[1];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < G; ++j) {
      mx[0] = fmaxf(mx[0], red[(rt * G + j) * 16 + g]);
      mx[1] = fmaxf(mx[1], red[(rt * G + j) * 16 + g + 8]);
    }
  }
}

// the accumulators of the other heads' output channels (MASKED), which the
// TPU kernels compute and mask away, folded into o with a factor of zero the
// compiler cannot see, so that their products stay in the kernel
__device__ __forceinline__ void fold(float (&o)[4], const float (&dummy)[4], int N) {
  const float none = static_cast<float>(N < 0);
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] += dummy[e] * none;
}

// Forward: one CTA of 8 warps per (group, batch, block of QR query rows).
template <int G, int MASKED, int SHARED>
__global__ void __launch_bounds__(THREADS) group_fwd_kernel(const Args A) {
  constexpr int SW = G * DH + 8, QR = 16 * WARPS / G, KC = DH / 16, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [QR][SW], then the output rows
  bf16* ks = qs + QR * SW;                        // [KT][SW]
  bf16* vs = ks + KT * SW;                        // [KT][SW]
  float* red = reinterpret_cast<float*>(vs + KT * SW);  // [WARPS][16]
  const int N = A.N, h0 = blockIdx.x * G, b = blockIdx.y, q0 = blockIdx.z * QR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, hw = warp % G, rt = warp / G;
  const int g = lane >> 2, t = lane & 3, r0 = rt * 16;
  move_rows<G, true>(A.in, 0, b, h0, q0, QR, N, qs);
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) frag_a<SW>(qf[kc], qs, r0, hw * DH + kc * 16, lane);
  const float sl = A.scale * LOG2E;
  float o[NT][4], dummy[4] = {0.f, 0.f, 0.f, 0.f};
  float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F}, lrow[2] = {0.f, 0.f};
  zero(o);
  for (int kb = 0; kb < N; kb += KT) {
    __syncthreads();  // the previous tile and the row maxima are consumed
    move_rows<G, true>(A.in, 1, b, h0, kb, KT, N, ks);
    move_rows<G, true>(A.in, 2, b, h0, kb, KT, N, vs);
    __syncthreads();
    float s[8][4];
    tile_scores<G, MASKED, false>(s, s, qf, qf, qs, ks, vs, r0, hw, lane);
    // every tile holds a real key (kb < N), so the running max stays finite
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = key < N ? s[nt][e] * sl : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    row_max<G, SHARED>(mx, red, warp, rt, lane);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(mrow[r], mx[r]);
      alpha[r] = exp2f(mrow[r] - mnew);
      mrow[r] = mnew;
      lrow[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mrow[e >> 1]);
        lrow[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      uint32_t pf[4];
      c_to_a(pf, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nj = 0; nj < DH / 16; ++nj)
        mma_trans2<SW>(o[2 * nj], o[2 * nj + 1], pf, vs, kc * 16, hw * DH + nj * 16, lane);
      if constexpr (MASKED && G > 1)
        for (int j = 0; j < G; ++j) {
          if (j == hw) continue;
#pragma unroll
          for (int nj = 0; nj < DH / 16; ++nj)
            mma_trans2<SW>(dummy, dummy, pf, vs, kc * 16, j * DH + nj * 16, lane);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    lrow[r] = 1.f / lrow[r];
  }
  if constexpr (MASKED && G > 1) fold(o[0], dummy, N);
  __syncthreads();  // every warp is done with qs (MASKED reads the other heads' rows)
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(qs + (r0 + g + 8 * r) * SW + hw * DH + i * 8 + 2 * t) =
          pack_bf16x2(o[i][2 * r] * lrow[r], o[i][2 * r + 1] * lrow[r]);
  __syncthreads();
  move_rows<G, false>(A.out, 0, b, h0, q0, QR, N, qs);
}

// Backward, query pass: dQ of the CTA's QR query rows and the row statistics.
template <int G, int MASKED, int SHARED>
__global__ void __launch_bounds__(THREADS) group_bwd_dq_kernel(const Args A) {
  constexpr int SW = G * DH + 8, QR = 16 * WARPS / G, KC = DH / 16, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [QR][SW], then dq
  bf16* gs = qs + QR * SW;                        // [QR][SW] dO
  bf16* ks = gs + QR * SW;                        // [KT][SW]
  bf16* vs = ks + KT * SW;                        // [KT][SW]
  float* red = reinterpret_cast<float*>(vs + KT * SW);
  const int N = A.N, h0 = blockIdx.x * G, b = blockIdx.y, q0 = blockIdx.z * QR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, hw = warp % G, rt = warp / G;
  const int g = lane >> 2, t = lane & 3, r0 = rt * 16;
  move_rows<G, true>(A.in, 0, b, h0, q0, QR, N, qs);
  move_rows<G, true>(A.out, 0, b, h0, q0, QR, N, gs);
  __syncthreads();
  uint32_t qf[KC][4], gf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    frag_a<SW>(qf[kc], qs, r0, hw * DH + kc * 16, lane);
    frag_a<SW>(gf[kc], gs, r0, hw * DH + kc * 16, lane);
  }
  const float sl = A.scale * LOG2E;

  // sweep 1: online max m, sum l of exp2(s - m), and sum of exp2(s - m) dP
  float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F}, lrow[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
  for (int kb = 0; kb < N; kb += KT) {
    __syncthreads();
    move_rows<G, true>(A.in, 1, b, h0, kb, KT, N, ks);
    move_rows<G, true>(A.in, 2, b, h0, kb, KT, N, vs);
    __syncthreads();
    float s[8][4], dp[8][4];
    tile_scores<G, MASKED, true>(s, dp, qf, gf, qs, ks, vs, r0, hw, lane);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = key < N ? s[nt][e] * sl : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    row_max<G, SHARED>(mx, red, warp, rt, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
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

  // sweep 2: P, dP -> dS -> dQ += dS K (MASKED: the other heads' channels of
  // K are zero, and their products go to `dummy`)
  float dq[NT][4], dummy[4] = {0.f, 0.f, 0.f, 0.f};
  zero(dq);
  const uint32_t z[4] = {0u, 0u, 0u, 0u};
  for (int kb = 0; kb < N; kb += KT) {
    __syncthreads();
    move_rows<G, true>(A.in, 1, b, h0, kb, KT, N, ks);
    move_rows<G, true>(A.in, 2, b, h0, kb, KT, N, vs);
    __syncthreads();
    float s[8][4], dp[8][4];
    tile_scores<G, MASKED, true>(s, dp, qf, gf, qs, ks, vs, r0, hw, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nt * 8 + 2 * t + (e & 1), r = e >> 1;
        const float p = key < N ? exp2f(s[nt][e] * sl - lse[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dsum[r]) * A.scale;
      }
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      uint32_t af[4];
      c_to_a(af, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nj = 0; nj < DH / 16; ++nj)
        mma_trans2<SW>(dq[2 * nj], dq[2 * nj + 1], af, ks, kc * 16, hw * DH + nj * 16, lane);
      if constexpr (MASKED && G > 1)
        for (int j = 0; j < G; ++j) {
          if (j == hw) continue;
#pragma unroll
          for (int nj = 0; nj < DH / 8; ++nj) mma_bf16(dummy, af, z[0], z[1]);
        }
    }
  }
  if constexpr (MASKED && G > 1) fold(dq[0], dummy, N);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = q0 + r0 + g + r * 8;
      if (n < N) {
        const size_t o = ((size_t)b * A.H + h0 + hw) * N + n;
        A.lse[o] = lse[r];
        A.dsum[o] = dsum[r];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(qs + (r0 + g + 8 * r) * SW + hw * DH + i * 8 + 2 * t) =
          pack_bf16x2(dq[i][2 * r], dq[i][2 * r + 1]);
  __syncthreads();
  move_rows<G, false>(A.d, 0, b, h0, q0, QR, N, qs);
}

// Backward, key pass: dK and dV of the CTA's QR key rows from the statistics
// of the query pass, sweeping 32-row query tiles.
template <int G, int MASKED>
__global__ void __launch_bounds__(THREADS) group_bwd_dkv_kernel(const Args A) {
  constexpr int SW = G * DH + 8, KR = 16 * WARPS / G, KC = DH / 16, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [KR][SW], then dk
  bf16* vs = ks + KR * SW;                        // [KR][SW], then dv
  bf16* qt = vs + KR * SW;                        // [QT][SW]
  bf16* gt = qt + QT * SW;                        // [QT][SW]
  float* st_lse = reinterpret_cast<float*>(gt + QT * SW);  // [G][QT]
  float* st_dsum = st_lse + G * QT;                         // [G][QT]
  const int N = A.N, h0 = blockIdx.x * G, b = blockIdx.y, j0 = blockIdx.z * KR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, hw = warp % G, rt = warp / G;
  const int t = lane & 3, r0 = rt * 16;
  move_rows<G, true>(A.in, 1, b, h0, j0, KR, N, ks);
  move_rows<G, true>(A.in, 2, b, h0, j0, KR, N, vs);
  __syncthreads();
  uint32_t kf[KC][4], vf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    frag_a<SW>(kf[kc], ks, r0, hw * DH + kc * 16, lane);
    frag_a<SW>(vf[kc], vs, r0, hw * DH + kc * 16, lane);
  }
  const float sl = A.scale * LOG2E;
  const uint32_t z[4] = {0u, 0u, 0u, 0u};
  float dk[NT][4], dv[NT][4], dummy[4] = {0.f, 0.f, 0.f, 0.f};
  zero(dk);
  zero(dv);
  for (int ib = 0; ib < N; ib += QT) {
    __syncthreads();
    move_rows<G, true>(A.in, 0, b, h0, ib, QT, N, qt);
    move_rows<G, true>(A.out, 0, b, h0, ib, QT, N, gt);
    for (int i = threadIdx.x; i < G * QT; i += THREADS) {
      const int j = i / QT, q = ib + i - j * QT;
      const size_t o = ((size_t)b * A.H + h0 + j) * N + q;
      st_lse[i] = q < N ? A.lse[o] : 0.f;
      st_dsum[i] = q < N ? A.dsum[o] : 0.f;
    }
    __syncthreads();
    // transposed tiles: rows = this warp's keys, columns = queries. MASKED:
    // (k o mask) q^T over the group's channels (zero A against the other
    // heads' q) and v (dO o mask)^T (the other heads' v against zero B)
    float st[QT / 8][4], dpt[QT / 8][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mma_rows<SW>(st[nt], kf[kc], qt, nt * 8, hw * DH + kc * 16, lane);
        mma_rows<SW>(dpt[nt], vf[kc], gt, nt * 8, hw * DH + kc * 16, lane);
      }
    if constexpr (MASKED && G > 1)
      for (int j = 0; j < G; ++j) {
        if (j == hw) continue;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t va[4];
          frag_a<SW>(va, vs, r0, j * DH + kc * 16, lane);
#pragma unroll
          for (int nt = 0; nt < QT / 8; ++nt) {
            mma_rows<SW>(st[nt], z, qt, nt * 8, j * DH + kc * 16, lane);
            mma_bf16(dpt[nt], va, 0u, 0u);
          }
        }
      }
    const float* lq = st_lse + hw * QT;
    const float* dq = st_dsum + hw * QT;
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        const float p = ib + qi < N ? exp2f(st[nt][e] * sl - lq[qi]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dq[qi]) * A.scale;
      }
#pragma unroll
    for (int kc = 0; kc < QT / 16; ++kc) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * kc], st[2 * kc + 1]);
      c_to_a(da, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int nj = 0; nj < DH / 16; ++nj) {
        mma_trans2<SW>(dv[2 * nj], dv[2 * nj + 1], pa, gt, kc * 16, hw * DH + nj * 16, lane);
        mma_trans2<SW>(dk[2 * nj], dk[2 * nj + 1], da, qt, kc * 16, hw * DH + nj * 16, lane);
      }
      if constexpr (MASKED && G > 1)
        for (int j = 0; j < G; ++j) {
          if (j == hw) continue;
#pragma unroll
          for (int nj = 0; nj < DH / 16; ++nj) {
            mma_trans2<SW>(dummy, dummy, pa, gt, kc * 16, j * DH + nj * 16, lane);
            mma_trans2<SW>(dummy, dummy, da, qt, kc * 16, j * DH + nj * 16, lane);
          }
        }
    }
  }
  if constexpr (MASKED && G > 1) fold(dk[0], dummy, N);
  __syncthreads();  // every warp is done with ks and vs (MASKED reads the other heads' v)
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int o = (r0 + g + 8 * r) * SW + hw * DH + i * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ks + o) = pack_bf16x2(dk[i][2 * r], dk[i][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vs + o) = pack_bf16x2(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  __syncthreads();
  move_rows<G, false>(A.d, 1, b, h0, j0, KR, N, ks);
  move_rows<G, false>(A.d, 2, b, h0, j0, KR, N, vs);
}

// shared memory of each kernel of group size G
__host__ __device__ constexpr int sw_of(int g) { return g * DH + 8; }
__host__ __device__ constexpr int rows_of(int g) { return 16 * WARPS / g; }
__host__ __device__ constexpr int fwd_smem(int g) {
  return (rows_of(g) + 2 * KT) * sw_of(g) * 2 + WARPS * 16 * 4;
}
__host__ __device__ constexpr int dq_smem(int g) {
  return (2 * rows_of(g) + 2 * KT) * sw_of(g) * 2 + WARPS * 16 * 4;
}
__host__ __device__ constexpr int dkv_smem(int g) {
  return (2 * rows_of(g) + 2 * QT) * sw_of(g) * 2 + 2 * g * QT * 4;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int G, int MASKED, int SHARED>
int launch(const Args& A, int B, bool bwd, cudaStream_t stream) {
  const dim3 grid(A.H / G, B, (A.N + rows_of(G) - 1) / rows_of(G));
  int err;
  if (!bwd) {
    if ((err = set_smem(group_fwd_kernel<G, MASKED, SHARED>, fwd_smem(G)))) return err;
    group_fwd_kernel<G, MASKED, SHARED><<<grid, THREADS, fwd_smem(G), stream>>>(A);
    return cudaGetLastError();
  }
  if ((err = set_smem(group_bwd_dq_kernel<G, MASKED, SHARED>, dq_smem(G)))) return err;
  if ((err = set_smem(group_bwd_dkv_kernel<G, MASKED>, dkv_smem(G)))) return err;
  group_bwd_dq_kernel<G, MASKED, SHARED><<<grid, THREADS, dq_smem(G), stream>>>(A);
  if ((err = cudaGetLastError())) return err;
  group_bwd_dkv_kernel<G, MASKED><<<grid, THREADS, dkv_smem(G), stream>>>(A);
  return cudaGetLastError();
}

// per segment of a table, the widest vector (elements, at least 2) that the
// group's slice width, the row and batch strides and the bases allow; false
// where a segment allows none
bool choose_vec(Table& T, int ns, int G, int N) {
  for (int i = 0; i < T.nseg; ++i) {
    int v = 8;
    for (; v >= 2; v /= 2) {
      bool ok = (G * T.width[i]) % v == 0;
      for (int s = 0; s < ns; ++s) {
        if (T.bs[i][s] == 0) T.bs[i][s] = (size_t)N * T.ld[i][s];
        ok = ok && T.ld[i][s] % v == 0 && T.bs[i][s] % v == 0 &&
             reinterpret_cast<uintptr_t>(T.p[i][s]) % (2 * v) == 0;
      }
      if (ok) break;
    }
    if (v < 2 || T.width[i] % 2) return false;
    T.vec[i] = v;
  }
  return true;
}

// The instantiated probes: (G, MASKED, SHARED) = the pack kernels (1, 0, 1),
// (2, 0, 1), (4, 0, 1) and the masked groups (2, 1, 0), (4, 1, 0); G = 1
// masked or per-head is the same kernel as the pack's G = 1.
int dispatch(Args& A, int B, int G, int masked, int shared, bool bwd, cudaStream_t stream) {
  int dh = 0;
  for (int i = 0; i < A.in.nseg; ++i) dh += A.in.width[i];
  if (dh != DH || A.H % G || !choose_vec(A.in, 3, G, A.N) || !choose_vec(A.out, 1, G, A.N) ||
      (bwd && !choose_vec(A.d, 3, G, A.N)))
    return cudaErrorInvalidValue;
  A.scale = 1.0f / sqrtf(static_cast<float>(DH));
  if (G == 1) return launch<1, 0, 1>(A, B, bwd, stream);
  if (G == 2 && !masked && shared) return launch<2, 0, 1>(A, B, bwd, stream);
  if (G == 4 && !masked && shared) return launch<4, 0, 1>(A, B, bwd, stream);
  if (G == 2 && masked && !shared) return launch<2, 1, 0>(A, B, bwd, stream);
  if (G == 4 && masked && !shared) return launch<4, 1, 0>(A, B, bwd, stream);
  return cudaErrorInvalidValue;
}

// operand i of a table: one array [B,N,ns*H*width] in (ns, H, width) column
// order (ns = 3: q, k, v; 1: an output or a cotangent), contiguous
void set_seg(Table& T, int i, const void* p, int ns, int width, int H) {
  for (int s = 0; s < ns; ++s) {
    T.p[i][s] = const_cast<bf16*>(static_cast<const bf16*>(p)) + (size_t)s * H * width;
    T.ld[i][s] = ns * H * width;
  }
  T.width[i] = width;
}

void set_octic(Table& T, const void* const* ps, int ns, int H, int d1, int de) {
  T.nseg = 6;
  for (int i = 0; i < 6; ++i) set_seg(T, i, ps[i], ns, i < 4 ? d1 : de, H);
}

}  // namespace
}  // namespace attn_group
}  // namespace ovt

using namespace ovt::attn_group;

// Standard layout: qkv [B,N,3*H*dh] and out [B,N,H*dh], contiguous (dh = 80).
OVT_EXPORT int ovt_attention_group_std(const void* qkv, void* out, int B, int N, int H, int G,
                                       int masked, int shared, void* stream) {
  Args A = {};
  A.N = N;
  A.H = H;
  A.in.nseg = A.out.nseg = 1;
  set_seg(A.in, 0, qkv, 3, DH, H);
  set_seg(A.out, 0, out, 1, DH, H);
  return dispatch(A, B, G, masked, shared, false, static_cast<cudaStream_t>(stream));
}

// Its backward: g [B,N,H*dh] -> dqkv [B,N,3*H*dh], contiguous; lse and dsum
// f32 scratch [B,H,N].
OVT_EXPORT int ovt_attention_group_std_bwd(const void* qkv, const void* g, void* dqkv, void* lse,
                                           void* dsum, int B, int N, int H, int G, int masked,
                                           int shared, void* stream) {
  Args A = {};
  A.N = N;
  A.H = H;
  A.lse = static_cast<float*>(lse);
  A.dsum = static_cast<float*>(dsum);
  A.in.nseg = A.out.nseg = A.d.nseg = 1;
  set_seg(A.in, 0, qkv, 3, DH, H);
  set_seg(A.out, 0, g, 1, DH, H);
  set_seg(A.d, 0, dqkv, 3, DH, H);
  return dispatch(A, B, G, masked, shared, true, static_cast<cudaStream_t>(stream));
}

// Octic layout: q1..q4 [B,N,3*H*d1], e0, e1 [B,N,3*H*de] -> o1..o4 [B,N,H*d1],
// oe0, oe1 [B,N,H*de], all contiguous (4*d1 + 2*de = 80).
OVT_EXPORT int ovt_attention_group_octic(const void* q1, const void* q2, const void* q3,
                                         const void* q4, const void* e0, const void* e1, void* o1,
                                         void* o2, void* o3, void* o4, void* oe0, void* oe1,
                                         int B, int N, int H, int d1, int de, int G, int masked,
                                         int shared, void* stream) {
  Args A = {};
  A.N = N;
  A.H = H;
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const void* outs[6] = {o1, o2, o3, o4, oe0, oe1};
  set_octic(A.in, ins, 3, H, d1, de);
  set_octic(A.out, outs, 1, H, d1, de);
  return dispatch(A, B, G, masked, shared, false, static_cast<cudaStream_t>(stream));
}

// Its backward: the six cotangents (shaped as the outputs) -> the six
// gradients (shaped as the qkv arrays), contiguous; lse and dsum f32 scratch
// [B,H,N].
OVT_EXPORT int ovt_attention_group_octic_bwd(
    const void* q1, const void* q2, const void* q3, const void* q4, const void* e0,
    const void* e1, const void* g1, const void* g2, const void* g3, const void* g4,
    const void* ge0, const void* ge1, void* d1p, void* d2p, void* d3p, void* d4p, void* de0,
    void* de1, void* lse, void* dsum, int B, int N, int H, int d1, int de, int G, int masked,
    int shared, void* stream) {
  Args A = {};
  A.N = N;
  A.H = H;
  A.lse = static_cast<float*>(lse);
  A.dsum = static_cast<float*>(dsum);
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const void* gs[6] = {g1, g2, g3, g4, ge0, ge1};
  const void* ds[6] = {d1p, d2p, d3p, d4p, de0, de1};
  set_octic(A.in, ins, 3, H, d1, de);
  set_octic(A.out, gs, 1, H, d1, de);
  set_octic(A.d, ds, 3, H, d1, de);
  return dispatch(A, B, G, masked, shared, true, static_cast<cudaStream_t>(stream));
}
