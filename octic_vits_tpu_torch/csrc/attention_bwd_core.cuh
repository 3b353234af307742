// K-attn-bwd's device code: the gradient of softmax(Q K^T * scale) V with
// respect to q, k and v, through a gather table (q, k, v), a cotangent table
// (g) and a gradient table (dq, dk, dv). csrc/attention_bwd.cu instantiates it
// for the model paths (the gradients in the gather's layout) and the
// head-major probe; csrc/attention_bwd_probe.cu for the probes of
// scripts/r3_attn_bwd_ablate.py (the gradients in a wide layout of their own,
// the cotangent pre-assembled per head), so the probes run this code and not
// a copy of it. See csrc/attention_bwd.cu for what it replaces, what bounds it
// on the H100 and why it is built this way.
//
// Everything here has internal linkage: each source that includes it keeps
// its own instantiations.
#pragma once

#include <math_constants.h>

#include "sm90.cuh"

namespace ovt {
namespace attn_bwd {
namespace {

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
  bf16* d[MAX_SEG][3];      // dq, dk, dv: segment i `d_width[i]` channels at column
  int d_ld[MAX_SEG][3];     // h * d_hs[i] of d[i][s], token rows d_ld[i][s] apart
  size_t d_bs[MAX_SEG][3];  // their batch strides (N * d_ld unless set)
  int d_nseg;               // the gradients' segments (0: those of qkv, the model paths)
  int d_width[MAX_SEG], d_hs[MAX_SEG];
  float* lse;   // [B,H,N] scratch: log2-sum-exp2 of the scaled scores
  float* dsum;  // [B,H,N] scratch: rowsum(dP o P)
  int N, H, dh;
  int pair_out;  // 1: the gradients take 4-byte bf16x2 stores
  int streamed;  // 1: the streamed form (the caller's plan), 0: whole-head staging
  float scale;
};

// rows [nrows][DS] of one segment of one operand (`width` channels from
// `src`, the head's column in row 0 of batch 0, token rows `ld` and batch
// rows `bs` apart) at channels [d_off, d_off + width): shared-memory row i
// holds token row0 + i, and tokens >= N are zero. Each thread keeps one
// V-element chunk of the row and steps over the rows, UNROLL loads in flight,
// so the loop has no division; consecutive threads take consecutive chunks of
// a row.
template <int DHP, int V>
__device__ __forceinline__ void gather_seg(const bf16* src, int ld, size_t bs, int width,
                                           int d_off, int b, int N, int row0, int nrows,
                                           bf16* dst) {
  typedef typename VecOf<V>::T Vec;
  constexpr int DS = DHP + 8;
  const int cpr = width / V, rows = THREADS / cpr;
  if (threadIdx.x >= rows * cpr) return;
  const int c = threadIdx.x % cpr;
  const bf16* from = src + b * bs + c * V;
  bf16* to = dst + d_off + c * V;
  for (int n = threadIdx.x / cpr; n < nrows; n += rows * UNROLL) {
    Vec v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = row0 + n + u * rows;
      v[u] = Vec{};
      if (m < N) v[u] = *reinterpret_cast<const Vec*>(from + (size_t)m * ld);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int m = n + u * rows;
      if (m < nrows) *reinterpret_cast<Vec*>(to + m * DS) = v[u];
    }
  }
}

// rows [nrows][DS] of operand s of table T for head h, token rows row0 ..
// row0 + nrows - 1; tokens >= N and channels >= dh are zero. Each segment
// takes its own load width.
template <int DHP>
__device__ __forceinline__ void gather_rows(const Heads& T, int s, const Args& A, int b, int h,
                                            int row0, int nrows, bf16* dst) {
  constexpr int DS = DHP + 8;
  const bf16 zero = __float2bfloat16(0.f);
  const int pad = DHP - A.dh;
  for (int i = threadIdx.x; i < nrows * pad; i += THREADS)
    dst[(i / pad) * DS + A.dh + i % pad] = zero;
  int d_off = 0;
  for (int i = 0; i < T.nseg; ++i) {
    const bf16* src = T.p[i][s] + (size_t)h * T.hs[i];
    const int ld = T.ld[i][s], w = T.width[i];
    const size_t bs = T.bs[i][s];
    switch (T.vec[i]) {
      case 8: gather_seg<DHP, 8>(src, ld, bs, w, d_off, b, A.N, row0, nrows, dst); break;
      case 4: gather_seg<DHP, 4>(src, ld, bs, w, d_off, b, A.N, row0, nrows, dst); break;
      case 2: gather_seg<DHP, 2>(src, ld, bs, w, d_off, b, A.N, row0, nrows, dst); break;
      default: gather_seg<DHP, 1>(src, ld, bs, w, d_off, b, A.N, row0, nrows, dst); break;
    }
    d_off += w;
  }
}

// shared memory: q, k, v, dO rows [kpad][DHP+8] bf16, the statistics
// [2][kpad] f32, the channel -> (segment, offset) tables
__host__ __device__ constexpr int smem_bytes(int kpad, int dhp) {
  return 4 * kpad * (dhp + 8) * 2 + 2 * kpad * 4 + 2 * dhp;
}

// The streamed form, where a head does not fit (ops/attention.py:
// attention_bwd_plan): a CTA owns a block of SROWS query rows (the query pass)
// or key rows (the key pass) and streams STILE-row tiles of the other
// operands through shared memory, FlashAttention-2 style.
constexpr int SROWS = WARPS * 16, STILE = 64;
constexpr int SMEM_LIMIT = 232448;

// the streamed form's shared memory: its block's two operands [SROWS][DS],
// a tile of the two streamed operands [STILE][DS], the tile's statistics
// [2][STILE] f32 (the key pass), the channel tables
__host__ __device__ constexpr int stream_smem_bytes(int dhp) {
  return 2 * (SROWS + STILE) * (dhp + 8) * 2 + 2 * STILE * 4 + 2 * dhp;
}

// the channel -> (gradient segment, channel within it) tables, for the stores
template <int DHP>
__device__ __forceinline__ void channel_tables(const Args& A, unsigned char* seg_of,
                                               unsigned char* w_of) {
  for (int d = threadIdx.x; d < DHP; d += THREADS) {
    int i = 0, base = 0;
    while (i < A.d_nseg - 1 && d >= base + A.d_width[i]) base += A.d_width[i++];
    seg_of[d] = static_cast<unsigned char>(i);
    w_of[d] = static_cast<unsigned char>(d - base);
  }
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
  channel_tables<DHP>(A, S.seg_of, S.w_of);
  gather_rows<DHP>(A.qkv, 0, A, b, h, 0, kpad, S.qs);
  gather_rows<DHP>(A.qkv, 1, A, b, h, 0, kpad, S.ks);
  gather_rows<DHP>(A.qkv, 2, A, b, h, 0, kpad, S.vs);
  gather_rows<DHP>(A.g, 0, A, b, h, 0, kpad, S.gs);
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
                  (size_t)h * A.d_hs[sg] + S.w_of[d];
      const float v0 = acc[i][2 * hf], v1 = acc[i][2 * hf + 1];
      if (A.pair_out) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v0, v1);
      } else {
        dst[0] = __float2bfloat16(v0);
        const int sg1 = S.seg_of[d + 1];
        A.d[sg1][s][b * A.d_bs[sg1][s] + (size_t)n * A.d_ld[sg1][s] +
                    (size_t)h * A.d_hs[sg1] + S.w_of[d + 1]] = __float2bfloat16(v1);
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

// The streamed form's shared memory, carved as in stream_smem_bytes: the
// block's two operands, the tile's two, the tile's statistics, the tables.
template <int DHP>
__device__ __forceinline__ Smem stream_smem(const Args& A, unsigned char* raw) {
  constexpr int DS = DHP + 8;
  Smem S;
  S.qs = reinterpret_cast<bf16*>(raw);  // the block: q rows (query pass) or k rows (key pass)
  S.gs = S.qs + SROWS * DS;             //            dO rows               v rows
  S.ks = S.gs + SROWS * DS;             // the tile:  k rows                q rows
  S.vs = S.ks + STILE * DS;             //            v rows                dO rows
  S.lse = reinterpret_cast<float*>(S.vs + STILE * DS);
  S.dsum = S.lse + STILE;
  S.seg_of = reinterpret_cast<unsigned char*>(S.dsum + STILE);
  S.w_of = S.seg_of + DHP;
  channel_tables<DHP>(A, S.seg_of, S.w_of);
  return S;
}

// Query pass, streamed: the CTA's SROWS query rows and their dO rows stay in
// shared memory; 64-key tiles of k and v stream through, once for the row
// statistics and once for dQ (the same two sweeps as attn_bwd_dq_kernel).
template <int DHP>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_stream_kernel(const Args A) {
  constexpr int KC = DHP / 16, NT = DHP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = A.N, h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * SROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3, g = lane >> 2;
  const Smem S = stream_smem<DHP>(A, smem_raw);
  gather_rows<DHP>(A.qkv, 0, A, b, h, q0, SROWS, S.qs);
  gather_rows<DHP>(A.g, 0, A, b, h, q0, SROWS, S.gs);
  __syncthreads();
  const float sl2 = A.scale * 1.4426950408889634f;
  const int r0 = warp * 16;
  uint32_t qf[KC][4], gf[KC][4];
  load_a<DHP>(qf, S.qs, r0, lane);
  load_a<DHP>(gf, S.gs, r0, lane);

  // sweep 1: online max m, sum l of exp2(s - m), and sum of exp2(s - m) dP
  float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F}, lrow[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
  for (int kb = 0; kb < N; kb += STILE) {
    __syncthreads();  // the previous tile is consumed
    gather_rows<DHP>(A.qkv, 1, A, b, h, kb, STILE, S.ks);
    gather_rows<DHP>(A.qkv, 2, A, b, h, kb, STILE, S.vs);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      mma_rows<DHP>(s[nt], qf, S.ks, nt * 8, lane);
      mma_rows<DHP>(dp[nt], gf, S.vs, nt * 8, lane);
    }
    // every tile holds a real key (kb < N): the max is finite
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
  for (int kb = 0; kb < N; kb += STILE) {
    __syncthreads();
    gather_rows<DHP>(A.qkv, 1, A, b, h, kb, STILE, S.ks);
    gather_rows<DHP>(A.qkv, 2, A, b, h, kb, STILE, S.vs);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      mma_rows<DHP>(s[nt], qf, S.ks, nt * 8, lane);
      mma_rows<DHP>(dp[nt], gf, S.vs, nt * 8, lane);
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
    for (int kc = 0; kc < STILE / 16; ++kc) {
      uint32_t af[4];
      c_to_a(af, s[2 * kc], s[2 * kc + 1]);
      mma_trans<DHP>(dq, af, S.ks, kc * 16, lane);
    }
  }
  store_rows<DHP>(A, S, dq, 0, b, h, q0 + r0, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = q0 + r0 + g + r * 8;
      if (n < N) {
        const size_t o = ((size_t)b * A.H + h) * N + n;
        A.lse[o] = lse[r];
        A.dsum[o] = dsum[r];
      }
    }
  }
}

// Key pass, streamed: the CTA's SROWS key rows and their v rows stay in
// shared memory; 64-query tiles of q and dO stream through with their row
// statistics (the same sweep as attn_bwd_dkv_kernel, 32 queries a step).
template <int DHP>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_stream_kernel(const Args A) {
  constexpr int KC = DHP / 16, NT = DHP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = A.N, h = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * SROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const Smem S = stream_smem<DHP>(A, smem_raw);
  bf16* const kblk = S.qs;  // the block's key rows
  bf16* const vblk = S.gs;  // and value rows
  bf16* const qt = S.ks;    // the tile's query rows
  bf16* const gt = S.vs;    // and dO rows
  gather_rows<DHP>(A.qkv, 1, A, b, h, j0, SROWS, kblk);
  gather_rows<DHP>(A.qkv, 2, A, b, h, j0, SROWS, vblk);
  __syncthreads();
  const float sl2 = A.scale * 1.4426950408889634f;
  const int r0 = warp * 16;
  uint32_t kf[KC][4], vf[KC][4];
  load_a<DHP>(kf, kblk, r0, lane);
  load_a<DHP>(vf, vblk, r0, lane);
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int ib = 0; ib < N; ib += STILE) {
    __syncthreads();  // the previous tile is consumed
    gather_rows<DHP>(A.qkv, 0, A, b, h, ib, STILE, qt);
    gather_rows<DHP>(A.g, 0, A, b, h, ib, STILE, gt);
    for (int n = threadIdx.x; n < STILE; n += THREADS) {
      const size_t o = ((size_t)b * A.H + h) * N + ib + n;
      S.lse[n] = ib + n < N ? A.lse[o] : 0.f;
      S.dsum[n] = ib + n < N ? A.dsum[o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int sb = 0; sb < STILE; sb += QB) {
      // transposed tiles: rows = this warp's keys, columns = queries
      float st[QB / 8][4], dpt[QB / 8][4];
#pragma unroll
      for (int nt = 0; nt < QB / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
        mma_rows<DHP>(st[nt], kf, qt, sb + nt * 8, lane);
        mma_rows<DHP>(dpt[nt], vf, gt, sb + nt * 8, lane);
      }
#pragma unroll
      for (int nt = 0; nt < QB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = sb + nt * 8 + 2 * t + (e & 1);
          const float p = ib + qi < N ? exp2f(st[nt][e] * sl2 - S.lse[qi]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - S.dsum[qi]) * A.scale;
        }
#pragma unroll
      for (int kc = 0; kc < QB / 16; ++kc) {
        uint32_t pa[4], da[4];
        c_to_a(pa, st[2 * kc], st[2 * kc + 1]);
        c_to_a(da, dpt[2 * kc], dpt[2 * kc + 1]);
        mma_trans<DHP>(dv, pa, gt, sb + kc * 16, lane);
        mma_trans<DHP>(dk, da, qt, sb + kc * 16, lane);
      }
    }
  }
  store_rows<DHP>(A, S, dk, 1, b, h, j0 + r0, lane);
  store_rows<DHP>(A, S, dv, 2, b, h, j0 + r0, lane);
}

template <int DHP>
int launch(const Args& A, int B, cudaStream_t stream) {
  if (A.streamed) {
    const int smem = stream_smem_bytes(DHP);
    const dim3 grid(A.H, B, (A.N + SROWS - 1) / SROWS);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_stream_kernel<DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attn_bwd_dkv_stream_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attn_bwd_dq_stream_kernel<DHP><<<grid, THREADS, smem, stream>>>(A);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_dkv_stream_kernel<DHP><<<grid, THREADS, smem, stream>>>(A);
    return cudaGetLastError();
  }
  const int kpad = (A.N + 15) / 16 * 16;
  const int smem = smem_bytes(kpad, DHP);
  if (smem > SMEM_LIMIT) return ERR_PLAN;  // the whole head does not fit: the plan streams
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
  if (A.d_nseg == 0) {
    A.d_nseg = A.qkv.nseg;
    for (int i = 0; i < A.qkv.nseg; ++i) {
      A.d_width[i] = A.qkv.width[i];
      A.d_hs[i] = A.qkv.hs[i];
    }
  }
  A.pair_out = 1;
  for (int i = 0; i < A.d_nseg; ++i) {
    A.pair_out = A.pair_out && A.d_width[i] % 2 == 0 && A.d_hs[i] % 2 == 0;
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

}  // namespace
}  // namespace attn_bwd
}  // namespace ovt
