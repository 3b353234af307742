// K-attn-bwd on TMA + wgmma: the device code and the host helpers of the
// model paths' attention backward (csrc/attention_bwd.cu). Per (batch, head),
// with s the scale dh^-0.5:
//   P  = softmax(s Q K^T)   dP = dO V^T   D = rowsum(dP o P)
//   dS = P o (dP - D) s     dQ = dS K     dK = dS^T Q     dV = P^T dO
//
// Two kernels, each a CTA of one consumer warpgroup (64 rows) and one
// producer warp that streams 64-row TMA tiles through an mbarrier ring, the
// standard forward's shape (csrc/attention_std_core.cuh, whose box,
// descriptor and product helpers this file uses):
//   query pass  a CTA a (batch, head, 64-query tile): Q and dO by TMA once,
//     the head's K and V tiles streamed twice. Sweep 1: S = Q K^T and dP =
//     dO V^T (wgmma, both operands in shared memory), the online max, sum
//     and sum of exp(s - m) dP, so D needs no third sweep; the row
//     log2-sum-exp and D go to f32 scratch [2, B*H, NP]. Sweep 2: S, dP
//     again, dS, and dQ += dS K with dS as bf16 register A fragments (K's
//     tile MN-major, the transpose bit).
//   key pass  a CTA a (batch, head, 64-key tile): K and V by TMA once, the
//     head's Q and dO tiles and their scratch rows (a 1-D bulk copy each)
//     streamed once. S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q from register fragments.
// Nine products of 64 x 64 x dh a tile pair, no atomics: each gradient row
// is written once, every sum runs over its keys or queries in a fixed order,
// so two launches on the same inputs give the same bits. A tile's dQ (dK and
// dV) products are waited for together with the next tile's S and dP.
//
// Loads: every operand's head is dh contiguous columns of an array (the
// standard qkv [B,N,3C] and g [B,N,C]; for the octic layouts the wide qkv
// and the cotangent in head order, which csrc/attention_bwd.cu's
// pack_heads_kernel assembles where the caller's arrays are not that),
// loaded as boxes of 64, 32, 16 and 8 columns through 3-D tensor maps over
// (W, N, B): rows >= N arrive as zeros, never the next image's. Stores: the
// head's columns split into up to six segments, each written into its own
// array (the six octic gradients, or one segment for a standard dqkv)
// through a per-CTA column table.
// Masking: keys >= N get P = 0 in the query pass; queries >= N get P = dS =
// 0 in the key pass, whatever the scratch holds there; gradient rows >= N
// are not stored. P and dS are rounded to bf16 only as product operands;
// scores, statistics and sums are f32.
//
// The kernels have internal linkage: each source that includes this file
// keeps its own instantiations.
#pragma once

#include "attention_std_core.cuh"

namespace ovt {
namespace attn_bwd90 {

constexpr int MAPS = 8;  // tensor maps: a box width each of the qkv and of g

// The geometry of one launch (host-built from the plan's table,
// ops/attention.py:_bwd_table)
struct Geo {
  CUtensorMap m[MAPS];
  float* stats;       // [2][B*H][np]: log2-sum-exp, then D
  bf16* out[3][6];    // segment j of dq, dk, dv
  int old[3][6];      // its token row stride (elements)
  int ocol[3][6];     // its column at head 0
  int ohs[3][6];      // its head stride (columns)
  int map[4][4];      // the map of box j of q, k, v, dO
  int col[4];         // the operand's column at head 0 (heads dh apart)
  int sw[6];          // the head's columns as gradient segments
  int nseg;
  int pairs;          // 1: every gradient value pair takes one 4-byte store
  int np;             // scratch row length: the query tiles' rows
  int bh;             // B * H
};

// the launches at head widths 72..128, compiled in csrc/attention_bwd_std.cu
// beside the others so that the two build in parallel (ERR_PLAN for another
// width)
int run_wide(int width, const Geo& g, const int64_t* T, cudaStream_t stream);

// The launch table (int64), written by ops/attention.py:_bwd_table
enum Table : int {
  T_B = 0, T_N, T_H, T_DH, T_STAGES, T_TILES, T_GRID, T_SMEM_Q, T_SMEM_K, T_NP, T_NMAPS,
  T_NSEG, T_STATS,
  T_MAPS = 16,    // MAPS x (pointer, width, row stride, box width)
  T_BOXES = 48,   // 4 operands x (column at head 0, 4 box maps)
  T_SEGS = 68,    // 6 segment widths
  T_STORES = 74,  // 3 gradients x 6 segments x (pointer, row stride, column, head stride)
};

namespace {

using namespace sm90;
using attn_std::ROWS;
using attn_std::STD;
using attn_std::box_off;
using attn_std::box_w;
using attn_std::num_boxes;

constexpr int THREADS = 160;         // one consumer warpgroup + the producer warp
constexpr int STATS = 2 * ROWS * 4;  // a query tile's log2-sum-exp and D rows (f32)
constexpr int OMAP = 256;            // a gradient column table (dh <= 128 shorts)

template <int DH>
struct Cfg {
  static constexpr int NB = num_boxes(DH, STD);
  static constexpr int TILE = ROWS * DH * 2;  // bytes of one operand tile
  static constexpr bool TAIL = DH % 16 != 0;  // an 8-column box ends the head
  static constexpr int ZERO = TAIL ? ROWS * 16 : 0;
  static constexpr int ST_Q = 2;              // the query pass's ring stages
  static constexpr int ST = DH > 96 ? 2 : 3;  // the key pass's
  // query pass: align slack, Q, dO, ST_Q x (K, V), the zero block, the dQ
  // column table, barriers (Q and dO, ST_Q full, ST_Q empty)
  static constexpr int SMEM_Q =
      1024 + TILE * (2 + 2 * ST_Q) + ZERO + OMAP + (1 + 2 * ST_Q) * 8;
  // key pass: align slack, K, V, ST x (Q, dO), ST x the scratch rows, the
  // zero block, the dK and dV column table, barriers
  static constexpr int SMEM_K =
      1024 + TILE * (2 + 2 * ST) + STATS * ST + ZERO + OMAP + (1 + 2 * ST) * 8;
  // CTAs an SM: three query-pass CTAs fit in registers and shared memory up
  // to 80 columns, two key-pass CTAs (two accumulators)
  static constexpr int MINB_Q = DH <= 80 ? 3 : 2;
  static constexpr int MINB_K = DH <= 80 ? 2 : 1;
};

// TMA the 64-row tile of operand s (0 q, 1 k, 2 v, 3 dO) of head h from token
// row `row` of batch b
template <int DH>
__device__ __forceinline__ void load_tile(uint8_t* dst, const Geo& g, uint64_t* bar, int s,
                                          int h, int row, int b) {
#pragma unroll
  for (int j = 0; j < Cfg<DH>::NB; ++j)
    tma_load_3d(dst + 128 * box_off(DH, j, STD), &g.m[g.map[s][j]], bar,
                g.col[s] + h * DH + box_off(DH, j, STD), row, b);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// global -> shared, completion reported to `bar` as bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The gradient column table's entry of head column d: (segment << 8) |
// column in the segment
__device__ __forceinline__ unsigned short entry(const Geo& g, int d) {
  int j = 0;
  while (j < g.nseg - 1 && d >= g.sw[j]) d -= g.sw[j++];
  return static_cast<unsigned short>((j << 8) | d);
}

// one gradient value pair (head columns col, col + 1) of token row `row`
__device__ __forceinline__ void store_pair(const Geo& g, const unsigned short* omap, int s,
                                           int col, size_t row, int h, float v0, float v1) {
  const unsigned short e0 = omap[col];
  const int p = e0 >> 8;
  bf16* dst = g.out[s][p] + row * g.old[s][p] + g.ocol[s][p] + h * g.ohs[s][p] + (e0 & 255);
  if (g.pairs) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v0, v1);
    return;
  }
  *dst = __float2bfloat16(v0);
  const unsigned short e1 = omap[col + 1];
  const int p1 = e1 >> 8;
  g.out[s][p1][row * g.old[s][p1] + g.ocol[s][p1] + h * g.ohs[s][p1] + (e1 & 255)] =
      __float2bfloat16(v1);
}

// the accumulator tile's rows r (token row of batch b, this thread's g-th
// row of its warp) and r + 8 -> gradient s
template <int DH>
__device__ __forceinline__ void store_tile(const Geo& g, const unsigned short* omap, int s,
                                           const float* acc, int r, int N, int b, int h, int q) {
  const size_t row = (size_t)b * N + r;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 4) {
    const int col = 8 * (i / 4) + 2 * q;
    if (r < N) store_pair(g, omap, s, col, row, h, acc[i], acc[i + 1]);
    if (r + 8 < N) store_pair(g, omap, s, col, row + 8, h, acc[i + 2], acc[i + 3]);
  }
}

// The m64n64 accumulator's values as the bf16 A fragments of four k16 steps
__device__ __forceinline__ void to_fragments(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16x2(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sweep 1 of one key tile (rows g and g + 8 of the warp's 16; keys >= N
// masked): the online max m (scaled, log2), the sum l of exp2(s - m) and the
// sum a of exp2(s - m) dP, each thread's share of its quad's columns
__device__ __forceinline__ void online_stats(float (&sc)[32], const float (&dp)[32], float& m0,
                                             float& m1, float& l0, float& l1, float& a0,
                                             float& a1, int kbase, int N, int q, float sl2) {
  if (kbase + ROWS > N) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (kbase + 8 * (i / 4) + 2 * q + (i & 1) >= N) sc[i] = -CUDART_INF_F;
  }
  float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    x0 = fmaxf(x0, fmaxf(sc[4 * c], sc[4 * c + 1]));
    x1 = fmaxf(x1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
  }
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  const float n0 = fmaxf(m0, x0 * sl2), n1 = fmaxf(m1, x1 * sl2);
  const float al0 = exp2f(m0 - n0), al1 = exp2f(m1 - n1);
  m0 = n0;
  m1 = n1;
  float t0 = 0.f, t1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float p0 = exp2f(fmaf(sc[4 * c], sl2, -n0)), p1 = exp2f(fmaf(sc[4 * c + 1], sl2, -n0));
    const float p2 = exp2f(fmaf(sc[4 * c + 2], sl2, -n1));
    const float p3 = exp2f(fmaf(sc[4 * c + 3], sl2, -n1));
    t0 += p0 + p1;
    t1 += p2 + p3;
    u0 = fmaf(p0, dp[4 * c], fmaf(p1, dp[4 * c + 1], u0));
    u1 = fmaf(p2, dp[4 * c + 2], fmaf(p3, dp[4 * c + 3], u1));
  }
  l0 = fmaf(l0, al0, t0);
  l1 = fmaf(l1, al1, t1);
  a0 = fmaf(a0, al0, u0);
  a1 = fmaf(a1, al1, u1);
}

// Wait for ring iteration `it`'s stage of an ST-stage ring and issue sc =
// R1 X^T and dp = R2 Y^T as one commit group: R1, R2 the resident tiles (Q
// and dO in the query pass, K and V in the key pass), X, Y the stage's two
// tiles (K and V, or Q and dO)
template <int DH, int ST>
__device__ __forceinline__ void issue_pair(float (&sc)[32], float (&dp)[32], uint64_t* full,
                                           int it, uint32_t ring_s, uint32_t r1, uint32_t r2,
                                           uint32_t z_s) {
  const uint32_t x_s = ring_s + 2 * Cfg<DH>::TILE * (it % ST);
  mbar_wait(&full[it % ST], (it / ST) & 1);
  wgmma_fence();
  attn_std::scores<DH, STD>(sc, r1, x_s, z_s);
  attn_std::scores<DH, STD>(dp, r2, x_s + Cfg<DH>::TILE, z_s);
  wgmma_commit();
}

// Query pass: dQ, and the rows' log2-sum-exp and D into the scratch
template <int DH>
__global__ void __launch_bounds__(THREADS, Cfg<DH>::MINB_Q)
    bwd_q_kernel(const __grid_constant__ Geo g, int N, int H, int T, float scale) {
  using Cf = Cfg<DH>;
  constexpr int ST = Cf::ST_Q;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* qs = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* os = qs + Cf::TILE;
  uint8_t* ring = os + Cf::TILE;  // stage st: K at ring + 2 TILE st, V after it
  uint8_t* zero = ring + 2 * Cf::TILE * ST;
  unsigned short* omap = reinterpret_cast<unsigned short*>(zero + Cf::ZERO);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(zero + Cf::ZERO + OMAP);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int qt = blockIdx.x % T, bh = blockIdx.x / T, h = bh % H, b = bh / H;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  if (Cf::TAIL && threadIdx.x < Cf::ZERO / 8) {
    reinterpret_cast<uint2*>(zero)[threadIdx.x] = make_uint2(0u, 0u);
    fence_proxy_async();
  }
  if (threadIdx.x < DH) omap[threadIdx.x] = entry(g, threadIdx.x);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: Q and dO once, then the key and value tiles twice
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(qbar, 2 * Cf::TILE);
      load_tile<DH>(qs, g, qbar, 0, h, qt * ROWS, b);
      load_tile<DH>(os, g, qbar, 3, h, qt * ROWS, b);
      for (int it = 0; it < 2 * T; ++it) {
        const int st = it % ST, kt = it % T;
        mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
        uint8_t* kv = ring + 2 * Cf::TILE * st;
        mbar_arrive_expect_tx(&full[st], 2 * Cf::TILE);
        load_tile<DH>(kv, g, &full[st], 1, h, kt * ROWS, b);
        load_tile<DH>(kv + Cf::TILE, g, &full[st], 2, h, kt * ROWS, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: query rows r and r + 8 of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane & 3;
  const int r = qt * ROWS + warp * 16 + (lane >> 2);
  const uint32_t q_s = smem_addr(qs), o_s = smem_addr(os), z_s = smem_addr(zero);
  const uint32_t ring_s = smem_addr(ring);
  const float sl2 = scale * 1.4426950408889634f;
  mbar_wait(qbar, 0);

  // sweep 1: the row statistics
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
  for (int kt = 0; kt < T; ++kt) {
    float sc[32], dp[32];
    issue_pair<DH, ST>(sc, dp, full, kt, ring_s, q_s, o_s, z_s);
    wgmma_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    if (lane == 0) mbar_arrive(&empty[kt % ST]);
    online_stats(sc, dp, m0, m1, l0, l1, a0, a1, kt * ROWS, N, q, sl2);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  a0 = quad_sum(a0);
  a1 = quad_sum(a1);
  const float lse0 = m0 + log2f(l0), lse1 = m1 + log2f(l1);
  const float d0 = a0 / l0, d1 = a1 / l1;
  if (q == 0) {  // every row of the tile, rows >= N too: the key pass masks them
    float* lse = g.stats + (size_t)bh * g.np;
    float* dsum = lse + (size_t)g.bh * g.np;
    lse[r] = lse0;
    lse[r + 8] = lse1;
    dsum[r] = d0;
    dsum[r + 8] = d1;
  }

  // sweep 2: dS, dQ += dS K
  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
  for (int kt = 0; kt < T; ++kt) {
    const int it = T + kt;
    float sc[32], dp[32];
    uint32_t da[4][4];
    issue_pair<DH, ST>(sc, dp, full, it, ring_s, q_s, o_s, z_s);
    wgmma_wait<0>();  // this tile's S and dP, the last tile's dQ product
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    fence_regs<DH / 2>(dq);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % ST]);
    const bool ragged = kt * ROWS + ROWS > N;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float lse = (i & 2) ? lse1 : lse0, dd = (i & 2) ? d1 : d0;
      const float p = exp2f(fmaf(sc[i], sl2, -lse));
      sc[i] = ragged && kt * ROWS + 8 * (i / 4) + 2 * q + (i & 1) >= N ? 0.f
                                                                       : p * (dp[i] - dd) * scale;
    }
    to_fragments(da, sc);
    wgmma_fence();
    attn_std::pv_product<DH, STD>(dq, da, ring_s + 2 * Cf::TILE * (it % ST));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<DH / 2>(dq);
  store_tile<DH>(g, omap, 0, dq, r, N, b, h, q);
}

// Key pass: dK and dV from the query pass's statistics
template <int DH>
__global__ void __launch_bounds__(THREADS, Cfg<DH>::MINB_K)
    bwd_kv_kernel(const __grid_constant__ Geo g, int N, int H, int T, float scale) {
  using Cf = Cfg<DH>;
  constexpr int ST = Cf::ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* ks = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* vs = ks + Cf::TILE;
  uint8_t* ring = vs + Cf::TILE;  // stage st: Q at ring + 2 TILE st, dO after it
  uint8_t* stat = ring + 2 * Cf::TILE * ST;  // stage st: lse[64], D[64] at stat + STATS st
  uint8_t* zero = stat + STATS * ST;
  unsigned short* omap = reinterpret_cast<unsigned short*>(zero + Cf::ZERO);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(zero + Cf::ZERO + OMAP);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + ST;

  const int kt = blockIdx.x % T, bh = blockIdx.x / T, h = bh % H, b = bh / H;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  if (Cf::TAIL && threadIdx.x < Cf::ZERO / 8) {
    reinterpret_cast<uint2*>(zero)[threadIdx.x] = make_uint2(0u, 0u);
    fence_proxy_async();
  }
  if (threadIdx.x < DH) omap[threadIdx.x] = entry(g, threadIdx.x);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: K and V once, then the query tiles with their scratch rows
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(kvbar, 2 * Cf::TILE);
      load_tile<DH>(ks, g, kvbar, 1, h, kt * ROWS, b);
      load_tile<DH>(vs, g, kvbar, 2, h, kt * ROWS, b);
      const float* lse = g.stats + (size_t)bh * g.np;
      const float* dsum = lse + (size_t)g.bh * g.np;
      for (int qt = 0; qt < T; ++qt) {
        const int st = qt % ST;
        mbar_wait(&empty[st], ((qt / ST) & 1) ^ 1);
        uint8_t* qo = ring + 2 * Cf::TILE * st;
        mbar_arrive_expect_tx(&full[st], 2 * Cf::TILE + STATS);
        load_tile<DH>(qo, g, &full[st], 0, h, qt * ROWS, b);
        load_tile<DH>(qo + Cf::TILE, g, &full[st], 3, h, qt * ROWS, b);
        bulk_load(stat + STATS * st, lse + qt * ROWS, ROWS * 4, &full[st]);
        bulk_load(stat + STATS * st + ROWS * 4, dsum + qt * ROWS, ROWS * 4, &full[st]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: key rows r and r + 8 of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane & 3;
  const int r = kt * ROWS + warp * 16 + (lane >> 2);
  const uint32_t k_s = smem_addr(ks), v_s = smem_addr(vs), z_s = smem_addr(zero);
  const uint32_t ring_s = smem_addr(ring);
  const float sl2 = scale * 1.4426950408889634f;
  mbar_wait(kvbar, 0);
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int qt = 0; qt < T; ++qt) {
    const int st = qt % ST;
    const float* lse = reinterpret_cast<const float*>(stat + STATS * st);
    const float* dsum = lse + ROWS;
    float sc[32], dp[32];
    uint32_t pa[4][4], da[4][4];
    issue_pair<DH, ST>(sc, dp, full, qt, ring_s, k_s, v_s, z_s);  // S^T, dP^T
    wgmma_wait<0>();  // this tile's S^T and dP^T, the last tile's dV and dK products
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    fence_regs<DH / 2>(dv);
    fence_regs<DH / 2>(dk);
    if (qt > 0 && lane == 0) mbar_arrive(&empty[(qt - 1) % ST]);
    const bool ragged = qt * ROWS + ROWS > N;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * q;
      const float2 ls = *reinterpret_cast<const float2*>(lse + col);
      const float2 ds = *reinterpret_cast<const float2*>(dsum + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * c + e;
        const float p = exp2f(fmaf(sc[i], sl2, -((e & 1) ? ls.y : ls.x)));
        const bool out = ragged && qt * ROWS + col + (e & 1) >= N;
        sc[i] = out ? 0.f : p;
        dp[i] = out ? 0.f : p * (dp[i] - ((e & 1) ? ds.y : ds.x)) * scale;
      }
    }
    to_fragments(pa, sc);
    to_fragments(da, dp);
    const uint32_t q_s = ring_s + 2 * Cf::TILE * st;
    wgmma_fence();
    attn_std::pv_product<DH, STD>(dv, pa, q_s + Cf::TILE);  // dV += P^T dO
    attn_std::pv_product<DH, STD>(dk, da, q_s);             // dK += dS^T Q
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<DH / 2>(dv);
  fence_regs<DH / 2>(dk);
  store_tile<DH>(g, omap, 1, dk, r, N, b, h, q);
  store_tile<DH>(g, omap, 2, dv, r, N, b, h, q);
}

// ------------------------------------------------------------------ host

// Both passes at head width DH, after checking the plan
template <int DH>
int run(const Geo& g, const int64_t* T, cudaStream_t stream) {
  using Cf = Cfg<DH>;
  const int B = (int)T[T_B], N = (int)T[T_N], H = (int)T[T_H];
  const int tiles = (N + ROWS - 1) / ROWS;
  if (T[T_TILES] != tiles || T[T_GRID] != (int64_t)B * H * tiles || T[T_SMEM_Q] != Cf::SMEM_Q ||
      T[T_SMEM_K] != Cf::SMEM_K || T[T_STAGES] != Cf::ST || g.np != tiles * ROWS)
    return ERR_PLAN;
  for (int s = 0; s < 4; ++s)
    for (int j = 0; j < Cf::NB; ++j) {
      const int m = g.map[s][j];
      if (m < 0 || m >= T[T_NMAPS] || T[T_MAPS + 4 * m + 3] != box_w(DH, j, STD)) return ERR_PLAN;
    }
  const float scale = 1.0f / sqrtf((float)DH);
  cudaError_t err = cudaFuncSetAttribute(bwd_q_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM_Q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_kv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cf::SMEM_K);
  if (err != cudaSuccess) return err;
  const int grid = B * H * tiles;
  bwd_q_kernel<DH><<<grid, THREADS, Cf::SMEM_Q, stream>>>(g, N, H, tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kv_kernel<DH><<<grid, THREADS, Cf::SMEM_K, stream>>>(g, N, H, tiles, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace attn_bwd90
}  // namespace ovt
