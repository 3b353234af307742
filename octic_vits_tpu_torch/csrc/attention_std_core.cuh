// K-attn's streamed forward on TMA + wgmma: the device code and the host
// helpers shared by csrc/attention_std.cu (the standard layout) and
// csrc/attention_octic.cu (the octic layouts: the wide qkv with the octic
// output scatter, and the caller's octic arrays as padded pieces). See
// csrc/attention_std.cu for what bounds it on the H100 and why it is built
// this way, and csrc/attention_octic.cu for the octic layouts.
//
// Everything here has internal linkage: each source that includes it keeps
// its own instantiations.
#pragma once

#include <math_constants.h>

#include "sm90.cuh"

namespace ovt {
namespace attn_std {
namespace {

using namespace sm90;

constexpr int ROWS = 64;  // query rows a CTA, keys a tile
constexpr int STAGES = 3;  // the ring's stages (2 for the 128-column padded pieces)
constexpr int THREADS = 160;  // one consumer warpgroup + the producer warp
constexpr int LAST = 512;     // key and value N - 1 (bf16, dh <= 128)
constexpr int OMAP = 256;     // the octic scatter's column table (dh <= 128 shorts)

// The layouts (template parameter L):
//   STD      qkv [B,N,3C] in (3, H, dh) order -> out [B,N,C]
//   SCATTER  the same gather (the wide octic qkv, each head [a1|a2|b1|b2|e0|e1])
//            -> the six irrep outputs (o1..o4 at h*d1, oe0 and oe1 at h*de)
//   PIECES   the caller's octic arrays: box j = 0..3 the 1-d piece g = j (d1
//            columns, a 16-column box), j = 4, 5 the E rows (de columns, a box
//            of 16 or 32); DH is the padded width 64 + 2 * WE. A TMA box starts
//            on a 16-byte boundary, so box j starts at the piece's column
//            rounded down to a multiple of 8 and holds the piece at offset o_j
//            (the same for q, k and v of a head; the plan checks that the
//            piece fits). The box's other columns are zeroed in the q tile
//            and in each k tile (they add exactly 0 to q k^T, whatever the
//            neighbouring heads hold) and their output columns are never
//            stored -> the six irrep outputs
enum Layout : int { STD = 0, SCATTER = 1, PIECES = 2 };

// A head's columns as boxes, widest first: ops/attention.py:std_attention_boxes.
// Loops and ternary chains, not recursions or nested loops: device code
// inlines and folds them at each call's constant arguments (a box helper that
// does not fold runs on every k step and made the forward 2.5x slower).
__host__ __device__ constexpr int box_greedy(int rem) {
  return rem >= 64 ? 64 : rem >= 32 ? 32 : rem >= 16 ? 16 : rem >= 8 ? 8 : 0;
}
__host__ __device__ constexpr int box_off(int dh, int j, int L) {
  if (L == PIECES) return j < 4 ? 16 * j : 64 + (j - 4) * ((dh - 64) / 2);
  int off = 0;
  for (int i = 0; i < j; ++i) off += box_greedy(dh - off);
  return off;
}
__host__ __device__ constexpr int box_w(int dh, int j, int L) {
  if (L == PIECES) return j < 4 ? 16 : j < 6 ? (dh - 64) / 2 : 0;
  return box_greedy(dh - box_off(dh, j, L));
}
__host__ __device__ constexpr int num_boxes(int dh, int L) {
  return L == PIECES ? 6
         : box_w(dh, 0, L) == 0 ? 0
         : box_w(dh, 1, L) == 0 ? 1
         : box_w(dh, 2, L) == 0 ? 2
         : box_w(dh, 3, L) == 0 ? 3 : 4;
}
// the box holding column d
__host__ __device__ constexpr int box_of(int dh, int d, int L) {
  if (L == PIECES) return d < 64 ? d / 16 : 4 + (d - 64) / ((dh - 64) / 2);
  return d < box_off(dh, 1, L) || num_boxes(dh, L) == 1 ? 0
         : d < box_off(dh, 2, L) || num_boxes(dh, L) == 2 ? 1
         : d < box_off(dh, 3, L) || num_boxes(dh, L) == 3 ? 2 : 3;
}

template <int DH, int L>
struct Cfg {
  static constexpr int NB = num_boxes(DH, L);
  static constexpr int TILE = ROWS * DH * 2;  // bytes of one operand tile; box j at 128 * off_j
  static constexpr bool TAIL = DH % 16 != 0;  // an 8-column box ends the head
  static constexpr int KSTEPS = (DH + 15) / 16;
  static constexpr int ZERO = TAIL ? ROWS * 16 : 0;  // the tail's zeroed k partner
  static constexpr int MAP = L == STD ? 0 : OMAP;
  // two CTAs an SM hold the padded 128-column head only with a 2-stage ring
  static constexpr int ST = L == PIECES && DH > 96 ? 2 : STAGES;
  // align slack, Q, ST x (K, V), the zero block, key and value N - 1,
  // the scatter's column table, barriers (Q, key N - 1, K full, V full, empty)
  static constexpr int SMEM = 1024 + TILE * (1 + 2 * ST) + ZERO + LAST + MAP + (2 + 3 * ST) * 8;
  static constexpr int MINB = DH <= 96 ? 3 : 2;  // CTAs an SM
};

// Where each box of q, k and v comes from and where the outputs go (host-built)
struct Geo {
  CUtensorMap m[6];    // STD, SCATTER: one per box width 64, 32, 16, 8; PIECES: one per array
  const bf16* ptr[6];  // the array of each map (key and value N - 1 are read from it)
  int ld[6];           // its token row stride (elements); batch rows N * ld apart
  int map[3][6];       // the map of box j of q, k, v
  int col[3][6];       // the column of box j of q, k, v at head 0
  int hs[6];           // box j's head stride (columns)
  int w[6];            // box j's real columns (PIECES: the piece's width)
  bf16* out[6];        // SCATTER, PIECES: o1..o4, oe0, oe1
  int ow[6];           // their widths a head (d1, de), also their head strides
  int old[6];          // their token row strides (elements)
  int pairs;           // 1: every piece has an even width, so bf16x2 stores stay in one piece
  int d1, de;          // SCATTER's pieces
};

__host__ __device__ constexpr int map_index(int w) {
  return w == 64 ? 0 : w == 32 ? 1 : w == 16 ? 2 : 3;
}

// TMA one 64-row tile of operand s (every box of the head) into `dst`; a box
// starts on the 16-byte boundary at or below its column (a no-op but for
// PIECES, whose piece then sits at offset piece_offset in the box)
template <int DH, int L>
__device__ __forceinline__ void load_tile(uint8_t* dst, const Geo& g, uint64_t* bar, int s,
                                          int h, int row, int b) {
#pragma unroll
  for (int j = 0; j < Cfg<DH, L>::NB; ++j)
    tma_load_3d(dst + 128 * box_off(DH, j, L), &g.m[g.map[s][j]], bar,
                (g.col[s][j] + h * g.hs[j]) & ~7, row, b);
}

// K-major descriptor of k step kk (columns 16 kk .. 16 kk + 15) of a Q or K tile
template <int DH, int L>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk, uint32_t zero) {
  const int j = box_of(DH, 16 * kk, L), off = box_off(DH, j, L), w = box_w(DH, j, L);
  const uint32_t base = tile + 128 * off;
  if (w == 8) return make_desc(base, zero - base, 128, SW_NONE);
  return make_desc(base + 2 * (16 * kk - off), 16, 16 * w, w == 64 ? SW_128 : w == 32 ? SW_64
                                                                                    : SW_32);
}

// MN-major descriptor of box j of a V tile at keys 16 kk .. 16 kk + 15
template <int DH, int L>
__device__ __forceinline__ uint64_t vdesc(uint32_t tile, int j, int kk) {
  const int w = box_w(DH, j, L);
  const uint32_t base = tile + 128 * box_off(DH, j, L) + kk * 16 * 2 * w;
  if (w == 8) return make_desc(base, 128, 128, SW_NONE);
  return make_desc(base, 16, 16 * w, w == 64 ? SW_128 : w == 32 ? SW_64 : SW_32);
}

// o += P V for box J at k step kk of one key tile (a box past the head's
// last is a discarded branch)
template <int DH, int L, int J>
__device__ __forceinline__ void pv_box(float* o, const uint32_t (&pa)[4], uint32_t vt, int kk) {
  if constexpr (J < Cfg<DH, L>::NB)
    wgmma_rs_t<box_w(DH, J, L)>(o + box_off(DH, J, L) / 2, pa, vdesc<DH, L>(vt, J, kk), 1);
}

// o += P V over the four k steps of one key tile, box by box (at most six boxes)
template <int DH, int L>
__device__ __forceinline__ void pv_product(float* o, const uint32_t (&pa)[4][4], uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pv_box<DH, L, 0>(o, pa[kk], vt, kk);
    pv_box<DH, L, 1>(o, pa[kk], vt, kk);
    pv_box<DH, L, 2>(o, pa[kk], vt, kk);
    pv_box<DH, L, 3>(o, pa[kk], vt, kk);
    pv_box<DH, L, 4>(o, pa[kk], vt, kk);
    pv_box<DH, L, 5>(o, pa[kk], vt, kk);
  }
}

__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// Byte offset of the 16-byte chunk of row r holding columns d .. d + 7 (d a
// multiple of 8) in a Q or K tile: the box's rows as TMA wrote them, the
// chunks XORed with the row's place in the swizzle pattern (none in the
// 8-column box)
template <int DH, int L>
__device__ __forceinline__ uint32_t chunk_offset(int r, int d) {
  const int j = box_of(DH, d, L), off = box_off(DH, j, L), w = box_w(DH, j, L), rb = 2 * w;
  const int sw = w >= 16 ? ((r * rb) >> 7) & (rb / 16 - 1) : 0;
  return 128 * off + r * rb + ((((d - off) >> 3) ^ sw) << 4);
}

// q_row . k in f32 for row r of the Q tile in shared memory and key k (bf16,
// shared memory), the lane quad splitting the head's 16-byte chunks
template <int DH, int L>
__device__ __forceinline__ float quad_dot(uint32_t q_s, int r, const bf16* k, int q) {
  float s = 0.f;
#pragma unroll
  for (int c = q; c < DH / 8; c += 4) {
    uint4 qv;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(qv.x), "=r"(qv.y), "=r"(qv.z), "=r"(qv.w)
                 : "r"(q_s + chunk_offset<DH, L>(r, 8 * c)));
    s += dot8(qv, *reinterpret_cast<const uint4*>(k + 8 * c));
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// issue sc = Q K^T of one key tile (m64n64, one wgmma a k16 step)
template <int DH, int L>
__device__ __forceinline__ void scores(float (&sc)[32], uint32_t q_s, uint32_t k_s, uint32_t z_s) {
#pragma unroll
  for (int kk = 0; kk < Cfg<DH, L>::KSTEPS; ++kk)
    wgmma_ss<64>(sc, kdesc<DH, L>(q_s, kk, z_s), kdesc<DH, L>(k_s, kk, z_s), kk);
}

// The online softmax of one key tile's scores (rows g and g + 8 of the
// warp's 16; keys >= Nk masked): new row maxima m, sums l, P as the A
// fragments of P.V's four k16 steps; returns the rows' rescale factors.
__device__ __forceinline__ float2 softmax_tile(float (&sc)[32], uint32_t (&pa)[4][4], float& m0,
                                               float& m1, float& l0, float& l1, int kbase, int Nk,
                                               int q, float scale_log2) {
  if (kbase + ROWS > Nk) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (kbase + 8 * (i / 4) + 2 * q + (i & 1) >= Nk) sc[i] = -CUDART_INF_F;
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
  const float n0 = fmaxf(m0, x0 * scale_log2), n1 = fmaxf(m1, x1 * scale_log2);
  const float2 alpha = make_float2(exp2f(m0 - n0), exp2f(m1 - n1));
  m0 = n0;
  m1 = n1;
  float t0 = 0.f, t1 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sc[4 * c] = exp2f(fmaf(sc[4 * c], scale_log2, -n0));
    sc[4 * c + 1] = exp2f(fmaf(sc[4 * c + 1], scale_log2, -n0));
    sc[4 * c + 2] = exp2f(fmaf(sc[4 * c + 2], scale_log2, -n1));
    sc[4 * c + 3] = exp2f(fmaf(sc[4 * c + 3], scale_log2, -n1));
    t0 += sc[4 * c] + sc[4 * c + 1];
    t1 += sc[4 * c + 2] + sc[4 * c + 3];
  }
  l0 = fmaf(l0, alpha.x, t0);
  l1 = fmaf(l1, alpha.y, t1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  return alpha;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the four consumer warps
}

// PIECES: the column of box j where head h's piece starts
__device__ __forceinline__ int piece_offset(const Geo& g, int j, int h) {
  return (g.col[0][j] + h * g.hs[j]) & 7;
}

// The octic scatter's entry of column d of head h: (piece << 8) | column in
// the piece, or 0xFFFF for a padded column that is never stored
template <int DH, int L>
__device__ __forceinline__ unsigned short scatter_entry(const Geo& g, int d, int h) {
  if constexpr (L == PIECES) {
    const int j = box_of(DH, d, L), o = d - box_off(DH, j, L) - piece_offset(g, j, h);
    return o >= 0 && o < g.w[j] ? static_cast<unsigned short>((j << 8) | o) : 0xFFFF;
  } else {
    const int e = d - 4 * g.d1;
    return static_cast<unsigned short>(e < 0 ? ((d / g.d1) << 8) | (d % g.d1)
                                             : ((4 + e / g.de) << 8) | (e % g.de));
  }
}

// one output value pair (columns col, col + 1 of the head) of row `row`
template <int DH, int L>
__device__ __forceinline__ void store_pair(const Geo& g, const unsigned short* omap, int col,
                                           size_t row, int h, float v0, float v1) {
  const unsigned short e0 = omap[col];
  if (g.pairs) {
    if (e0 == 0xFFFF) return;
    const int p = e0 >> 8;
    *reinterpret_cast<uint32_t*>(g.out[p] + row * g.old[p] + h * g.ow[p] + (e0 & 255)) =
        pack_bf16x2(v0, v1);
    return;
  }
  const unsigned short e1 = omap[col + 1];
  if (e0 != 0xFFFF)
    g.out[e0 >> 8][row * g.old[e0 >> 8] + h * g.ow[e0 >> 8] + (e0 & 255)] = __float2bfloat16(v0);
  if (e1 != 0xFFFF)
    g.out[e1 >> 8][row * g.old[e1 >> 8] + h * g.ow[e1 >> 8] + (e1 & 255)] = __float2bfloat16(v1);
}

// PIECES: the columns around head h's pieces are zeroed in the q tile and
// in each k tile, so that they add exactly 0 to q k^T whatever the
// neighbouring columns hold (a non-finite value of another head would give
// 0 x Inf = NaN in this head's scores). Consumer thread t keeps one 16-byte
// chunk column of the tile, c = t % (DH / 8), for rows t / (DH / 8), t / (DH
// / 8) + 128 / (DH / 8), ...: the bf16 lanes of the piece it keeps, whether
// it clears the chunk (no piece column in it) and whether it has work at all.
struct PadChunk {
  int d0;
  uint4 keep;
  bool clear, work;
};

template <int DH, int L>
__device__ __forceinline__ PadChunk pad_chunk(const Geo& g, int h, int t) {
  constexpr int CH = DH / 8;
  PadChunk p;
  p.d0 = 8 * (t % CH);
  const int j = box_of(DH, p.d0, L);
  const int lo = box_off(DH, j, L) + piece_offset(g, j, h), hi = lo + g.w[j];
  uint32_t k[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = p.d0 + 2 * e;
    k[e] = (c >= lo && c < hi ? 0xFFFFu : 0u) | (c + 1 >= lo && c + 1 < hi ? 0xFFFF0000u : 0u);
  }
  p.keep = make_uint4(k[0], k[1], k[2], k[3]);
  p.clear = (k[0] | k[1] | k[2] | k[3]) == 0u;
  p.work = t < (128 / CH) * CH && (k[0] & k[1] & k[2] & k[3]) != 0xFFFFFFFFu;
  return p;
}

// this thread's chunks of a q or k tile, cleared or masked; the writes
// fenced for wgmma (the caller then syncs the consumer warpgroup)
template <int DH, int L>
__device__ __forceinline__ void zero_padding(uint8_t* tile, const PadChunk& p, int t) {
  constexpr int CH = DH / 8, STEP = 128 / CH;
  if (p.work) {
    for (int r = t / CH; r < ROWS; r += STEP) {
      uint4* a = reinterpret_cast<uint4*>(tile + chunk_offset<DH, L>(r, p.d0));
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (!p.clear) {
        v = *a;
        v.x &= p.keep.x;
        v.y &= p.keep.y;
        v.z &= p.keep.z;
        v.w &= p.keep.w;
      }
      *a = v;
    }
  }
  fence_proxy_async();
}

template <int DH, int L>
__global__ void __launch_bounds__(THREADS, Cfg<DH, L>::MINB)
    std_attention_kernel(const __grid_constant__ Geo geo, bf16* __restrict__ out, int N, int H,
                         int QT, int KT, int Nk, float scale_log2) {
  using Cf = Cfg<DH, L>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* qs = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* zero = qs + Cf::TILE * (1 + 2 * Cf::ST);
  bf16* last = reinterpret_cast<bf16*>(zero + Cf::ZERO);  // key and value N - 1
  unsigned short* omap = reinterpret_cast<unsigned short*>(zero + Cf::ZERO + LAST);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(zero + Cf::ZERO + LAST + Cf::MAP);
  uint64_t* lastbar = qbar + 1;
  uint64_t* kfull = lastbar + 1;
  uint64_t* vfull = kfull + Cf::ST;
  uint64_t* empty = vfull + Cf::ST;

  const int qt = blockIdx.x % QT, bh = blockIdx.x / QT, h = bh % H, b = bh / H;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    mbar_init(lastbar, 31);  // producer lanes 1-31
    for (int s = 0; s < Cf::ST; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  if (Cf::TAIL && threadIdx.x < Cf::ZERO / 8) {
    reinterpret_cast<uint2*>(zero)[threadIdx.x] = make_uint2(0u, 0u);
    fence_proxy_async();
  }
  if (L != STD && threadIdx.x < DH) omap[threadIdx.x] = scatter_entry<DH, L>(geo, threadIdx.x, h);
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: lane 0 loads the query tile and streams the key
    // and value tiles through the ring; lanes 1-31 copy key and value N - 1
    // for the rank-1 update
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, Cf::TILE);
      load_tile<DH, L>(qs, geo, qbar, 0, h, qt * ROWS, b);
    }
    if (Nk < N && lane > 0) {  // lanes 1-31, so lane 0 goes straight on to the ring
      const size_t row = (size_t)b * N + N - 1;
      if constexpr (L == PIECES) {
        // padded columns: each box's piece, zeros around it
        for (int i = lane - 1; i < 2 * DH; i += 31) {
          const int s = 1 + (i >= DH), d = i - (s - 1) * DH, j = box_of(DH, d, L);
          const int o = d - box_off(DH, j, L) - piece_offset(geo, j, h), m = geo.map[s][j];
          last[i] = o >= 0 && o < geo.w[j]
                        ? geo.ptr[m][row * geo.ld[m] + geo.col[s][j] + h * geo.hs[j] + o]
                        : __float2bfloat16(0.f);
        }
      } else {
        const bf16* base = geo.ptr[0] + row * geo.ld[0] + h * geo.hs[0];
        const bf16* kl = base + geo.col[1][0];
        const bf16* vl = base + geo.col[2][0];
        for (int c = lane - 1; c < DH / 4; c += 31)  // DH / 8 chunks of k, then of v
          reinterpret_cast<uint4*>(last)[c] = *reinterpret_cast<const uint4*>(
              c < DH / 8 ? kl + 8 * c : vl + 8 * (c - DH / 8));
      }
      mbar_arrive(lastbar);
    }
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % Cf::ST;
        mbar_wait(&empty[s], ((kt / Cf::ST) & 1) ^ 1);
        uint8_t* kv = qs + Cf::TILE * (1 + 2 * s);
        mbar_arrive_expect_tx(&kfull[s], Cf::TILE);
        load_tile<DH, L>(kv, geo, &kfull[s], 1, h, kt * ROWS, b);
        mbar_arrive_expect_tx(&vfull[s], Cf::TILE);
        load_tile<DH, L>(kv + Cf::TILE, geo, &vfull[s], 2, h, kt * ROWS, b);
      }
    }
  } else {
    // ---- consumer warpgroup: rows r0 = 16 warp + g and r0 + 8 of the tile
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane & 3;
    const int r0 = qt * ROWS + warp * 16 + (lane >> 2), r1 = r0 + 8;
    const uint32_t q_s = smem_addr(qs), z_s = smem_addr(zero);
    float o[DH / 2];
    float m0, m1, l0, l1;
    mbar_wait(qbar, 0);
    PadChunk pad = {};
    if constexpr (L == PIECES) {
      pad = pad_chunk<DH, L>(geo, h, threadIdx.x);
      zero_padding<DH, L>(qs, pad, threadIdx.x);
      consumer_sync();
    }
    if (Nk < N) {
      // key N - 1 as a rank-1 update: p = exp2(s - m) = 1 at m = s, so o = v
      mbar_wait(lastbar, 0);
      const float s0 = quad_dot<DH, L>(q_s, r0 - qt * ROWS, last, q);
      const float s1 = quad_dot<DH, L>(q_s, r1 - qt * ROWS, last, q);
      m0 = s0 * scale_log2;
      m1 = s1 * scale_log2;
      l0 = l1 = q == 0 ? 1.f : 0.f;  // the row sum is taken over the quad at the end
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(last + DH + 8 * (i / 4) + 2 * q));
        o[i] = o[i + 2] = v.x;
        o[i + 1] = o[i + 3] = v.y;
      }
    } else {
      m0 = m1 = -CUDART_INF_F;
      l0 = l1 = 0.f;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    }

    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % Cf::ST;
      const uint32_t ph = (kt / Cf::ST) & 1;
      const uint32_t k_s = q_s + Cf::TILE * (1 + 2 * s), v_s = k_s + Cf::TILE;
      float sc[32];
      uint32_t pa[4][4];
      mbar_wait(&kfull[s], ph);
      if constexpr (L == PIECES) {
        zero_padding<DH, L>(qs + Cf::TILE * (1 + 2 * s), pad, threadIdx.x);
        consumer_sync();
      }
      wgmma_fence();
      scores<DH, L>(sc, q_s, k_s, z_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(sc);
      const float2 alpha = softmax_tile(sc, pa, m0, m1, l0, l1, kt * ROWS, Nk, q, scale_log2);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
      mbar_wait(&vfull[s], ph);
      fence_regs<DH / 2>(o);
      wgmma_fence();
      pv_product<DH, L>(o, pa, v_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DH / 2>(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    if constexpr (L == STD) {
      const int C = H * DH;
      bf16* o0 = out + ((size_t)b * N + r0) * C + h * DH;
      bf16* o1 = o0 + (size_t)8 * C;
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        const int col = 8 * (i / 4) + 2 * q;
        if (r0 < N) *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16x2(o[i] * i0, o[i + 1] * i0);
        if (r1 < N)
          *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16x2(o[i + 2] * i1, o[i + 3] * i1);
      }
    } else {
      // the octic scatter: the head's columns to o1..o4 and oe0, oe1
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        const int col = 8 * (i / 4) + 2 * q;
        if (r0 < N)
          store_pair<DH, L>(geo, omap, col, (size_t)b * N + r0, h, o[i] * i0, o[i + 1] * i0);
        if (r1 < N)
          store_pair<DH, L>(geo, omap, col, (size_t)b * N + r1, h, o[i + 2] * i1, o[i + 3] * i1);
      }
    }
  }
}

// One launch of layout L at (padded) head width DH after checking the
// caller's plan against this instantiation's; `dh` the head's real width
// (the scale is dh^-0.5).
template <int DH, int L>
int run(const Geo& geo, void* out, int B, int N, int H, int dh, int grid, int smem,
        cudaStream_t stream) {
  using Cf = Cfg<DH, L>;
  const int split = N > 1 && (N - 1) % ROWS == 0;
  const int Nk = N - split, QT = (N + ROWS - 1) / ROWS;
  const int KT = (Nk + ROWS - 1) / ROWS;
  if (smem != Cf::SMEM || (long long)grid != (long long)B * H * QT) return ERR_PLAN;
  cudaError_t err = cudaFuncSetAttribute(std_attention_kernel<DH, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return err;
  std_attention_kernel<DH, L><<<grid, THREADS, Cf::SMEM, stream>>>(
      geo, static_cast<bf16*>(out), N, H, QT, KT, Nk, 1.4426950408889634f / sqrtf((float)dh));
  return cudaGetLastError();
}

// The standard gather over qkv [B,N,3C] (C = H * DH): one map per box width
template <int DH>
int std_geo(Geo& g, const void* qkv, int B, int N, int H, const int* widths, int nboxes) {
  constexpr int NB = num_boxes(DH, STD);
  bool ok = nboxes == NB;
  for (int j = 0; ok && j < nboxes; ++j) ok = widths[j] == box_w(DH, j, STD);
  if (!ok) return ERR_PLAN;
  const uint64_t C = (uint64_t)H * DH;
  const uint64_t dims[3] = {3 * C, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {3 * C * 2, 3 * C * 2 * N};
  for (int j = 0; j < NB; ++j) {
    const int w = box_w(DH, j, STD);
    const uint32_t box[3] = {(uint32_t)w, ROWS, 1};
    const int err = encode_bf16_map(&g.m[map_index(w)], qkv, 3, dims, strides, box,
                                    w >= 16 ? 2 * w : 0);
    if (err != 0) return err;
    for (int s = 0; s < 3; ++s) {
      g.map[s][j] = map_index(w);
      g.col[s][j] = s * (int)C + box_off(DH, j, STD);
    }
    g.hs[j] = DH;
    g.w[j] = w;
  }
  for (int m = 0; m < 4; ++m) {
    g.ptr[m] = static_cast<const bf16*>(qkv);
    g.ld[m] = 3 * (int)C;
  }
  return 0;
}

}  // namespace
}  // namespace attn_std
}  // namespace ovt
