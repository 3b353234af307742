// K-lin-d8-bwd's device code on TMA + wgmma: the transpose and the weight
// gradients of the block-diagonal D8 qkv map (csrc/lin_d8_bwd.cu). See
// csrc/lin_d8_bwd.cu for what it replaces, what bounds it on the H100 and
// why it is built this way.
//
// Everything here has internal linkage.
#pragma once

#include "sm90.cuh"

namespace ovt {
namespace lind8bwd {
namespace {

using namespace sm90;

// A unit is one 128 x 128 output tile with its k loop; each of the two
// consumer warpgroups holds 64 of its rows (one m64n128 accumulator, 64 f32 a
// thread) and they share the B box; 64-wide k blocks through a ring of
// STAGES stages; a producer warpgroup (setmaxnreg) issues the loads; one CTA
// an SM walks its list of units (the launch plan, ops/linear.py:
// lin_d8_bwd_plan), slab by slab.
//   dx units: rows = 128 tokens, columns = 128 input channels of one 1-d slot
//     or one E row; A = the cotangent (dq_g or de_r) K-major, B = the weight
//     rows (w1[g] or we) K-major: wgmma_ss.
//   dW units: rows = 128 input channels, columns = 128 output columns, k = the
//     tokens of one slab; A = x_g (or E row r of ef), B = dq_g (or de_r), both
//     token-major as they lie in memory: wgmma_ss_tt. One f32 partial a slab.
constexpr int BM = 128, BN = 128, BK = 64, CONSUMERS = 2, STAGES = 6;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int BOX = 64 * 64 * 2;                // one 64 x 64 bf16 box, 128-byte swizzle
constexpr int A_BYTES = CONSUMERS * BOX;        // a warpgroup's A box each
constexpr int B_BYTES = 2 * BOX;                // 128 K-major rows, or two 64-column MN-major boxes
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 32 KB, every unit's k block
constexpr int STAGING = 2 * BOX;                // a warpgroup's 64 x 128 bf16 dx tile
constexpr int TILE = BM * BN;                   // floats in one dW tile's partial
constexpr int BIAS_PARTS = 4;                   // dbias sums a slab and column (16-row quarters)
// align slack, the ring, each warpgroup's dx staging, full and empty a stage
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + CONSUMERS * STAGING + 2 * STAGES * 8;

enum Kind : int { DX1 = 0, DXE = 1, DW1 = 2, DWE = 3 };

struct Maps {
  CUtensorMap dq[4];  // dq_g [M, F], 64 x 64 boxes
  CUtensorMap de[2];  // de_r [M, 2F]
  CUtensorMap x[4];   // x_g [M, c] (row stride ldx)
  CUtensorMap xe[2];  // E row r, ef[:, 2c r : 2c (r + 1)] (ldxe)
  CUtensorMap w1;     // w1 [4, c, F] as (F, c, 4), 64 x 128 x 1 boxes
  CUtensorMap we;     // we [2c, 2F] as (2F, 2c), 64 x 128 boxes
  CUtensorMap dx[4];  // dx_g [M, c] (ldd), 64 x 64 boxes
  CUtensorMap dxe;    // dxef [M, 4c] as (2c, 2, M) (ldde): each row clipped at 2c
};

struct Args {
  const int* table;        // [grid + 1] unit offsets, then int4 units from `units_at`
  float* part;             // [slabs] x (tiles x TILE, then BIAS_PARTS x nj1 BN) f32
  long long slab_stride;   // floats a slab's partials
  int M, c, F, slab_tokens, units_at, bias;
  int ni1, nj1, nie, nje;  // dW tiles: rows x columns of a w1[g] and of a we gradient
};

struct Unit {
  int kind, slot, rt, ct, slab;  // slot g or r; row tile, column tile
};

// a unit: {kind + 4 slot, row tile, column tile, slab}
__device__ __forceinline__ Unit unit_at(const Args& a, int u) {
  const int4 w = reinterpret_cast<const int4*>(a.table + a.units_at)[u];
  return {w.x & 3, w.x >> 2, w.y, w.z, w.w};
}

__device__ __forceinline__ int k_blocks(const Args& a, const Unit& u) {
  if (u.kind == DX1) return (a.F + BK - 1) / BK;
  if (u.kind == DXE) return (2 * a.F + BK - 1) / BK;
  return (min(a.slab_tokens, a.M - u.slab * a.slab_tokens) + BK - 1) / BK;
}

// index of a dW unit's partial among a slab's tiles: w1[0..3], then we row 0, row 1
__device__ __forceinline__ int tile_of(const Args& a, const Unit& u) {
  return u.kind == DW1 ? (u.slot * a.ni1 + u.rt) * a.nj1 + u.ct
                       : 4 * a.ni1 * a.nj1 + (u.slot * a.nie + u.rt) * a.nje + u.ct;
}

// K-major box (128-byte swizzle, rows of 64 k), k16 step kk
__device__ __forceinline__ uint64_t k_desc(uint32_t box, int kk) {
  return make_desc(box + 32 * kk, 16, 1024, SW_128);
}

// MN-major boxes (128-byte swizzle, rows of 64 columns a token; a second
// 64-column box BOX bytes on), k16 step kk
__device__ __forceinline__ uint64_t mn_desc(uint32_t box, int kk) {
  return make_desc(box + 2048 * kk, BOX, 1024, SW_128);
}

// byte offset of (row r, column c < 128) in two 64-column boxes of 128-byte
// rows as the 128-byte swizzle lays them out: 16-byte chunks XORed with r % 8
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * BOX + r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__global__ void __launch_bounds__(THREADS, 1)
    lin_d8_bwd_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + CONSUMERS * STAGING);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  const int u_begin = a.table[blockIdx.x], u_end = a.table[blockIdx.x + 1];

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread streams each unit's k blocks through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int p = 0;
      for (int ui = u_begin; ui < u_end; ++ui) {
        const Unit u = unit_at(a, ui);
        const int kt_n = k_blocks(a, u);
        const bool dw = u.kind >= DW1;
        // dx: A = the cotangent; dW: A = the input, B = the cotangent
        const CUtensorMap* am = u.kind == DX1   ? &maps.dq[u.slot]
                                : u.kind == DXE ? &maps.de[u.slot]
                                : u.kind == DW1 ? &maps.x[u.slot]
                                                : &maps.xe[u.slot];
        const CUtensorMap* cot = u.kind == DW1 ? &maps.dq[u.slot] : &maps.de[u.slot];
        for (int kt = 0; kt < kt_n; ++kt, ++p) {
          const int s = p % STAGES;
          mbar_wait(&empty[s], ((p / STAGES) & 1) ^ 1);
          uint8_t* st = ring + s * STAGE_BYTES;
          uint8_t* sb = st + A_BYTES;
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);  // out-of-bounds boxes count in full
          if (dw) {
            const int m = u.slab * a.slab_tokens + kt * BK, i0 = u.rt * BM, j0 = u.ct * BN;
            tma_load_2d(st, am, &full[s], i0, m);
            tma_load_2d(st + BOX, am, &full[s], i0 + 64, m);
            tma_load_2d(sb, cot, &full[s], j0, m);
            tma_load_2d(sb + BOX, cot, &full[s], j0 + 64, m);
          } else {
            const int k0 = kt * BK, m0 = u.rt * BM, n0 = u.ct * BN;
            tma_load_2d(st, am, &full[s], k0, m0);
            tma_load_2d(st + BOX, am, &full[s], k0, m0 + 64);
            if (u.kind == DX1)
              tma_load_3d(sb, &maps.w1, &full[s], k0, n0, u.slot);
            else
              tma_load_2d(sb, &maps.we, &full[s], k0, n0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63 of each unit
  setmaxnreg_inc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, q = lane & 3;
  const uint32_t ring_s = smem_addr(ring);
  uint8_t* stage_out = staging + wg * STAGING;
  const int bar_id = 1 + wg;
  const int tiles = 4 * a.ni1 * a.nj1 + 2 * a.nie * a.nje;
  float acc[64];
  int p = 0;
  for (int ui = u_begin; ui < u_end; ++ui) {
    const Unit u = unit_at(a, ui);
    const int kt_n = k_blocks(a, u);
    const bool dw = u.kind >= DW1;
    // the A1 units of the first channel tile also sum dq_0's columns for
    // dbias: this thread takes columns 2 (tid % 64), +1 over 16 rows of each
    // k block (a quarter: 32 wg + 16 (tid / 64))
    const bool bias = a.bias && u.kind == DW1 && u.slot == 0 && u.rt == 0;
    // a warpgroup whose 64 rows all lie past the output (the ragged last
    // token or channel tile) skips its products and keeps the ring's pace
    const bool live = u.rt * BM + 64 * wg < (u.kind == DW1 ? a.c : u.kind == DWE ? 2 * a.c : a.M);
    float b0 = 0.f, b1 = 0.f;
    for (int kt = 0; kt < kt_n; ++kt, ++p) {
      const int s = p % STAGES;
      mbar_wait(&full[s], (p / STAGES) & 1);
      const uint32_t sa = ring_s + s * STAGE_BYTES + wg * BOX;
      const uint32_t sb = ring_s + s * STAGE_BYTES + A_BYTES;
      if (live) {
        fence_regs<64>(acc);
        wgmma_fence();
        if (dw) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_ss_tt<128>(acc, mn_desc(sa, kk), mn_desc(sb, kk), kt > 0 || kk > 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_ss<128>(acc, k_desc(sa, kk), k_desc(sb, kk), kt > 0 || kk > 0);
        }
        wgmma_commit();
      }
      if (bias) {
        const uint8_t* tile = ring + s * STAGE_BYTES + A_BYTES;
        const int col = 2 * (tid & 63), r0 = 32 * wg + 16 * (tid >> 6);
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(tile + swz(r0 + rr, col)));
          b0 += v.x;
          b1 += v.y;
        }
      }
      if (kt > 0) {
        // the previous k block's products are done: release its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(p - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs<64>(acc);
    if (lane == 0) mbar_arrive(&empty[(p - 1) % STAGES]);

    if (!dw) {
      // ---- dx: bf16 into the staging (128-byte swizzle), then TMA stores
      // of two 64-column boxes, clipped at M and at the slot's width
      const int m0 = u.rt * BM + 64 * wg, n0 = u.ct * BN;
      const int width = u.kind == DX1 ? a.c : 2 * a.c;
      if (tid == 0) tma_store_wait_read<0>();  // the last unit's stores read the staging
      named_sync(bar_id, 128);
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(stage_out + swz(16 * warp + g8 + 8 * h, 8 * i + 2 * q)) =
              pack_bf16x2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      fence_proxy_async();
      named_sync(bar_id, 128);
      if (tid == 0 && m0 < a.M) {
        for (int b = 0; b < 2 && n0 + 64 * b < width; ++b) {
          if (u.kind == DX1)
            tma_store_2d(&maps.dx[u.slot], stage_out + b * BOX, n0 + 64 * b, m0);
          else
            tma_store_3d(&maps.dxe, stage_out + b * BOX, n0 + 64 * b, u.slot, m0);
        }
        tma_store_commit();
      }
    } else {
      // ---- dW: the f32 partial in the accumulators' own order (float4 v of
      // thread tid at [v][tid]: coalesced), rows past the gradient skipped
      float* part = a.part + (size_t)u.slab * a.slab_stride + (size_t)tile_of(a, u) * TILE +
                    wg * (TILE / 2);
      const int ni = u.kind == DW1 ? a.c : 2 * a.c, nj = u.kind == DW1 ? a.F : 2 * a.F;
      const int i = u.rt * BM + 64 * wg + 16 * warp + g8;
#pragma unroll
      for (int v = 0; v < 16; ++v) {
        const int j = u.ct * BN + 8 * v + 2 * q;
        if (i < ni && j < nj)
          reinterpret_cast<float4*>(part)[v * 128 + tid] =
              make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
      }
      if (bias) {
        const int j = u.ct * BN + 2 * (tid & 63);
        if (j < a.F)
          *reinterpret_cast<float2*>(a.part + (size_t)u.slab * a.slab_stride +
                                     (size_t)tiles * TILE +
                                     (2 * wg + (tid >> 6)) * (a.nj1 * BN) + j) =
              make_float2(b0, b1);
      }
    }
  }
  if (tid == 0) tma_store_wait<0>();
}

// dw1, dwe and dbias: each element the sum of its partials in a fixed order
// (slab, then E row, then the bias's quarters), rounded to bf16. Thread idx
// takes one float4 of a tile's partial (the rows r and r + 8, the columns j and
// j + 1 of one accumulator quad), or one dbias column past the tiles.
__global__ void reduce_kernel(const Args a, int slabs, bf16* dw1, bf16* dwe, bf16* dbias) {
  const int n1 = 4 * a.ni1 * a.nj1, ne = a.nie * a.nje, tiles = n1 + 2 * ne;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long quads = (long long)(n1 + ne) * (TILE / 4);
  if (idx < quads) {
    const int tile = (int)(idx / (TILE / 4)), rem = (int)(idx % (TILE / 4));
    const int w = rem / 2048, v = (rem / 128) % 16, t = rem % 128;
    const int di = 64 * w + 16 * (t / 32) + (t % 32) / 4, dj = 8 * v + 2 * (t % 4);
    const bool one = tile < n1;
    const int e = one ? tile % (a.ni1 * a.nj1) : tile - n1;
    const int nj_t = one ? a.nj1 : a.nje;
    const int i = (e / nj_t) * BM + di, j = (e % nj_t) * BN + dj;
    const int ni = one ? a.c : 2 * a.c, nj = one ? a.F : 2 * a.F;
    if (i >= ni || j >= nj) return;  // never written
    // the slabs' partials of this quad (both E rows' for dwe), loads unrolled
    // ahead of the sums, which keep their order
    const float* p0 = a.part + (size_t)(one ? tile : n1 + e) * TILE + 4 * rem;
    const float* p1 = p0 + (size_t)ne * TILE;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float* p) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    };
    if (one) {
#pragma unroll 8
      for (int sl = 0; sl < slabs; ++sl) add(p0 + (size_t)sl * a.slab_stride);
    } else {
#pragma unroll 4
      for (int sl = 0; sl < slabs; ++sl) {
        add(p0 + (size_t)sl * a.slab_stride);
        add(p1 + (size_t)sl * a.slab_stride);
      }
    }
    bf16* out = one ? dw1 + (size_t)(tile / (a.ni1 * a.nj1)) * a.c * a.F : dwe;
    *reinterpret_cast<uint32_t*>(out + (size_t)i * nj + j) = pack_bf16x2(s.x, s.y);
    if (i + 8 < ni)
      *reinterpret_cast<uint32_t*>(out + (size_t)(i + 8) * nj + j) = pack_bf16x2(s.z, s.w);
    return;
  }
  const long long j = idx - quads;
  if (dbias == nullptr || j >= a.F) return;
  float s = 0.f;
#pragma unroll 2
  for (int sl = 0; sl < slabs; ++sl)
#pragma unroll
    for (int h = 0; h < BIAS_PARTS; ++h)
      s += a.part[(size_t)sl * a.slab_stride + (size_t)tiles * TILE + h * (a.nj1 * BN) + j];
  dbias[j] = __float2bfloat16(s);
}

}  // namespace
}  // namespace lind8bwd
}  // namespace ovt
