// K-lin-d8's device code on TMA + wgmma: the block-diagonal D8 linear map
// over the flat-E tuple with its epilogues, the model paths' kernel
// (csrc/lin_d8.cu). See csrc/lin_d8.cu for what it replaces, what bounds it
// on the H100 and why it is built this way. The mma.sync core it replaced
// (csrc/lin_d8_core.cuh) stays for the tile probes (csrc/lin_d8_probe.cu).
//
// Everything here has internal linkage.
#pragma once

#include "sm90.cuh"

namespace ovt {
namespace lind8w {
namespace {

using namespace sm90;

// A CTA's tile: BM tokens x BN channels across all eight slots; each of its
// two consumer warpgroups holds the eight products of BNW channels and they
// share the A boxes; 32-wide k blocks through a ring of STAGES stages; a
// producer warpgroup (setmaxnreg) issues the loads; one CTA an SM. Two other
// schedules were slower at every shape of the main path (PERF.md): one
// consumer warpgroup a 64 x 32 tile with two CTAs an SM, and the two
// warpgroups taking 64 x 32 tiles in turns (ping-pong), each so that an
// epilogue ran beside other products, at 1.5x the A loads.
constexpr int BM = 64, BNW = 32, BK = 32, CONSUMERS = 2, BN = BNW * CONSUMERS, STAGES = 3;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int A_BOX = BM * BK * 2;    // one A box: 64 tokens x 32 k, 64-byte swizzle
constexpr int B_BOX = BK * BNW * 2;   // one B box: 32 k x 32 channels, 64-byte swizzle
constexpr int A_BYTES = 6 * A_BOX;    // x_a1, x_a2, x_b1, x_b2, E row 0, E row 1
// w1[0..3], we[:, j], we[:, F + j]; a half of 32 channels for each warpgroup
constexpr int B_BYTES = 6 * CONSUMERS * B_BOX;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int E_STAGE_BYTES = 2 * A_BOX + 2 * CONSUMERS * B_BOX;  // past k = C: the E rows
constexpr int OUT_BOX = BM * BNW * 2;  // one product's staged output tile (a warpgroup)
constexpr int STAGING = 8 * OUT_BOX;   // a warpgroup's eight products
// align slack, the ring, each warpgroup's staging, the barriers (full and
// empty a stage; a warpgroup's residual full and free for the LayerScale
// epilogue)
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + CONSUMERS * STAGING + (2 * STAGES + 4) * 8;

enum Epi : int { NONE = 0, GELU = 1, LS = 2 };

struct Maps {
  CUtensorMap a[6];   // x0..x3 [M, C], E row 0 and row 1 [M, 2C] (row strides ldx, ldxe)
  CUtensorMap w1;     // w1 [4, C, F] as (F, C, 4)
  CUtensorMap we;     // we [2C, 2F] as (2F, 2C)
  CUtensorMap y[4];   // the tuple store: y_g [M, F] (row stride ldy)
  CUtensorMap ye[2];  // ye_r [M, 2F] as (F, 2, M): [e_r1 | e_r2], each half clipped at F
  CUtensorMap r[4];   // the LayerScale epilogue's residual: r_g [M, F]
  CUtensorMap ref;    // ref [M, 4F] as (F, 4, M): e11 | e12 | e21 | e22
};

struct Args {
  const bf16* bias;   // [F] or null (A1 only)
  const bf16* ls1;    // LayerScale epilogue: [4, F]
  const bf16* lse;    // [2F]
  const bf16* r[4];   // the residual, [M, F] each, contiguous
  const bf16* ref;    // [M, 4F], contiguous
  bf16* y[4];         // the grouped store's outputs (base pointers)
  bf16* ye[2];
  int g1, s1, ge, se;  // grouped-column maps (csrc/lin_d8.cu)
  int pairs;           // 1: the grouped store may write bf16x2 pairs
  int M, C, F, ldy, ldye;
  int MT, NT, KT1, KTE;  // M-tiles, N-tiles, k blocks of the 1-d and the E products
};

// K-major A box (64B swizzle), k16 step kk of the 32-wide block
__device__ __forceinline__ uint64_t adesc(uint32_t box, int kk) {
  return make_desc(box + 32 * kk, 16, 512, SW_64);
}

// MN-major B box (32 k rows of 32 channels, 64B swizzle), k16 step kk
__device__ __forceinline__ uint64_t bdesc(uint32_t box, int kk) {
  return make_desc(box + 1024 * kk, 16, 512, SW_64);
}

// byte offset of (row r, channel pair c) in a staged 64 x 32 output tile as
// the 64B-swizzled TMA store reads it: 16-byte chunks XORed with (r / 2) % 4
__device__ __forceinline__ uint32_t stage_off(int r, int c) {
  return r * 64 + ((((c >> 3) ^ (r >> 1)) & 3) << 4) + (c & 7) * 2;
}

template <int EPI, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 1)
    lin_d8_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args a) {
  constexpr int CONS = CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + CONS * STAGING);
  uint64_t* empty = full + STAGES;
  // the LayerScale epilogue's residual tile, loaded into the warpgroup's staging
  uint64_t* rfull = empty + STAGES;
  uint64_t* rfree = rfull + CONS;
  const int T = a.MT * a.NT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS * 4);  // one arrival per consumer warp
    }
    for (int w = 0; w < CONS; ++w) {
      mbar_init(&rfull[w], 1);
      mbar_init(&rfree[w], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONS) {
    // ---- producer: one thread streams each tile's k blocks through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONS * 128) {
      int p = 0, tk = 0;
      for (int t = blockIdx.x; t < T; t += gridDim.x, ++tk) {
        const int m0 = (t / a.NT) * BM, j0 = (t % a.NT) * BN;
        for (int kt = 0; kt < a.KTE; ++kt, ++p) {
          const int s = p % STAGES, k0 = kt * BK;
          mbar_wait(&empty[s], ((p / STAGES) & 1) ^ 1);
          uint8_t* st = ring + s * STAGE_BYTES;
          uint8_t* sb = st + A_BYTES;
          const bool one = kt < a.KT1;
          mbar_arrive_expect_tx(&full[s], one ? STAGE_BYTES : E_STAGE_BYTES);
          // B box (bi, half h) at (bi CONS + h): w1[0..3], we[:, j], we[:, F + j]
#pragma unroll
          for (int h = 0; h < CONS; ++h) {
            const int j = j0 + h * BNW;
            if (one) {
#pragma unroll
              for (int g = 0; g < 4; ++g)
                tma_load_3d(sb + (g * CONS + h) * B_BOX, &maps.w1, &full[s], j, k0, g);
            }
            tma_load_2d(sb + (4 * CONS + h) * B_BOX, &maps.we, &full[s], j, k0);
            tma_load_2d(sb + (5 * CONS + h) * B_BOX, &maps.we, &full[s], a.F + j, k0);
          }
          if (one) {
#pragma unroll
            for (int g = 0; g < 4; ++g) tma_load_2d(st + g * A_BOX, &maps.a[g], &full[s], k0, m0);
          }
          tma_load_2d(st + 4 * A_BOX, &maps.a[4], &full[s], k0, m0);
          tma_load_2d(st + 5 * A_BOX, &maps.a[5], &full[s], k0, m0);
        }
        if constexpr (EPI == LS) {
          // the tile's residual into each warpgroup's staging, once the last
          // tile's stores have read it: staging slot p holds product p's
          // residual (ref's e11 | e12 | e21 | e22 go to slots 4, 6, 5, 7)
          for (int w = 0; w < CONS; ++w) {
            uint8_t* out = staging + w * STAGING;
            const int jw = j0 + w * BNW;
            mbar_wait(&rfree[w], (tk & 1) ^ 1);
            mbar_arrive_expect_tx(&rfull[w], 8 * OUT_BOX);
            for (int g = 0; g < 4; ++g) tma_load_2d(out + g * OUT_BOX, &maps.r[g], &rfull[w], jw, m0);
            tma_load_3d(out + 4 * OUT_BOX, &maps.ref, &rfull[w], jw, 0, m0);
            tma_load_3d(out + 6 * OUT_BOX, &maps.ref, &rfull[w], jw, 1, m0);
            tma_load_3d(out + 5 * OUT_BOX, &maps.ref, &rfull[w], jw, 2, m0);
            tma_load_3d(out + 7 * OUT_BOX, &maps.ref, &rfull[w], jw, 3, m0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds the eight m64n32 products of channels
  // j0 + 32 wg .. j0 + 32 wg + 31 of the CTA's tiles
  setmaxnreg_inc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, q = lane & 3;
  const uint32_t ring_s = smem_addr(ring);
  uint8_t* stage_out = staging + wg * STAGING;
  const int bar_id = 1 + wg;
  // acc[p]: p = 0..3 the 1-d products a1, a2, b1, b2; 4 e11 (row 0, we[:, j]),
  // 5 e21 (row 1, we[:, j]), 6 e12 (row 0, we[:, F + j]), 7 e22 (row 1, we[:, F + j])
  float acc[8][16];
  int p = 0, tk = 0;
  for (int t = blockIdx.x; t < T; t += gridDim.x, ++tk) {
    const int m0 = (t / a.NT) * BM, jw = (t % a.NT) * BN + wg * BNW;
    for (int kt = 0; kt < a.KTE; ++kt, ++p) {
      const int s = p % STAGES;
      mbar_wait(&full[s], (p / STAGES) & 1);
      const uint32_t st = ring_s + s * STAGE_BYTES, sb = st + A_BYTES;
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_regs<16>(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int acc_on = kt > 0 || kk > 0;
        if (kt < a.KT1) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            wgmma_ss_t<32>(acc[g], adesc(st + g * A_BOX, kk),
                           bdesc(sb + (g * CONS + wg) * B_BOX, kk), acc_on);
        }
        const uint64_t r0 = adesc(st + 4 * A_BOX, kk), r1 = adesc(st + 5 * A_BOX, kk);
        const uint64_t blo = bdesc(sb + (4 * CONS + wg) * B_BOX, kk);
        const uint64_t bhi = bdesc(sb + (5 * CONS + wg) * B_BOX, kk);
        wgmma_ss_t<32>(acc[4], r0, blo, acc_on);
        wgmma_ss_t<32>(acc[5], r1, blo, acc_on);
        wgmma_ss_t<32>(acc[6], r0, bhi, acc_on);
        wgmma_ss_t<32>(acc[7], r1, bhi, acc_on);
      }
      wgmma_commit();
      if (kt > 0) {
        // the previous k block's products are done: release its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(p - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) fence_regs<16>(acc[i]);
    if (lane == 0) mbar_arrive(&empty[(p - 1) % STAGES]);

    // ---- epilogue: the octet of each (m, j) in registers, then the staged store
    if (!GROUPED && tid == 0) tma_store_wait_read<0>();  // the last tile's stores read staging
    if (EPI == LS) mbar_wait(&rfull[wg], tk & 1);         // the residual is in the staging
    else named_sync(bar_id, 128);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * i + 2 * q, j = jw + c;
      const bool jin = j < a.F;  // F % 8 == 0: the pair (j, j + 1) is in or out together
      float b0 = 0.f, b1 = 0.f;
      if (a.bias != nullptr && jin) {
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.bias + j));
        b0 = bb.x;
        b1 = bb.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g8 + 8 * h, m = m0 + r;
        float v[2][8];
#pragma unroll
        for (int pp = 0; pp < 8; ++pp) {
          v[0][pp] = acc[pp][4 * i + 2 * h];
          v[1][pp] = acc[pp][4 * i + 2 * h + 1];
        }
        v[0][0] += b0;
        v[1][0] += b1;
        if constexpr (EPI == GELU) {
          gelu_d8_octet(v[0]);
          gelu_d8_octet(v[1]);
        }
        if constexpr (EPI == LS) {
          // y = r + ls z with the residual from the staging, written back in place
          const size_t F = a.F;
          float2 ls[8];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            ls[g] = jin ? __bfloat1622float2(
                              *reinterpret_cast<const __nv_bfloat162*>(a.ls1 + g * F + j))
                        : make_float2(0.f, 0.f);
          ls[4] = ls[5] = jin ? __bfloat1622float2(
                                    *reinterpret_cast<const __nv_bfloat162*>(a.lse + j))
                              : make_float2(0.f, 0.f);  // e11, e21: lse[j]
          ls[6] = ls[7] = jin ? __bfloat1622float2(
                                    *reinterpret_cast<const __nv_bfloat162*>(a.lse + F + j))
                              : make_float2(0.f, 0.f);  // e12, e22: lse[F + j]
#pragma unroll
          for (int pp = 0; pp < 8; ++pp) {
            const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                stage_out + pp * OUT_BOX + stage_off(r, c)));
            v[0][pp] = rr.x + ls[pp].x * v[0][pp];
            v[1][pp] = rr.y + ls[pp].y * v[1][pp];
          }
        }
#pragma unroll
        for (int pp = 0; pp < 8; ++pp)
          *reinterpret_cast<uint32_t*>(stage_out + pp * OUT_BOX + stage_off(r, c)) =
              pack_bf16x2(v[0][pp], v[1][pp]);
      }
    }
    if constexpr (!GROUPED) {
      // the tuple store: one TMA box a product (rows >= M and channels >= F clipped)
      fence_proxy_async();
      named_sync(bar_id, 128);
      if (tid == 0 && jw < a.F) {
#pragma unroll
        for (int g = 0; g < 4; ++g) tma_store_2d(&maps.y[g], stage_out + g * OUT_BOX, jw, m0);
        tma_store_3d(&maps.ye[0], stage_out + 4 * OUT_BOX, jw, 0, m0);  // e11
        tma_store_3d(&maps.ye[1], stage_out + 5 * OUT_BOX, jw, 0, m0);  // e21
        tma_store_3d(&maps.ye[0], stage_out + 6 * OUT_BOX, jw, 1, m0);  // e12
        tma_store_3d(&maps.ye[1], stage_out + 7 * OUT_BOX, jw, 1, m0);  // e22
        tma_store_commit();
      }
      if (EPI == LS && tid == 0) {
        // the producer loads the next residual into the staging once these stores read it
        tma_store_wait_read<0>();
        mbar_arrive(&rfree[wg]);
      }
    } else {
      // the grouped-column store: thread tid keeps product pp = (tid / 16) % 8
      // and channel pair c = 2 (tid % 16) for the 64 rows, so consecutive
      // threads store consecutive pairs of one row; bf16x2 where the map allows
      named_sync(bar_id, 128);
      const int c = 2 * (tid & 15), pp = (tid >> 4) & 7, j = jw + c;
      if (j < a.F) {
        const int jj = pp < 4 || !(pp & 2) ? j : a.F + j;  // e12, e22: column F + j
        const int g = pp < 4 ? a.g1 : a.ge, sg = pp < 4 ? a.s1 : a.se;
        const int col = (jj / g) * sg + jj % g, col2 = ((jj + 1) / g) * sg + (jj + 1) % g;
        bf16* base = pp < 4 ? a.y[pp] : a.ye[pp & 1];
        const size_t ld = pp < 4 ? a.ldy : a.ldye;
        const uint8_t* src = stage_out + pp * OUT_BOX;
        const int rows = min(BM, a.M - m0);
        for (int r = 0; r < rows; ++r) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(src + stage_off(r, c));
          bf16* row = base + (size_t)(m0 + r) * ld;
          if (a.pairs) {
            *reinterpret_cast<uint32_t*>(row + col) = v;
          } else {
            row[col] = __ushort_as_bfloat16(static_cast<unsigned short>(v & 0xFFFF));
            row[col2] = __ushort_as_bfloat16(static_cast<unsigned short>(v >> 16));
          }
        }
      }
    }
  }
  if (!GROUPED && tid == 0) tma_store_wait<0>();
}

}  // namespace
}  // namespace lind8w
}  // namespace ovt
