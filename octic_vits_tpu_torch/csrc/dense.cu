// K-dense: y = gelu(x @ W^T + b), the standard ViT MLP's fc1.
//
// Replaces octic_vits_tpu/ops/pallas_dense.py:dense_gelu (Pallas `_kernel`,
// with its 2-D and 3-D tilings `_fwd` and `_fwd_3d`).
//
// What bounds it on the H100: at ViT-H/14, B=64 the product is
// [16448 x 1280] x [1280 x 5120] = 215.6 GFLOP against 42 MB read and
// 168 MB written, about 1000 FLOP per byte, so it is bound by the tensor
// cores (0.218 ms at 989 TFLOP/s), not by HBM (the card's ridge is ~295
// FLOP/byte in bf16). Only wgmma reaches that rate; the erf GELU of the
// 84 M outputs is another ~0.06 ms of CUDA-core work that has to hide under
// the products.
//
// What the design does about it: a persistent, warp-specialised TMA + wgmma
// kernel. One CTA an SM walks the 128 x 128 output tiles in an L2-friendly
// raster (groups of `group_m` M-tiles, each group walked down M and then
// along F). A producer warp issues the TMA loads of x and W (128 x 64 boxes,
// 128-byte swizzle) into a ring of STAGES stages; two consumer warpgroups
// take alternate tiles of the CTA (ping-pong): each runs its tile's whole K
// loop as m64n128k16 wgmmas from shared memory, then adds the bias, applies
// the exact-erf GELU to the f32 accumulators and stores bf16 straight from
// registers, while the other warpgroup's K loop keeps the tensor cores busy.
// An ordering barrier hands the tensor cores from one warpgroup to the other
// at the end of each K loop, which also keeps the two warpgroups' waits on
// the shared ring in ring order. setmaxnreg moves registers from the
// producer warpgroup (40) to the consumers (232): each holds 128 f32
// accumulators. The pre-activation never reaches HBM. Ragged edges: TMA
// fills the rows and K columns beyond the arrays with zeros and the store
// masks rows >= M and columns >= F (F % 8 == 0).
//
// What holds it back (PERF.md): the epilogue of a tile, the erf GELU of 128
// f32 values a thread and their stores, outlasts the other warpgroup's K
// loop, which itself slows while an epilogue runs beside it; so the
// epilogue, not the tensor cores, sets the pace. Larger or cooperative
// tiles, a shared-memory + TMA-store epilogue and an epilogue handed to
// seven other warps through shared memory did not change the time.
#include "sm90.cuh"

namespace ovt {
namespace dense {

using namespace sm90;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 6, CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int TILE_A = BM * BK * 2, TILE_B = BN * BK * 2, STAGE_BYTES = TILE_A + TILE_B;
// 1024 bytes of slack to align the ring to the 128-byte swizzle's repeat,
// the ring, the barriers (full and empty a stage, two ordering barriers)
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + (2 * STAGES + 2) * 8;

// tile t of the raster -> (M-tile, F-tile); ops/dense.py:dense_tile mirrors it
__device__ __forceinline__ void tile_coords(int t, int MT, int NT, int group, int& m, int& n) {
  const int per_group = group * NT;
  const int gi = t / per_group, first = gi * group;
  const int gsz = min(group, MT - first);
  const int r = t - gi * per_group;
  m = first + r % gsz;
  n = r / gsz;
}

// K-major, 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc128(uint32_t saddr) {
  return make_desc(saddr, 16, 1024, SW_128);
}

__global__ void __launch_bounds__(THREADS, 1)
    dense_gelu_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ bias,
                      bf16* __restrict__ y, int M, int N, int K, int group) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* order = empty + STAGES;  // order[w]: the other warpgroup's K loop is done
  const uint32_t ring_s = smem_addr(ring);

  const int MT = (M + BM - 1) / BM, NT = (N + BN - 1) / BN, T = MT * NT;
  const int KT = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(&order[0], 1);
    mbar_init(&order[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread streams every tile's K blocks through the ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int p = 0;
      for (int t = blockIdx.x; t < T; t += gridDim.x) {
        int m, n;
        tile_coords(t, MT, NT, group, m, n);
        for (int kb = 0; kb < KT; ++kb, ++p) {
          const int s = p % STAGES;
          mbar_wait(&empty[s], ((p / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          uint8_t* a = ring + s * STAGE_BYTES;
          tma_load_2d(a, &xmap, &full[s], kb * BK, m * BM);
          tma_load_2d(a + TILE_A, &wmap, &full[s], kb * BK, n * BN);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes the CTA's tiles i = wg, wg + 2, ...
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float acc[2][64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.f;
    int i = wg;
    for (int t = blockIdx.x + wg * gridDim.x; t < T; t += CONSUMERS * gridDim.x, i += CONSUMERS) {
      int m, n;
      tile_coords(t, MT, NT, group, m, n);
      // the tensor cores are ours once the other warpgroup's K loop of tile i-1 is issued
      if (i > 0) mbar_wait(&order[wg], ((i - 1) / 2) & 1);
      for (int kb = 0; kb < KT; ++kb) {
        const int p = i * KT + kb, s = p % STAGES;
        mbar_wait(&full[s], (p / STAGES) & 1);
        const uint32_t a = ring_s + s * STAGE_BYTES, b = a + TILE_A;
        fence_regs<64>(acc[0]);
        fence_regs<64>(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          const uint64_t db = desc128(b + 32 * k);
          wgmma_ss<128>(acc[0], desc128(a + 32 * k), db, kb | k);
          wgmma_ss<128>(acc[1], desc128(a + 64 * 128 + 32 * k), db, kb | k);
        }
        wgmma_commit();
        if (kb > 0) {
          // the previous K block's products are done: release its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(p - 1) % STAGES]);
        }
      }
      if (tid == 0) mbar_arrive(&order[wg ^ 1]);
      wgmma_wait<0>();
      fence_regs<64>(acc[0]);
      fence_regs<64>(acc[1]);
      if (lane == 0) mbar_arrive(&empty[(i * KT + KT - 1) % STAGES]);

      // epilogue: bias + exact-erf GELU on the accumulators, one bf16 store
      const int q = lane & 3;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int col = n * BN + c * 8 + 2 * q;
        if (col >= N) continue;  // N % 8 == 0: the pair (col, col+1) is in or out together
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
          b0 = __low2float(bb);
          b1 = __high2float(bb);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = m * BM + h * 64 + warp * 16 + (lane >> 2) + r * 8;
            if (row < M)
              *reinterpret_cast<uint32_t*>(y + (size_t)row * N + col) =
                  pack_bf16x2(gelu_erf(acc[h][4 * c + 2 * r] + b0),
                              gelu_erf(acc[h][4 * c + 2 * r + 1] + b1));
          }
        }
      }
    }
  }
}

}  // namespace dense
}  // namespace ovt

// x [M,K], w [N,K] (torch Linear layout), bias [N] or null, y [M,N]; all
// bf16, contiguous, 16-byte aligned, K % 8 == 0 and N % 8 == 0 (checked by
// the Python wrapper). The launch plan (ops/dense.py:dense_plan): `grid`
// persistent CTAs, raster groups of `group_m` M-tiles, `smem` bytes of
// shared memory, which must be this kernel's. Returns the cudaError_t of the
// launch or an ERR_* code.
OVT_EXPORT int ovt_dense_gelu(const void* x, const void* w, const void* bias, void* y, int M,
                              int N, int K, int grid, int group_m, int smem, void* stream) {
  using namespace ovt::dense;
  if (smem != SMEM_BYTES || grid < 1 || group_m < 1) return ovt::ERR_PLAN;
  CUtensorMap xmap, wmap;
  const uint32_t box[2] = {BK, BM};
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M}, wdims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t stride[1] = {(uint64_t)K * 2};
  int err = ovt::encode_bf16_map(&xmap, x, 2, xdims, stride, box, 128);
  if (err == 0) err = ovt::encode_bf16_map(&wmap, w, 2, wdims, stride, box, 128);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(dense_gelu_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (cerr != cudaSuccess) return cerr;
  dense_gelu_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const ovt::bf16*>(bias), static_cast<ovt::bf16*>(y), M, N, K,
      group_m);
  return cudaGetLastError();
}

OVT_EXPORT const char* ovt_error_string(int err) {
  if (err == ovt::ERR_PLAN) return "launch plan disagrees with the kernel's";
  if (err == ovt::ERR_ENTRY_POINT)
    return "cuTensorMapEncodeTiled not found (cudaGetDriverEntryPoint failed)";
  if (err >= ovt::ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
