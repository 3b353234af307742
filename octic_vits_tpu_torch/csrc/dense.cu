// K-dense: y = gelu(x @ W^T + b), the standard ViT MLP's fc1.
//
// Replaces octic_vits_tpu/ops/pallas_dense.py:dense_gelu (Pallas `_kernel`,
// with its 2-D and 3-D tilings `_fwd` and `_fwd_3d`).
//
// What bounds it on the H100: at ViT-H/14, B=64 the product is
// [16448 x 1280] x [1280 x 5120] = 215.6 GFLOP against 42 MB read and
// 168 MB written, about 1000 FLOP per byte, so it is bound by the tensor
// cores, not by HBM (the card's ridge is ~295 FLOP/byte in bf16).
//
// What the design does about it: a 128x128x32 CTA tile, 8 warps each owning
// a 64x32 warp tile of m16n8k16 bf16 MMAs with f32 accumulators, operands
// staged by a 3-stage cp.async pipeline and loaded with ldmatrix. The bias
// and exact-erf GELU are applied to the accumulators in registers before the
// single bf16 store, so the pre-activation hidden never reaches HBM (the
// point of the TPU kernel too). mma.sync reaches roughly two thirds of the
// wgmma rate; wgmma + TMA is later work.
#include "common.cuh"

namespace ovt {
namespace dense {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int LDS = BK + 8;  // padded smem row (80 bytes): conflict-free ldmatrix
constexpr int STAGE_ELEMS = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;

__device__ __forceinline__ void load_stage(bf16* sa, bf16* sb, const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
  // 128 rows x 4 chunks of 8 for each operand: 2 chunks per thread each.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 2, kc = (c & 3) * 8;
    const int k = k0 + kc;
    const bool ka = k < K;
    const int ma = m0 + r, nb = n0 + r;
    cp_async16(sa + r * LDS + kc, ka && ma < M ? x + (size_t)ma * K + k : x, ka && ma < M);
    cp_async16(sb + r * LDS + kc, ka && nb < N ? w + (size_t)nb * K + k : w, ka && nb < N);
  }
}

__global__ void __launch_bounds__(THREADS)
    dense_gelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const bf16* __restrict__ bias, bf16* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      bf16* sa = smem + s * STAGE_ELEMS;
      load_stage(sa, sa + BM * LDS, x, w, M, N, K, m0, n0, s * BK, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nk = kt + STAGES - 1;
      if (nk < KT) {
        bf16* sa = smem + (nk % STAGES) * STAGE_ELEMS;
        load_stage(sa, sa + BM * LDS, x, w, M, N, K, m0, n0, nk * BK, tid);
      }
      cp_async_commit();
    }
    const bf16* sa = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], sa + r * LDS + kk + (lane >> 4) * 8);
      }
      uint32_t bfr[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(bfr[nj], sb + n * LDS + kk + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2], bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    if (col >= N) continue;  // N % 8 == 0: the pair (col, col+1) is in or out together
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = __bfloat162float(bias[col]);
      b1 = __bfloat162float(bias[col + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * 64 + mi * 16 + g + hf * 8;
        if (row < M) {
          const uint32_t v = pack_bf16x2(gelu_erf(acc[mi][ni][2 * hf] + b0),
                                         gelu_erf(acc[mi][ni][2 * hf + 1] + b1));
          *reinterpret_cast<uint32_t*>(y + (size_t)row * N + col) = v;
        }
      }
    }
  }
}

}  // namespace dense
}  // namespace ovt

// x [M,K], w [N,K] (torch Linear layout), bias [N] or null, y [M,N]; all
// bf16, contiguous, 16-byte aligned, K % 8 == 0 and N % 8 == 0 (checked by
// the Python wrapper). Returns the cudaError_t of the launch.
OVT_EXPORT int ovt_dense_gelu(const void* x, const void* w, const void* bias, void* y, int M,
                              int N, int K, void* stream) {
  using namespace ovt::dense;
  cudaError_t err = cudaFuncSetAttribute(dense_gelu_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dense_gelu_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ovt::bf16*>(x), static_cast<const ovt::bf16*>(w),
      static_cast<const ovt::bf16*>(bias), static_cast<ovt::bf16*>(y), M, N, K);
  return cudaGetLastError();
}

OVT_EXPORT const char* ovt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
