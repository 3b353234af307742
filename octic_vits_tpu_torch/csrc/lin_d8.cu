// K-lin-d8: block-diagonal D8-equivariant linear map over the flat-E tuple,
// with an optional D8-GELU epilogue.
//
// Replaces the block-diagonal products of
//   octic_vits_tpu/ops/pallas_linear.py:mlp_d8_fused (`_mlp_kernel`): fc1
//     with the GELU epilogue, then fc2 (two launches here);
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention_fused_qkv
//     (`_octic_qkv_attn_kernel`, its qkv half): the qkv 5-tuple, no epilogue.
//
// Math, for every token m and output channel j < F (x_g [M,C], ef [M,4C] =
// [row0 | row1], w1 [4,C,F], we [2C,2F], A1 bias [F]):
//   y_g[m,j]  = x_g[m,:] . w1[g][:,j]         (+ bias[j] for g = 0, A1)
//   e11 = row0 . we[:,j]    e12 = row0 . we[:,F+j]
//   e21 = row1 . we[:,j]    e22 = row1 . we[:,F+j]
//   yef[m] = [e11 | e12 | e21 | e22]          (= [row0 out | row1 out])
// With the GELU epilogue the octet (a1,a2,b1,b2,e11,e21,e12,e22) of each
// (m, j) goes through the isotypic->regular butterfly, erf GELU and back.
//
// What bounds it on the H100: at ViT-H/14, B=64 (M = 16448, C = 160) the
// MLP fc1 (F = 640) is 40.4 GFLOP and writes a 168 MB bf16 hidden; fc2 reads
// it back. About 200 FLOP per byte: near the card's ridge, so both the
// tensor cores and HBM matter; the qkv (F = 480) is the same shape class.
//
// What the design does about it: one CTA owns a 64-token x 32-channel tile
// ACROSS ALL EIGHT SLOTS, so the D8-GELU octet of each (m, j) meets in one
// CTA and the epilogue needs no second pass over HBM. 8 warps: warp w
// computes half the rows of 1-d slot w/2 (K = C) and of E slot w/2 (K = 2C),
// which balances the 1-d and E work exactly. Operands (6 A tiles and 6 B
// tiles a stage) are staged with a 2-stage cp.async pipeline; m16n8k16 bf16
// MMAs accumulate in f32; the accumulators go through shared memory once
// for the epilogue. The hidden still round-trips HBM between fc1 and fc2
// (the TPU kernel keeps it in VMEM): fusing the two launches is the first
// perf item in ROADMAP.md.
#include "common.cuh"

namespace ovt {
namespace lind8 {

constexpr int BM = 64, BN = 32, BK = 32, THREADS = 256, STAGES = 2;
constexpr int LDS = BK + 8;  // A tiles: [BM][LDS] (k contiguous)
constexpr int LDB = BN + 8;  // B tiles: [BK][LDB] (n contiguous)
constexpr int A_ELEMS = 6 * BM * LDS;  // x_a1, x_a2, x_b1, x_b2, row0, row1
constexpr int B_ELEMS = 6 * BK * LDB;  // w1[0..3], we[:, j], we[:, F + j]
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr int LDO = BN + 4;  // epilogue staging [8][BM][LDO] f32
constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int EPI_BYTES = 8 * BM * LDO * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

struct Args {
  const bf16* x[4];
  const bf16* xef;
  const bf16* w1;
  const bf16* we;
  const bf16* bias;
  bf16* y[4];
  bf16* yef;
  int M, C, F;
};

__device__ __forceinline__ void load_stage(bf16* st, const Args& a, int m0, int j0, int k0,
                                           int tid) {
  const int C = a.C, F = a.F, M = a.M;
  bf16* sa = st;
  bf16* sb = st + A_ELEMS;
  // A: 6 tiles of 64 rows x 4 chunks = 256 chunks each, one per thread.
  {
    const int r = tid >> 2, kc = (tid & 3) * 8;
    const int m = m0 + r, k = k0 + kc;
    const bool mv = m < M;
    if (k0 < C) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const bool v = mv && k < C;
        cp_async16(sa + (g * BM + r) * LDS + kc, v ? a.x[g] + (size_t)m * C + k : a.x[g], v);
      }
    }
    const bool ve = mv && k < 2 * C;
    const bf16* row0 = a.xef + (size_t)m * 4 * C + k;
    cp_async16(sa + (4 * BM + r) * LDS + kc, ve ? row0 : a.xef, ve);
    cp_async16(sa + (5 * BM + r) * LDS + kc, ve ? row0 + 2 * C : a.xef, ve);
  }
  // B: 6 tiles of 32 k-rows x 4 chunks = 128 chunks each; threads 0..127
  // take the even tiles, 128..255 the odd ones.
  {
    const int c = tid & 127, par = tid >> 7;
    const int r = c >> 2, nc = (c & 3) * 8;
    const int k = k0 + r, j = j0 + nc;
    const bool v1 = k < C && j < F;
    const bool ve = k < 2 * C && j < F;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int tile = 2 * i + par;
      bf16* dst = sb + (tile * BK + r) * LDB + nc;
      if (tile < 4) {
        if (k0 < C) {
          const bf16* src = a.w1 + ((size_t)tile * C + k) * F + j;
          cp_async16(dst, v1 ? src : a.w1, v1);
        }
      } else {
        const bf16* src = a.we + (size_t)k * 2 * F + (tile - 4) * F + j;
        cp_async16(dst, ve ? src : a.we, ve);
      }
    }
  }
}

// acc += A(32 rows of tile `at`, from row `r0`) x B(tile `bt`) for one BK slab
__device__ __forceinline__ void mma_slab(float (&acc)[2][4][4], const bf16* sa, const bf16* sb,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(af[mi], sa + (mi * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
    uint32_t bfr[2][4];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4_trans(bfr[nj],
                        sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + nj * 16 +
                            (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2], bfr[ni >> 1][(ni & 1) * 2 + 1]);
  }
}

template <bool GELU>
__global__ void __launch_bounds__(THREADS) lin_d8_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = warp & 1, slot = warp >> 1;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int C = a.C;
  const int KT1 = (C + BK - 1) / BK, KTE = (2 * C + BK - 1) / BK;
  // E slot order e11, e21, e12, e22: A = row (slot & 1), B = we half (slot >> 1)
  const int ea = 4 + (slot & 1), eb = 4 + (slot >> 1);

  float acc1[2][4][4], acce[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][j][e] = acce[i][j][e] = 0.f;

  load_stage(smem, a, m0, j0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < KTE; ++kt) {
    if (kt + 1 < KTE) load_stage(smem + ((kt + 1) & 1) * STAGE_ELEMS, a, m0, j0, (kt + 1) * BK, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* st = smem + (kt & 1) * STAGE_ELEMS;
    const bf16* sa = st;
    const bf16* sb = st + A_ELEMS;
    if (kt < KT1)
      mma_slab(acc1, sa + (slot * BM + half * 32) * LDS, sb + slot * BK * LDB, lane);
    mma_slab(acce, sa + (ea * BM + half * 32) * LDS, sb + eb * BK * LDB, lane);
    __syncthreads();  // the next iteration's load overwrites this stage
  }
  cp_async_wait<0>();

  // accumulators -> staging [slot][row][col] in isotypic octet order
  float* so = reinterpret_cast<float*>(smem_raw);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = half * 32 + mi * 16 + g + (e >> 1) * 8;
        const int c = ni * 8 + 2 * t + (e & 1);
        so[(slot * BM + r) * LDO + c] = acc1[mi][ni][e];
        so[((4 + slot) * BM + r) * LDO + c] = acce[mi][ni][e];
      }
  __syncthreads();

  const int F = a.F;
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, j = j0 + c;
    if (m >= a.M || j >= F) continue;
    float v[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) v[s] = so[(s * BM + r) * LDO + c];
    if (a.bias != nullptr) v[0] += __bfloat162float(a.bias[j]);
    if (GELU) gelu_d8_octet(v);
#pragma unroll
    for (int s = 0; s < 4; ++s) a.y[s][(size_t)m * F + j] = __float2bfloat16(v[s]);
    bf16* ye = a.yef + (size_t)m * 4 * F + j;
    ye[0] = __float2bfloat16(v[4]);      // e11
    ye[F] = __float2bfloat16(v[6]);      // e12
    ye[2 * F] = __float2bfloat16(v[5]);  // e21
    ye[3 * F] = __float2bfloat16(v[7]);  // e22
  }
}

}  // namespace lind8
}  // namespace ovt

// x0..x3 [M,C], xef [M,4C], w1 [4,C,F], we [2C,2F], bias [F] or null,
// y0..y3 [M,F], yef [M,4F]; all bf16, contiguous, 16-byte aligned,
// C % 8 == 0 and F % 8 == 0 (checked by the Python wrapper).
OVT_EXPORT int ovt_lin_d8(const void* x0, const void* x1, const void* x2, const void* x3,
                          const void* xef, const void* w1, const void* we, const void* bias,
                          void* y0, void* y1, void* y2, void* y3, void* yef, int M, int C, int F,
                          int gelu, void* stream) {
  using namespace ovt::lind8;
  using ovt::bf16;
  Args a;
  a.x[0] = static_cast<const bf16*>(x0);
  a.x[1] = static_cast<const bf16*>(x1);
  a.x[2] = static_cast<const bf16*>(x2);
  a.x[3] = static_cast<const bf16*>(x3);
  a.xef = static_cast<const bf16*>(xef);
  a.w1 = static_cast<const bf16*>(w1);
  a.we = static_cast<const bf16*>(we);
  a.bias = static_cast<const bf16*>(bias);
  a.y[0] = static_cast<bf16*>(y0);
  a.y[1] = static_cast<bf16*>(y1);
  a.y[2] = static_cast<bf16*>(y2);
  a.y[3] = static_cast<bf16*>(y3);
  a.yef = static_cast<bf16*>(yef);
  a.M = M;
  a.C = C;
  a.F = F;
  dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (gelu) {
    err = cudaFuncSetAttribute(lin_d8_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    lin_d8_kernel<true><<<grid, THREADS, SMEM_BYTES, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(lin_d8_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    lin_d8_kernel<false><<<grid, THREADS, SMEM_BYTES, s>>>(a);
  }
  return cudaGetLastError();
}
