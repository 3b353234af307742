// K-lin-d8's device code: the block-diagonal D8 linear map over the flat-E
// tuple with its epilogues, templated on the CTA's tile of BM tokens x BN
// channels (across all eight slots). csrc/lin_d8.cu instantiates it for the
// model paths (BM = 64, BN = 32); csrc/lin_d8_probe.cu for the tile sweep of
// scripts/profile_lin_tiles.py, so the sweep runs this code and not a copy
// of it. See csrc/lin_d8.cu for what it replaces, what bounds it on the H100
// and why it is built this way. The tile does not change any output's
// summation order: every tile gives the same bits.
//
// Everything here has internal linkage: each source that includes it keeps
// its own instantiations.
#pragma once

#include "common.cuh"

namespace ovt {
namespace lind8 {
namespace {

constexpr int BK = 32, THREADS = 256, STAGES = 2;
constexpr int LDS = BK + 8;  // A tiles: [BM][LDS] (k contiguous)

// the shared-memory plan of a BM x BN tile: two stages of 6 A tiles (x_a1,
// x_a2, x_b1, x_b2, row0, row1) and 6 B tiles (w1[0..3], we[:, j], we[:, F +
// j]), reused as the epilogue's f32 staging [8][BM][LDO]
template <int BM, int BN>
struct Tile {
  static constexpr int LDB = BN + 8;  // B tiles: [BK][LDB] (n contiguous)
  static constexpr int A_ELEMS = 6 * BM * LDS;
  static constexpr int B_ELEMS = 6 * BK * LDB;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int LDO = BN + 4;
  static constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr int EPI_BYTES = 8 * BM * LDO * 4;
  static constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  // each warp: half the rows of one slot (MI m16 tiles) x BN channels (NI n8 tiles)
  static constexpr int MI = BM / 32, NI = BN / 8;
  // B chunks (16 bytes) of one tile; tiles loaded side by side per pass
  static constexpr int CB = BK * BN / 8, TPP = THREADS / CB;
  static_assert(BM % 32 == 0 && BN % 16 == 0 && THREADS % CB == 0 && 6 % TPP == 0,
                "unsupported K-lin-d8 tile");
};

struct Args {
  const bf16* x[4];
  const bf16* xef;
  const bf16* w1;
  const bf16* we;
  const bf16* bias;
  bf16* y[4];
  bf16* ye[2];  // the outputs of E row 0 and row 1
  int g1, s1, ge, se;  // grouped-column stores (see the header)
  const bf16* ls1;   // LayerScale epilogue: [4, F] or null
  const bf16* lse;   // [2F]
  const bf16* r[4];  // the residual, [M, F] each
  const bf16* ref;   // [M, 4F]
  int M, C, F;
  int ldx, ldxe, ldy, ldye;  // row strides (elements) of x_g, ef, y_g, yef
};

template <int BM, int BN>
__device__ __forceinline__ void load_stage(bf16* st, const Args& a, int m0, int j0, int k0,
                                           int tid) {
  typedef Tile<BM, BN> T;
  const int C = a.C, F = a.F, M = a.M;
  bf16* sa = st;
  bf16* sb = st + T::A_ELEMS;
  // A: 6 tiles of BM rows x 4 chunks each, one chunk of each a thread and pass
#pragma unroll
  for (int it = 0; it < (BM * 4 + THREADS - 1) / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    if (BM * 4 % THREADS != 0 && idx >= BM * 4) break;
    const int r = idx >> 2, kc = (idx & 3) * 8;
    const int m = m0 + r, k = k0 + kc;
    const bool mv = m < M;
    if (k0 < C) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const bool v = mv && k < C;
        cp_async16(sa + (g * BM + r) * LDS + kc, v ? a.x[g] + (size_t)m * a.ldx + k : a.x[g], v);
      }
    }
    const bool ve = mv && k < 2 * C;
    const bf16* row0 = a.xef + (size_t)m * a.ldxe + k;
    cp_async16(sa + (4 * BM + r) * LDS + kc, ve ? row0 : a.xef, ve);
    cp_async16(sa + (5 * BM + r) * LDS + kc, ve ? row0 + 2 * C : a.xef, ve);
  }
  // B: 6 tiles of 32 k-rows x BN/8 chunks (CB) each; TPP tiles a pass, thread
  // tid taking chunk tid % CB of tile TPP i + tid / CB (BN = 32: threads
  // 0..127 the even tiles, 128..255 the odd ones)
  {
    const int c = tid & (T::CB - 1), par = static_cast<unsigned>(tid) / T::CB;
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int k = k0 + r, j = j0 + nc;
    const bool v1 = k < C && j < F;
    const bool ve = k < 2 * C && j < F;
#pragma unroll
    for (int i = 0; i < 6 / T::TPP; ++i) {
      const int tile = T::TPP * i + par;
      bf16* dst = sb + (tile * BK + r) * T::LDB + nc;
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

// acc += A(BM/2 rows from sa) x B(the tile at sb) for one BK slab
template <int BM, int BN>
__device__ __forceinline__ void mma_slab(float (&acc)[BM / 32][BN / 8][4], const bf16* sa,
                                         const bf16* sb, int lane) {
  typedef Tile<BM, BN> T;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[T::MI][4];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
      ldmatrix_x4(af[mi], sa + (mi * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
    uint32_t bfr[T::NI / 2][4];
#pragma unroll
    for (int nj = 0; nj < T::NI / 2; ++nj)
      ldmatrix_x4_trans(bfr[nj],
                        sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * T::LDB + nj * 16 +
                            (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
        mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2], bfr[ni >> 1][(ni & 1) * 2 + 1]);
  }
}

template <bool GELU, bool GROUPED, int BM, int BN>
__global__ void __launch_bounds__(THREADS) lin_d8_kernel(const Args a) {
  typedef Tile<BM, BN> T;
  constexpr int STAGE_ELEMS = T::STAGE_ELEMS, LDO = T::LDO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = warp & 1, slot = warp >> 1;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int C = a.C;
  const int KT1 = (C + BK - 1) / BK, KTE = (2 * C + BK - 1) / BK;
  // E slot order e11, e21, e12, e22: A = row (slot & 1), B = we half (slot >> 1)
  const int ea = 4 + (slot & 1), eb = 4 + (slot >> 1);

  float acc1[T::MI][T::NI][4], acce[T::MI][T::NI][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][j][e] = acce[i][j][e] = 0.f;

  load_stage<BM, BN>(smem, a, m0, j0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < KTE; ++kt) {
    if (kt + 1 < KTE)
      load_stage<BM, BN>(smem + ((kt + 1) & 1) * STAGE_ELEMS, a, m0, j0, (kt + 1) * BK, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* st = smem + (kt & 1) * STAGE_ELEMS;
    const bf16* sa = st;
    const bf16* sb = st + T::A_ELEMS;
    if (kt < KT1)
      mma_slab<BM, BN>(acc1, sa + (slot * BM + half * (BM / 2)) * LDS, sb + slot * BK * T::LDB,
                       lane);
    mma_slab<BM, BN>(acce, sa + (ea * BM + half * (BM / 2)) * LDS, sb + eb * BK * T::LDB, lane);
    __syncthreads();  // the next iteration's load overwrites this stage
  }
  cp_async_wait<0>();

  // the output columns of this CTA's BN channels j under the grouped-column
  // maps (one division each per CTA instead of per element)
  __shared__ int col1[BN], cola[BN], colb[BN];
  if (GROUPED && tid < BN) {
    const int j = j0 + tid, jb = a.F + j;
    col1[tid] = (j / a.g1) * a.s1 + j % a.g1;
    cola[tid] = (j / a.ge) * a.se + j % a.ge;    // column j of an E row's output
    colb[tid] = (jb / a.ge) * a.se + jb % a.ge;  // column F + j
  }
  // accumulators -> staging [slot][row][col] in isotypic octet order
  float* so = reinterpret_cast<float*>(smem_raw);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = half * (BM / 2) + mi * 16 + g + (e >> 1) * 8;
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
    if (a.ls1 != nullptr) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        v[s] = __bfloat162float(a.r[s][(size_t)m * F + j]) +
               __bfloat162float(a.ls1[s * F + j]) * v[s];
      const bf16* re = a.ref + (size_t)m * 4 * F + j;
      const float l0 = __bfloat162float(a.lse[j]), l1 = __bfloat162float(a.lse[F + j]);
      v[4] = __bfloat162float(re[0]) + l0 * v[4];      // e11, column j
      v[6] = __bfloat162float(re[F]) + l1 * v[6];      // e12, column F + j
      v[5] = __bfloat162float(re[2 * F]) + l0 * v[5];  // e21, column 2F + j
      v[7] = __bfloat162float(re[3 * F]) + l1 * v[7];  // e22, column 3F + j
    }
    const size_t c1 = (size_t)m * a.ldy + (GROUPED ? col1[c] : j);
#pragma unroll
    for (int s = 0; s < 4; ++s) a.y[s][c1] = __float2bfloat16(v[s]);
    const size_t ca = (size_t)m * a.ldye + (GROUPED ? cola[c] : j);       // column j
    const size_t cb = (size_t)m * a.ldye + (GROUPED ? colb[c] : F + j);   // column F + j
    a.ye[0][ca] = __float2bfloat16(v[4]);  // e11
    a.ye[0][cb] = __float2bfloat16(v[6]);  // e12
    a.ye[1][ca] = __float2bfloat16(v[5]);  // e21
    a.ye[1][cb] = __float2bfloat16(v[7]);  // e22
  }
}

// one launch of the <GELU, GROUPED> kernel at tile BM x BN on checked
// arguments; returns the cudaError_t of the launch
template <bool GELU, bool GROUPED, int BM, int BN>
int launch(const Args& a, cudaStream_t s) {
  constexpr int smem = Tile<BM, BN>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(lin_d8_kernel<GELU, GROUPED, BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.F + BN - 1) / BN, (a.M + BM - 1) / BM);
  lin_d8_kernel<GELU, GROUPED, BM, BN><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lind8
}  // namespace ovt
