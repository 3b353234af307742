// The product-cost law: the time of one bf16 matrix product with f32
// accumulators at the shapes of the attention's two products, as K-attn
// issues them (warp-level mma.sync m16n8k16, operands from shared memory).
//
// Replaces the Pallas probes of scripts/r3_matmul_law.py (kernel row 14b):
//   `_mm_kernel` (:37, its pallas_call in bench_mm :65): per grid step b,
//     `reps` products max(a_b, -10 - i) . b_b, "nt" ([M,K] x [L,K]^T, the
//     scores' shape) or "nn" ([M,K] x [K,L], P.V's), each reduced to its f32
//     max; the maxima are summed and the sum fills out[b] [8,128];
//   `batched_kernel` (:111, its pallas_call in main :134): the 16 heads'
//     products of [16,M,K] x [16,L,K]^T or [16,K,L] at once, out[b] = the
//     max over all of them.
// The nonlinear per-rep perturbation keeps the compiler from factoring the
// repeated product out; the maxima keep the stores out of the time.
//
// What bounds it on the H100: the tensor cores, on paper (a product of [257,
// 257] x [257,80] is 10.6 MFLOP on 0.13 MB of operands, ~80 FLOP a byte of
// the CTA's operands, read from L2 after the first rep). In practice the
// grid of B = 64 CTAs fills 64 of the 132 SMs, and one CTA's 8 warps issue
// mma.sync from shared memory with no asynchrony beyond a 2-stage cp.async
// pipeline, as K-attn does: the law measures what that issue rate gives.
//
// What the design does: one CTA of 8 warps per batch row. The output is
// computed in passes of 64 columns: each pass streams K in 32-wide slabs of
// A (all M rows) and of B through a 2-stage pipeline in shared memory (A =
// [257,512] alone is 263 KB, more than a CTA may hold). Warp w owns the
// 16-row tiles w, w + 8, w + 16 (M <= 384) and the pass's 8 n-tiles; the
// perturbation max(a, floor) is applied to the A fragments (bf16x2 max). A
// row stride that is not a multiple of 8 elements (the [257,257] operand)
// cannot be copied 16 bytes at a time and is loaded element by element.
#include <math_constants.h>

#include "common.cuh"

namespace ovt {
namespace law {

constexpr int THREADS = 256, WARPS = 8, BK = 32, TL = 64, MT_MAX = 3;
constexpr int LDA = BK + 8;  // A slab [mpad][LDA] and the nt B slab [TL][LDA] (k contiguous)
constexpr int LDN = TL + 8;  // the nn B slab [BK][LDN] (l contiguous)

struct Law {
  const bf16* a;   // [B, (heads,) M, K]
  const bf16* b;   // nt: [B, (heads,) L, K]; nn: [B, (heads,) K, L]
  float* out;      // [B, 8, 128]
  int M, K, L, nn, reps, heads;
  int vec_a, vec_b;  // 16-byte copies allowed (row strides multiples of 8 elements)
};

__host__ __device__ constexpr int stage_elems(int mpad) { return mpad * LDA + TL * LDA; }

// one 16-byte chunk of 8 elements from src (row r, columns c..c+7 of a
// [rows, cols] matrix with row stride ld), zero outside; with vec a cp.async
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int r, int c, int rows,
                                           int cols, int ld, bool vec) {
  if (vec) {
    const bool v = r < rows && c < cols;
    cp_async16(dst, v ? src + (size_t)r * ld + c : src, v);
    return;
  }
  const unsigned short* row = reinterpret_cast<const unsigned short*>(src) + (size_t)r * ld;
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = r < rows && c + 2 * i < cols ? row[c + 2 * i] : 0u;
    const uint32_t hi = r < rows && c + 2 * i + 1 < cols ? row[c + 2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void load_slab(bf16* st, const Law& p, const bf16* a, const bf16* b,
                                          int mpad, int l0, int k0) {
  bf16* sa = st;
  bf16* sb = st + mpad * LDA;
  for (int q = threadIdx.x; q < mpad * (BK / 8); q += THREADS) {
    const int r = q / (BK / 8), c = (q % (BK / 8)) * 8;
    load_chunk(sa + r * LDA + c, a, r, k0 + c, p.M, p.K, p.K, p.vec_a);
  }
  const int q = threadIdx.x;  // TL * BK / 8 = 256 chunks of B, one a thread
  if (p.nn) {
    const int r = q / (TL / 8), c = (q % (TL / 8)) * 8;
    load_chunk(sb + r * LDN + c, b, k0 + r, l0 + c, p.K, p.L, p.L, p.vec_b);
  } else {
    const int r = q / (BK / 8), c = (q % (BK / 8)) * 8;
    load_chunk(sb + r * LDA + c, b, l0 + r, k0 + c, p.L, p.K, p.K, p.vec_b);
  }
}

__global__ void __launch_bounds__(THREADS) law_kernel(const Law p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float red[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int mtiles = (p.M + 15) / 16, mpad = mtiles * 16, SE = stage_elems(mpad);
  const int KT = (p.K + BK - 1) / BK;
  const size_t a_hs = (size_t)p.M * p.K, b_hs = (size_t)p.K * p.L;
  const bf16* a_b = p.a + blockIdx.x * a_hs * p.heads;
  const bf16* b_b = p.b + blockIdx.x * b_hs * p.heads;
  float total = 0.f;
  for (int rep = 0; rep < p.reps; ++rep) {
    const __nv_bfloat162 floor2 = __float2bfloat162_rn(-10.f - rep);
    float mx = -CUDART_INF_F;
    for (int h = 0; h < p.heads; ++h) {
      const bf16* a = a_b + h * a_hs;
      const bf16* b = b_b + h * b_hs;
      for (int l0 = 0; l0 < p.L; l0 += TL) {
        float acc[MT_MAX][8][4];
#pragma unroll
        for (int mi = 0; mi < MT_MAX; ++mi)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;
        load_slab(smem, p, a, b, mpad, l0, 0);
        cp_async_commit();
        for (int kt = 0; kt < KT; ++kt) {
          if (kt + 1 < KT) load_slab(smem + ((kt + 1) & 1) * SE, p, a, b, mpad, l0, (kt + 1) * BK);
          cp_async_commit();
          cp_async_wait<1>();
          __syncthreads();
          const bf16* sa = smem + (kt & 1) * SE;
          const bf16* sb = sa + mpad * LDA;
#pragma unroll
          for (int kk = 0; kk < BK; kk += 16) {
            uint32_t bf[8][2];
            if (p.nn) {
#pragma unroll
              for (int nj = 0; nj < 4; ++nj) {
                uint32_t r4[4];
                ldmatrix_x4_trans(r4, sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                                               nj * 16 + (lane >> 4) * 8);
                bf[2 * nj][0] = r4[0];
                bf[2 * nj][1] = r4[1];
                bf[2 * nj + 1][0] = r4[2];
                bf[2 * nj + 1][1] = r4[3];
              }
            } else {
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                const bf16* q = sb + (n * 8 + g) * LDA + kk + 2 * t;
                bf[n][0] = *reinterpret_cast<const uint32_t*>(q);
                bf[n][1] = *reinterpret_cast<const uint32_t*>(q + 8);
              }
            }
#pragma unroll
            for (int mi = 0; mi < MT_MAX; ++mi) {
              const int mt = warp + WARPS * mi;
              if (mt >= mtiles) break;
              uint32_t af[4];
              ldmatrix_x4(af, sa + (mt * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                __nv_bfloat162 v = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&af[i]), floor2);
                af[i] = *reinterpret_cast<uint32_t*>(&v);
              }
#pragma unroll
              for (int n = 0; n < 8; ++n)
                if (l0 + n * 8 < p.L) mma_bf16(acc[mi][n], af, bf[n][0], bf[n][1]);
            }
          }
          __syncthreads();  // the next slab's load overwrites this stage
        }
        cp_async_wait<0>();
#pragma unroll
        for (int mi = 0; mi < MT_MAX; ++mi)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = (warp + WARPS * mi) * 16 + g + (e >> 1) * 8;
              const int col = l0 + n * 8 + 2 * t + (e & 1);
              if (row < p.M && col < p.L) mx = fmaxf(mx, acc[mi][n][e]);
            }
      }
    }
    // the product's (or the heads') max over the CTA
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    float m = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
    total += m;
    __syncthreads();
  }
  float* o = p.out + (size_t)blockIdx.x * 8 * 128;
  for (int i = threadIdx.x; i < 8 * 128; i += THREADS) o[i] = total;
}

}  // namespace law
}  // namespace ovt

// a [B, heads, M, K]; b [B, heads, L, K] (nn = 0) or [B, heads, K, L] (nn = 1);
// bf16, contiguous, 16-byte aligned; out [B, 8, 128] f32. heads = 1: `reps`
// products a perturbed by max(a, -10 - i), out = the sum of their maxima;
// heads > 1 (reps = 1): the heads' products with max(a, -10), out = their
// max. M <= 384. Returns the cudaError_t of the launch.
OVT_EXPORT int ovt_mma_law(const void* a, const void* b, void* out, int B, int heads, int M,
                           int K, int L, int nn, int reps, void* stream) {
  using namespace ovt::law;
  using ovt::bf16;
  if (M < 1 || M > MT_MAX * WARPS * 16 || K < 1 || L < 1 || reps < 1 || heads < 1 ||
      (heads > 1 && reps != 1))
    return cudaErrorInvalidValue;
  Law p;
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.K = K;
  p.L = L;
  p.nn = nn;
  p.reps = reps;
  p.heads = heads;
  p.vec_a = K % 8 == 0;
  p.vec_b = (nn ? L : K) % 8 == 0;
  const int smem = 2 * stage_elems((M + 15) / 16 * 16) * 2;
  cudaError_t err =
      cudaFuncSetAttribute(law_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  law_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
