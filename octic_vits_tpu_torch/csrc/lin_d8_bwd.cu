// K-lin-d8-bwd: the linear transpose and the weight gradients of the
// block-diagonal D8 qkv map, the last of the three launches of the backward
// of the fused octic qkv + attention (ops/attention.py:
// octic_attention_fused_qkv_bwd; the first two recompute the qkv with
// K-lin-d8 and run K-attn-bwd on it).
//
// Replaces octic_vits_tpu/ops/pallas_attention.py:_octic_qkv_attn_bwd_kernel
// (called by _fused_bwd_kernel_call, the custom VJP _fused_bwd_rule of
// octic_attention_fused_qkv): the part of that TPU kernel after the
// attention backward, which folds dx and the f32 weight-gradient sums in.
// Also the backward of the packed variant (pallas_attention.py:
// _fused_packed_bwd_rule): x_g and ef are then column views of one packed
// [M, C] container and dx lands in place in one packed [M, C] gradient,
// through the row strides ldx, ldxe (inputs) and ldd, ldde (dx).
//
// Math, for tokens m < M (x_g [M,C], ef [M,4C] = [row0 | row1], the qkv
// cotangents dq_g [M,F] and de_r [M,2F], w1 [4,C,F], we [2C,2F]):
//   dx_g[m]    = dq_g[m] . w1[g]^T              (K = F)
//   def[m]     = [de_0[m] . we^T | de_1[m] . we^T]   (K = 2F)
//   dw1[g]     = sum_m x_g[m]^T dq_g[m]
//   dwe        = sum_r sum_m row_r[m]^T de_r[m]
//   dbias      = sum_m dq_0[m]                  (the A1 bias, when present)
// bf16 operands, f32 accumulation; dx and the weight gradients are written in
// bf16 (the weights' dtype), as _fused_bwd_kernel_call returns them.
//
// What bounds it on the H100: at hybrid ViT-L/16 global crops (M = 64 * 197
// = 12608, C = 128, F = 384) dx and dW are 72 M C^2 FLOP each, 29.7 GFLOP
// together (30 us at 989 TFLOP/s); it reads x (25.8 MB) and dqkv (77.5 MB)
// and writes dx (25.8 MB), 129 MB or 39 us at 3.35 TB/s. Memory-bound, ~40 us.
//
// What the design does about it. The TPU kernel carries its weight-gradient
// sums from one sequential grid step to the next; Hopper's blocks run in no
// order, so that does not carry over. Three kernels instead, none with
// atomics, so the result does not depend on the schedule:
//   1. dx_kernel: one CTA per 64-token x 64-channel tile of one of six
//      products (four 1-d, two E rows), K streamed through a 2-stage cp.async
//      pipeline, m16n8k16 bf16 MMAs from ldmatrix fragments.
//   2. dw_kernel: the weight gradients are only 4 (2 x 6) + 4 x 12 = 96 tiles
//      of 64 x 64 at L/16, too few for 132 SMs, so the token axis is split
//      into `splits` fixed chunks; each CTA reduces one chunk of one tile into
//      an f32 partial (x^T and dq tiles both come through ldmatrix.trans, so
//      nothing is transposed in memory). The A1 CTAs of the first channel tile
//      also sum the dq_0 columns for dbias.
//   3. reduce_kernel: sums the partials in split order and rounds to bf16.
// Kernel 1 reads dqkv and kernel 2 reads x and dqkv again: at L/16 the
// dqkv (77.5 MB) exceeds the 50 MB L2, so it crosses HBM twice. One kernel
// per token tile that forms dx and the dW partials from one read is the
// next step (ROADMAP Queue 2).
#include "common.cuh"

namespace ovt {
namespace lind8bwd {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDK = BK + 8;  // dx tiles [64 rows][LDK], k contiguous
constexpr int LDT = BM + 8;  // dW tiles [BK k-rows][LDT], channels contiguous

// one product of kernel 1: out[m, n] = sum_k a[m, k] w[n, k], w row-major
// [n][k] with row stride k
struct XProb {
  const bf16* a;
  const bf16* w;
  bf16* out;
  int lda, ldo, n, k;
};
struct XArgs {
  XProb p[6];
  int M;
};

// one weight gradient of kernel 2: part[i, j] = sum over `segs` segments and
// the tokens of one chunk of a[s][m, i] b[s][m, j]
struct WProb {
  const bf16* a[2];
  const bf16* b[2];
  int lda, ldb, ni, nj, segs;
  int part;  // offset of this gradient in a split's partial block (floats)
};
struct WArgs {
  WProb p[5];
  float* scratch;
  long long split_stride;  // floats per split
  int bias_off;            // offset of the dbias partial, or -1 without bias
  int M, chunk;
};

__device__ __forceinline__ void mma_warp_tile(float (&acc)[2][4][4], const uint32_t (&af)[2][4],
                                              const uint32_t (&bfr)[2][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2], bfr[ni >> 1][(ni & 1) * 2 + 1]);
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// 4 warps, each owns a 32 x 32 quarter of the 64 x 64 tile
__global__ void __launch_bounds__(THREADS) dx_kernel(const XArgs args) {
  const XProb p = args.p[blockIdx.z];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  if (n0 >= p.n) return;  // the 1-d products are half as wide as the E ones
  __shared__ __align__(16) bf16 sa[2][BM * LDK];
  __shared__ __align__(16) bf16 sb[2][BN * LDK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int M = args.M;

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int k = k0 + kc;
      const int m = m0 + r;
      const bool va = m < M && k < p.k;
      cp_async16(&sa[stage][r * LDK + kc], va ? p.a + (size_t)m * p.lda + k : p.a, va);
      const int n = n0 + r;
      const bool vb = n < p.n && k < p.k;
      cp_async16(&sb[stage][r * LDK + kc], vb ? p.w + (size_t)n * p.k + k : p.w, vb);
    }
  };

  float acc[2][4][4];
  zero(acc);
  const int KT = (p.k + BK - 1) / BK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* A = sa[kt & 1];
    const bf16* B = sb[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], A + (wm * 32 + mi * 16 + (lane & 15)) * LDK + kk + (lane >> 4) * 8);
      // w is stored [n][k]: the non-transposed load gives the "col" B fragment
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(bfr[nj], B + (wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * LDK + kk +
                                 ((lane >> 3) & 1) * 8);
      mma_warp_tile(acc, af, bfr);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mi * 16 + g + h * 8;
        const int n = n0 + wn * 32 + ni * 8 + 2 * t;  // even; p.n % 8 == 0
        if (m < M && n < p.n)
          *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)m * p.ldo + n) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

__global__ void __launch_bounds__(THREADS) dw_kernel(const WArgs args) {
  const int pidx = blockIdx.z % 5, split = blockIdx.z / 5;
  const WProb p = args.p[pidx];
  const int j0 = blockIdx.x * BN, i0 = blockIdx.y * BM;
  if (i0 >= p.ni || j0 >= p.nj) return;  // uniform across the CTA
  __shared__ __align__(16) bf16 sa[2][BK * LDT];
  __shared__ __align__(16) bf16 sb[2][BK * LDT];
  __shared__ float bias_half[BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int mlo = split * args.chunk;
  const int mhi = min(args.M, mlo + args.chunk);
  const int per_seg = mhi > mlo ? (mhi - mlo + BK - 1) / BK : 0;
  const int KT = per_seg * p.segs;
  const bool do_bias = args.bias_off >= 0 && pidx == 0 && blockIdx.y == 0;

  auto load = [&](int stage, int kt) {
    const int seg = kt / per_seg;
    const int mb = mlo + (kt - seg * per_seg) * BK;
    const bf16* a = p.a[seg];
    const bf16* b = p.b[seg];
#pragma unroll
    for (int c = tid; c < BK * BM / 8; c += THREADS) {
      const int r = c >> 3, cc = (c & 7) * 8;
      const int m = mb + r;
      const bool vm = m < mhi;
      const bool va = vm && i0 + cc < p.ni;
      cp_async16(&sa[stage][r * LDT + cc], va ? a + (size_t)m * p.lda + i0 + cc : a, va);
      const bool vb = vm && j0 + cc < p.nj;
      cp_async16(&sb[stage][r * LDT + cc], vb ? b + (size_t)m * p.ldb + j0 + cc : b, vb);
    }
  };

  float acc[2][4][4];
  zero(acc);
  float bsum = 0.f;  // column (tid & 63) of dq_0 over k-rows (tid >> 6) * 16 .. +16
  if (KT > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* A = sa[kt & 1];
    const bf16* B = sb[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
      // x is stored [k = token][i]: the transposed load gives the row-major A
      // fragment of x^T
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], A + (kk + (lane & 7) + (lane >> 4) * 8) * LDT + wm * 32 +
                                      mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], B + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT + wn * 32 +
                                       nj * 16 + (lane >> 4) * 8);
      mma_warp_tile(acc, af, bfr);
    }
    if (do_bias) {
      const int col = tid & (BN - 1), r0 = (tid >> 6) * (BK / 2);
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) bsum += __bfloat162float(B[(r0 + r) * LDT + col]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* part = args.scratch + (size_t)split * args.split_stride + p.part;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wm * 32 + mi * 16 + g + h * 8;
        const int j = j0 + wn * 32 + ni * 8 + 2 * t;
        if (i < p.ni && j < p.nj)
          *reinterpret_cast<float2*>(part + (size_t)i * p.nj + j) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  if (do_bias) {
    const int col = tid & (BN - 1);
    if (tid >= BN) bias_half[col] = bsum;
    __syncthreads();
    if (tid < BN && j0 + col < p.nj)
      args.scratch[(size_t)split * args.split_stride + args.bias_off + j0 + col] =
          bsum + bias_half[col];
  }
}

// out[idx] = sum over splits, in split order, of the partials; then bf16
__global__ void reduce_kernel(const float* scratch, long long split_stride, int splits, int n_w1,
                              int n_we, int n_bias, bf16* dw1, bf16* dwe, bf16* dbias) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_w1 + n_we + n_bias) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += scratch[(size_t)sp * split_stride + idx];
  const bf16 v = __float2bfloat16(s);
  if (idx < n_w1)
    dw1[idx] = v;
  else if (idx < n_w1 + n_we)
    dwe[idx - n_w1] = v;
  else
    dbias[idx - n_w1 - n_we] = v;
}

}  // namespace lind8bwd
}  // namespace ovt

// x0..x3 [M,C] (row stride ldx), xef [M,4C] (ldxe), w1 [4,C,F], we [2C,2F],
// dq0..dq3 [M,F], de0, de1 [M,2F] -> dx0..dx3 [M,C] (ldd), dxef [M,4C]
// (ldde), dw1 [4,C,F], dwe [2C,2F], dbias [F] (null: no bias). All bf16 with
// unit channel stride, every start 16-byte aligned, the row strides
// multiples of 8, dq and de contiguous, C % 8 == 0 and F % 8 == 0 (checked by
// the Python wrapper). scratch: f32, splits * (8 C F + F) values.
OVT_EXPORT int ovt_lin_d8_bwd(const void* x0, const void* x1, const void* x2, const void* x3,
                              const void* xef, const void* w1, const void* we, const void* dq0,
                              const void* dq1, const void* dq2, const void* dq3, const void* de0,
                              const void* de1, void* dx0, void* dx1, void* dx2, void* dx3,
                              void* dxef, void* dw1, void* dwe, void* dbias, void* scratch, int M,
                              int C, int F, int splits, int ldx, int ldxe, int ldd, int ldde,
                              void* stream) {
  using namespace ovt::lind8bwd;
  using ovt::bf16;
  const bf16* xs[4] = {static_cast<const bf16*>(x0), static_cast<const bf16*>(x1),
                       static_cast<const bf16*>(x2), static_cast<const bf16*>(x3)};
  const bf16* dqs[4] = {static_cast<const bf16*>(dq0), static_cast<const bf16*>(dq1),
                        static_cast<const bf16*>(dq2), static_cast<const bf16*>(dq3)};
  bf16* dxs[4] = {static_cast<bf16*>(dx0), static_cast<bf16*>(dx1), static_cast<bf16*>(dx2),
                  static_cast<bf16*>(dx3)};
  const bf16* des[2] = {static_cast<const bf16*>(de0), static_cast<const bf16*>(de1)};
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* wep = static_cast<const bf16*>(we);
  const bf16* efp = static_cast<const bf16*>(xef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  XArgs xa;
  xa.M = M;
  for (int g = 0; g < 4; ++g) xa.p[g] = {dqs[g], w1p + (size_t)g * C * F, dxs[g], F, ldd, C, F};
  for (int r = 0; r < 2; ++r)
    xa.p[4 + r] = {des[r], wep, static_cast<bf16*>(dxef) + r * 2 * C, 2 * F, ldde, 2 * C, 2 * F};
  dim3 gx((2 * C + BN - 1) / BN, (M + BM - 1) / BM, 6);
  dx_kernel<<<gx, THREADS, 0, s>>>(xa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  WArgs wa;
  for (int g = 0; g < 4; ++g)
    wa.p[g] = {{xs[g], xs[g]}, {dqs[g], dqs[g]}, ldx, F, C, F, 1, g * C * F};
  wa.p[4] = {{efp, efp + 2 * C}, {des[0], des[1]}, ldxe, 2 * F, 2 * C, 2 * F, 2, 4 * C * F};
  wa.scratch = static_cast<float*>(scratch);
  wa.split_stride = 8LL * C * F + F;
  wa.bias_off = dbias != nullptr ? 8 * C * F : -1;
  wa.M = M;
  const int per = (M + splits - 1) / splits;
  wa.chunk = (per + BK - 1) / BK * BK;
  dim3 gw((2 * F + BN - 1) / BN, (2 * C + BM - 1) / BM, 5 * splits);
  dw_kernel<<<gw, THREADS, 0, s>>>(wa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_w1 = 4 * C * F, n_we = 4 * C * F, n_bias = dbias != nullptr ? F : 0;
  const int total = n_w1 + n_we + n_bias;
  reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(scratch), wa.split_stride, splits, n_w1, n_we, n_bias,
      static_cast<bf16*>(dw1), static_cast<bf16*>(dwe), static_cast<bf16*>(dbias));
  return cudaGetLastError();
}
