// K-ln-d8: the shared-std D8 LayerNorm on the flat-E tuple, forward and
// backward, with or without the AffineD8 epilogue.
//
// Replaces octic_vits_tpu/ops/pallas_ln.py: `_fwd_kernel` (:88) and
// `_fwd_affine_kernel` (:99) -> ovt_ln_d8_fwd; `_bwd_kernel` (:190) and
// `_bwd_affine_kernel` (:117) -> ovt_ln_d8_bwd.
//
// Math, per token m over its row [a1 | a2 | b1 | b2 | ef] (a* [c], ef [4c] =
// [row0 | row1]): six segments, the four 1-d slots and the two E rows, each
// with its own mean; one shared variance
//   var = sum_g |a_g - mean_g|^2 / c + sum_r |e_r - mean_r|^2 * 0.25 / c + eps
// (biased, = var_A1 + var_A2 + var_B1 + var_B2 + 0.5 (var_e0 + var_e1) + eps),
// inv = 1 / (sqrt2/4 sqrt(var)), out = (x - mean) inv, then with the affine
// out * alpha (+ beta on A1) before the one bf16 store. f32 statistics.
// Backward, with u the cotangent and out the un-affined normalized row:
//   ust = u * alpha (u without the affine), coef = inv (sqrt2/4)^2 (ust . out),
//   dxc = inv ust - coef w out  (w = 1/c on 1-d lanes, 0.25/c on E lanes),
//   dx = dxc minus its per-segment mean;
//   dalpha = sum_m u out, dalpha_e = sum_m u_e out_e, dbeta = sum_m u_a1.
// The affine backward recomputes the statistics from the saved input (the
// JAX rule's residual); the stats-only backward reads the saved normalized
// output and var.
//
// What bounds it on the H100: bytes. At ViT-H/14 B=64 (M = 16448, c = 160)
// the forward reads and writes 2560 bytes a token, 84.2 MB in all, against
// ~30 FLOP a value; the backward reads two rows and writes one.
//
// What the design does about it: one warp owns one token row. The row is
// cut into c 16-byte chunks of 8 bf16 (c % 8 == 0, so a chunk never
// crosses a slot or the E row boundary at 2c, which is not a tile edge);
// lane l holds chunks l, l+32, ... in registers (NV per lane), so the row is
// read from HBM once and the two statistics passes and the store run from
// registers with warp shuffles. The parameter gradients are column sums over
// all tokens: each warp adds its rows into its own f32 slice of shared
// memory, each CTA (a fixed range of 16 rows) sums its warps in warp order
// into an f32 partial, and a second kernel sums the partials in split order.
// No atomics, so the result is the same bitwise on every run.
#include <type_traits>

#include "common.cuh"

namespace ovt {
namespace lnd8 {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int ROWS_PER_SPLIT = 16;  // rows of one affine-backward CTA
constexpr float K = 0.35355339059327376f;  // sqrt(2) / 4

struct Args {
  const bf16* x[4];  // inputs (the stats-only backward: the normalized output)
  const bf16* xef;
  const bf16* u[4];  // cotangents (backward)
  const bf16* uef;
  const void* alpha;     // [4, c]  (bf16 or f32)
  const void* alpha_ef;  // [4c]
  const void* beta;      // [c]
  bf16* y[4];            // forward: out; backward: dx
  bf16* yef;
  float* var;      // [M]: written by the forward where not null, read by the stats-only backward
  float* partial;  // [splits, 9c] f32: dalpha | dalpha_e | dbeta per split
  int M, c;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 r;
  r.x = pack_bf16x2(f[0], f[1]);
  r.y = pack_bf16x2(f[2], f[3]);
  r.z = pack_bf16x2(f[4], f[5]);
  r.w = pack_bf16x2(f[6], f[7]);
  return r;
}

__device__ __forceinline__ void load_params8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load_params8(const bf16* p, float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

// offset of chunk k (8 values) of row m inside its array, and its segment:
// 0..3 the 1-d slots, 4 and 5 the two E rows
__device__ __forceinline__ size_t chunk_at(int k, int m, int c, int& arr, int& seg) {
  const int q = c >> 3;
  if (k < 4 * q) {
    arr = seg = k / q;
    return (size_t)m * c + (k - arr * q) * 8;
  }
  arr = 4;
  const int e = k - 4 * q;
  seg = 4 + (e >= 2 * q);
  return (size_t)m * 4 * c + e * 8;
}

template <typename T>
__device__ __forceinline__ uint4 load_chunk(T* const (&p)[4], T* pe, int arr, size_t off) {
  const T* base = arr < 4 ? p[arr] : pe;
  return *reinterpret_cast<const uint4*>(base + off);
}

__device__ __forceinline__ float pick(const float (&v)[6], int seg) {
  float r = v[0];
#pragma unroll
  for (int s = 1; s < 6; ++s) r = seg == s ? v[s] : r;
  return r;
}

// the statistics of one row held in registers: per-segment means and inv
template <int NV>
__device__ __forceinline__ void row_stats(const uint4 (&raw)[NV], const int (&segs)[NV], int lane,
                                          int c, float eps, float (&mean)[6], float& var,
                                          float& inv) {
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= c) continue;
    float f[8];
    unpack8(raw[i], f);
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) t += f[j];
#pragma unroll
    for (int sg = 0; sg < 6; ++sg) s[sg] += segs[i] == sg ? t : 0.f;
  }
#pragma unroll
  for (int sg = 0; sg < 6; ++sg) mean[sg] = warp_sum(s[sg]) * (sg < 4 ? 1.f / c : 0.5f / c);
  float sqa = 0.f, sqe = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= c) continue;
    float f[8];
    unpack8(raw[i], f);
    const float mu = pick(mean, segs[i]);
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) t += (f[j] - mu) * (f[j] - mu);
    if (segs[i] < 4) sqa += t;
    else sqe += t;
  }
  var = warp_sum(sqa) * (1.f / c) + warp_sum(sqe) * (0.25f / c) + eps;
  inv = 1.f / (K * sqrtf(var));
}

template <int NV, bool AFFINE, typename PT>
__global__ void __launch_bounds__(THREADS) ln_fwd_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= a.M) return;
  const int c = a.c, q = c >> 3;
  uint4 raw[NV];
  int segs[NV], arrs[NV];
  size_t offs[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = lane + 32 * i;
    segs[i] = arrs[i] = 0;
    offs[i] = 0;
    if (k < c) {
      offs[i] = chunk_at(k, m, c, arrs[i], segs[i]);
      raw[i] = load_chunk(a.x, a.xef, arrs[i], offs[i]);
    }
  }
  float mean[6], var, inv;
  row_stats<NV>(raw, segs, lane, c, a.eps, mean, var, inv);
  const PT* alpha = static_cast<const PT*>(a.alpha);
  const PT* alpha_ef = static_cast<const PT*>(a.alpha_ef);
  const PT* beta = static_cast<const PT*>(a.beta);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = lane + 32 * i;
    if (k >= c) continue;
    float f[8];
    unpack8(raw[i], f);
    const float mu = pick(mean, segs[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (f[j] - mu) * inv;
    if (AFFINE) {
      float al[8];
      load_params8(k < 4 * q ? alpha + 8 * k : alpha_ef + 8 * (k - 4 * q), al);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] *= al[j];
      if (k < q) {  // A1: the bias
        float be[8];
        load_params8(beta + 8 * k, be);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] += be[j];
      }
    }
    bf16* dst = (arrs[i] < 4 ? a.y[arrs[i]] : a.yef) + offs[i];
    *reinterpret_cast<uint4*>(dst) = pack8(f);
  }
  if (a.var != nullptr && lane == 0) a.var[m] = var;
}

// dx of one row from the un-affined output `o` and `ust` (the cotangent
// without the affine), both f32 in registers of this lane: dxc, its segment
// means, the store.
template <int NV>
__device__ __forceinline__ void store_dx(const Args& a, float (&o)[NV][8], float (&ust)[NV][8],
                                         const int (&segs)[NV], const int (&arrs)[NV],
                                         const size_t (&offs)[NV], int lane, float inv,
                                         float coef) {
  const int c = a.c;
  float ds[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= c) continue;
    const float w = segs[i] < 4 ? 1.f / c : 0.25f / c;
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[i][j] = inv * ust[i][j] - coef * w * o[i][j];  // o now holds dxc
      t += o[i][j];
    }
#pragma unroll
    for (int sg = 0; sg < 6; ++sg) ds[sg] += segs[i] == sg ? t : 0.f;
  }
  float dm[6];
#pragma unroll
  for (int sg = 0; sg < 6; ++sg) dm[sg] = warp_sum(ds[sg]) * (sg < 4 ? 1.f / c : 0.5f / c);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i >= c) continue;
    const float mu = pick(dm, segs[i]);
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = o[i][j] - mu;
    bf16* dst = (arrs[i] < 4 ? a.y[arrs[i]] : a.yef) + offs[i];
    *reinterpret_cast<uint4*>(dst) = pack8(f);
  }
}

// Backward with the affine: statistics recomputed from the input; each warp
// adds its rows' parameter gradients into its own shared-memory slice
// [dalpha (8c: the four 1-d alphas then alpha_ef) | dbeta (c)].
template <int NV, typename PT>
__global__ void __launch_bounds__(THREADS) ln_bwd_affine_kernel(const Args a) {
  extern __shared__ float sp[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = a.c, q = c >> 3, W = 9 * c;
  float* mine = sp + warp * W;
  for (int i = lane; i < W; i += 32) mine[i] = 0.f;
  __syncwarp();
  const PT* alpha = static_cast<const PT*>(a.alpha);
  const PT* alpha_ef = static_cast<const PT*>(a.alpha_ef);
  const int r0 = blockIdx.x * ROWS_PER_SPLIT;
  const int r1 = min(a.M, r0 + ROWS_PER_SPLIT);
  for (int m = r0 + warp; m < r1; m += WARPS) {
    uint4 raw[NV];
    int segs[NV], arrs[NV];
    size_t offs[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = lane + 32 * i;
      segs[i] = arrs[i] = 0;
      offs[i] = 0;
      if (k < c) {
        offs[i] = chunk_at(k, m, c, arrs[i], segs[i]);
        raw[i] = load_chunk(a.x, a.xef, arrs[i], offs[i]);
      }
    }
    float mean[6], var, inv;
    row_stats<NV>(raw, segs, lane, c, a.eps, mean, var, inv);
    float o[NV][8], ust[NV][8];
    float ud = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = lane + 32 * i;
      if (k >= c) continue;
      float f[8], g[8], al[8];
      unpack8(raw[i], f);
      unpack8(load_chunk(a.u, a.uef, arrs[i], offs[i]), g);
      load_params8(k < 4 * q ? alpha + 8 * k : alpha_ef + 8 * (k - 4 * q), al);
      const float mu = pick(mean, segs[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[i][j] = (f[j] - mu) * inv;
        ust[i][j] = g[j] * al[j];
        mine[8 * k + j] += g[j] * o[i][j];
        ud += ust[i][j] * o[i][j];
      }
      if (k < q) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mine[8 * c + 8 * k + j] += g[j];
      }
    }
    const float coef = inv * K * K * warp_sum(ud);
    store_dx<NV>(a, o, ust, segs, arrs, offs, lane, inv, coef);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W; i += THREADS) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += sp[w * W + i];
    a.partial[(size_t)blockIdx.x * W + i] = t;
  }
}

// Backward of the statistics alone, from the saved normalized output and var.
template <int NV>
__global__ void __launch_bounds__(THREADS) ln_bwd_stats_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= a.M) return;
  const int c = a.c;
  const float inv = 1.f / (K * sqrtf(a.var[m]));
  int segs[NV], arrs[NV];
  size_t offs[NV];
  float o[NV][8], ust[NV][8];
  float ud = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = lane + 32 * i;
    segs[i] = arrs[i] = 0;
    offs[i] = 0;
    if (k >= c) continue;
    offs[i] = chunk_at(k, m, c, arrs[i], segs[i]);
    unpack8(load_chunk(a.x, a.xef, arrs[i], offs[i]), o[i]);
    unpack8(load_chunk(a.u, a.uef, arrs[i], offs[i]), ust[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) ud += ust[i][j] * o[i][j];
  }
  const float coef = inv * K * K * warp_sum(ud);
  store_dx<NV>(a, o, ust, segs, arrs, offs, lane, inv, coef);
}

// dparams[i] = sum over splits, in split order, of partial[s][i]: 32 columns
// a CTA, 8 rows of threads each summing every 8th split, then the 8 row sums
// in row order.
__global__ void __launch_bounds__(256) ln_param_reduce_kernel(const float* partial, int splits,
                                                              int W, float* out) {
  __shared__ float red[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x, ty = threadIdx.y;
  float t = 0.f;
  if (col < W)
    for (int s = ty; s < splits; s += 8) t += partial[(size_t)s * W + col];
  red[ty][threadIdx.x] = t;
  __syncthreads();
  if (ty == 0 && col < W) {
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) r += red[i][threadIdx.x];
    out[col] = r;
  }
}

template <int NV>
cudaError_t launch_fwd(const Args& a, bool affine, bool f32, cudaStream_t s) {
  const dim3 grid((a.M + WARPS - 1) / WARPS);
  if (!affine) ln_fwd_kernel<NV, false, float><<<grid, THREADS, 0, s>>>(a);
  else if (f32) ln_fwd_kernel<NV, true, float><<<grid, THREADS, 0, s>>>(a);
  else ln_fwd_kernel<NV, true, bf16><<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <int NV, typename PT>
cudaError_t launch_bwd_affine(const Args& a, int splits, cudaStream_t s) {
  const int smem = WARPS * 9 * a.c * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_bwd_affine_kernel<NV, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_affine_kernel<NV, PT><<<splits, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_bwd(const Args& a, bool affine, bool f32, int splits, cudaStream_t s) {
  if (!affine) {
    ln_bwd_stats_kernel<NV><<<(a.M + WARPS - 1) / WARPS, THREADS, 0, s>>>(a);
    return cudaGetLastError();
  }
  return f32 ? launch_bwd_affine<NV, float>(a, splits, s) : launch_bwd_affine<NV, bf16>(a, splits, s);
}

// chunks a lane holds: ceil(c / 32), rounded up to an instantiated count
template <typename F>
cudaError_t by_nv(int c, F&& f) {
  const int need = (c + 31) / 32;
  if (need <= 1) return f(std::integral_constant<int, 1>());
  if (need <= 2) return f(std::integral_constant<int, 2>());
  if (need <= 4) return f(std::integral_constant<int, 4>());
  if (need <= 5) return f(std::integral_constant<int, 5>());
  if (need <= 8) return f(std::integral_constant<int, 8>());
  return cudaErrorInvalidValue;
}

Args make_args(const void* const* x, const void* const* u, const void* alpha, const void* alpha_ef,
               const void* beta, void* const* y, float* var, float* partial, int M, int c,
               float eps) {
  Args a;
  for (int g = 0; g < 4; ++g) {
    a.x[g] = static_cast<const bf16*>(x[g]);
    a.u[g] = u ? static_cast<const bf16*>(u[g]) : nullptr;
    a.y[g] = static_cast<bf16*>(y[g]);
  }
  a.xef = static_cast<const bf16*>(x[4]);
  a.uef = u ? static_cast<const bf16*>(u[4]) : nullptr;
  a.yef = static_cast<bf16*>(y[4]);
  a.alpha = alpha;
  a.alpha_ef = alpha_ef;
  a.beta = beta;
  a.var = var;
  a.partial = partial;
  a.M = M;
  a.c = c;
  a.eps = eps;
  return a;
}

}  // namespace lnd8
}  // namespace ovt

// Forward. x0..x3 [M,c], xef [M,4c] bf16; with `affine`, alpha [4,c],
// alpha_ef [4c], beta [c] (f32 if param_f32, else bf16); y0..y3, yef the
// outputs; var [M] f32 or null. c % 8 == 0, c <= 256, every pointer 16-byte
// aligned (checked by the Python wrapper).
OVT_EXPORT int ovt_ln_d8_fwd(const void* x0, const void* x1, const void* x2, const void* x3,
                             const void* xef, const void* alpha, const void* alpha_ef,
                             const void* beta, void* y0, void* y1, void* y2, void* y3, void* yef,
                             void* var, int M, int c, int affine, int param_f32, float eps,
                             void* stream) {
  using namespace ovt::lnd8;
  const void* x[5] = {x0, x1, x2, x3, xef};
  void* y[5] = {y0, y1, y2, y3, yef};
  const Args a = make_args(x, nullptr, alpha, alpha_ef, beta, y, static_cast<float*>(var),
                           nullptr, M, c, eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_nv(c, [&](auto nv) { return launch_fwd<decltype(nv)::value>(a, affine, param_f32, s); });
}

// Backward. With `affine`: x the forward's input, alpha and alpha_ef its
// parameters; partial [splits, 9c] f32 scratch with splits = ceil(M / 16);
// dparams [9c] f32 receives dalpha (4c) | dalpha_e (4c) | dbeta (c). Without:
// x the forward's normalized output, var its [M] f32 variance. u0..u3, uef
// the cotangent; dx0..dx3, dxef the input gradient.
OVT_EXPORT int ovt_ln_d8_bwd(const void* x0, const void* x1, const void* x2, const void* x3,
                             const void* xef, const void* alpha, const void* alpha_ef,
                             const void* u0, const void* u1, const void* u2, const void* u3,
                             const void* uef, const void* var, void* dx0, void* dx1, void* dx2,
                             void* dx3, void* dxef, void* partial, void* dparams, int M, int c,
                             int affine, int param_f32, int splits, float eps, void* stream) {
  using namespace ovt::lnd8;
  const void* x[5] = {x0, x1, x2, x3, xef};
  const void* u[5] = {u0, u1, u2, u3, uef};
  void* dx[5] = {dx0, dx1, dx2, dx3, dxef};
  const Args a = make_args(x, u, alpha, alpha_ef, nullptr, dx,
                           const_cast<float*>(static_cast<const float*>(var)),
                           static_cast<float*>(partial), M, c, eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = by_nv(
      c, [&](auto nv) { return launch_bwd<decltype(nv)::value>(a, affine, param_f32, splits, s); });
  if (err != cudaSuccess || !affine) return err;
  const int W = 9 * c;
  ln_param_reduce_kernel<<<(W + 31) / 32, dim3(32, 8), 0, s>>>(static_cast<const float*>(partial),
                                                              splits, W,
                                                              static_cast<float*>(dparams));
  return cudaGetLastError();
}
