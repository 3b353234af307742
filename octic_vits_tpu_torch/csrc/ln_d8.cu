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
// registers with warp shuffles.
//
// The affine backward also sums the parameter gradients over all tokens, and
// its row math takes about as long as its bytes on the card. So its grid is
// persistent, one CTA an SM (ops/ln_d8.py:ln_bwd_plan), each CTA one
// contiguous range of rows, its warps taking the range's rows in turn and
// holding a row's out and ust in f32, computed once: recomputing them from
// the raw row, to fit two CTAs an SM, spilled and ran far slower. A lane
// owns the same chunks in every row, so it adds its dalpha and dbeta in
// registers across all of its warp's rows; shared memory holds the sums once
// a CTA, at the end (consecutive floats a warp, then the warps in warp
// order), and each CTA writes one f32 partial, which a second kernel sums in
// a fixed order. No atomics, so the result is the same bitwise on every run.
// The rows reach each warp through its own ring of two stages: lane 0
// refills a stage by ten 1-D bulk copies (the four slots and the E row of x
// and of u) as soon as the warp holds the stage's row in registers, so the
// next rows are in flight while one is computed.
#include <type_traits>

#include "sm90.cuh"

namespace ovt {
namespace lnd8 {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr float K = 0.35355339059327376f;  // sqrt(2) / 4
constexpr int BWD_STAGES = 2;  // the rows of a warp's ring in the affine backward

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
  float* partial;  // [grid, bwd_partial_floats] f32: each CTA's parameter-gradient sums
  int M, c;
  float eps;
};

// The f32 slots of one warp's (and one CTA's) parameter-gradient sums: lane
// l's dalpha of its chunk l + 32 i, value j, at (8 i + j) 32 + l, then its
// dbeta value j at 256 NV + 32 j + l; consecutive lanes, consecutive floats.
__host__ __device__ constexpr int bwd_partial_floats(int nv) { return 256 * (nv + 1); }

// The affine backward's dynamic shared memory: each warp's BWD_STAGES full
// barriers, then each warp's ring of BWD_STAGES rows (x then u, 32c bytes a
// row), which the warps' sums reuse at the end.
inline int bwd_smem(int c, int nv) {
  const int ring = WARPS * BWD_STAGES * 32 * c, sums = WARPS * bwd_partial_floats(nv) * 4;
  return WARPS * BWD_STAGES * 8 + (ring > sums ? ring : sums);
}

// The parameter gradient of slot p: dalpha 8k + j over [alpha (4c) |
// alpha_ef (4c)], dbeta at 8c + 8k + j; -1 for a slot of no chunk.
__device__ __forceinline__ int bwd_param_of(int p, int nv, int c) {
  if (p < 256 * nv) {
    const int k = 32 * (p >> 8) + (p & 31);
    return k < c ? 8 * k + ((p >> 5) & 7) : -1;
  }
  const int r = p - 256 * nv, k = r & 31;
  return k < (c >> 3) ? 8 * c + 8 * k + (r >> 5) : -1;
}

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

// dx of one row of slot width c from the un-affined output `o` and `ust`
// (the cotangent without the affine), both f32 in registers of this lane:
// dxc, its segment means, the store.
template <int NV>
__device__ __forceinline__ void store_dx(const Args& a, int c, float (&o)[NV][8],
                                         float (&ust)[NV][8], const int (&segs)[NV],
                                         const int (&arrs)[NV], const size_t (&offs)[NV],
                                         int lane, float inv, float coef) {
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

// One row's x and u into a ring stage by ten 1-D bulk copies (the four
// slots, 2c bytes each, and the E row, 8c bytes, of each), laid out as the
// row's chunks (chunk k at 16 k; u from 16c on), counted on `bar`.
__device__ __forceinline__ void load_row(const Args& a, int c, int m, unsigned char* st,
                                         uint64_t* bar) {
  sm90::mbar_arrive_expect_tx(bar, 32 * c);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    sm90::bulk_load(st + 2 * c * g, a.x[g] + (size_t)m * c, 2 * c, bar);
    sm90::bulk_load(st + 16 * c + 2 * c * g, a.u[g] + (size_t)m * c, 2 * c, bar);
  }
  sm90::bulk_load(st + 8 * c, a.xef + (size_t)m * 4 * c, 8 * c, bar);
  sm90::bulk_load(st + 24 * c, a.uef + (size_t)m * 4 * c, 8 * c, bar);
}

// Backward with the affine: statistics recomputed from the input. CTA b
// takes rows [b rows, (b + 1) rows), its warp w the rows w, w + WARPS, ... of
// that range, each through the warp's ring; a row's out and ust are held in
// f32 for store_dx, and the parameter gradients add up in registers (slots as
// bwd_partial_floats); the CTA's warps' sums, in warp order, are its partial.
// CC: the slot width where it is 32 NV (every lane holds NV chunks: no
// bounds on the chunks), else 0 (c from the arguments). One CTA an SM.
template <int NV, int CC, typename PT>
__global__ void __launch_bounds__(THREADS, 1)
    ln_bwd_affine_kernel(const Args a, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WP = bwd_partial_floats(NV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = CC ? CC : a.c, q = c >> 3;
  constexpr int S = BWD_STAGES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem) + warp * S;
  unsigned char* base = smem + WARPS * S * 8;
  unsigned char* ring = base + (size_t)warp * S * 32 * c;
  const int m0 = blockIdx.x * rows + warp;
  const int end = min(a.M, (blockIdx.x + 1) * rows);
  const int n = m0 < end ? (end - m0 + WARPS - 1) / WARPS : 0;  // this warp's rows
  if (lane == 0) {
    for (int s = 0; s < S; ++s) sm90::mbar_init(full + s, 1);
    sm90::mbar_fence_init();
    for (int j = 0; j < min(n, S); ++j)
      load_row(a, c, m0 + j * WARPS, ring + j * 32 * c, full + j);
  }
  __syncwarp();
  const PT* alpha = static_cast<const PT*>(a.alpha);
  const PT* alpha_ef = static_cast<const PT*>(a.alpha_ef);
  // this lane's chunks, the same in every row: segment, array, offset in row 0
  int segs[NV], arrs[NV], at[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = lane + 32 * i;
    segs[i] = arrs[i] = at[i] = 0;
    if (k < c) at[i] = (int)chunk_at(k, 0, c, arrs[i], segs[i]);
  }
  float dal[NV][8], dbe[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dbe[j] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) dal[i][j] = 0.f;
  }
  for (int j = 0; j < n; ++j) {
    const int s = j % S, m = m0 + j * WARPS;
    unsigned char* st = ring + s * 32 * c;
    sm90::mbar_wait(full + s, (j / S) & 1);
    uint4 rx[NV], ru[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = lane + 32 * i;
      if (k >= c) continue;
      rx[i] = *reinterpret_cast<const uint4*>(st + 16 * k);
      ru[i] = *reinterpret_cast<const uint4*>(st + 16 * c + 16 * k);
    }
    __syncwarp();  // the warp holds the row: the stage takes the row S on
    if (lane == 0 && j + S < n) {
      sm90::fence_proxy_async();
      load_row(a, c, m + S * WARPS, st, full + s);
    }
    float mean[6], var, inv;
    row_stats<NV>(rx, segs, lane, c, a.eps, mean, var, inv);
    float o[NV][8], ust[NV][8];
    float ud = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = lane + 32 * i;
      if (k >= c) continue;
      float f[8], g[8], al[8];
      unpack8(rx[i], f);
      unpack8(ru[i], g);
      load_params8(k < 4 * q ? alpha + 8 * k : alpha_ef + 8 * (k - 4 * q), al);
      const float mu = pick(mean, segs[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[i][j] = (f[j] - mu) * inv;
        ust[i][j] = g[j] * al[j];
        dal[i][j] += g[j] * o[i][j];
        ud += ust[i][j] * o[i][j];
      }
      if (i == 0 && k < q) {
#pragma unroll
        for (int j = 0; j < 8; ++j) dbe[j] += g[j];
      }
    }
    const float coef = inv * K * K * warp_sum(ud);
    size_t offs[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) offs[i] = (size_t)m * (arrs[i] < 4 ? c : 4 * c) + at[i];
    store_dx<NV>(a, c, o, ust, segs, arrs, offs, lane, inv, coef);
  }
  // every copy issued was waited on, so the rings are free for the sums
  __syncthreads();
  float* sums = reinterpret_cast<float*>(base);
  float* mine = sums + warp * WP;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < NV; ++i) mine[(8 * i + j) * 32 + lane] = dal[i][j];
    mine[256 * NV + 32 * j + lane] = dbe[j];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < WP; p += THREADS) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += sums[w * WP + p];
    a.partial[(size_t)blockIdx.x * WP + p] = t;
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
  store_dx<NV>(a, c, o, ust, segs, arrs, offs, lane, inv, coef);
}

// dparams = the sum over the CTAs' partials in a fixed order: 32 slots a
// CTA, 8 rows of threads each summing every 8th CTA's partial in CTA order,
// then the 8 row sums in row order; each slot lands on its parameter
// (bwd_param_of).
__global__ void __launch_bounds__(256) ln_param_reduce_kernel(const float* partial, int ctas,
                                                              int nv, int c, float* out) {
  __shared__ float red[8][33];
  const int wp = bwd_partial_floats(nv);
  const int p = blockIdx.x * 32 + threadIdx.x, ty = threadIdx.y;
  float t = 0.f;
  if (p < wp)
    for (int s = ty; s < ctas; s += 8) t += partial[(size_t)s * wp + p];
  red[ty][threadIdx.x] = t;
  __syncthreads();
  if (ty == 0 && p < wp) {
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) r += red[i][threadIdx.x];
    const int e = bwd_param_of(p, nv, c);
    if (e >= 0) out[e] = r;
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

// The affine backward and the sum of its partials, after checking the plan
// (ops/ln_d8.py:ln_bwd_plan) against the kernel's: the CTAs' ranges cover
// the M rows, the ring's stages and the shared memory and partial sizes.
template <int NV, typename PT>
int launch_bwd_affine(const Args& a, float* dparams, int grid, int rows, int stages, int smem,
                      int partial_floats, cudaStream_t s) {
  if (grid < 1 || rows < 1 || (long long)(grid - 1) * rows >= a.M ||
      (long long)grid * rows < a.M || stages != BWD_STAGES || smem != bwd_smem(a.c, NV) ||
      partial_floats != bwd_partial_floats(NV))
    return ERR_PLAN;
  auto kern = a.c == 32 * NV ? ln_bwd_affine_kernel<NV, 32 * NV, PT>
                              : ln_bwd_affine_kernel<NV, 0, PT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, s>>>(a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_param_reduce_kernel<<<(partial_floats + 31) / 32, dim3(32, 8), 0, s>>>(a.partial, grid, NV,
                                                                           a.c, dparams);
  return cudaGetLastError();
}

// chunks a lane holds: ceil(c / 32), rounded up to an instantiated count
template <typename F>
int by_nv(int c, F&& f) {
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
// parameters; the plan (grid, rows, stages, smem, partial_floats) of
// ops/ln_d8.py:ln_bwd_plan, checked here (ERR_PLAN); partial [grid,
// partial_floats] f32 scratch; dparams [9c] f32 receives dalpha (4c) |
// dalpha_e (4c) | dbeta (c). Without: x the forward's normalized output, var
// its [M] f32 variance, the plan's integers 0. u0..u3, uef the cotangent;
// dx0..dx3, dxef the input gradient. Every pointer 16-byte aligned.
OVT_EXPORT int ovt_ln_d8_bwd(const void* x0, const void* x1, const void* x2, const void* x3,
                             const void* xef, const void* alpha, const void* alpha_ef,
                             const void* u0, const void* u1, const void* u2, const void* u3,
                             const void* uef, const void* var, void* dx0, void* dx1, void* dx2,
                             void* dx3, void* dxef, void* partial, void* dparams, int M, int c,
                             int affine, int param_f32, int grid, int rows, int stages, int smem,
                             int partial_floats, float eps, void* stream) {
  using namespace ovt::lnd8;
  const void* x[5] = {x0, x1, x2, x3, xef};
  const void* u[5] = {u0, u1, u2, u3, uef};
  void* dx[5] = {dx0, dx1, dx2, dx3, dxef};
  const Args a = make_args(x, u, alpha, alpha_ef, nullptr, dx,
                           const_cast<float*>(static_cast<const float*>(var)),
                           static_cast<float*>(partial), M, c, eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(dparams);
  return by_nv(c, [&](auto nv) -> int {
    constexpr int NV = decltype(nv)::value;
    if (!affine) {
      ln_bwd_stats_kernel<NV><<<(M + WARPS - 1) / WARPS, THREADS, 0, s>>>(a);
      return cudaGetLastError();
    }
    return param_f32 ? launch_bwd_affine<NV, float>(a, dp, grid, rows, stages, smem,
                                                    partial_floats, s)
                     : launch_bwd_affine<NV, ovt::bf16>(a, dp, grid, rows, stages, smem,
                                                        partial_floats, s);
  });
}
