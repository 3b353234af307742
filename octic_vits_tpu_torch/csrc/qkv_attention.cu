// K-qkv-attn: the octic qkv product and the attention in one launch, and the
// same followed by the proj product in one launch (probes of kernel row 14c).
//
// Replaces
//   scripts/r3_attn_bwd_ablate.py:k_octic_qkvattn_fwd (call :735): the
//     block-diagonal qkv LinearD8 of the flat-E tuple (x a1..b2 [B,N,C/8] with
//     w1 [4, C/8, 3C/8], the E rows e0 | e1 of ef [B,N,C/2] with we
//     [C/4, 3C/4], the bias on the A1 output; each product rounded to bf16,
//     then the bias added) and the octic attention of its result, with the
//     [B,N,3C] qkv kept out of device memory -> o1..o4 [B,N,C/8], oe0, oe1
//     [B,N,C/4]: row 2's function;
//   scripts/r3_attn_bwd_ablate.py:k_octic_qkvattnproj_fwd (call :693): the
//     same, then the proj LinearD8 (w1p [4, C/8, C/8], wep [C/4, C/4], biasp;
//     rounded to bf16, then the bias added) of the attention output (rounded
//     to bf16), with neither the qkv nor the attention output in device
//     memory -> o1..o4 [B,N,C/8], oef [B,N,C/2].
// What bounds it on the H100: the attention's 4 b n^2 c products and the qkv
// product's 72 b n (C/8)^2 (the proj's 24 b n (C/8)^2 more) over the input,
// the weights and the output: ~0.05 ms of products at ViT-H/14 B=64, above
// the ~0.03 ms of bytes. The TPU kernel keeps all the qkv weights (~1.2 MB)
// and one image's qkv (~2 MB) in VMEM; one CTA holds 227 KB here.
// What the design does about it: one CTA of 8 warps per (head, image). It
// forms its head's q, k and v (dh = 80 channels each, for every token) with
// the block-diagonal weights' columns of that head, staged transposed in
// shared memory, against the image's input read straight into MMA fragments
// (so the input is read once per head, from L2), and writes them into K-attn's
// staging layout (q and k rows, v transposed; ~141 KB at N = 257); then runs
// K-attn's chain (csrc/attention_core.cuh:head_chain) on them. With the proj,
// the 16 CTAs of an image form one thread-block cluster (a non-portable size
// above 8): each keeps its head's attention output (bf16) in shared memory,
// and after a cluster barrier CTA h computes the proj's output columns [h d1,
// (h + 1) d1) of a1..b2 and [h de, (h + 1) de) of each E row, reading every
// head's pieces through distributed shared memory in a fixed order. The
// attention output never goes through device memory; no atomics, so every
// sum has a fixed order. Where the card cannot hold one such cluster at a
// time the launch is refused and the wrapper raises. Reading the input once
// an image through a TMA multicast over the cluster is later work.
#include <cooperative_groups.h>

#include "attention_core.cuh"

// (a named namespace: nvcc's host stub of a kernel in an unnamed namespace
// clashes with the unnamed namespace of csrc/attention_core.cuh)
namespace ovt {
namespace qkv_attn {

namespace cg = cooperative_groups;

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int DHP = 80, DS = DHP + 8, D1 = 10, DE = 20;
// the head's columns of one irrep's product (q, k and v pieces: 3 d1 or 3 de),
// padded to whole 8-column MMA tiles; the proj's (d1 or de)
constexpr int NCOL_A = 32, NCOL_E = 64, PCOL_A = 16, PCOL_E = 32;

struct Args {
  const bf16* x[4];   // a1..b2 [B,N,C8]
  const bf16* ef;     // [B,N,4*C8]: e0 | e1
  const bf16* w1;     // [4, C8, 3*C8]
  const bf16* we;     // [2*C8, 6*C8]
  const bf16* bias;   // [3*C8] or null
  const bf16* w1p;    // [4, C8, C8]
  const bf16* wep;    // [2*C8, 2*C8]
  const bf16* biasp;  // [C8] or null
  bf16* out[6];       // o1..o4 [B,N,C8], oe0, oe1 [B,N,2*C8]; with the proj o1..o4, oef [B,N,4*C8]
  int N, H, C8;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16(bf16(acc) + bias): the products rounded to bf16 before the bias, as the
// TPU kernels add it
__device__ __forceinline__ bf16 round_bias(float acc, const bf16* bias, int col) {
  bf16 v = __float2bfloat16(acc);
  if (bias) v = __float2bfloat16(__bfloat162float(v) + __bfloat162float(bias[col]));
  return v;
}

// W^T [ncol][K + 8] of the columns col_of(j) (j < nreal; zero to ncol) of a
// row-major [K][ld] weight; consecutive threads take consecutive columns
template <typename ColOf>
__device__ __forceinline__ void stage_wt(bf16* wt, const bf16* w, int K, int ld, int ncol,
                                         int nreal, ColOf col_of) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < K * ncol; idx += THREADS) {
    const int k = idx / ncol, j = idx - k * ncol;
    wt[j * (K + 8) + k] = j < nreal ? w[(size_t)k * ld + col_of(j)] : zero;
  }
}

// acc[NT] += A(16 rows from r0 of x, all K) * wt^T: A straight from device
// memory (rows >= N zero), B from the staged W^T
template <int NT>
__device__ __forceinline__ void product_rows(float (&acc)[NT][4], const bf16* x, int ldx, int K,
                                             int r0, int N, const bf16* wt, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const bool in0 = r0 + g < N, in1 = r0 + g + 8 < N;
  const bf16* x0 = x + (size_t)(r0 + g) * ldx + 2 * t;
  const bf16* x1 = x0 + (size_t)8 * ldx;
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t a[4];
    a[0] = in0 ? ld32(x0 + kc * 16) : 0u;
    a[1] = in1 ? ld32(x1 + kc * 16) : 0u;
    a[2] = in0 ? ld32(x0 + kc * 16 + 8) : 0u;
    a[3] = in1 ? ld32(x1 + kc * 16 + 8) : 0u;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* p = wt + (nt * 8 + g) * (K + 8) + kc * 16 + 2 * t;
      mma_bf16(acc[nt], a, ld32(p), ld32(p + 8));
    }
  }
}

// Phase 1: head h's q, k (rows [kpad][DS]) and v^T ([DHP][VS]) of image b in
// shared memory; rows >= N zero.
__device__ __forceinline__ void qkv_head(const Args& A, int b, int h, int kpad, bf16* qs, bf16* ks,
                                         bf16* vt, int VS, bf16* wt) {
  const int N = A.N, H = A.H, C8 = A.C8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  for (int seg = 0; seg < 6; ++seg) {
    const bool e = seg >= 4;
    const int w = e ? DE : D1, K = e ? 2 * C8 : C8, ncol = e ? NCOL_E : NCOL_A;
    if (seg != 5) {  // e0 and e1 share the E weight
      __syncthreads();  // the previous segment's products are done with wt
      const bf16* wsrc = e ? A.we : A.w1 + (size_t)seg * C8 * 3 * C8;
      stage_wt(wt, wsrc, K, e ? 6 * C8 : 3 * C8, ncol, 3 * w,
               [=](int j) { return (j / w * H + h) * w + j % w; });
      __syncthreads();
    }
    const bf16* x = e ? A.ef + (size_t)b * N * 4 * C8 + (seg - 4) * 2 * C8
                      : A.x[seg] + (size_t)b * N * C8;
    const int ldx = e ? 4 * C8 : C8, chan = e ? 4 * D1 + (seg - 4) * DE : seg * D1;
    const bf16* bias = seg == 0 ? A.bias : nullptr;
    for (int r0 = warp * 16; r0 < kpad; r0 += WARPS * 16) {
      float acc[NCOL_E / 8][4] = {};
      if (e) {
        product_rows<NCOL_E / 8>(acc, x, ldx, K, r0, N, wt, lane);
      } else {
        float a4[NCOL_A / 8][4];
        product_rows<NCOL_A / 8>(a4, x, ldx, K, r0, N, wt, lane);
#pragma unroll
        for (int i = 0; i < NCOL_A / 8; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = a4[i][q];
      }
#pragma unroll
      for (int nt = 0; nt < NCOL_E / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = r0 + g + (q >> 1) * 8, j = nt * 8 + 2 * t + (q & 1);
          if (j >= 3 * w) continue;
          const int s = j / w, c = j % w;
          const bf16 v = n < N ? round_bias(acc[nt][q], bias, (s * H + h) * w + c)
                               : __float2bfloat16(0.f);
          if (s == 0)
            qs[n * DS + chan + c] = v;
          else if (s == 1)
            ks[n * DS + chan + c] = v;
          else
            vt[(chan + c) * VS + n] = v;
        }
    }
  }
  __syncthreads();
}

// Phase 3 (PROJ): CTA h's output columns of the proj from every head's
// attention output, os of cluster rank h' (rows [kpad][DS], bf16).
__device__ __forceinline__ void proj_head(const Args& A, int b, int h, int kpad, bf16* os,
                                          bf16* wt) {
  cg::cluster_group cluster = cg::this_cluster();
  const int N = A.N, C8 = A.C8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // W^T of this head's columns: four [PCOL_A][C8 + 8] for a1..b2, [PCOL_E][2 C8 + 8] for E
  bf16* wte = wt + 4 * PCOL_A * (C8 + 8);
  for (int seg = 0; seg < 4; ++seg)
    stage_wt(wt + seg * PCOL_A * (C8 + 8), A.w1p + (size_t)seg * C8 * C8, C8, C8, PCOL_A, D1,
             [=](int j) { return h * D1 + j; });
  stage_wt(wte, A.wep, 2 * C8, 2 * C8, PCOL_E, DE, [=](int j) { return h * DE + j; });
  __syncthreads();
  for (int r0 = warp * 16; r0 < kpad; r0 += WARPS * 16) {
    for (int seg = 0; seg < 6; ++seg) {
      const bool e = seg >= 4;
      const int w = e ? DE : D1, K = e ? 2 * C8 : C8;
      const int chan = e ? 4 * D1 + (seg - 4) * DE : seg * D1;
      const bf16* wts = e ? wte : wt + seg * PCOL_A * (C8 + 8);
      float acc[PCOL_E / 8][4];
#pragma unroll
      for (int i = 0; i < PCOL_E / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int kc = 0; kc < K / 16; ++kc) {
        // contraction index k: head k / w's channel chan + k % w (w even, so a
        // channel pair never straddles two heads)
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = kc * 16 + 2 * t + (q >> 1) * 8, hp = k / w;
          const bf16* src = cluster.map_shared_rank(os, hp);
          a[q] = ld32(src + (r0 + g + (q & 1) * 8) * DS + chan + k - hp * w);
        }
        const int nts = e ? PCOL_E / 8 : PCOL_A / 8;
#pragma unroll
        for (int nt = 0; nt < PCOL_E / 8; ++nt) {
          if (nt >= nts) break;
          const bf16* p = wts + (nt * 8 + g) * (K + 8) + kc * 16 + 2 * t;
          mma_bf16(acc[nt], a, ld32(p), ld32(p + 8));
        }
      }
      bf16* out = e ? A.out[4] + (seg - 4) * 2 * C8 : A.out[seg];
      const int ldo = e ? 4 * C8 : C8;
      const bf16* bias = seg == 0 ? A.biasp : nullptr;
#pragma unroll
      for (int nt = 0; nt < PCOL_E / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = r0 + g + (q >> 1) * 8, j = nt * 8 + 2 * t + (q & 1);
          if (j < w && n < N)
            out[((size_t)b * N + n) * ldo + h * w + j] = round_bias(acc[nt][q], bias, h * w + j);
        }
    }
  }
}

// One CTA of 8 warps per (head, image); with PROJ the image's H CTAs are one
// cluster (cluster rank = head).
template <int PROJ>
__global__ void __launch_bounds__(THREADS) qkv_attention_kernel(const Args A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = A.N, kpad = (N + 15) / 16 * 16, VS = kpad + 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // K-attn's staging layout
  bf16* qs = ks + kpad * DS;
  bf16* vt = qs + kpad * DS;
  bf16* wt = vt + DHP * VS;
  qkv_head(A, b, h, kpad, qs, ks, vt, VS, wt);

  constexpr int KC = DHP / 16, NT = DHP / 8;
  for (int r0 = warp * 16; r0 < kpad; r0 += WARPS * 16) {
    uint32_t qf[1][KC][4];
    float o[1][NT][4], mrow[1][2], lrow[1][2];
    attn::q_frags_smem<DHP>(qf[0], qs, r0, lane);
    bf16* const kk[1] = {ks};
    bf16* const vv[1] = {vt};
    attn::head_chain<DHP, attn::FULL, 1>(qf, kk, vv, VS, N, kpad, A.scale, lane, o, mrow, lrow);
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = r0 + g + (q >> 1) * 8, d = i * 8 + 2 * t + (q & 1);
        const bf16 v = __float2bfloat16(o[0][i][q] / lrow[0][q >> 1]);
        if (PROJ) {
          qs[n * DS + d] = v;  // the warp's own q rows, already in its fragments
        } else if (n < N) {
          const int seg = d < 4 * D1 ? d / D1 : 4 + (d - 4 * D1) / DE;
          const int w = seg < 4 ? D1 : DE, c = seg < 4 ? d - seg * D1 : d - 4 * D1 - (seg - 4) * DE;
          A.out[seg][((size_t)b * N + n) * A.H * w + h * w + c] = v;
        }
      }
  }
  if constexpr (PROJ) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every head's attention output is in its CTA's shared memory
    proj_head(A, b, h, kpad, qs, wt);
    cluster.sync();  // no CTA leaves while another reads its shared memory
  }
}

int smem_bytes(int N, int C8, bool proj) {
  const int kpad = (N + 15) / 16 * 16;
  int w = NCOL_E * (2 * C8 + 8);
  if (proj) w = w > 4 * PCOL_A * (C8 + 8) + PCOL_E * (2 * C8 + 8)
                    ? w : 4 * PCOL_A * (C8 + 8) + PCOL_E * (2 * C8 + 8);
  return (2 * kpad * DS + DHP * (kpad + 8) + w) * 2;
}

int launch(Args& A, int B, bool proj, cudaStream_t stream) {
  if (A.C8 != A.H * D1 || A.C8 % 16 || (proj && A.H > 16)) return cudaErrorInvalidValue;
  A.scale = 1.0f / sqrtf(static_cast<float>(DHP));
  const int smem = smem_bytes(A.N, A.C8, proj);
  cudaError_t err;
  if (!proj) {
    err = cudaFuncSetAttribute(qkv_attention_kernel<0>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    qkv_attention_kernel<0><<<dim3(A.H, B), THREADS, smem, stream>>>(A);
    return cudaGetLastError();
  }
  auto kernel = qkv_attention_kernel<1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(A.H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = A.H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, A);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace qkv_attn
}  // namespace ovt

// x a1..b2 [B,N,C8] and ef [B,N,4*C8] contiguous, w1 [4,C8,3*C8], we
// [2*C8,6*C8], bias [3*C8] or null -> o1..o4 [B,N,C8], oe0, oe1 [B,N,2*C8]
// contiguous (d1 = 10: C8 = 10 H, a multiple of 16).
OVT_EXPORT int ovt_qkv_attention(const void* x1, const void* x2, const void* x3, const void* x4,
                                 const void* ef, const void* w1, const void* we, const void* bias,
                                 void* o1, void* o2, void* o3, void* o4, void* oe0, void* oe1,
                                 int B, int N, int H, int C8, void* stream) {
  ovt::qkv_attn::Args A = {};
  const void* xs[4] = {x1, x2, x3, x4};
  void* outs[6] = {o1, o2, o3, o4, oe0, oe1};
  for (int i = 0; i < 4; ++i) A.x[i] = static_cast<const ovt::bf16*>(xs[i]);
  for (int i = 0; i < 6; ++i) A.out[i] = static_cast<ovt::bf16*>(outs[i]);
  A.ef = static_cast<const ovt::bf16*>(ef);
  A.w1 = static_cast<const ovt::bf16*>(w1);
  A.we = static_cast<const ovt::bf16*>(we);
  A.bias = static_cast<const ovt::bf16*>(bias);
  A.N = N;
  A.H = H;
  A.C8 = C8;
  return ovt::qkv_attn::launch(A, B, false, static_cast<cudaStream_t>(stream));
}

// The same inputs and the proj's w1p [4,C8,C8], wep [2*C8,2*C8], biasp [C8] or
// null -> o1..o4 [B,N,C8], oef [B,N,4*C8] contiguous (H <= 16: one cluster of
// H CTAs an image).
OVT_EXPORT int ovt_qkv_attention_proj(const void* x1, const void* x2, const void* x3,
                                      const void* x4, const void* ef, const void* w1,
                                      const void* we, const void* bias, const void* w1p,
                                      const void* wep, const void* biasp, void* o1, void* o2,
                                      void* o3, void* o4, void* oef, int B, int N, int H, int C8,
                                      void* stream) {
  ovt::qkv_attn::Args A = {};
  const void* xs[4] = {x1, x2, x3, x4};
  void* outs[5] = {o1, o2, o3, o4, oef};
  for (int i = 0; i < 4; ++i) A.x[i] = static_cast<const ovt::bf16*>(xs[i]);
  for (int i = 0; i < 5; ++i) A.out[i] = static_cast<ovt::bf16*>(outs[i]);
  A.ef = static_cast<const ovt::bf16*>(ef);
  A.w1 = static_cast<const ovt::bf16*>(w1);
  A.we = static_cast<const ovt::bf16*>(we);
  A.bias = static_cast<const ovt::bf16*>(bias);
  A.w1p = static_cast<const ovt::bf16*>(w1p);
  A.wep = static_cast<const ovt::bf16*>(wep);
  A.biasp = static_cast<const ovt::bf16*>(biasp);
  A.N = N;
  A.H = H;
  A.C8 = C8;
  return ovt::qkv_attn::launch(A, B, true, static_cast<cudaStream_t>(stream));
}
