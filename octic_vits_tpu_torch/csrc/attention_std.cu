// K-attn, standard forward: softmax(Q K^T * dh^-0.5) V for each (batch,
// head), on TMA + wgmma.
//
// Replaces octic_vits_tpu/ops/pallas_attention.py:standard_attention
// (`_std_fwd_kernel`): qkv [B,N,3C] in (3, H, dh) column order -> [B,N,C].
// Scores and the softmax are f32; the probabilities are rounded to bf16 only
// as the P.V operand. The backward (csrc/attention_bwd.cu) recomputes its
// own statistics, so this kernel writes nothing else. The octic layouts keep
// K-attn's whole-head core (csrc/attention_core.cuh).
//
// What bounds it on the H100: at ViT-H/14, B=64 (N = 257, H = 16, dh = 80)
// one layer reads 126 MB of qkv and writes 42 MB for 21.7 GFLOP of
// products: ~130 FLOP per byte, below the card's ridge, so HBM bounds it
// (0.050 ms at 3.35 TB/s). The whole-head core it replaces staged a head
// before its first product, with one CTA an SM, so its loads overlapped
// nothing (46% of its time, PERF.md).
//
// What the design does about it: one CTA for each (batch, head, 64-query
// tile), small enough that two or three CTAs share an SM and one's loads
// overlap another's products. A producer warp issues TMA loads of the
// query tile and streams the head's keys and values through a ring of
// 64-key tiles (3-D tensor maps over (3C, N, B), so a tile never reads the
// next image's rows: rows >= N arrive as zeros). One consumer warpgroup runs
// S = Q K^T as m64n64k16 wgmmas with both operands in shared memory, the
// online softmax on the f32 accumulators in registers, and P.V as wgmmas
// with P from registers and V MN-major in shared memory (the transpose bit).
// A head's dh columns are loaded as boxes of 64, 32, 16 and 8 columns with
// the 128-, 64- and 32-byte swizzles (dh = 80: 64 + 16), each k step of
// Q K^T and each box of P.V with its own descriptor; an 8-column tail
// (dh % 16 == 8) is an unswizzled box whose k partner is a zeroed block.
// When N - 1 is a multiple of 64 (N = 257 at 224^2 / 14), key N - 1 is
// folded in as a rank-1 f32 update on the CUDA cores before the first tile
// (its score a dot product with the query rows in shared memory, its
// probability never rounded), so the key tiles end at N - 1 and no tile
// holds a single real key. The producer warp's other lanes copy key and
// value N - 1 into shared memory beside the TMA loads: read from device
// memory by the consumers, their two dependent loads delayed every CTA's
// first product. Query row N - 1
// keeps a 64-row tile of its own (a fifth of the CTAs at N = 257): carried
// on the CUDA cores instead, by extra warps or by the CTA of the head's last
// full tile, it made the whole forward slower, not faster (PERF.md).
#include <math_constants.h>

#include "sm90.cuh"

namespace ovt {
namespace attn_std {

using namespace sm90;

constexpr int ROWS = 64;  // query rows a CTA, keys a tile
constexpr int STAGES = 3;
constexpr int THREADS = 160;  // one consumer warpgroup + the producer warp
constexpr int LAST = 512;     // key and value N - 1 (bf16, dh <= 128)

// A head's columns as boxes, widest first: ops/attention.py:std_attention_boxes
__host__ __device__ constexpr int box_greedy(int rem) {
  return rem >= 64 ? 64 : rem >= 32 ? 32 : rem >= 16 ? 16 : rem >= 8 ? 8 : 0;
}
__host__ __device__ constexpr int box_off(int dh, int j) {
  int off = 0;  // a loop, not a recursion: device code inlines and folds it
  for (int i = 0; i < j; ++i) off += box_greedy(dh - off);
  return off;
}
__host__ __device__ constexpr int box_w(int dh, int j) { return box_greedy(dh - box_off(dh, j)); }
__host__ __device__ constexpr int num_boxes(int dh) {
  return box_w(dh, 0) == 0 ? 0 : box_w(dh, 1) == 0 ? 1 : box_w(dh, 2) == 0 ? 2
                                 : box_w(dh, 3) == 0 ? 3 : 4;
}
// the box holding column d
__host__ __device__ constexpr int box_of(int dh, int d) {
  return d < box_off(dh, 1) || num_boxes(dh) == 1 ? 0
         : d < box_off(dh, 2) || num_boxes(dh) == 2 ? 1
         : d < box_off(dh, 3) || num_boxes(dh) == 3 ? 2 : 3;
}

template <int DH>
struct Cfg {
  static constexpr int NB = num_boxes(DH);
  static constexpr int TILE = ROWS * DH * 2;  // bytes of one operand tile; box j at 128 * off_j
  static constexpr bool TAIL = DH % 16 != 0;  // an 8-column box ends the head
  static constexpr int KSTEPS = (DH + 15) / 16;
  static constexpr int ZERO = TAIL ? ROWS * 16 : 0;  // the tail's zeroed k partner
  // align slack, Q, STAGES x (K, V), the zero block, key and value N - 1,
  // barriers (Q, key N - 1, K full, V full, empty)
  static constexpr int SMEM = 1024 + TILE * (1 + 2 * STAGES) + ZERO + LAST + (2 + 3 * STAGES) * 8;
  static constexpr int MINB = DH <= 96 ? 3 : 2;  // CTAs an SM
};

struct Maps {
  CUtensorMap m[4];  // one per box width 64, 32, 16, 8 (those the head uses)
};

__host__ __device__ constexpr int map_index(int w) {
  return w == 64 ? 0 : w == 32 ? 1 : w == 16 ? 2 : 3;
}

// TMA one 64-row operand tile (every box of the head) into `dst`
template <int DH>
__device__ __forceinline__ void load_tile(uint8_t* dst, const Maps& maps, uint64_t* bar, int col,
                                          int row, int b) {
#pragma unroll
  for (int j = 0; j < Cfg<DH>::NB; ++j)
    tma_load_3d(dst + 128 * box_off(DH, j), &maps.m[map_index(box_w(DH, j))], bar,
                col + box_off(DH, j), row, b);
}

// K-major descriptor of k step kk (columns 16 kk .. 16 kk + 15) of a Q or K tile
template <int DH>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk, uint32_t zero) {
  const int j = box_of(DH, 16 * kk), off = box_off(DH, j), w = box_w(DH, j);
  const uint32_t base = tile + 128 * off;
  if (w == 8) return make_desc(base, zero - base, 128, SW_NONE);
  return make_desc(base + 2 * (16 * kk - off), 16, 16 * w, w == 64 ? SW_128 : w == 32 ? SW_64
                                                                                    : SW_32);
}

// MN-major descriptor of box j of a V tile at keys 16 kk .. 16 kk + 15
template <int DH>
__device__ __forceinline__ uint64_t vdesc(uint32_t tile, int j, int kk) {
  const int w = box_w(DH, j);
  const uint32_t base = tile + 128 * box_off(DH, j) + kk * 16 * 2 * w;
  if (w == 8) return make_desc(base, 128, 128, SW_NONE);
  return make_desc(base, 16, 16 * w, w == 64 ? SW_128 : w == 32 ? SW_64 : SW_32);
}

// o += P V over the four k steps of one key tile, box by box (at most four
// boxes; a box past the head's last is a discarded branch)
template <int DH>
__device__ __forceinline__ void pv_product(float* o, const uint32_t (&pa)[4][4], uint32_t vt) {
  constexpr int NB = Cfg<DH>::NB;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (NB > 0)
      wgmma_rs_t<box_w(DH, 0)>(o + box_off(DH, 0) / 2, pa[kk], vdesc<DH>(vt, 0, kk), 1);
    if constexpr (NB > 1)
      wgmma_rs_t<box_w(DH, 1)>(o + box_off(DH, 1) / 2, pa[kk], vdesc<DH>(vt, 1, kk), 1);
    if constexpr (NB > 2)
      wgmma_rs_t<box_w(DH, 2)>(o + box_off(DH, 2) / 2, pa[kk], vdesc<DH>(vt, 2, kk), 1);
    if constexpr (NB > 3)
      wgmma_rs_t<box_w(DH, 3)>(o + box_off(DH, 3) / 2, pa[kk], vdesc<DH>(vt, 3, kk), 1);
  }
}

__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// Byte offset of the 16-byte chunk of row r holding columns d .. d + 7 (d a
// multiple of 8) in a Q or K tile: the box's rows as TMA wrote them, the
// chunks XORed with the row's place in the swizzle pattern (none in the
// 8-column box)
template <int DH>
__device__ __forceinline__ uint32_t chunk_offset(int r, int d) {
  const int j = box_of(DH, d), off = box_off(DH, j), w = box_w(DH, j), rb = 2 * w;
  const int sw = w >= 16 ? ((r * rb) >> 7) & (rb / 16 - 1) : 0;
  return 128 * off + r * rb + ((((d - off) >> 3) ^ sw) << 4);
}

// q_row . k in f32 for row r of the Q tile in shared memory and key k (bf16,
// shared memory), the lane quad splitting the head's 16-byte chunks
template <int DH>
__device__ __forceinline__ float quad_dot(uint32_t q_s, int r, const bf16* k, int q) {
  float s = 0.f;
#pragma unroll
  for (int c = q; c < DH / 8; c += 4) {
    uint4 qv;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(qv.x), "=r"(qv.y), "=r"(qv.z), "=r"(qv.w)
                 : "r"(q_s + chunk_offset<DH>(r, 8 * c)));
    s += dot8(qv, *reinterpret_cast<const uint4*>(k + 8 * c));
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// issue sc = Q K^T of one key tile (m64n64, one wgmma a k16 step)
template <int DH>
__device__ __forceinline__ void scores(float (&sc)[32], uint32_t q_s, uint32_t k_s, uint32_t z_s) {
#pragma unroll
  for (int kk = 0; kk < Cfg<DH>::KSTEPS; ++kk)
    wgmma_ss<64>(sc, kdesc<DH>(q_s, kk, z_s), kdesc<DH>(k_s, kk, z_s), kk);
}

// The online softmax of one key tile's scores (rows g and g + 8 of the
// warp's 16; keys >= Nk masked): new row maxima m, sums l, P as the A
// fragments of P.V's four k16 steps; returns the rows' rescale factors.
__device__ __forceinline__ float2 softmax_tile(float (&sc)[32], uint32_t (&pa)[4][4], float& m0,
                                               float& m1, float& l0, float& l1, int kbase, int Nk,
                                               int q, float scale_log2) {
  if (kbase + ROWS > Nk) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (kbase + 8 * (i / 4) + 2 * q + (i & 1) >= Nk) sc[i] = -CUDART_INF_F;
  }
  float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    x0 = fmaxf(x0, fmaxf(sc[4 * c], sc[4 * c + 1]));
    x1 = fmaxf(x1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
  }
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  const float n0 = fmaxf(m0, x0 * scale_log2), n1 = fmaxf(m1, x1 * scale_log2);
  const float2 alpha = make_float2(exp2f(m0 - n0), exp2f(m1 - n1));
  m0 = n0;
  m1 = n1;
  float t0 = 0.f, t1 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sc[4 * c] = exp2f(fmaf(sc[4 * c], scale_log2, -n0));
    sc[4 * c + 1] = exp2f(fmaf(sc[4 * c + 1], scale_log2, -n0));
    sc[4 * c + 2] = exp2f(fmaf(sc[4 * c + 2], scale_log2, -n1));
    sc[4 * c + 3] = exp2f(fmaf(sc[4 * c + 3], scale_log2, -n1));
    t0 += sc[4 * c] + sc[4 * c + 1];
    t1 += sc[4 * c + 2] + sc[4 * c + 3];
  }
  l0 = fmaf(l0, alpha.x, t0);
  l1 = fmaf(l1, alpha.y, t1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  return alpha;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, Cfg<DH>::MINB)
    std_attention_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ qkv,
                         bf16* __restrict__ out, int N, int H, int QT, int KT, int Nk,
                         float scale_log2) {
  using Cf = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* qs = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* zero = qs + Cf::TILE * (1 + 2 * STAGES);
  bf16* last = reinterpret_cast<bf16*>(zero + Cf::ZERO);  // key and value N - 1
  uint64_t* qbar = reinterpret_cast<uint64_t*>(zero + Cf::ZERO + LAST);
  uint64_t* lastbar = qbar + 1;
  uint64_t* kfull = lastbar + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  const int qt = blockIdx.x % QT, bh = blockIdx.x / QT, h = bh % H, b = bh / H;
  const int C = H * DH;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    mbar_init(lastbar, 31);  // producer lanes 1-31
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  if (Cf::TAIL && threadIdx.x < Cf::ZERO / 8) {
    reinterpret_cast<uint2*>(zero)[threadIdx.x] = make_uint2(0u, 0u);
    fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: lane 0 loads the query tile and streams the key
    // and value tiles through the ring; lanes 1-31 copy key and value N - 1
    // for the rank-1 update
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, Cf::TILE);
      load_tile<DH>(qs, maps, qbar, h * DH, qt * ROWS, b);
    }
    if (Nk < N && lane > 0) {  // lanes 1-31, so lane 0 goes straight on to the ring
      const bf16* kl = qkv + ((size_t)b * N + N - 1) * 3 * C + C + h * DH;
      for (int c = lane - 1; c < DH / 4; c += 31)  // DH / 8 chunks of k, then of v (= k + C)
        reinterpret_cast<uint4*>(last)[c] =
            *reinterpret_cast<const uint4*>(kl + (c < DH / 8 ? 8 * c : C + 8 * (c - DH / 8)));
      mbar_arrive(lastbar);
    }
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        uint8_t* kv = qs + Cf::TILE * (1 + 2 * s);
        mbar_arrive_expect_tx(&kfull[s], Cf::TILE);
        load_tile<DH>(kv, maps, &kfull[s], C + h * DH, kt * ROWS, b);
        mbar_arrive_expect_tx(&vfull[s], Cf::TILE);
        load_tile<DH>(kv + Cf::TILE, maps, &vfull[s], 2 * C + h * DH, kt * ROWS, b);
      }
    }
  } else {
    // ---- consumer warpgroup: rows r0 = 16 warp + g and r0 + 8 of the tile
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, q = lane & 3;
    const int r0 = qt * ROWS + warp * 16 + (lane >> 2), r1 = r0 + 8;
    const uint32_t q_s = smem_addr(qs), z_s = smem_addr(zero);
    float o[DH / 2];
    float m0, m1, l0, l1;
    mbar_wait(qbar, 0);
    if (Nk < N) {
      // key N - 1 as a rank-1 update: p = exp2(s - m) = 1 at m = s, so o = v
      mbar_wait(lastbar, 0);
      const float s0 = quad_dot<DH>(q_s, r0 - qt * ROWS, last, q);
      const float s1 = quad_dot<DH>(q_s, r1 - qt * ROWS, last, q);
      m0 = s0 * scale_log2;
      m1 = s1 * scale_log2;
      l0 = l1 = q == 0 ? 1.f : 0.f;  // the row sum is taken over the quad at the end
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(last + DH + 8 * (i / 4) + 2 * q));
        o[i] = o[i + 2] = v.x;
        o[i + 1] = o[i + 3] = v.y;
      }
    } else {
      m0 = m1 = -CUDART_INF_F;
      l0 = l1 = 0.f;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    }

    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      const uint32_t ph = (kt / STAGES) & 1;
      const uint32_t k_s = q_s + Cf::TILE * (1 + 2 * s), v_s = k_s + Cf::TILE;
      float sc[32];
      uint32_t pa[4][4];
      mbar_wait(&kfull[s], ph);
      wgmma_fence();
      scores<DH>(sc, q_s, k_s, z_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(sc);
      const float2 alpha = softmax_tile(sc, pa, m0, m1, l0, l1, kt * ROWS, Nk, q, scale_log2);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
      mbar_wait(&vfull[s], ph);
      fence_regs<DH / 2>(o);
      wgmma_fence();
      pv_product<DH>(o, pa, v_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DH / 2>(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    bf16* o0 = out + ((size_t)b * N + r0) * C + h * DH;
    bf16* o1 = o0 + (size_t)8 * C;
#pragma unroll
    for (int i = 0; i < DH / 2; i += 4) {
      const int col = 8 * (i / 4) + 2 * q;
      if (r0 < N) *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16x2(o[i] * i0, o[i + 1] * i0);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16x2(o[i + 2] * i1, o[i + 3] * i1);
    }
  }
}

// One launch at head width DH after checking the caller's plan against this
// instantiation's.
template <int DH>
int launch(const void* qkv, void* out, int B, int N, int H, int grid, int smem, const int* widths,
           int nboxes, cudaStream_t stream) {
  using Cf = Cfg<DH>;
  const int split = N > 1 && (N - 1) % ROWS == 0;
  const int Nk = N - split, QT = (N + ROWS - 1) / ROWS;
  const int KT = (Nk + ROWS - 1) / ROWS;
  bool ok = smem == Cf::SMEM && nboxes == Cf::NB && (long long)grid == (long long)B * H * QT;
  for (int j = 0; ok && j < nboxes; ++j) ok = widths[j] == box_w(DH, j);
  if (!ok) return ERR_PLAN;
  Maps maps = {};
  const uint64_t C = (uint64_t)H * DH;
  const uint64_t dims[3] = {3 * C, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {3 * C * 2, 3 * C * 2 * N};
  for (int j = 0; j < Cf::NB; ++j) {
    const int w = box_w(DH, j);
    const uint32_t box[3] = {(uint32_t)w, ROWS, 1};
    const int err = encode_bf16_map(&maps.m[map_index(w)], qkv, 3, dims, strides, box,
                                    w >= 16 ? 2 * w : 0);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(std_attention_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return err;
  std_attention_kernel<DH><<<grid, THREADS, Cf::SMEM, stream>>>(
      maps, static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, H, QT, KT, Nk,
      1.4426950408889634f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace attn_std
}  // namespace ovt

// qkv [B,N,3*H*dh] in (3, H, dh) column order -> out [B,N,H*dh]; bf16,
// contiguous, 16-byte aligned, dh a multiple of 8 up to 128. The launch
// plan (ops/attention.py:std_attention_plan): `grid` CTAs (B * H * query
// tiles), `smem` bytes, the head's `nboxes` column boxes of widths w0..w3;
// it must be this kernel's. Returns the cudaError_t of the launch or an
// ERR_* code.
OVT_EXPORT int ovt_attention_std(const void* qkv, void* out, int B, int N, int H, int dh,
                                 int grid, int smem, int nboxes, int w0, int w1, int w2, int w3,
                                 void* stream) {
  using namespace ovt::attn_std;
  const int widths[4] = {w0, w1, w2, w3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
#define OVT_STD_CASE(D) \
  case D:               \
    return launch<D>(qkv, out, B, N, H, grid, smem, widths, nboxes, st);
    OVT_STD_CASE(8) OVT_STD_CASE(16) OVT_STD_CASE(24) OVT_STD_CASE(32)
    OVT_STD_CASE(40) OVT_STD_CASE(48) OVT_STD_CASE(56) OVT_STD_CASE(64)
    OVT_STD_CASE(72) OVT_STD_CASE(80) OVT_STD_CASE(88) OVT_STD_CASE(96)
    OVT_STD_CASE(104) OVT_STD_CASE(112) OVT_STD_CASE(120) OVT_STD_CASE(128)
#undef OVT_STD_CASE
    default:
      return ovt::ERR_PLAN;
  }
}
