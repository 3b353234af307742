// K-attn: softmax(Q K^T * scale) V for each (batch, head), with the head's
// channels gathered from the producer's natural layout and the output
// scattered back into the consumer's layout.
//
// Replaces
//   octic_vits_tpu/ops/pallas_attention.py:standard_attention
//     (`_std_fwd_kernel`): qkv [B,N,3C] in (3, H, dh) order -> [B,N,C];
//   the attention half of octic_attention_fused_qkv
//     (`_qkv_attn_store`, `_group_attn_fwd`): head h's dh = 4*d1 + 2*de
//     channels are a1|a2|b1|b2 at column (s*H + h)*d1 of the four 1-d qkv
//     arrays [B,N,3C/8] plus e0|e1 at column (s*H + h)*de of the two E rows
//     of the flat-E qkv [B,N,3C/2] = [row0 | row1]; the output goes back
//     to 4 x [B,N,C/8] + 2 x [B,N,C/4] in irrep layout.
//
// What bounds it on the H100: at ViT-H/14, B=64 (N = 257, H = 16, dh = 80)
// one layer is 2 * 2 * 64*16 * 257^2 * 80 = 10.8 GFLOP over 126 MB of qkv:
// ~86 FLOP per byte, below the ridge, and each head's data is small and
// (in octic mode) cut into 20- and 40-byte pieces that are not 16-byte
// aligned. So the gather and the latency of many small CTAs matter more
// than the MMA rate.
//
// What the design does about it: one CTA of 8 warps per (head, batch)
// gathers the head's q, k and v^T once into shared memory (any head layout,
// zero-padded to a multiple of 16 tokens and of 16 channels; 141 KB at
// ViT-H). The gather uses the widest load every segment allows (16 bytes
// for the standard layout, 4 bytes for the octic 20- and 40-byte pieces)
// with four loads in flight per thread: a first version that gathered with
// one dependent 2-byte load per loop trip, 5 times per head, was bound by
// load latency (3.2 ms per layer at ViT-H B=64, PERF.md). One head's whole
// [257, 257] f32 score tile (264 KB) would not fit, so each warp takes 16
// query rows at a time and runs an online softmax over 64-key blocks
// (FlashAttention-2 style) with scores, probabilities and output kept in
// m16n8k16 MMA fragments in registers. Scores and the softmax are f32; the
// probabilities are rounded to bf16 only as the P.V operand.
#include <math_constants.h>

#include "common.cuh"

namespace ovt {
namespace attn {

constexpr int WARPS = 8, THREADS = WARPS * 32, KB = 64, UNROLL = 4;
constexpr int MAX_SEG = 6;

struct Layout {
  int nseg;
  const bf16* in[MAX_SEG];
  int in_ld[MAX_SEG];  // token row stride of the input segment
  bf16* out[MAX_SEG];
  int out_ld[MAX_SEG];  // token row stride of the output segment
  int width[MAX_SEG];   // channels of one head in this segment
  int N, H, dh;
  int vec;  // elements per gather load: 8, 4, 2 or 1 (chosen by the host)
  float scale;
};

template <int V>
struct VecOf;
template <>
struct VecOf<8> {
  typedef uint4 T;
};
template <>
struct VecOf<4> {
  typedef uint2 T;
};
template <>
struct VecOf<2> {
  typedef uint32_t T;
};
template <>
struct VecOf<1> {
  typedef unsigned short T;
};

// Gather q, k and v of head h (batch b) into shared memory: q and k as
// [kpad][DS] rows, v transposed as [DHP][VS]; rows >= N and channels >= dh
// are zero. Loads are V elements wide (V divides every segment width, row
// stride and base offset) and UNROLL of them are in flight per thread.
// Consecutive threads take consecutive tokens, which keeps the transposed
// 2-byte stores into v^T free of bank conflicts.
template <int DHP, int V>
__device__ __forceinline__ void gather_head(const Layout& L, const unsigned char* seg_of,
                                            const unsigned char* w_of, int b, int h, int kpad,
                                            bf16* qs, bf16* ks, bf16* vt, int VS) {
  typedef typename VecOf<V>::T Vec;
  constexpr int DS = DHP + 8, CPR = DHP / V;
  const int total = kpad * CPR;
  for (int s = 0; s < 3; ++s) {
    for (int base = threadIdx.x; base < total; base += THREADS * UNROLL) {
      Vec v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = base + u * THREADS;
        const int c = idx / kpad, n = idx - c * kpad, d0 = c * V;
        v[u] = Vec{};
        if (idx < total && n < L.N && d0 < L.dh) {
          const int i = seg_of[d0];
          v[u] = *reinterpret_cast<const Vec*>(
              L.in[i] + ((size_t)b * L.N + n) * L.in_ld[i] +
              (size_t)(s * L.H + h) * L.width[i] + w_of[d0]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = base + u * THREADS;
        if (idx >= total) continue;
        const int c = idx / kpad, n = idx - c * kpad, d0 = c * V;
        if (s == 2) {
          const bf16* e = reinterpret_cast<const bf16*>(&v[u]);
#pragma unroll
          for (int i = 0; i < V; ++i) vt[(d0 + i) * VS + n] = e[i];
        } else {
          *reinterpret_cast<Vec*>((s == 0 ? qs : ks) + n * DS + d0) = v[u];
        }
      }
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(THREADS) attention_kernel(const Layout L) {
  constexpr int DS = DHP + 8;  // q and k smem row stride (bank-conflict-free 32-bit loads)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = L.N, dh = L.dh;
  const int kpad = (N + 15) / 16 * 16;
  const int VS = kpad + 8;  // v^T smem row stride
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = ks + kpad * DS;
  bf16* vt = qs + kpad * DS;
  unsigned char* seg_of = reinterpret_cast<unsigned char*>(vt + DHP * VS);
  unsigned char* w_of = seg_of + DHP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;

  for (int d = tid; d < DHP; d += THREADS) {
    int i = 0, base = 0;
    while (i < L.nseg - 1 && d >= base + L.width[i]) base += L.width[i++];
    seg_of[d] = static_cast<unsigned char>(i);
    w_of[d] = static_cast<unsigned char>(d - base);
  }
  __syncthreads();
  switch (L.vec) {
    case 8: gather_head<DHP, 8>(L, seg_of, w_of, b, h, kpad, qs, ks, vt, VS); break;
    case 4: gather_head<DHP, 4>(L, seg_of, w_of, b, h, kpad, qs, ks, vt, VS); break;
    case 2: gather_head<DHP, 2>(L, seg_of, w_of, b, h, kpad, qs, ks, vt, VS); break;
    default: gather_head<DHP, 1>(L, seg_of, w_of, b, h, kpad, qs, ks, vt, VS); break;
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  constexpr int KC = DHP / 16, NT = DHP / 8;
  const float sl2 = L.scale * 1.4426950408889634f;  // softmax in base 2

  // each warp owns 16 query rows at a time
  for (int r0 = warp * 16; r0 < kpad; r0 += WARPS * 16) {
    uint32_t qf[KC][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const bf16* p = qs + (r0 + g) * DS + kc * 16 + 2 * t;
      qf[kc][0] = *reinterpret_cast<const uint32_t*>(p);
      qf[kc][1] = *reinterpret_cast<const uint32_t*>(p + 8 * DS);
      qf[kc][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      qf[kc][3] = *reinterpret_cast<const uint32_t*>(p + 8 * DS + 8);
    }

    float o[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float lrow[2] = {0.f, 0.f};

    for (int kb = 0; kb < kpad; kb += KB) {
      // every block holds at least one real key (kpad - 16 < N), so the
      // running max stays finite
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        if (kb + nt * 8 < kpad) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            const bf16* p = ks + (kb + nt * 8 + g) * DS + kc * 16 + 2 * t;
            mma_bf16(s[nt], qf[kc], *reinterpret_cast<const uint32_t*>(p),
                     *reinterpret_cast<const uint32_t*>(p + 8));
          }
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + nt * 8 + 2 * t + (e & 1);
          s[nt][e] = key < N ? s[nt][e] * sl2 : -CUDART_INF_F;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mnew = fmaxf(mrow[r], mx[r]);
        alpha[r] = exp2f(mrow[r] - mnew);
        mrow[r] = mnew;
        lrow[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - mrow[e >> 1]);
          lrow[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        o[i][0] *= alpha[0];
        o[i][1] *= alpha[0];
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
#pragma unroll
      for (int kc = 0; kc < KB / 16; ++kc) {
        if (kb + kc * 16 >= kpad) break;
        uint32_t pf[4];
        pf[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
        pf[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
        pf[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pf[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const bf16* p = vt + (i * 8 + g) * VS + kb + kc * 16 + 2 * t;
          mma_bf16(o[i], pf, *reinterpret_cast<const uint32_t*>(p),
                   *reinterpret_cast<const uint32_t*>(p + 8));
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
      lrow[r] = 1.f / lrow[r];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = r0 + g + (e >> 1) * 8;
        const int d = i * 8 + 2 * t + (e & 1);
        if (n < N && d < dh) {
          const int sg = seg_of[d];
          L.out[sg][((size_t)b * N + n) * L.out_ld[sg] + (size_t)h * L.width[sg] + w_of[d]] =
              __float2bfloat16(o[i][e] * lrow[e >> 1]);
        }
      }
  }
}

template <int DHP>
int launch(const Layout& L, int B, cudaStream_t stream) {
  const int kpad = (L.N + 15) / 16 * 16;
  const int smem = (2 * kpad * (DHP + 8) + DHP * (kpad + 8)) * 2 + 2 * DHP;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attention_kernel<DHP><<<dim3(L.H, B), THREADS, smem, stream>>>(L);
  return cudaGetLastError();
}

// widest gather load (elements) that every input segment's width, row
// stride and base address allow
void choose_vec(Layout& L) {
  for (int v = 8; v > 1; v /= 2) {
    bool ok = true;
    for (int i = 0; i < L.nseg; ++i)
      ok = ok && L.width[i] % v == 0 && L.in_ld[i] % v == 0 &&
           reinterpret_cast<uintptr_t>(L.in[i]) % (2 * v) == 0;
    if (ok) {
      L.vec = v;
      return;
    }
  }
  L.vec = 1;
}

int dispatch(Layout& L, int B, cudaStream_t stream) {
  choose_vec(L);
  const int dhp = (L.dh + 15) / 16 * 16;
  switch (dhp) {
    case 16: return launch<16>(L, B, stream);
    case 32: return launch<32>(L, B, stream);
    case 48: return launch<48>(L, B, stream);
    case 64: return launch<64>(L, B, stream);
    case 80: return launch<80>(L, B, stream);
    case 96: return launch<96>(L, B, stream);
    case 128: return launch<128>(L, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace ovt

// qkv [B,N,3*H*dh] in (3, H, dh) column order -> out [B,N,H*dh]; bf16,
// contiguous. Returns the cudaError_t of the launch.
OVT_EXPORT int ovt_attention_std(const void* qkv, void* out, int B, int N, int H, int dh,
                                 void* stream) {
  ovt::attn::Layout L = {};
  L.nseg = 1;
  L.in[0] = static_cast<const ovt::bf16*>(qkv);
  L.in_ld[0] = 3 * H * dh;
  L.out[0] = static_cast<ovt::bf16*>(out);
  L.out_ld[0] = H * dh;
  L.width[0] = dh;
  L.N = N;
  L.H = H;
  L.dh = dh;
  L.scale = 1.0f / sqrtf(static_cast<float>(dh));
  return ovt::attn::dispatch(L, B, static_cast<cudaStream_t>(stream));
}

// Octic head layout. q1..q4 [B,N,3*H*d1] (the 1-d qkv, (3, H, d1) order),
// qef [B,N,6*H*de] = [row0 | row1], each row in (3, H, de) order;
// o1..o4 [B,N,H*d1], oe0, oe1 [B,N,H*de]. Head dim dh = 4*d1 + 2*de and
// the scale is dh^-0.5 (= (C/H)^-0.5).
OVT_EXPORT int ovt_attention_octic(const void* q1, const void* q2, const void* q3,
                                   const void* q4, const void* qef, void* o1, void* o2, void* o3,
                                   void* o4, void* oe0, void* oe1, int B, int N, int H, int d1,
                                   int de, void* stream) {
  using ovt::bf16;
  ovt::attn::Layout L = {};
  L.nseg = 6;
  const void* ins[4] = {q1, q2, q3, q4};
  void* outs[4] = {o1, o2, o3, o4};
  for (int i = 0; i < 4; ++i) {
    L.in[i] = static_cast<const bf16*>(ins[i]);
    L.in_ld[i] = 3 * H * d1;
    L.out[i] = static_cast<bf16*>(outs[i]);
    L.out_ld[i] = H * d1;
    L.width[i] = d1;
  }
  const int row = 3 * H * de;
  L.in[4] = static_cast<const bf16*>(qef);
  L.in[5] = static_cast<const bf16*>(qef) + row;
  L.in_ld[4] = L.in_ld[5] = 2 * row;
  L.out[4] = static_cast<bf16*>(oe0);
  L.out[5] = static_cast<bf16*>(oe1);
  L.out_ld[4] = L.out_ld[5] = H * de;
  L.width[4] = L.width[5] = de;
  L.N = N;
  L.H = H;
  L.dh = 4 * d1 + 2 * de;
  L.scale = 1.0f / sqrtf(static_cast<float>(L.dh));
  return ovt::attn::dispatch(L, B, static_cast<cudaStream_t>(stream));
}
