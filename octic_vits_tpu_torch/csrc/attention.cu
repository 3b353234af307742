// K-attn: softmax(Q K^T * scale) V for each (batch, head), with the head's
// channels gathered from the producer's natural layout and the output
// scattered back into the consumer's layout.
//
// Replaces
//   octic_vits_tpu/ops/pallas_attention.py:standard_attention
//     (`_std_fwd_kernel`): qkv [B,N,3C] in (3, H, dh) order -> [B,N,C];
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention (`_octic_fwd_kernel`)
//     and the attention half of octic_attention_fused_qkv (`_qkv_attn_store`,
//     `_group_attn_fwd`): head h's dh = 4*d1 + 2*de channels are a1|a2|b1|b2
//     at column (s*H + h)*d1 of the four 1-d qkv arrays [B,N,3C/8] plus
//     e0|e1 at column (s*H + h)*de of the two E rows [B,N,3C/4] (each with
//     its own row stride: on the train path they are the two column halves
//     of one flat-E qkv); the output goes back to 4 x [B,N,C/8] +
//     2 x [B,N,C/4] in irrep layout. The backward is csrc/attention_bwd.cu;
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention_wide1d
//     (`_octic_w1d_fwd_kernel`): head h's 1-d channels a1|a2|b1|b2 are ONE
//     4*d1 slice at column h*4*d1 of q1d, k1d or v1d [B,N,C/2] (three arrays,
//     one per s), its E channels as in octic_attention; the same six outputs;
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention_wide
//     (`_octic_wide_fwd_kernel`): head h's dh channels [a1|a2|b1|b2|e0|e1]
//     are one slice at column (s*H + h)*dh of one qkv [B,N,3C], the standard
//     layout's gather; the same six outputs.
// One kernel serves every layout: a gather table says where each segment of
// a head's channels lies (a base pointer per s, a row stride, a width and a
// head stride) and a scatter table where the output's segments go.
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
// ViT-H). Each segment is gathered with the widest load that it allows (16
// bytes for the standard and wide layouts and for the wide-1d layout's
// 80-byte 1-d slice, 8 bytes for the octic 40-byte E pieces, 4 bytes for its
// 20-byte 1-d pieces), so one narrow segment does not narrow the others,
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

// Where head h's dh channels of q (s = 0), k (1) and v (2) lie: segment i
// holds `width[i]` consecutive channels of the head at column h * hs[i] of
// the array p[i][s], whose token rows are ld[i][s] elements apart. The
// segments follow each other in the head's channel order.
struct Gather {
  int nseg;
  const bf16* p[MAX_SEG][3];
  int ld[MAX_SEG][3];
  int width[MAX_SEG], hs[MAX_SEG];
  int vec[MAX_SEG];  // elements per load of the segment: 8, 4, 2 or 1 (chosen by the host)
};

// Where head h's dh output channels go: segment i receives `width[i]`
// channels at column h * hs[i] of p[i], rows ld[i] apart.
struct Scatter {
  int nseg;
  bf16* p[MAX_SEG];
  int ld[MAX_SEG], width[MAX_SEG], hs[MAX_SEG];
};

struct Layout {
  Gather in;
  Scatter out;
  int N, H, dh;
  float scale;
};

// Gather one segment of q, k and v (`width` channels of each from src[s],
// the head's column in row 0 of batch 0, rows ld[s] apart) into channels
// [d_off, d_off + width) of q and k ([kpad][DS] rows) and, transposed, of v^T
// ([DHP][VS]); rows >= N are zero. One loop covers the three operands, so
// a narrow segment still keeps UNROLL loads of V elements in flight per
// thread. Consecutive threads take consecutive tokens, which keeps the
// transposed 2-byte stores into v^T free of bank conflicts.
template <int DHP, int V>
__device__ __forceinline__ void gather_seg(const bf16* const* src, const int* ld, int width,
                                           int d_off, int b, int N, int kpad, bf16* qs,
                                           bf16* ks, bf16* vt, int VS) {
  typedef typename VecOf<V>::T Vec;
  constexpr int DS = DHP + 8;
  const int per_s = kpad * (width / V), total = 3 * per_s;
  for (int base = threadIdx.x; base < total; base += THREADS * UNROLL) {
    Vec v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * THREADS;
      const int s = idx / per_s, r = idx - s * per_s;
      const int c = r / kpad, n = r - c * kpad;
      v[u] = Vec{};
      if (idx < total && n < N)
        v[u] = *reinterpret_cast<const Vec*>(src[s] + ((size_t)b * N + n) * ld[s] + c * V);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int idx = base + u * THREADS;
      if (idx >= total) continue;
      const int s = idx / per_s, r = idx - s * per_s;
      const int c = r / kpad, n = r - c * kpad, d0 = d_off + c * V;
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

// Gather q, k and v of head h (batch b) into shared memory: q and k as
// [kpad][DS] rows, v transposed as [DHP][VS]; rows >= N and channels >= dh
// are zero. Each segment takes its own load width.
template <int DHP>
__device__ __forceinline__ void gather_head(const Layout& L, int b, int h, int kpad, bf16* qs,
                                            bf16* ks, bf16* vt, int VS) {
  constexpr int DS = DHP + 8;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kpad * (DHP - L.dh); i += THREADS) {
    const int d = L.dh + i / kpad, n = i % kpad;
    qs[n * DS + d] = zero;
    ks[n * DS + d] = zero;
    vt[d * VS + n] = zero;
  }
  const Gather& G = L.in;
  int d_off = 0;
  for (int i = 0; i < G.nseg; ++i) {
    const bf16* src[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) src[s] = G.p[i][s] + (size_t)h * G.hs[i];
    const int w = G.width[i];
    switch (G.vec[i]) {
      case 8: gather_seg<DHP, 8>(src, G.ld[i], w, d_off, b, L.N, kpad, qs, ks, vt, VS); break;
      case 4: gather_seg<DHP, 4>(src, G.ld[i], w, d_off, b, L.N, kpad, qs, ks, vt, VS); break;
      case 2: gather_seg<DHP, 2>(src, G.ld[i], w, d_off, b, L.N, kpad, qs, ks, vt, VS); break;
      default: gather_seg<DHP, 1>(src, G.ld[i], w, d_off, b, L.N, kpad, qs, ks, vt, VS); break;
    }
    d_off += w;
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

  // output channel -> (scatter segment, channel within it)
  for (int d = tid; d < DHP; d += THREADS) {
    int i = 0, base = 0;
    while (i < L.out.nseg - 1 && d >= base + L.out.width[i]) base += L.out.width[i++];
    seg_of[d] = static_cast<unsigned char>(i);
    w_of[d] = static_cast<unsigned char>(d - base);
  }
  gather_head<DHP>(L, b, h, kpad, qs, ks, vt, VS);
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
          L.out.p[sg][((size_t)b * N + n) * L.out.ld[sg] + (size_t)h * L.out.hs[sg] + w_of[d]] =
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

// per gather segment, the widest load (elements) that its width, head
// stride, channel offset in the head, row strides and base addresses allow
void choose_vec(Gather& G) {
  int d_off = 0;
  for (int i = 0; i < G.nseg; ++i) {
    int v = 8;
    for (; v > 1; v /= 2) {
      bool ok = G.width[i] % v == 0 && G.hs[i] % v == 0 && d_off % v == 0;
      for (int s = 0; s < 3; ++s)
        ok = ok && G.ld[i][s] % v == 0 && reinterpret_cast<uintptr_t>(G.p[i][s]) % (2 * v) == 0;
      if (ok) break;
    }
    G.vec[i] = v;
    d_off += G.width[i];
  }
}

int dispatch(Layout& L, int B, cudaStream_t stream) {
  choose_vec(L.in);
  L.scale = 1.0f / sqrtf(static_cast<float>(L.dh));
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

// gather segment i: one array [B,N,3*H*width] in (3, H, width) column order
// (the standard and the octic layouts): the s-th block at column s*H*width
void set_gather_3h(Gather& G, int i, const void* p, int ld, int width, int H) {
  for (int s = 0; s < 3; ++s) {
    G.p[i][s] = static_cast<const bf16*>(p) + (size_t)s * H * width;
    G.ld[i][s] = ld;
  }
  G.width[i] = width;
  G.hs[i] = width;
}

// the octic scatter: o1..o4 [B,N,H*d1], oe0, oe1 [B,N,H*de], contiguous
void set_octic_scatter(Scatter& S, void* const* outs, int H, int d1, int de) {
  S.nseg = 6;
  for (int i = 0; i < 6; ++i) {
    const int w = i < 4 ? d1 : de;
    S.p[i] = static_cast<bf16*>(outs[i]);
    S.ld[i] = H * w;
    S.width[i] = w;
    S.hs[i] = w;
  }
}

}  // namespace attn
}  // namespace ovt

// qkv [B,N,3*H*dh] in (3, H, dh) column order -> out [B,N,H*dh]; bf16,
// contiguous. Returns the cudaError_t of the launch.
OVT_EXPORT int ovt_attention_std(const void* qkv, void* out, int B, int N, int H, int dh,
                                 void* stream) {
  ovt::attn::Layout L = {};
  L.in.nseg = 1;
  ovt::attn::set_gather_3h(L.in, 0, qkv, 3 * H * dh, dh, H);
  L.out.nseg = 1;
  L.out.p[0] = static_cast<ovt::bf16*>(out);
  L.out.ld[0] = H * dh;
  L.out.width[0] = dh;
  L.out.hs[0] = dh;
  L.N = N;
  L.H = H;
  L.dh = dh;
  return ovt::attn::dispatch(L, B, static_cast<cudaStream_t>(stream));
}

// Octic head layout, each input with its own token row stride (elements):
// q1..q4 [B,N,3*H*d1] (the 1-d qkv, (3, H, d1) column order), e0 and e1
// [B,N,3*H*de] (the two E rows, (3, H, de) order; on the train path they
// are the two halves of one flat-E qkv [B,N,6*H*de], so ld = 6*H*de);
// o1..o4 [B,N,H*d1], oe0, oe1 [B,N,H*de] contiguous. Head dim
// dh = 4*d1 + 2*de and the scale is dh^-0.5 (= (C/H)^-0.5).
OVT_EXPORT int ovt_attention_octic_rows(const void* q1, const void* q2, const void* q3,
                                        const void* q4, const void* e0, const void* e1, int ld1,
                                        int ld2, int ld3, int ld4, int lde0, int lde1, void* o1,
                                        void* o2, void* o3, void* o4, void* oe0, void* oe1, int B,
                                        int N, int H, int d1, int de, void* stream) {
  ovt::attn::Layout L = {};
  L.in.nseg = 6;
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lds[6] = {ld1, ld2, ld3, ld4, lde0, lde1};
  for (int i = 0; i < 6; ++i) ovt::attn::set_gather_3h(L.in, i, ins[i], lds[i], i < 4 ? d1 : de, H);
  void* const outs[6] = {o1, o2, o3, o4, oe0, oe1};
  ovt::attn::set_octic_scatter(L.out, outs, H, d1, de);
  L.N = N;
  L.H = H;
  L.dh = 4 * d1 + 2 * de;
  return ovt::attn::dispatch(L, B, static_cast<cudaStream_t>(stream));
}

// Wide-1d octic layout: q1d, k1d, v1d [B,N,4*H*d1] with columns (H, [a1|a2|
// b1|b2], d1), each with its own token row stride (they may be column views
// of one [B,N,12*H*d1] buffer); e0, e1 as in ovt_attention_octic_rows; the
// same six outputs.
OVT_EXPORT int ovt_attention_wide1d(const void* q1d, const void* k1d, const void* v1d,
                                    const void* e0, const void* e1, int ldq, int ldk, int ldv,
                                    int lde0, int lde1, void* o1, void* o2, void* o3, void* o4,
                                    void* oe0, void* oe1, int B, int N, int H, int d1, int de,
                                    void* stream) {
  ovt::attn::Layout L = {};
  L.in.nseg = 3;
  const void* one[3] = {q1d, k1d, v1d};
  const int ld1[3] = {ldq, ldk, ldv};
  for (int s = 0; s < 3; ++s) {
    L.in.p[0][s] = static_cast<const ovt::bf16*>(one[s]);
    L.in.ld[0][s] = ld1[s];
  }
  L.in.width[0] = 4 * d1;
  L.in.hs[0] = 4 * d1;
  ovt::attn::set_gather_3h(L.in, 1, e0, lde0, de, H);
  ovt::attn::set_gather_3h(L.in, 2, e1, lde1, de, H);
  void* const outs[6] = {o1, o2, o3, o4, oe0, oe1};
  ovt::attn::set_octic_scatter(L.out, outs, H, d1, de);
  L.N = N;
  L.H = H;
  L.dh = 4 * d1 + 2 * de;
  return ovt::attn::dispatch(L, B, static_cast<cudaStream_t>(stream));
}

// Wide octic layout: qkv [B,N,3*H*dh] contiguous with columns (3, H, [a1|a2|
// b1|b2|e0|e1]), dh = 4*d1 + 2*de (the standard layout's gather); the same six
// outputs as ovt_attention_octic_rows.
OVT_EXPORT int ovt_attention_wide(const void* qkv, void* o1, void* o2, void* o3, void* o4,
                                  void* oe0, void* oe1, int B, int N, int H, int d1, int de,
                                  void* stream) {
  ovt::attn::Layout L = {};
  const int dh = 4 * d1 + 2 * de;
  L.in.nseg = 1;
  ovt::attn::set_gather_3h(L.in, 0, qkv, 3 * H * dh, dh, H);
  void* const outs[6] = {o1, o2, o3, o4, oe0, oe1};
  ovt::attn::set_octic_scatter(L.out, outs, H, d1, de);
  L.N = N;
  L.H = H;
  L.dh = dh;
  return ovt::attn::dispatch(L, B, static_cast<cudaStream_t>(stream));
}
