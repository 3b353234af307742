// K-attn, standard forward: softmax(Q K^T * dh^-0.5) V for each (batch,
// head), on TMA + wgmma.
//
// Replaces octic_vits_tpu/ops/pallas_attention.py:standard_attention
// (`_std_fwd_kernel`): qkv [B,N,3C] in (3, H, dh) column order -> [B,N,C].
// Scores and the softmax are f32; the probabilities are rounded to bf16 only
// as the P.V operand. The backward (csrc/attention_bwd.cu) recomputes its
// own statistics, so this kernel writes nothing else. The device code is
// csrc/attention_std_core.cuh, which the octic layouts (csrc/attention_octic.cu)
// share.
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
#include "attention_std_core.cuh"

namespace ovt {
namespace attn_std {
namespace {

template <int DH>
int std_dispatch(const void* qkv, void* out, int B, int N, int H, int grid, int smem,
                 const int* widths, int nboxes, cudaStream_t st) {
  Geo geo = {};
  const int err = std_geo<DH>(geo, qkv, B, N, H, widths, nboxes);
  if (err != 0) return err;
  return run<DH, STD>(geo, out, B, N, H, DH, grid, smem, st);
}

}  // namespace
}  // namespace attn_std
}  // namespace ovt

#define OVT_STD_CASES(CALL)                                                      \
  CALL(8) CALL(16) CALL(24) CALL(32) CALL(40) CALL(48) CALL(56) CALL(64) CALL(72) \
      CALL(80) CALL(88) CALL(96) CALL(104) CALL(112) CALL(120) CALL(128)

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
    return std_dispatch<D>(qkv, out, B, N, H, grid, smem, widths, nboxes, st);
    OVT_STD_CASES(OVT_STD_CASE)
#undef OVT_STD_CASE
    default:
      return ovt::ERR_PLAN;
  }
}

