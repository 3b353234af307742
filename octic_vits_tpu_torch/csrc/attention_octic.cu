// K-attn's octic forward on TMA + wgmma: softmax(Q K^T * dh^-0.5) V over each
// head's dh = 4*d1 + 2*de channels [a1|a2|b1|b2|e0|e1], the output split into
// the six irrep arrays o1..o4 [B,N,H*d1] and oe0, oe1 [B,N,H*de].
//
// Replaces octic_vits_tpu/ops/pallas_attention.py:octic_attention (`_octic_
// fwd_kernel`), the attention half of octic_attention_fused_qkv (:538) and of
// octic_attention_fused_qkv_packed (:904), octic_attention_wide1d (:1058) and
// octic_attention_wide (:1154). The whole-head core they ran on before
// (csrc/attention.cu) stays for the probes only.
//
// What bounds it on the H100: the standard forward's bytes (csrc/
// attention_std.cu): at ViT-H/14, B=64 126 MB of qkv in and 42 MB out,
// 0.050 ms at 3.35 TB/s, under the products. The whole-head core staged a
// head before its first product (its gather and store, 46% of its time,
// overlapped nothing).
//
// What the design does about it: the standard forward's streamed kernel
// (csrc/attention_std_core.cuh: a CTA a 64-query tile, 64-key TMA tiles
// through a 3-stage ring, wgmma for q k^T and P.V) in two layouts.
//   Route (a), SCATTER: the wide qkv [B,N,3C] whose (s, head) slices are
//     [a1|a2|b1|b2|e0|e1] is the standard layout with a fixed column order
//     inside each head, so the kernel reads it as it stands; only the store
//     differs: the head's output columns go to o1..o4 at h*d1 and to oe0,
//     oe1 at h*de through a per-CTA column table, bf16x2 stores from the
//     accumulators (d1 and de even: no pair straddles two pieces; odd
//     widths take two 2-byte stores). The fused qkv + attention (rows 2
//     and 10) write this layout with K-lin-d8's grouped-column store; row
//     13a reads it directly.
//   Route (b), PIECES: the caller's arrays (row 5's six, row 12's five),
//     whose pieces are 20- and 40-byte runs at H/14 that no TMA box can
//     start and end on. Each piece is loaded as an over-wide box that starts
//     at it (16 columns for d1 <= 16, 16 or 32 for de), so a head is 96 or
//     128 padded columns: the extra columns (the next head's, or zeros past
//     the array) are zeroed in the q tile once a CTA and in each k tile, so
//     they add exactly 0 to q k^T (a non-finite value in another head stays
//     in that head), and their output columns are never stored. The products grow
//     by the padding (128 / 80 at H/14); the loads stay single TMA boxes.
//     A TMA box starts on a 16-byte boundary, so each box starts at its
//     piece's column rounded down to a multiple of 8 and the piece sits at
//     an offset inside it (0, 2, 4 or 6 columns for d1 = 10 at H/14; 0 or 4
//     for de = 20): the zeroed columns and the store's column table follow
//     the offset of the CTA's head. Arrays whose starts or row strides are
//     not 16-byte aligned (no TMA map), or whose pieces do not fit their
//     boxes at the same offset in q, k and v, go through route (a) after the
//     op assembles the wide qkv. Gathering the pieces with the producer
//     warp's 4-byte cp.async copies instead, unpadded, was correct and
//     slower (10x at H/14 B=64, 1.12x at the L/16 crops: PERF.md); so is
//     one copy into the wide qkv and route (a) (chip_smoke.py P25).
#include "attention_std_core.cuh"

namespace ovt {
namespace attn_std {
namespace {

// the six irrep outputs: o1..o4 [B,N,H*d1], oe0, oe1 [B,N,H*de], contiguous
void octic_outputs(Geo& g, void* const* outs, int H, int d1, int de) {
  for (int i = 0; i < 6; ++i) {
    g.out[i] = static_cast<bf16*>(outs[i]);
    g.ow[i] = i < 4 ? d1 : de;
    g.old[i] = H * g.ow[i];
  }
  g.pairs = d1 % 2 == 0 && de % 2 == 0;
  g.d1 = d1;
  g.de = de;
}

// box j of the PIECES layout from map m: `width` columns a head at column
// col_s + h * hs of operand s
void piece(Geo& g, int j, const int (&m)[3], const int (&col)[3], int hs, int width) {
  for (int s = 0; s < 3; ++s) {
    g.map[s][j] = m[s];
    g.col[s][j] = col[s];
  }
  g.hs[j] = hs;
  g.w[j] = width;
}

// a map over one array [B,N,W] (row stride ld) with boxes of bw columns
int piece_map(Geo& g, int m, const void* p, int W, int ld, int N, int B, int bw) {
  const uint64_t dims[3] = {(uint64_t)W, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)ld * 2, (uint64_t)ld * 2 * N};
  const uint32_t box[3] = {(uint32_t)bw, ROWS, 1};
  g.ptr[m] = static_cast<const bf16*>(p);
  g.ld[m] = ld;
  return encode_bf16_map(&g.m[m], p, 3, dims, strides, box, 2 * bw);
}

template <int DH>
int octic_dispatch(const void* qkv, void* const* outs, int B, int N, int H, int d1, int de,
                   int grid, int smem, const int* widths, int nboxes, cudaStream_t st) {
  Geo geo = {};
  const int err = std_geo<DH>(geo, qkv, B, N, H, widths, nboxes);
  if (err != 0) return err;
  octic_outputs(geo, outs, H, d1, de);
  return run<DH, SCATTER>(geo, nullptr, B, N, H, DH, grid, smem, st);
}

// the PIECES launch at the padded width dhp (96: de <= 16, 128: de <= 32),
// after checking that every head's piece fits its box from the 16-byte
// boundary below it, at the same offset for q, k and v
int pieces_dispatch(Geo& geo, int B, int N, int H, int d1, int de, int dhp, int grid, int smem,
                    cudaStream_t st) {
  if (d1 < 1 || d1 > 16 || de < 1 || de > (dhp - 64) / 2) return ERR_PLAN;
  for (int j = 0; j < 6; ++j) {
    const int box = j < 4 ? 16 : (dhp - 64) / 2;
    for (int s = 1; s < 3; ++s)
      if ((geo.col[s][j] - geo.col[0][j]) % 8 != 0) return ERR_PLAN;
    for (int h = 0; h < H; ++h)
      if ((geo.col[0][j] + h * geo.hs[j]) % 8 + geo.w[j] > box) return ERR_PLAN;
  }
  const int dh = 4 * d1 + 2 * de;
  if (dhp == 96) return run<96, PIECES>(geo, nullptr, B, N, H, dh, grid, smem, st);
  if (dhp == 128) return run<128, PIECES>(geo, nullptr, B, N, H, dh, grid, smem, st);
  return ERR_PLAN;
}

}  // namespace
}  // namespace attn_std
}  // namespace ovt

#define OVT_STD_CASES(CALL)                                                      \
  CALL(8) CALL(16) CALL(24) CALL(32) CALL(40) CALL(48) CALL(56) CALL(64) CALL(72) \
      CALL(80) CALL(88) CALL(96) CALL(104) CALL(112) CALL(120) CALL(128)

// Route (a) of the octic forward: the wide octic qkv [B,N,3*H*dh] (each (s,
// head) slice [a1|a2|b1|b2|e0|e1], dh = 4*d1 + 2*de; the output of K-lin-d8's
// grouped-column store) read as the standard layout, the output scattered to
// o1..o4 [B,N,H*d1] and oe0, oe1 [B,N,H*de] (contiguous). The plan as in
// ovt_attention_std (ops/attention.py:octic_attention_plan, route "a").
OVT_EXPORT int ovt_attention_std_octic(const void* qkv, void* o1, void* o2, void* o3, void* o4,
                                       void* oe0, void* oe1, int B, int N, int H, int d1, int de,
                                       int grid, int smem, int nboxes, int w0, int w1, int w2,
                                       int w3, void* stream) {
  using namespace ovt::attn_std;
  const int widths[4] = {w0, w1, w2, w3};
  void* const outs[6] = {o1, o2, o3, o4, oe0, oe1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (4 * d1 + 2 * de) {
#define OVT_STD_CASE(D)                                                                        \
  case D:                                                                                      \
    return octic_dispatch<D>(qkv, outs, B, N, H, d1, de, grid, smem, widths, nboxes, st);
    OVT_STD_CASES(OVT_STD_CASE)
#undef OVT_STD_CASE
    default:
      return ovt::ERR_PLAN;
  }
}

// Route (b), the six octic arrays of octic_attention: q1..q4 [B,N,3*H*d1] in
// (3, H, d1) column order and e0, e1 [B,N,3*H*de] in (3, H, de) order, each
// with its own token row stride (16-byte aligned starts and strides: TMA);
// the six outputs as ovt_attention_std_octic. `dhp` the padded head width
// of the plan (ops/attention.py:octic_attention_plan, route "b").
OVT_EXPORT int ovt_attention_octic_pieces(const void* q1, const void* q2, const void* q3,
                                          const void* q4, const void* e0, const void* e1,
                                          int ld1, int ld2, int ld3, int ld4, int lde0, int lde1,
                                          void* o1, void* o2, void* o3, void* o4, void* oe0,
                                          void* oe1, int B, int N, int H, int d1, int de, int dhp,
                                          int grid, int smem, void* stream) {
  using namespace ovt::attn_std;
  Geo geo = {};
  const void* ins[6] = {q1, q2, q3, q4, e0, e1};
  const int lds[6] = {ld1, ld2, ld3, ld4, lde0, lde1};
  for (int i = 0; i < 6; ++i) {
    const int w = i < 4 ? d1 : de;
    const int err = piece_map(geo, i, ins[i], 3 * H * w, lds[i], N, B, i < 4 ? 16 : (dhp - 64) / 2);
    if (err != 0) return err;
    piece(geo, i, {i, i, i}, {0, H * w, 2 * H * w}, w, w);
  }
  void* const outs[6] = {o1, o2, o3, o4, oe0, oe1};
  octic_outputs(geo, outs, H, d1, de);
  return pieces_dispatch(geo, B, N, H, d1, de, dhp, grid, smem, static_cast<cudaStream_t>(stream));
}

// Route (b), the wide-1d layout of octic_attention_wide1d: q1d, k1d, v1d
// [B,N,4*H*d1] with columns (H, [a1|a2|b1|b2], d1) and e0, e1 as above, each
// with its own row stride; the same six outputs.
OVT_EXPORT int ovt_attention_wide1d_pieces(const void* q1d, const void* k1d, const void* v1d,
                                           const void* e0, const void* e1, int ldq, int ldk,
                                           int ldv, int lde0, int lde1, void* o1, void* o2,
                                           void* o3, void* o4, void* oe0, void* oe1, int B, int N,
                                           int H, int d1, int de, int dhp, int grid, int smem,
                                           void* stream) {
  using namespace ovt::attn_std;
  Geo geo = {};
  const void* ins[5] = {q1d, k1d, v1d, e0, e1};
  const int lds[5] = {ldq, ldk, ldv, lde0, lde1};
  for (int i = 0; i < 5; ++i) {
    const int err = piece_map(geo, i, ins[i], i < 3 ? 4 * H * d1 : 3 * H * de, lds[i], N, B,
                              i < 3 ? 16 : (dhp - 64) / 2);
    if (err != 0) return err;
  }
  for (int j = 0; j < 4; ++j) piece(geo, j, {0, 1, 2}, {j * d1, j * d1, j * d1}, 4 * d1, d1);
  piece(geo, 4, {3, 3, 3}, {0, H * de, 2 * H * de}, de, de);
  piece(geo, 5, {4, 4, 4}, {0, H * de, 2 * H * de}, de, de);
  void* const outs[6] = {o1, o2, o3, o4, oe0, oe1};
  octic_outputs(geo, outs, H, d1, de);
  return pieces_dispatch(geo, B, N, H, d1, de, dhp, grid, smem, static_cast<cudaStream_t>(stream));
}

