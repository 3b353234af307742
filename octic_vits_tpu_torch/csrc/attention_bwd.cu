// K-attn-bwd: the gradient of softmax(Q K^T * scale) V with respect to q, k
// and v for each (batch, head), recomputing the probabilities from q and k
// (the only residual is the qkv, as in the JAX custom VJP). Per head:
//   P  = softmax(s Q K^T)        dV = P^T dO        dP = dO V^T
//   dS = P o (dP - rowsum(dP o P)) s                dQ = dS K      dK = dS^T Q
//
// Replaces
//   octic_vits_tpu/ops/pallas_attention.py:standard_attention backward
//     (`_std_bwd_rule`, `_std_bwd_kernel`): qkv [B,N,3C] in (3, H, dh) order
//     and g [B,N,C] -> dqkv [B,N,3C];
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention backward
//     (`_octic_bwd_rule`, `_octic_bwd_kernel`), and the attention backward
//     inside `_fused_bwd_kernel_call` (row 2b) and the packed rule (row 10):
//     the six irrep qkv arrays and the six output cotangents -> the six
//     input gradients;
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention_wide1d backward
//     (`_w1d_bwd_rule`, `_octic_w1d_bwd_kernel`) -> dq1d, dk1d, dv1d, de0, de1;
//   octic_vits_tpu/ops/pallas_attention.py:octic_attention_wide backward
//     (`_octic_wide_bwd_rule`, `_octic_wide_bwd_kernel`) -> dqkv in the wide
//     layout.
// One entry point serves every layout: the op's launch plan
// (ops/attention.py:attention_bwd_sm90_plan) and its table (_bwd_table) name
// the arrays q, k, v and dO are loaded from, a head's dh contiguous columns
// each, and the arrays each segment of dq, dk and dv is stored to.
//
// What bounds it on the H100: at ViT-H/14, B=32 (N = 257, H = 16, dh = 80)
// one layer moves 63 MB of qkv and 21 MB of g in and 63 MB of gradients
// out (0.044 ms at 3.35 TB/s); the function's five products (S, dP, dV, dQ,
// dK) of 2 * 32*16 * 257^2 * 80 FLOP each take 0.027 ms at 989 TFLOP/s, and
// the nine this design runs (S and dP three times) 0.049 ms: the card is fed
// only if loads overlap the products and the products run on wgmma.
// The mma.sync core it replaces (csrc/attention_bwd_core.cuh, kept for the
// probes and as the yardstick ops.attention_bwd_sync) gathered a whole head
// into 191 KB of shared memory before its first product, one CTA an SM, so
// its loads overlapped nothing, and where a head did not fit its streamed
// form gathered tiles with 4-byte loads, slower still.
//
// What the design does about it (csrc/attention_bwd_sm90.cuh): the forward's
// shape, two kernels of one consumer warpgroup and one producer warp each,
// small enough that two or three CTAs share an SM. The producer streams 64-row
// TMA tiles through an mbarrier ring (3-D maps over (W, N, B): rows past N
// arrive as zeros, never the next image's); the consumer runs every product as
// an m64nNk16 wgmma: S and dP with both operands in shared memory, dQ, dK and
// dV with P or dS as register A fragments and the other operand MN-major in
// shared memory. The query pass (a CTA a 64-query tile) sweeps the key tiles
// twice, first for the row statistics (written to f32 scratch), then for dQ;
// the key pass (a CTA a 64-key tile) sweeps the query tiles once for dK and dV.
// No atomics: gradients are bitwise repeatable. The octic layouts run the same
// loads (route (a)): the wide qkv as the caller has it (rows 13a and the
// recomputing chains of rows 2b and 10b) or as pack_heads_kernel below
// assembles it from the caller's arrays (rows 5 and 12), and the six cotangents
// assembled in head order, since dP = dO V^T contracts dO's columns against
// v's. The gradients leave through a per-CTA column table into the caller's
// arrays. Loading the caller's arrays in place as padded 16-byte-aligned boxes
// (the octic forward's route (b)) was correct and slower: 80 columns padded to
// 128 (1.6x the products) put the key pass past 230 registers, one CTA an SM
// (PERF.md).
#include "attention_bwd_sm90.cuh"

namespace ovt {
namespace attn_bwd90 {
namespace {

// The geometry from the table: the tensor maps encoded, the boxes, the
// gradient segments and whether their value pairs take 4-byte stores
int geometry(Geo& g, const int64_t* T) {
  const int N = (int)T[T_N], B = (int)T[T_B], nmaps = (int)T[T_NMAPS];
  if (nmaps < 1 || nmaps > MAPS) return ERR_PLAN;
  for (int m = 0; m < nmaps; ++m) {
    const int64_t* e = T + T_MAPS + 4 * m;
    const uint64_t dims[3] = {(uint64_t)e[1], (uint64_t)N, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)e[2] * 2, (uint64_t)e[2] * 2 * N};
    const uint32_t box[3] = {(uint32_t)e[3], ROWS, 1};
    const int err = encode_bf16_map(&g.m[m], reinterpret_cast<const void*>(e[0]), 3, dims,
                                    strides, box, e[3] >= 16 ? 2 * (int)e[3] : 0);
    if (err != 0) return err;
  }
  for (int s = 0; s < 4; ++s) {
    const int64_t* e = T + T_BOXES + 5 * s;
    g.col[s] = (int)e[0];
    for (int j = 0; j < 4; ++j) g.map[s][j] = (int)e[1 + j];
  }
  g.nseg = (int)T[T_NSEG];
  if (g.nseg < 1 || g.nseg > 6) return ERR_PLAN;
  bool pairs = true;
  int sum = 0;
  for (int j = 0; j < 6; ++j) {
    g.sw[j] = (int)T[T_SEGS + j];
    if (j < g.nseg) {
      if (g.sw[j] < 1) return ERR_PLAN;
      pairs = pairs && g.sw[j] % 2 == 0;
      sum += g.sw[j];
    }
  }
  if (sum != T[T_DH]) return ERR_PLAN;
  for (int s = 0; s < 3; ++s)
    for (int j = 0; j < 6; ++j) {
      const int64_t* e = T + T_STORES + 4 * (6 * s + j);
      g.out[s][j] = reinterpret_cast<bf16*>(e[0]);
      g.old[s][j] = (int)e[1];
      g.ocol[s][j] = (int)e[2];
      g.ohs[s][j] = (int)e[3];
      if (j < g.nseg) {
        if (e[0] == 0) return ERR_PLAN;
        pairs = pairs && e[0] % 4 == 0 && e[1] % 2 == 0 && e[2] % 2 == 0 && e[3] % 2 == 0;
      }
    }
  g.pairs = pairs;
  g.stats = reinterpret_cast<float*>(T[T_STATS]);
  g.np = (int)T[T_NP];
  g.bh = (int)(T[T_B] * T[T_H]);
  return 0;
}

// ---- route (a)'s assembly: up to six pieces of each of up to three
// operands into one [M, W] array, head h's dh columns of operand s at
// column (s H + h) dh, piece j at its segment's place in the head
struct Pack {
  const bf16* p[3][6];
  int ld[3][6], col[3][6], hs[3][6];  // row stride, column at head 0, head stride
  int sw[6];
  int nseg, H, dh, W;
  bf16* out;
};

// The pack table (int64), written by ops/attention.py:_pack_heads
enum PackTable : int { P_M = 0, P_W, P_H, P_DH, P_NSEG, P_OUT, P_SEGS = 8, P_PIECES = 14 };

constexpr int PACK_ROWS = 16;    // token rows a CTA: each thread's loads of a column in flight
constexpr int PACK_COLS = 6144;  // the column table's entries (W / V, 3 x 16 x 128 at most)

// PACK_ROWS rows of the output a CTA. The column table, the same for every
// row, is built once a CTA: entry c (a V-column group) holds the piece (s, j)
// and the column in the piece's array. Then each thread takes a column group
// and issues its loads for all the CTA's rows before the stores (V = 2: every
// piece even, 4-byte copies); consecutive threads take consecutive groups, so
// reads and writes coalesce within each piece
template <int V>
__global__ void __launch_bounds__(256) pack_heads_kernel(const __grid_constant__ Pack g,
                                                         int rows) {
  typedef typename VecOf<V>::T Vec;
  __shared__ uint32_t table[PACK_COLS];
  const int groups = g.W / V, hc = g.H * g.dh;
  for (int c = threadIdx.x; c < groups; c += blockDim.x) {
    const int col = c * V, s = col / hc, h = (col - s * hc) / g.dh;
    int d = col - s * hc - h * g.dh, j = 0;
    while (j < g.nseg - 1 && d >= g.sw[j]) d -= g.sw[j++];
    table[c] = (uint32_t)(6 * s + j) << 24 | (uint32_t)(g.col[s][j] + h * g.hs[s][j] + d);
  }
  __syncthreads();
  const int r0 = blockIdx.x * PACK_ROWS, nr = min(PACK_ROWS, rows - r0);
  for (int c = threadIdx.x; c < groups; c += blockDim.x) {
    const uint32_t e = table[c];
    const int s = (e >> 24) / 6, j = (e >> 24) % 6;
    const bf16* src = g.p[s][j] + (size_t)r0 * g.ld[s][j] + (e & 0xFFFFFF);
    bf16* dst = g.out + (size_t)r0 * g.W + c * V;
    Vec v[PACK_ROWS];
#pragma unroll
    for (int r = 0; r < PACK_ROWS; ++r)
      if (r < nr) v[r] = *reinterpret_cast<const Vec*>(src + (size_t)r * g.ld[s][j]);
#pragma unroll
    for (int r = 0; r < PACK_ROWS; ++r)
      if (r < nr) *reinterpret_cast<Vec*>(dst + (size_t)r * g.W) = v[r];
  }
}

}  // namespace
}  // namespace attn_bwd90
}  // namespace ovt

// `table`: the int64 launch table of ops/attention.py:_bwd_table (the plan,
// the tensor maps' arrays, the column of q, k, v and dO at head 0 with the
// map of each box, the gradient segments, the f32 scratch [2, B*H, NP]),
// read on the host. Returns the cudaError_t of the two launches or an ERR_*
// code (ERR_PLAN: the table disagrees with the kernel's plan).
OVT_EXPORT int ovt_attention_bwd(const void* table, void* stream) {
  using namespace ovt::attn_bwd90;
  const int64_t* T = static_cast<const int64_t*>(table);
  Geo g = {};
  const int err = geometry(g, T);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T[T_DH]) {
    case 8: return run<8>(g, T, st);
    case 16: return run<16>(g, T, st);
    case 24: return run<24>(g, T, st);
    case 32: return run<32>(g, T, st);
    case 40: return run<40>(g, T, st);
    case 48: return run<48>(g, T, st);
    case 56: return run<56>(g, T, st);
    case 64: return run<64>(g, T, st);
    default: return run_wide((int)T[T_DH], g, T, st);
  }
}

// `table`: the int64 table of ops/attention.py:_pack_heads: M rows of the
// output [M, W] (W = operands x H x dh), its pointer, the head's segment
// widths, and for each operand's segment its array (pointer, token row
// stride, column at head 0, head stride). Returns the cudaError_t.
OVT_EXPORT int ovt_attention_bwd_pack(const void* table, void* stream) {
  using namespace ovt::attn_bwd90;
  const int64_t* T = static_cast<const int64_t*>(table);
  Pack g = {};
  g.W = (int)T[P_W];
  g.H = (int)T[P_H];
  g.dh = (int)T[P_DH];
  g.nseg = (int)T[P_NSEG];
  g.out = reinterpret_cast<ovt::bf16*>(T[P_OUT]);
  if (g.nseg < 1 || g.nseg > 6 || g.W % (g.H * g.dh) != 0 || g.W / (g.H * g.dh) > 3)
    return ovt::ERR_PLAN;
  bool pairs = g.W % 2 == 0 && T[P_OUT] % 4 == 0;
  for (int j = 0; j < 6; ++j) {
    g.sw[j] = (int)T[P_SEGS + j];
    pairs = pairs && (j >= g.nseg || g.sw[j] % 2 == 0);
  }
  for (int s = 0; s < 3; ++s)
    for (int j = 0; j < 6; ++j) {
      const int64_t* e = T + P_PIECES + 4 * (6 * s + j);
      g.p[s][j] = reinterpret_cast<const ovt::bf16*>(e[0]);
      g.ld[s][j] = (int)e[1];
      g.col[s][j] = (int)e[2];
      g.hs[s][j] = (int)e[3];
      if (s < g.W / (g.H * g.dh) && j < g.nseg)
        pairs = pairs && e[0] % 4 == 0 && e[1] % 2 == 0 && e[2] % 2 == 0 && e[3] % 2 == 0;
    }
  if (g.W / (pairs ? 2 : 1) > PACK_COLS) return ovt::ERR_PLAN;
  const int rows = (int)T[P_M], blocks = (rows + PACK_ROWS - 1) / PACK_ROWS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pairs)
    pack_heads_kernel<2><<<blocks, 256, 0, st>>>(g, rows);
  else
    pack_heads_kernel<1><<<blocks, 256, 0, st>>>(g, rows);
  return cudaGetLastError();
}
