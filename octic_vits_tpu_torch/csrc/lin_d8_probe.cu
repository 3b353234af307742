// The tile sweep of K-lin-d8's mma.sync core: the qkv LinearD8 at other CTA
// tiles than the 64 tokens x 32 channels that the model paths ran before
// K-lin-d8's TMA + wgmma redesign (csrc/lin_d8.cu), and that core itself at
// 64 x 32 with every epilogue and store (ovt_lin_d8_sync), the yardstick the
// new kernel is timed against.
//
// Replaces the Pallas probes of scripts/profile_lin_tiles.py (kernel row
// 14b): `call_tuple` (pallas_linear.py `_kernel`, the plain tuple store y1
// [4,M,F] + yef [M,4F]) and `call_wide` (`_wide_kernel`, the grouped-column
// store of one interleaved qkv [M,8F], kernel row 13b), each at token tiles
// tm = 128 ... 1024. A TPU grid step's tile is a row block of tm tokens with
// every channel; an H100 CTA's tile is two-dimensional (BM tokens x BN
// channels across all eight slots) and bounded by 227 KB of shared memory,
// so the sweep is BM in {32, 64, 128} at BN = 32, and BN = 64 at BM = 64
// (BM = 128 at BN = 64 would stage 8 x 128 x 68 x 4 = 279 KB in its epilogue).
//
// What bounds them on the H100: as K-lin-d8 (csrc/lin_d8.cu), near the ridge
// at ViT-H/14 B=64 (M = 16448, C = 160, F = 480). What the sweep shows: a
// larger BM halves the B tiles a token reads (the weights are read once per
// CTA row) and the CTAs, at the price of registers (BM = 128: 128 f32
// accumulators a thread) and shared memory (one CTA an SM at every tile).
// The device code is csrc/lin_d8_core.cuh; the tile changes no output's
// summation order, so every tile gives the bits of its 64 x 32 instantiation.
#include "lin_d8_core.cuh"

namespace {

using namespace ovt::lind8;

template <int BM, int BN>
int run(const Args& a, bool grouped, cudaStream_t s) {
  return grouped ? launch<false, true, BM, BN>(a, s) : launch<false, false, BM, BN>(a, s);
}

}  // namespace

// x0..x3, xef, w1, we, bias, y0..y3, ye0, ye1 and the row strides and
// grouped-column maps as in ovt_lin_d8 (csrc/lin_d8.cu), no epilogue; the
// tile (bm, bn) one of (32, 32), (64, 32), (128, 32), (64, 64). Returns the
// cudaError_t of the launch.
OVT_EXPORT int ovt_lin_d8_tiled(const void* x0, const void* x1, const void* x2, const void* x3,
                                const void* xef, const void* w1, const void* we, const void* bias,
                                void* y0, void* y1, void* y2, void* y3, void* ye0, void* ye1,
                                int M, int C, int F, int ldx, int ldxe, int ldy, int ldye, int g1,
                                int s1, int ge, int se, int bm, int bn, void* stream) {
  using ovt::bf16;
  if (g1 <= 0 || ge <= 0) return cudaErrorInvalidValue;
  Args a = {};
  const void* xs[4] = {x0, x1, x2, x3};
  void* ys[4] = {y0, y1, y2, y3};
  for (int g = 0; g < 4; ++g) {
    a.x[g] = static_cast<const bf16*>(xs[g]);
    a.y[g] = static_cast<bf16*>(ys[g]);
  }
  a.xef = static_cast<const bf16*>(xef);
  a.w1 = static_cast<const bf16*>(w1);
  a.we = static_cast<const bf16*>(we);
  a.bias = static_cast<const bf16*>(bias);
  a.ye[0] = static_cast<bf16*>(ye0);
  a.ye[1] = static_cast<bf16*>(ye1);
  a.g1 = g1;
  a.s1 = s1;
  a.ge = ge;
  a.se = se;
  a.M = M;
  a.C = C;
  a.F = F;
  a.ldx = ldx;
  a.ldxe = ldxe;
  a.ldy = ldy;
  a.ldye = ldye;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool grouped = !(g1 >= F && ge >= 2 * F);
  if (bn == 32) {
    switch (bm) {
      case 32: return run<32, 32>(a, grouped, s);
      case 64: return run<64, 32>(a, grouped, s);
      case 128: return run<128, 32>(a, grouped, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (bn == 64 && bm == 64) return run<64, 64>(a, grouped, s);
  return cudaErrorInvalidValue;
}

// K-lin-d8 as the model paths ran it until its TMA + wgmma redesign
// (csrc/lin_d8.cu): the mma.sync core at its 64 x 32 tile, with every
// epilogue and store, the parent that chip_smoke.py times the new kernel
// against. The arguments as ovt_lin_d8's, without the launch plan:
// x0..x3 [M,C] (row stride ldx), xef [M,4C] (ldxe), w1 [4,C,F], we [2C,2F],
// bias [F] or null; the outputs y0..y3 (row stride ldy) and ye0, ye1 (ldye)
// with the grouped-column maps (g1, s1) and (ge, se) of the header (the
// plain layout: y_g [M,F], ye0 and ye1 the halves of yef [M,4F], g1 = F, ge
// = 2F); the LayerScale epilogue's ls1 [4,F], lse [2F], r0..r3 [M,F] and ref
// [M,4F] (contiguous), or all null; all bf16 with unit channel stride, every
// input's start 16-byte aligned, ldx and ldxe multiples of 8, C % 8 == 0 and
// F % 8 == 0 (checked by the Python wrapper).
OVT_EXPORT int ovt_lin_d8_sync(const void* x0, const void* x1, const void* x2, const void* x3,
                               const void* xef, const void* w1, const void* we,
                               const void* bias, void* y0, void* y1, void* y2, void* y3,
                               void* ye0, void* ye1, const void* ls1, const void* lse,
                               const void* r0, const void* r1, const void* r2, const void* r3,
                               const void* ref, int M, int C, int F, int gelu, int ldx, int ldxe,
                               int ldy, int ldye, int g1, int s1, int ge, int se, void* stream) {
  using namespace ovt::lind8;
  using ovt::bf16;
  constexpr int BM = 64, BN = 32;  // the model paths' tile
  Args a;
  a.x[0] = static_cast<const bf16*>(x0);
  a.x[1] = static_cast<const bf16*>(x1);
  a.x[2] = static_cast<const bf16*>(x2);
  a.x[3] = static_cast<const bf16*>(x3);
  a.xef = static_cast<const bf16*>(xef);
  a.w1 = static_cast<const bf16*>(w1);
  a.we = static_cast<const bf16*>(we);
  a.bias = static_cast<const bf16*>(bias);
  a.y[0] = static_cast<bf16*>(y0);
  a.y[1] = static_cast<bf16*>(y1);
  a.y[2] = static_cast<bf16*>(y2);
  a.y[3] = static_cast<bf16*>(y3);
  a.ye[0] = static_cast<bf16*>(ye0);
  a.ye[1] = static_cast<bf16*>(ye1);
  if (g1 <= 0 || ge <= 0) return cudaErrorInvalidValue;
  a.g1 = g1;
  a.s1 = s1;
  a.ge = ge;
  a.se = se;
  a.ls1 = static_cast<const bf16*>(ls1);
  a.lse = static_cast<const bf16*>(lse);
  a.r[0] = static_cast<const bf16*>(r0);
  a.r[1] = static_cast<const bf16*>(r1);
  a.r[2] = static_cast<const bf16*>(r2);
  a.r[3] = static_cast<const bf16*>(r3);
  a.ref = static_cast<const bf16*>(ref);
  if (gelu && ls1 != nullptr) return cudaErrorInvalidValue;
  a.M = M;
  a.C = C;
  a.F = F;
  a.ldx = ldx;
  a.ldxe = ldxe;
  a.ldy = ldy;
  a.ldye = ldye;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the plain layout keeps the store without the column tables
  const bool grouped = !(g1 >= F && ge >= 2 * F);
  if (grouped && gelu) return cudaErrorInvalidValue;
  return gelu ? launch<true, false, BM, BN>(a, s)
              : grouped ? launch<false, true, BM, BN>(a, s) : launch<false, false, BM, BN>(a, s);
}
