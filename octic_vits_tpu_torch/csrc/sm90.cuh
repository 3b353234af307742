// Hopper (sm_90a) primitives shared by the TMA + wgmma kernels: K-dense
// (csrc/dense.cu), K-attn's streamed forward (csrc/attention_std_core.cuh),
// K-lin-d8 (csrc/lin_d8_sm90.cuh) and K-lin-d8-bwd (csrc/lin_d8_bwd_sm90.cuh);
// the mbarrier and the 1-D bulk copy also feed K-ln-d8's affine backward
// (csrc/ln_d8.cu).
//
//   mbarrier  init, arrive, arrive with an expected transaction count, and a
//             wait on a phase parity (a wait on parity P returns once the
//             phase with that parity has completed; a fresh barrier counts
//             its "previous" phase, parity 1, as complete)
//   TMA       1-D bulk copies and tile loads (2-D and 3-D boxes), completion
//             reported to an mbarrier as bytes, and the 2-D and 3-D tile
//             stores with their bulk groups;
//             out-of-bounds elements of a load arrive as zeros, and the
//             transaction count is always the whole box
//   wgmma     the shared-memory matrix descriptor, fence / commit / wait,
//             m64nNk16 bf16 products with f32 accumulators: A and B from
//             shared memory, both K-major (wgmma_ss), A K-major and B
//             MN-major (wgmma_ss_t: the transpose bit on B), both MN-major
//             (wgmma_ss_tt: the transpose bit on A and B, a product that
//             contracts the token axis of two token-major tiles), or A from
//             registers and B MN-major (wgmma_rs_t)
//   named barriers  bar.sync on an id other than 0, for one warpgroup
//   setmaxnreg  the register hand-over between a producer and its consumers
//   host      cuTensorMapEncodeTiled, reached through the runtime's
//             cudaGetDriverEntryPoint, so the library links without -lcuda
//
// Shared-memory layouts (CuTe's canonical GMMA layouts, T = 8 bf16 = 16 bytes):
//   K-major, swizzle S in {32, 64, 128} bytes: rows of S bytes as TMA writes
//     them with CU_TENSOR_MAP_SWIZZLE_<S>B; 8-row groups SBO = 8 S bytes apart;
//     a k16 step inside the row is the start address + 32 bytes
//   K-major, no swizzle (the 8-column tail of a head): 8 x 16-byte core
//     matrices, rows 16 bytes apart, 8-row groups SBO apart, the two k halves
//     of a k16 step LBO apart
//   MN-major, swizzle S: rows (the k index) of S bytes of N; 8-row groups SBO
//     apart; blocks of S / 2 columns (one box each) LBO apart
//   MN-major, no swizzle: rows of 8 columns, 16 bytes apart; 8-row groups
//     LBO apart
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace ovt {
namespace sm90 {

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and the
// other threads; call after mbar_init, before the CTA-wide __syncthreads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait still open after ten seconds traps: a pipeline fault surfaces as
// a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint64_t start = 0;
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 1024) start = globaltimer_ns();
    if (polls > 1024 && globaltimer_ns() - start > 10000000000ull) __trap();
  }
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------- TMA

// 1-D bulk copy of `bytes` (a multiple of 16; `dst` and `src` 16-byte
// aligned) from global to shared memory, completion reported to `bar` as
// bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared -> global box store; out-of-bounds elements are not written. The
// writes of the box must be fenced (fence_proxy_async) before the store.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N committed store groups still read shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until at most N committed store groups are still writing global memory
template <int N>
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier of `count` threads (a multiple of 32) on id `id` (1..15)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------- wgmma

// layout_type field of the descriptor
enum Swizzle : uint32_t { SW_NONE = 0, SW_128 = 1, SW_64 = 2, SW_32 = 3 };

// The 64-bit shared-memory matrix descriptor: start address, leading and
// stride byte offsets (each >> 4, 14 bits), base offset 0 (every swizzled
// tile here starts on its swizzle pattern's repeat), layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler that an accumulator register may change here: placed
// after wgmma_wait (and before reusing registers in a new wgmma), it keeps
// reads and writes of the accumulators from moving across the asynchronous
// product.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[N/2] (+)= A[64x16] B[16xN]: A and B K-major in shared memory. scale_d = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d);

// d[N/2] (+)= A[64x16] B[16xN]: A K-major, B MN-major (transpose bit set),
// both in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss_t(float* d, uint64_t da, uint64_t db, int scale_d);

// d[N/2] (+)= A[64x16] B[16xN]: A and B both MN-major (transpose bits on A
// and B), in shared memory: A^T B where both tiles are stored k-row by k-row.
template <int N>
__device__ __forceinline__ void wgmma_ss_tt(float* d, uint64_t da, uint64_t db, int scale_d);

// d[N/2] (+)= A[64x16] B[16xN]: A in registers (the m16n8k16 A fragment of
// each warp's 16 rows: a0 = (g, 2t..), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
// a3 = (g+8, 2t+8..)), B MN-major in shared memory (transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float* d, const uint32_t (&a)[4], uint64_t db,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_t<32>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<8>(float* d, const uint32_t (&a)[4], uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<16>(float* d, const uint32_t (&a)[4], uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<32>(float* d, const uint32_t (&a)[4], uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float* d, const uint32_t (&a)[4], uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ----------------------------------------------------------- setmaxnreg

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace sm90

// -------------------------------------------------------------------- host

// Error codes the entry points return beside cudaError_t values (see
// ovt_error_string in csrc/dense.cu).
constexpr int ERR_TENSOR_MAP = 9000;   // + the CUresult of cuTensorMapEncodeTiled
constexpr int ERR_PLAN = 8999;         // the launch plan disagrees with the kernel's
constexpr int ERR_ENTRY_POINT = 8998;  // cuTensorMapEncodeTiled not found

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

inline CUtensorMapSwizzle swizzle_of_bytes(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                       : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// A bf16 tensor map of `rank` dims (innermost first), strides in bytes of
// dims 1.., box `box`, swizzle of `swizzle_bytes` (0, 32, 64, 128); loads
// out of bounds fill zeros. Returns 0 or an ERR_* code.
inline int encode_bf16_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                           const uint64_t* strides, const uint32_t* box, int swizzle_bytes) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return ERR_ENTRY_POINT;
  // The driver's encoder needs a current context, which a thread that has
  // made no runtime call yet lacks (PyTorch's autograd worker, running a
  // backward that recomputes a product): a runtime call binds the device's
  // primary context to the thread, once.
  static thread_local const bool bound = cudaFree(nullptr) == cudaSuccess;
  (void)bound;
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle_of_bytes(swizzle_bytes), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

}  // namespace ovt
