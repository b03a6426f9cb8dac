// sm90_mainloop: the pieces of Hopper's asynchronous tensor-core GEMM that
// gemm_sm90.cu's instances (the per-call products) and persistent_stages.cuh
// (the GEMM stages of the all-layer stacks) share, so that the port has one
// mainloop: TMA loads (cp.async.bulk.tensor, 128-byte swizzle, zero-filled
// past the tensor's edge) into a ring of K-tile slots guarded by full /
// empty mbarriers, produced by one thread and consumed by warpgroups that
// issue wgmma.mma_async from shared-memory descriptors (an operand with K
// contiguous read K-major, one with M or N contiguous MN-major through the
// transpose bits), one wgmma group in flight while the next slot is awaited;
// the forward's epilogue from the accumulator registers (bias, ReLU, keep
// bits, one rounding); the split-K sum in a fixed order through a
// workspace and one counter per tile; the host's tensor-map encoding; and
// the thread-block cluster pieces (launch, ranks, barriers, distributed
// shared memory) that gemm_ln.cu and attflat_pool.cu use. gemm_sm90.cu's header note says what bounds its products and how the
// persistent grid walks their items; persistent_stages.cuh how the stacks do.
#pragma once

#include <cuda.h>  // CUtensorMap and the encode function's types; no -lcuda

#include <cstdint>
#include <cstring>
#include <utility>

#include "common.cuh"

namespace sm90 {

constexpr int BM = 128, BK = 64;
constexpr int BOX = 64 * BK * 2;          // one 64 x 64 bf16 box: 8 KB
constexpr uint32_t SWIZZLE_ATOM = 1024;   // 8 rows of 128 bytes

struct Epilogue {
  const bf16* gate;   // NT: [M, N], keep (x inv_keep) where > 0, else 0
  long long ldg;
  float inv_keep;     // NT's gate and NN's keep-mask
  const float* res;   // NT: [M, N] f32 added after the gate, or null
  long long ldr;
  float* out_f32;     // either output may be null (NN: one is); both dense [M, N]
  bf16* out_bf16;
  long long ldo;
  const float* bias;  // NN: [N] f32 or null
  int relu;
  const unsigned char* mask;   // NN: [M, N] keep-mask (row stride ldm) or null
  long long ldm;
  Philox keep;        // NN: or its seeded source (the seeded instance only)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// more bytes for the barrier's current phase to wait for, without an
// arrival (a second box of one K-tile, armed before any of its loads)
__device__ __forceinline__ void mbar_expect_more(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one box of a 2-D tensor map at (c0 inner, c1 outer) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// one box of a 3-D tensor map at (c0 inner, c1, c2 outer) into shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled operand in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout 1
// = 128B swizzle. K-major: SBO = 1024 (8 rows of 128 B), LBO unused.
// MN-major: SBO = 1024 (8 K-rows of 128 B), LBO = the next 64-wide MN box.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the same for a swizzle of `row` bytes (128, 64 or 32: a row of the
// operand's 8-row atom; layout 1, 2 or 3)
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo, uint32_t sbo, int row) {
  const uint64_t mode = row == 128 ? 1 : row == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// the byte offset `off` (from a 1024-byte aligned base) as the swizzle of
// `row`-byte rows places it: its 16-byte chunk XOR the row's bits above
// 128 bytes, as TMA writes and wgmma reads a swizzled operand
__device__ __forceinline__ uint32_t swizzled(uint32_t off, int row) {
  return off ^ (((off >> 7) & ((row >> 4) - 1)) << 4);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (issue, wait)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the consumer warpgroups only (the producer warp has left)
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}

// m64n128k16: 64 f32 accumulators a thread
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// m64n64k16: 32 f32 accumulators a thread
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// m64n256k16: 128 f32 accumulators a thread
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// m64n32k16: 16 f32 accumulators a thread (the streaming FFN's narrow
// hidden slices; B's swizzle is its descriptor's)
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// m64n16k16: 8 f32 accumulators a thread
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// m64n128k32, s8 x s8 -> s32: 64 accumulators a thread (both operands K-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db) {
  static_assert(TA == 0 && TB == 0, "wgmma has no transpose for 8-bit operands");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// m64n64k32, s8 x s8 -> s32: 32 accumulators a thread (both operands K-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da, uint64_t db) {
  static_assert(TA == 0 && TB == 0, "wgmma has no transpose for 8-bit operands");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// One output tile (of tiles_n across, bm x bn) and one split of its
// K-tiles: a work item of a persistent grid. Split s of `splits` sums
// K-tiles [s T / S, (s + 1) T / S).
struct Item {
  int tile, split, m0, n0, kt0, nk;
  __device__ Item(int w, int tiles, int tiles_n, int bn, int k_tiles, int splits, int bm = BM) {
    tile = w % tiles;
    split = w / tiles;
    m0 = tile / tiles_n * bm;
    n0 = tile % tiles_n * bn;
    kt0 = static_cast<int>(static_cast<long long>(split) * k_tiles / splits);
    nk = static_cast<int>(static_cast<long long>(split + 1) * k_tiles / splits) - kt0;
  }
};

// m64n64k32, s8 x s8 -> s32 with A from registers: four .b32 of four
// codes each, the warp's rows g, g + 8 (g = lane / 4) at k 4t .. 4t + 3 and
// 16 + 4t .. (t = lane % 4), in the order (g, 0), (g + 8, 0), (g, 16),
// (g + 8, 16); B K-major in shared memory; scale_d 0 overwrites the
// accumulators
__device__ __forceinline__ void wgmma_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// m64n16k16 / m64n32k16, bf16 x bf16 -> f32 with A from registers (the
// fragment layout of the m64n64k16 form below); B in shared memory,
// K-major (TB 0) or MN-major (TB 1); the accumulators are added to
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// m64n64k16, bf16 x bf16 -> f32 with A from registers: four .b32 of two
// bf16 each, the warp's rows g, g + 8 at k 2t, 2t + 1 and 8 + 2t, 9 + 2t, in
// the order (g, 0), (g + 8, 0), (g, 8), (g + 8, 8); B in shared memory,
// K-major (TB 0) or MN-major (TB 1, wgmma's transpose bit); the
// accumulators are added to
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// m64n128k16, bf16 x bf16 -> f32 with A from registers (the fragment layout
// of the m64n64k16 form above); B K-major (TB 0) or MN-major (TB 1); the
// accumulators are added to
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// m64n256k16, bf16 x bf16 -> f32 with A from registers (the fragment layout
// of the m64n64k16 form above); B in shared memory, K-major (TB 0) or
// MN-major (TB 1); the accumulators are added to
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// four 8 x 16-byte matrices from shared memory (ldmatrix .b16): lane L gives
// the address of row L % 8 of matrix L / 8; register i gets matrix i's row
// lane / 4, bytes 4 (lane % 4) .. + 3
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// keeps the compiler from reusing the registers of A fragments that an
// asynchronous wgmma may still read (issue .. wait)
template <int S>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[s][j])::"memory");
}

// The ring of K-tile slots at `base` (STAGES slots of STAGE_BYTES, 1024-byte
// aligned), its mbarriers at `bars` (full[s] at bars + 8 s, then empty[s]):
// the producer's side for one work item of nk K-tiles. For each, it waits
// for the slot to be free, arms its full barrier with the bytes to come and
// calls load(slot address, full barrier, i), which issues the TMA loads.
// stage / phase carry the ring's position from item to item.
template <int STAGES, int STAGE_BYTES, typename Load>
__device__ __forceinline__ void produce(uint32_t base, uint32_t bars, int& stage, uint32_t& phase,
                                        int nk, uint32_t bytes, Load&& load) {
  for (int i = 0; i < nk; ++i) {
    mbar_wait(bars + 8 * (STAGES + stage), phase ^ 1);   // the slot is free
    const uint32_t full = bars + 8 * stage;
    mbar_expect_tx(full, bytes);
    load(base + stage * STAGE_BYTES, full, i);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The consumers' side for one work item: acc[h] += A(half h) . B for each of
// the nk K-tiles of BK, the A operand of half h at slot + a_off + h BOX
// (64 rows), B at slot + b_off. Each K-tile is BK / 16 wgmma steps (32
// bytes of a K-major row or 16 rows of an MN-major operand each); the
// group is committed, between() runs while the tensor cores work, and the
// previous K-tile's slot is released once its group is done.
template <int TA, int TB, int STAGES, int STAGE_BYTES, int HALVES, typename Acc, int ACC,
          typename Between>
__device__ __forceinline__ void consume(Acc (&acc)[HALVES][ACC], uint32_t base, uint32_t bars,
                                        int& stage, uint32_t& phase, int nk, uint32_t a_off,
                                        uint32_t b_off, Between&& between) {
  int prev = 0;
  for (int i = 0; i < nk; ++i) {
    mbar_wait(bars + 8 * stage, phase);
    const uint32_t a = base + stage * STAGE_BYTES + a_off;
    const uint32_t b = base + stage * STAGE_BYTES + b_off;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) fence_acc(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major: the next 16 k (S8: 32) are 32 bytes on in each 128-byte
      // row; MN-major: 16 k-rows of 128 bytes on
      const uint32_t step_a = TA ? kk * 16 * 128 : kk * 32;
      const uint32_t step_b = TB ? kk * 16 * 128 : kk * 32;
      const uint64_t db = desc(b + step_b, BOX, SWIZZLE_ATOM);
#pragma unroll
      for (int h = 0; h < HALVES; ++h)   // rows 64 h .. + 63: the next box
        wgmma<TA, TB>(acc[h], desc(a + h * BOX + step_a, BOX, SWIZZLE_ATOM), db);
    }
    wgmma_commit();
    between();
    wgmma_wait<1>();   // the previous stage's products are done with it
#pragma unroll
    for (int h = 0; h < HALVES; ++h) fence_acc(acc[h]);
    if (i > 0) mbar_arrive(bars + 8 * (STAGES + prev));
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < HALVES; ++h) fence_acc(acc[h]);
  if (nk > 0) mbar_arrive(bars + 8 * (STAGES + prev));   // the item's last slot
}

// the A fragments of one K-tile of f32 a for wgmma's register-A form: rows
// 16 warp + g (+ 8), k 16 kk + 2 t (+ 8) of the warpgroup's 64 rows, in two
// f32 boxes (32 values a row, 128-byte rows, 128-byte swizzle: the 16-byte
// chunk c of row r at chunk c ^ (r % 8)) `xstride` bytes apart, each pair
// rounded to bf16 as one word
__device__ __forceinline__ void f32_frags(uint32_t a, uint32_t xstride, int warp, int lane,
                                          uint32_t (&f)[BK / 16][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // (g, 0), (g + 8, 0), (g, 8), (g + 8, 8)
      const int row = 16 * warp + g + 8 * (q & 1);
      const int k = 16 * kk + 2 * t + 8 * (q >> 1);
      const int kc = k & 31;
      const uint32_t addr = a + (k >> 5) * xstride + row * 128 + (((kc >> 2) ^ (row & 7)) << 4) +
                            (kc & 3) * 4;
      float x, y;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(x), "=f"(y) : "r"(addr));
      const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);   // x in the low half
      f[kk][q] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
}

// The side of one consumer warpgroup for one work item whose A operand it
// forms in its own registers (the int4 products: the weight, unpacked or
// dequantized from the slot's packed bytes; the activations are B): for
// each K-tile, wait for its slot, load_a(slot, stage, i, frags) fills the
// K-tile's four steps of A fragments, then its wgmma group reads them with
// B at slot + b_off (K-major, 32 bytes on a step). Nothing is written to
// shared memory, so no warp waits for another. One group stays in flight,
// its fragments in the other of two register sets, while the next K-tile's
// are formed; f32 accumulators summed over every K-tile. B is read K-major
// (TB 0: 32 bytes on a step) or MN-major (TB 1: 16 k-rows of 128 bytes on a
// step, the next 64-wide N box a BOX on; gemm_ln.cu's f32 activations
// against the [K, D] weight).
template <int STAGES, int STAGE_BYTES, int ACC, int TB = 0, typename LoadA>
__device__ __forceinline__ void consume_rs(float (&acc)[ACC], uint32_t base, uint32_t bars,
                                           int& stage, uint32_t& phase, int nk, uint32_t b_off,
                                           LoadA&& load_a) {
  uint32_t frags[2][BK / 16][4];
  int prev = 0;
  auto step = [&](uint32_t(&cur)[BK / 16][4], uint32_t(&other)[BK / 16][4], int i) {
    mbar_wait(bars + 8 * stage, phase);
    const uint32_t slot = base + stage * STAGE_BYTES;
    load_a(slot, stage, i, cur);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<TB>(acc, cur[kk], desc(slot + b_off + (TB ? kk * 16 * 128 : kk * 32), BOX, SWIZZLE_ATOM));
    wgmma_commit();
    wgmma_wait<1>();   // the previous K-tile's products are done with its slot
    fence_acc(acc);
    fence_regs(other);
    if (i > 0) mbar_arrive(bars + 8 * (STAGES + prev));
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (int i = 0; i < nk; i += 2) {   // the sets alternate: indices known at compile time
    step(frags[0], frags[1], i);
    if (i + 1 < nk) step(frags[1], frags[0], i + 1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(frags[0]);
  fence_regs(frags[1]);
  if (nk > 0) mbar_arrive(bars + 8 * (STAGES + prev));   // the item's last slot
}

// consume_rs for a product whose every K-tile's exact int32 sums are
// drained on their own (S4's groups): K-tile i goes to accumulator set i % 2
// (its first step overwriting them, scale-d 0) and fragment set i % 2; K-tile
// i + 1 is issued before K-tile i is drained, so drain(stage, i, sums) runs
// while the tensor cores work on the next; then K-tile i's slot is released.
template <int STAGES, int STAGE_BYTES, int ACC, typename LoadA, typename Drain>
__device__ __forceinline__ void consume_rs_drain(int (&acc)[2][ACC], uint32_t base, uint32_t bars,
                                                 int& stage, uint32_t& phase, int nk,
                                                 uint32_t b_off, LoadA&& load_a, Drain&& drain) {
  uint32_t frags[2][BK / 16][4];
  int st[2];
  auto issue = [&](int(&a)[ACC], uint32_t(&f)[BK / 16][4], int i, int& s) {
    s = stage;
    mbar_wait(bars + 8 * stage, phase);
    const uint32_t slot = base + stage * STAGE_BYTES;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    load_a(slot, s, i, f);
    fence_acc(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(a, f[kk], desc(slot + b_off + kk * 32, BOX, SWIZZLE_ATOM), kk > 0 ? 1 : 0);
    wgmma_commit();
  };
  auto finish = [&](int(&a)[ACC], uint32_t(&f)[BK / 16][4], int i, int s, bool more) {
    if (more)
      wgmma_wait<1>();   // K-tile i's group; K-tile i + 1's stays in flight
    else
      wgmma_wait<0>();
    fence_acc(a);
    fence_regs(f);
    drain(s, i, a);
    mbar_arrive(bars + 8 * (STAGES + s));
  };
  if (nk > 0) issue(acc[0], frags[0], 0, st[0]);
  for (int i = 0; i < nk; i += 2) {   // the sets alternate: indices known at compile time
    if (i + 1 < nk) issue(acc[1], frags[1], i + 1, st[1]);
    finish(acc[0], frags[0], i, st[0], i + 1 < nk);
    if (i + 1 == nk) break;
    if (i + 2 < nk) issue(acc[0], frags[0], i + 2, st[0]);
    finish(acc[1], frags[1], i + 1, st[1], i + 2 < nk);
  }
}

// Split-K: this split's f32 partial of one output tile, as float4 q of
// consumer thread tid at [q][tid] (coalesced), into the tile's slots of the
// workspace (splits x Q x CONSUMERS float4s a tile); then the tile's counter
// (the only atomic). The last block to arrive puts the counter back to 0
// for the next launch, reads every split's partial back (its own too, as
// written) and sums them in split order 0 .. S-1 into acc, so the bits do
// not depend on which block ran first. Returns true in that block, which
// then runs the epilogue, eight loads of one split in flight at a time.
// last_flag: an int in shared memory; CONSUMERS threads take part. A thread
// whose accumulators all lie past the output's rows (live false) writes
// and reads nothing: its rows are never stored.
template <int HALVES, int ACC, int CONSUMERS>
__device__ __forceinline__ bool split_sum(float (&acc)[HALVES][ACC], float* ws, int* counters,
                                          int tile, int split, int splits, int tid,
                                          int* last_flag, bool live = true) {
  constexpr int Q = HALVES * ACC / 4;   // float4s a thread
  float4* slots = reinterpret_cast<float4*>(ws) + static_cast<size_t>(tile) * splits * Q * CONSUMERS;
  float4* mine = slots + static_cast<size_t>(split) * Q * CONSUMERS;
  if (live) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int h = q / (ACC / 4), c = (q % (ACC / 4)) * 4;
      mine[q * CONSUMERS + tid] = make_float4(acc[h][c], acc[h][c + 1], acc[h][c + 2], acc[h][c + 3]);
    }
  }
  __threadfence();
  consumer_sync<CONSUMERS>();
  if (tid == 0) {
    const int last = atomicAdd(&counters[tile], 1) == splits - 1;
    if (last) counters[tile] = 0;   // ready for the next launch
    *last_flag = last;
  }
  consumer_sync<CONSUMERS>();
  if (!*last_flag) return false;
  __threadfence();
  if (!live) return true;
  constexpr int QC = 8;
#pragma unroll
  for (int q0 = 0; q0 < Q; q0 += QC) {
    for (int s = 0; s < splits; ++s) {
      const float4* p = slots + (static_cast<size_t>(s) * Q + q0) * CONSUMERS + tid;
      float4 v[QC];
#pragma unroll
      for (int q = 0; q < QC; ++q) v[q] = __ldcg(p + q * CONSUMERS);
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const int h = (q0 + q) / (ACC / 4), c = ((q0 + q) % (ACC / 4)) * 4;
        acc[h][c] = s == 0 ? v[q].x : acc[h][c] + v[q].x;
        acc[h][c + 1] = s == 0 ? v[q].y : acc[h][c + 1] + v[q].y;
        acc[h][c + 2] = s == 0 ? v[q].z : acc[h][c + 2] + v[q].z;
        acc[h][c + 3] = s == 0 ? v[q].w : acc[h][c + 3] + v[q].w;
      }
    }
  }
  return true;
}

// a[i] for a run-time i < N, by selects (an indexed register array would
// go to local memory)
template <int N>
__device__ __forceinline__ unsigned pick(const unsigned (&a)[N], int i) {
  unsigned v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = i == k ? a[k] : v;
  return v;
}

// The forward's (NN) per-item state beside a thread's accumulators: HALVES
// 64-row halves of ACC each (a warpgroup's m64nN, N = 2 ACC, per half).
// Accumulator j of half h holds row r0 + 64 h + 8 ((j / 2) % 2), column
// c0 + 8 (j / 4) + j % 2, where r0 = the half's first row + 16 warp + lane
// / 4 and c0 = its first column + 2 (lane % 4): a thread's
// columns are the same in every row it holds, so its ACC / 4 bias pairs are
// loaded once, as the item starts (their latency hides behind the
// mainloop). The keep bits of its HALVES x ACC accumulators go into one
// 64-bit mask, bit h ACC + j.
//
// Seeded, a pair (col, col + 1) starts on an even column, so its elements
// e, e + 1 share the Philox counter e >> 2 (words 0, 1 where e % 4 == 0,
// else 2, 3), and the lanes 2i, 2i + 1 of a quad hold the same rows and
// columns 4k .. 4k + 3 between them: one counter. So a lane pair draws each
// of its counters once: in draw s the even lane takes the thread's pair
// 2s, the odd lane pair 2s + 1, and each hands the other the keep bits of
// the other's words by one shuffle -- philox_keep_rows's decision, element
// by element, at a quarter of its draws. A row's sample and first element
// are worked out as the item starts. The draws run in batches of B
// independent draws (a lone draw waits out each round's latency), in a
// rolled loop (Philox inlined into an unrolled row takes minutes to
// build): a batch between the mainloop's wgmma issue and wait, while the
// tensor cores run, the rest after the mainloop.
template <int HALVES, int ACC, bool SEEDED>
struct NNState {
  static constexpr int PAIRS = ACC / 4;
  static constexpr int DRAWS = HALVES * ACC / 4;   // per thread and item
  float2 bias[PAIRS];
  unsigned long long kept;
  int drawn;
  unsigned sample[2 * HALVES], first[2 * HALVES];   // of row r0 + 64 h + 8 hi at 2 h + hi

  __device__ __forceinline__ void start(const Epilogue& ep, int r0, int c0, int N) {
    if (ep.bias != nullptr) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const int col = c0 + 8 * p;
        bias[p] = col < N ? make_float2(__ldg(ep.bias + col), __ldg(ep.bias + col + 1))
                          : make_float2(0.0f, 0.0f);
      }
    }
    kept = 0;
    drawn = 0;
    if (SEEDED) {
#pragma unroll
      for (int i = 0; i < 2 * HALVES; ++i) {
        const int row = r0 + 64 * (i / 2) + 8 * (i % 2), b = row / ep.keep.rows;
        sample[i] = static_cast<unsigned>(b);
        first[i] = static_cast<unsigned>((row - static_cast<long long>(b) * ep.keep.rows) * N);
      }
    }
  }

  // draws drawn .. drawn + B - 1 (B divides what is left)
  template <int B>
  __device__ __forceinline__ void draw(const Epilogue& ep, int lane, int r0, int c0, int M, int N) {
    const int odd = lane & 1;
    uint4 w[B];
    bool in[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int j = 2 * (drawn + i) + odd;   // pair q of half h
      const int h = j / (ACC / 2), q = j % (ACC / 2), hi = q & 1;
      const int row = r0 + 64 * h + 8 * hi, col = c0 + 8 * (q >> 1);
      in[i] = row < M && col < N;
      const unsigned e = pick(first, 2 * h + hi) + static_cast<unsigned>(col);
      w[i] = philox4x32_10(make_uint4(e >> 2, pick(sample, 2 * h + hi), 0u, 0u),
                           make_uint2(ep.keep.seed, ep.keep.site));
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const unsigned t = ep.keep.thresh;   // keep bits from words 0, 1 and 2, 3
      const unsigned lo = in[i] ? (w[i].x < t ? 1u : 0u) | (w[i].y < t ? 2u : 0u) : 0u;
      const unsigned hi = in[i] ? (w[i].z < t ? 1u : 0u) | (w[i].w < t ? 2u : 0u) : 0u;
      const unsigned mine = odd ? hi : lo;
      const unsigned got = __shfl_xor_sync(0xFFFFFFFFu, odd ? lo : hi, 1);   // the partner's pair
      kept |= static_cast<unsigned long long>(odd ? got | mine << 2 : mine | got << 2)
              << (4 * (drawn + i));
    }
    drawn += B;
  }
};

// 4 x 4 transpose of 32-bit values across the lanes of a quad: lane t's
// a[s] becomes lane s's a[t]. Two butterfly stages, each swapping one bit
// of (lane, position) for the values whose bits differ.
__device__ __forceinline__ void quad_transpose(unsigned (&a)[4], int lane) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const bool up = lane & m;
#pragma unroll
    for (int s0 = 0; s0 < 4; ++s0) {
      if (s0 & m) continue;
      const unsigned got = __shfl_xor_sync(0xFFFFFFFFu, up ? a[s0] : a[s0 | m], m);
      if (up)
        a[s0] = got;
      else
        a[s0 | m] = got;
    }
  }
}

// The forward's epilogue from the accumulator registers, in gemm_bias_act's
// order: + bias[col], ReLU, then the keep-mask or its Philox source (x
// inv_keep, else 0), one rounding into the dense output. The mask of a pair
// is two adjacent bytes; a half's pairs are all loaded before its first
// store, then kept as bits like the seeded ones. f32 rows go out as the
// pairs the lanes hold (a quad writes 32 bytes of a row at a time); bf16
// pairs are 4 bytes, so a quad first transposes four of them, and each
// lane writes 8 columns (16 bytes: a quad 64 contiguous bytes of a row).
template <int HALVES, int ACC, bool SEEDED>
__device__ __forceinline__ void nn_epilogue(float (&acc)[HALVES][ACC],
                                            NNState<HALVES, ACC, SEEDED>& st, int lane, int r0,
                                            int c0, int M, int N, const Epilogue& ep) {
  constexpr int PAIRS = ACC / 4;
  if (SEEDED) {
#pragma unroll 1
    while (st.drawn < NNState<HALVES, ACC, SEEDED>::DRAWS) st.template draw<2>(ep, lane, r0, c0, M, N);
  }
  const bool drop = SEEDED || ep.mask != nullptr;
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    const int rh = r0 + 64 * h;
    if (!SEEDED && ep.mask != nullptr) {
      unsigned short mk[ACC / 2];
#pragma unroll
      for (int q = 0; q < ACC / 2; ++q) {
        const int row = rh + 8 * (q & 1), col = c0 + 8 * (q >> 1);
        mk[q] = row < M && col < N ? *reinterpret_cast<const unsigned short*>(
                                         ep.mask + static_cast<size_t>(row) * ep.ldm + col)
                                   : 0;
      }
#pragma unroll
      for (int q = 0; q < ACC / 2; ++q)   // little-endian: col's byte is the low one
        st.kept |= static_cast<unsigned long long>(((mk[q] & 0xFFu) != 0u ? 1u : 0u) |
                                                   ((mk[q] >> 8) != 0u ? 2u : 0u))
                   << (h * ACC + 2 * q);
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = rh + 8 * hi;
#pragma unroll
      for (int g = 0; g < PAIRS; g += 4) {   // pairs g .. g + 3: columns 8 g .. 8 g + 31
        float v[8];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = 4 * (g + s) + 2 * hi;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float x = acc[h][j + k];
            if (ep.bias != nullptr) x += k ? st.bias[g + s].y : st.bias[g + s].x;
            if (ep.relu) x = fmaxf(x, 0.0f);
            if (drop) x = (st.kept >> (h * ACC + j + k)) & 1ull ? x * ep.inv_keep : 0.0f;
            v[2 * s + k] = x;
          }
        }
        if (ep.out_f32 != nullptr) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int col = c0 + 8 * (g + s);
            if (row < M && col < N)   // N is even: col + 1 < N too
              *reinterpret_cast<float2*>(ep.out_f32 + static_cast<size_t>(row) * ep.ldo + col) =
                  make_float2(v[2 * s], v[2 * s + 1]);
          }
        } else {
          unsigned a[4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const __nv_bfloat162 b2 = __halves2bfloat162(to_bf16(v[2 * s]), to_bf16(v[2 * s + 1]));
            a[s] = *reinterpret_cast<const unsigned*>(&b2);
          }
          quad_transpose(a, lane);   // a: columns 8 (g + lane % 4) .. + 7 of the row
          const int col = c0 - 2 * (lane & 3) + 8 * (g + (lane & 3));
          if (row < M && col < N)   // N % 8 == 0: all 8 columns or none
            *reinterpret_cast<uint4*>(ep.out_bf16 + static_cast<size_t>(row) * ep.ldo + col) =
                make_uint4(a[0], a[1], a[2], a[3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// thread-block clusters (gemm_ln.cu, attflat_pool.cu; the cluster work left
// for gemm_s8, gemm_s4 and gemm_bias_act -- a weight or activation box
// multicast to the CTAs that share it -- builds on the same pieces, adding
// the multicast load and a remote arrival on a peer's empty barrier)
//
// A cluster is C CTAs of consecutive blockIdx.x, launched by launch_cluster
// below (cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension {C, 1,
// 1}) and scheduled together on one GPC. Each CTA may read the others'
// shared memory (distributed shared memory): mapa turns an address of this
// CTA's shared window into rank r's, ld.shared::cluster reads it.
// barrier.cluster.arrive.release / wait.acquire orders those reads after the
// writes that came before the barrier. Every thread of every CTA that has
// not exited takes part in a cluster barrier, so a kernel keeps its
// producer warp to the end and converges it (__syncwarp) before the
// barrier: lanes left waiting at it while lane 0 still issued loads slowed
// that lane's issue. A CTA must not exit while a peer may still read its
// shared memory or arrive on its barriers: its last arrive comes after its
// last remote access, and it waits before leaving.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// the cluster's index along x: the launch's clusters are its grid / C
__device__ __forceinline__ unsigned cluster_index() {
  unsigned c;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(c));
  return c;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the f32 at p in rank r's shared memory (p: an address of this CTA's
// shared window; every CTA of the kernel lays its shared memory out alike)
__device__ __forceinline__ float peer_f32(const float* p, unsigned r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(r));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// the 16 bytes at p (16-byte aligned) in rank r's shared memory
__device__ __forceinline__ float4 peer_f32x4(const float* p, unsigned r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(r));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// p (an address of this CTA's shared window) in rank r's window
__device__ __forceinline__ uint32_t peer_addr(uint32_t p, unsigned r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(p), "r"(r));
  return a;
}

// one arrival on the mbarrier `bar` of rank r (this CTA's own too), with
// release at cluster scope: what this thread saw before it is visible to a
// thread of rank r that waits on that barrier with acquire (mbar_wait_cluster)
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, unsigned r) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(peer_addr(bar, r))
               : "memory");
}

// one arrival on the mbarrier `bar` of rank r with the default (CTA-scope)
// semantics: enough to free a buffer that only the async proxy (TMA, bulk
// copies, wgmma) reads and writes, as CUTLASS's cluster pipelines release
// a multicast slot; far cheaper than mbar_arrive_peer
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, unsigned r) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(peer_addr(bar, r)) : "memory");
}

// mbar_wait with acquire at cluster scope (the arrivals came from peers)
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) of this CTA's shared memory at src into rank
// r's at the same address, completing on rank r's mbarrier `bar` (a bulk
// copy of the async proxy: what generic stores wrote to src must be fenced
// for it first, fence_proxy_async)
__device__ __forceinline__ void copy_to_peer(uint32_t src, uint32_t bytes, uint32_t bar, unsigned r) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          peer_addr(src, r)),
      "r"(src), "r"(bytes), "r"(peer_addr(bar, r))
      : "memory");
}

// this thread's generic-proxy writes to shared memory, ordered before the
// async proxy's (wgmma, bulk copies) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry
// point query (no -lcuda at link time); null where it is missing
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// a matrix of `outer` rows of `inner` elements of `bytes` bytes (2: bf16,
// 1: int8), row stride `ld` elements, read in boxes of box_outer rows x
// box_inner elements (128 bytes, the swizzle span; or 64 / 32 under that
// swizzle); out-of-bounds elements read as zeros
inline bool make_map(CUtensorMap* map, const void* ptr, int bytes, long long inner, long long outer,
              long long ld, int box_inner, int box_outer,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  // one row: its stride is never stepped over, and may be anything
  const cuuint64_t strides[1] = {
      static_cast<cuuint64_t>(outer > 1 ? ld * bytes : (inner * bytes + 15) / 16 * 16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a matrix of `outer` rows of `inner` elements of `bytes` bytes (1: uint8,
// 4: f32), row stride `ld` elements, read in boxes of box_outer rows x
// box_inner elements (box_inner x bytes a multiple of 16, at most 256
// elements), dense in shared memory, unswizzled or with `swizzle` (the
// 64-byte one: box rows of 64 bytes); out-of-bounds elements read as zeros
inline bool make_map_flat(CUtensorMap* map, const void* ptr, int bytes, long long inner,
                          long long outer, long long ld, int box_inner, int box_outer,
                          CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {
      static_cast<cuuint64_t>(outer > 1 ? ld * bytes : (inner * bytes + 15) / 16 * 16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a stack of `depth` matrices of `outer` rows of `inner` bf16 elements, each
// contiguous (row stride inner, matrix stride inner x outer), read in boxes
// of one matrix's box_outer rows x box_inner elements (128 bytes, the
// swizzle span); out-of-bounds elements read as zeros
inline bool make_map3(CUtensorMap* map, const void* ptr, long long inner, long long outer,
                      long long depth, int box_inner, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner * 2),
                                 static_cast<cuuint64_t>(inner * outer * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches kernel(args...) on `grid` CTAs of `threads` threads with `smem`
// bytes of dynamic shared memory, in clusters of `cluster` consecutive CTAs
// along x (grid a multiple of it; at most 8, the portable size). A launch
// the card cannot place (too much shared memory for a cluster on one GPC)
// returns its error, as any refused launch.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int grid, int threads, int smem,
                                  int cluster, cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// How many clusters of `cluster` CTAs of this kernel the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: the shape cannot launch), or -1 when
// the query fails.
template <typename... Params>
inline int max_active_clusters(void (*kernel)(Params...), int threads, int smem, int cluster) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg) == cudaSuccess
             ? n
             : -1;
}

}  // namespace sm90
