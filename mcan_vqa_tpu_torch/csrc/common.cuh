// Shared helpers for the port's kernels. Each kernel file exports a
// plain C function that launches on the caller's stream and returns
// cudaGetLastError() as an int, so the Python wrapper (ops/kernels.py,
// loaded with ctypes) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

#define MCAN_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// round-to-nearest-even, as JAX's astype(bfloat16)
__device__ __forceinline__ bf16 to_bf16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ bf16 to_bf16(bf16 x) { return x; }

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) { *p = to_bf16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// In-kernel dropout: Philox4x32-10 (Salmon et al., "Parallel random numbers:
// as easy as 1, 2, 3", SC'11; the Random123 round and constants), in place
// of the TPU kernels' hardware PRNG (mcan_vqa_tpu/ops/sga_train.py::
// _PrngMasks :187, sa_train.py::_PrngMasksSA :74). The TPU's bits cannot be
// reproduced; the keep decision and its scale are the TPU kernels':
// keep iff word < thresh, thresh = round((1 - rate) 2^32) clamped to
// [1, 2^32 - 1], kept values x 2^32 / thresh (prng_keep_params,
// sga_train.py:1451).
//
// Key (step seed, site code); counter (e >> 2, b, 0, 0); the element takes
// word e & 3. b is the sample, e the element's flat index in that sample's
// slab of the site: i * Lk + j in one head's attention map (the site code
// carries the head), r * N + c in the sample's rows of a [B * L, N] matrix.
// Every kernel that reads a site (forward, backward, the mask dump) calls
// philox_keep with the same (seed, site, b, e), so all regenerate one mask.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Inlined: the LayerNorm and attention kernels draw their bits in a rolled
// loop before their unrolled register arrays come live, so each has one
// copy (a copy per unrolled element took minutes to build)
__device__ __forceinline__ unsigned philox_word(unsigned seed, unsigned site, unsigned b,
                                                unsigned e) {
  const uint4 w = philox4x32_10(make_uint4(e >> 2, b, 0u, 0u), make_uint2(seed, site));
  const unsigned s = e & 3u;
  return s == 0u ? w.x : s == 1u ? w.y : s == 2u ? w.z : w.w;
}

// The seeded keep source of one dropout site, passed by value to a kernel
// that would otherwise read a uint8 keep-mask. on == 0: no seeded dropout.
// rows: the rows per sample of a [B * rows, N] operand (GEMM, LayerNorm);
// the attention kernels add the head to site.
struct Philox {
  int on;
  unsigned seed, site, thresh;
  int rows;
};

__device__ __forceinline__ bool philox_keep(const Philox& p, unsigned site, unsigned b,
                                            unsigned e) {
  return philox_word(p.seed, site, b, e) < p.thresh;
}

// row `row` of a [B * p.rows, n] operand, column c
__device__ __forceinline__ bool philox_keep_rows(const Philox& p, long long row, int n, int c) {
  const long long b = row / p.rows;
  return philox_keep(p, p.site, static_cast<unsigned>(b),
                     static_cast<unsigned>((row - b * p.rows) * n + c));
}

// 16-byte asynchronous copies into shared memory (the GEMMs' tile loads)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // n == 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
