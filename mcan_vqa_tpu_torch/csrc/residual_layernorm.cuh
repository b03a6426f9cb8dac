// What residual_layernorm.cu (forward), residual_layernorm_bwd.cu
// (backward), gemm_ln.cu and the all-layer stacks share: the block shapes,
// the choice of kernel by width, the row statistics of a row staged in
// shared memory or held in registers, and the dropout keep source.
#pragma once

#include <math.h>

#include "common.cuh"

namespace ln {

// the row-in-registers kernels: one warp per row, 8 rows per block
constexpr int THREADS = 256, ROWS_PER_BLOCK = THREADS / 32;
// the rolled kernels (every other width): one warp per row, 4 rows per
// block, each row staged in shared memory
constexpr int ROLLED_THREADS = 128, ROLLED_ROWS = ROLLED_THREADS / 32;
constexpr int MAX_D = 2048;

// the values per lane of a width with a row-in-registers instance (256,
// 512, 1024: MCAN-small, MCAN-large and hidden 256), else 0: the rolled
// kernel, for any other multiple of 32 up to MAX_D
inline int vpt_of(int D) { return D == 256 || D == 512 || D == 1024 ? D / 32 : 0; }

inline bool width_ok(int D) { return D >= 32 && D <= MAX_D && D % 32 == 0; }

// The row r[0, D) that one warp holds in shared memory, each lane its
// columns lane, lane + 32, ... (the only ones it reads back), and `sum`
// this lane's part of the row's sum: centres r in place and returns the
// Bessel-corrected std + eps, the denominator of the reference LayerNorm
// (sqrt(sum (r - mean)^2 / (D - 1)) + eps).
__device__ __forceinline__ float centre_row(float* r, int D, int lane, float sum, float eps) {
  const float mean = warp_sum(sum) / D;
  float ss = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = r[c] - mean;
    r[c] = d;
    ss += d * d;
  }
  return sqrtf(warp_sum(ss) / (D - 1)) + eps;
}

// centre_row for a row that one warp holds in registers: this lane's
// values r[0, n) (n <= N; r[n, N) unused), the row D wide, `sum` this
// lane's part of its sum. Centres r[0, n) in place and returns the same
// denominator.
template <int N>
__device__ __forceinline__ float centre_regs(float (&r)[N], int n, int D, float sum, float eps) {
  const float mean = warp_sum(sum) / D;
  float ss = 0.0f;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (t < n) {
      r[t] -= mean;
      ss += r[t] * r[t];
    }
  }
  return sqrtf(warp_sum(ss) / (D - 1)) + eps;
}

// bit t: keep element lane + 32 t of the row (t < nv), drawn by Philox in a
// rolled loop before the row is loaded, so that no call lies among the
// row's unrolled registers
__device__ __forceinline__ unsigned long long drawn_bits(const Philox& p, int row, int D,
                                                         int lane, int nv) {
  unsigned long long bits = 0;
#pragma unroll 1
  for (int t = 0; t < nv; ++t)
    bits |= static_cast<unsigned long long>(philox_keep_rows(p, row, D, lane + 32 * t)) << t;
  return bits;
}

// u through the dropout on the sublayer input: kept (x inv_keep) or 0 by
// `keep` when DRAWN, else by the uint8 keep-mask when one is given
template <bool DRAWN>
__device__ __forceinline__ float drop_in(float u, const unsigned char* mask, bool keep, size_t e,
                                         float inv_keep) {
  if (DRAWN) return keep ? u * inv_keep : 0.0f;
  if (mask != nullptr) return mask[e] ? u * inv_keep : 0.0f;
  return u;
}

}  // namespace ln
