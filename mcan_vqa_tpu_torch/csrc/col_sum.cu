// col_sum: out[c] = sum over rows r of x[r, c], f32 sums of f32 or bf16
// matrices, for up to four matrices with the same number of rows in one
// launch.
//
// Replaces: the row-sum partials of the TPU train kernels' weight
//   gradients, mcan_vqa_tpu/ops/sga_train.py::_rsum (:406) accumulated by
//   _acc (:390) -- the bias gradients db1, db2 (:526, :528), dbqkv, dbm1,
//   dbq2, dbm2 (:785-793) and the LayerNorm gradients dln*_s = sum(g * u),
//   dln*_b = sum(g) (:529-530, :788-795), summed over all B * Lv rows; and
//   the same twelve sums of mcan_vqa_tpu/ops/sa_train.py::_bwd_body
//   (:273-284). Under bf16_saves the upstream gradient gv2 is bf16
//   (sga_train.py:1032), and dln2_b sums it as it is.
//
// Bounds on an H100: memory -- each input element is read once for one
// add (7.9 MB per [3840, 512] matrix, 2.3 us at 3.35 TB/s).
//
// Design (simple first, and deterministic): one block of 32 columns x 16
// row groups; thread (g, c) sums rows g, g + 16, ... of its column in
// order, and the 16 partials are added in a fixed order in shared memory.
// No atomics: the same inputs give the same bits on every run.
#include "common.cuh"

namespace {

constexpr int COLS = 32, GROUPS = 16, THREADS = COLS * GROUPS, MAX_SUMS = 4;

struct Sums {
  const void* src[MAX_SUMS];
  int bf16_src[MAX_SUMS];       // 1: src is bf16, else f32
  long long ld[MAX_SUMS];
  int cols[MAX_SUMS];
  float* dst[MAX_SUMS];
};

__global__ void __launch_bounds__(THREADS) col_sum_kernel(Sums s, int rows) {
  __shared__ float part[GROUPS][COLS];
  const int which = blockIdx.y;
  const int c = blockIdx.x * COLS + (threadIdx.x % COLS);
  const int g = threadIdx.x / COLS;
  const int ncols = s.cols[which];
  if (blockIdx.x * COLS >= ncols) return;  // the whole block is past the end
  const long long ld = s.ld[which];
  float acc = 0.0f;
  if (c < ncols) {
    if (s.bf16_src[which]) {
      const bf16* src = static_cast<const bf16*>(s.src[which]);
      for (int r = g; r < rows; r += GROUPS) acc += to_f32(src[(size_t)r * ld + c]);
    } else {
      const float* src = static_cast<const float*>(s.src[which]);
      for (int r = g; r < rows; r += GROUPS) acc += src[(size_t)r * ld + c];
    }
  }
  part[g][threadIdx.x % COLS] = acc;
  __syncthreads();
  if (g == 0 && c < ncols) {
    float tot = 0.0f;
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) tot += part[k][threadIdx.x];
    s.dst[which][c] = tot;
  }
}

}  // namespace

// n (1..4) column sums over `rows` rows: srcs[i] [rows, cols[i]], bf16
// where bf16s[i] != 0 else f32, with row stride lds[i] (elements), dsts[i]
// f32 [cols[i]]. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for n outside 1..4.
MCAN_API int mcan_col_sum(int n, const void* const* srcs, const int* bf16s, const long long* lds,
                          const int* cols, void* const* dsts, int rows, void* stream) {
  if (n < 1 || n > MAX_SUMS) return static_cast<int>(cudaErrorInvalidValue);
  Sums s{};
  int max_cols = 0;
  for (int i = 0; i < n; ++i) {
    s.src[i] = srcs[i];
    s.bf16_src[i] = bf16s[i];
    s.ld[i] = lds[i];
    s.cols[i] = cols[i];
    s.dst[i] = static_cast<float*>(dsts[i]);
    max_cols = cols[i] > max_cols ? cols[i] : max_cols;
  }
  if (rows > 0 && max_cols > 0) {
    dim3 grid((max_cols + COLS - 1) / COLS, n);
    col_sum_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(s, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
