// quantize_rows: symmetric int8 codes of f32 or bf16 rows [M, K], one
// scale per row (dynamic) or one scale for the whole tensor (static).
//   dynamic: s[m] = max_k |x[m, k]| / 127 (0 -> 1), q = clip(rint(x / s), +-127)
//   static:  q = clip(rint(x * inv_a), +-127), inv_a = 1 / a rounded to f32
//
// Replaces: the activation quantization inside the TPU kernels
//   mcan_vqa_tpu/ops/quant.py::_sga_kernel_qffn (:1057) and
//   ::_sa_kernel_qffn (:1184) -- ``_qrow`` (:245) under ``_qdot`` (:253)
//   and the first line of ``_qdot_static`` (:263), which quantize the FFN
//   input (the f32 LayerNorm output), the FFN's ReLU output h1, the qkv
//   input (the bf16 stream) and, at level 3, the f32 attention output and
//   the cross-q input, in registers between the block's matmuls.
//
// Numerics: every step is one correctly rounded IEEE operation (a true
// division, never a reciprocal multiply, for x / s; rint is round half to
// even, as jnp.round), so the codes and scales equal the plain version's
// bit for bit. The build has no --use_fast_math, and the explicit
// __fdiv_rn / __fmul_rn keep the compiler from contracting or
// approximating them.
//
// Bounds on an H100: a pure stream, one read of x (two for the dynamic
// max, the second from L1/L2) and one write of the codes: at the FFN's w2
// site of a B=64 SGA block (3840 x 2048 f32) 31 MB in, 7.9 MB out, ~12 us
// at 3.35 TB/s. Design (simple first): one warp per row, lanes striding
// the row; the row max by shuffles. Not yet: vectorised loads, fusion into
// the producer's epilogue (the LN, the GEMM, the attention).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename T, bool DYNAMIC>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const T* __restrict__ x, long long ldx, int M, int K, float inv_a,
                     signed char* __restrict__ q, float* __restrict__ scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * ldx;
  signed char* qr = q + (size_t)row * K;
  float s = 1.0f;
  if (DYNAMIC) {
    float m = 0.0f;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(to_f32(xr[k])));
    m = warp_max(m);
    s = __fdiv_rn(m, 127.0f);
    if (s == 0.0f) s = 1.0f;
    if (lane == 0) scale[row] = s;
  }
  for (int k = lane; k < K; k += 32) {
    const float v = to_f32(xr[k]);
    float r = DYNAMIC ? rintf(__fdiv_rn(v, s)) : rintf(__fmul_rn(v, inv_a));
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    qr[k] = static_cast<signed char>(static_cast<int>(r));
  }
}

template <typename T>
void launch(const void* x, long long ldx, int M, int K, int dynamic, float inv_a, void* q,
            void* scale, cudaStream_t s) {
  const int grid = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const T* xt = static_cast<const T*>(x);
  signed char* qt = static_cast<signed char*>(q);
  float* st = static_cast<float*>(scale);
  if (dynamic)
    quantize_rows_kernel<T, true><<<grid, THREADS, 0, s>>>(xt, ldx, M, K, inv_a, qt, st);
  else
    quantize_rows_kernel<T, false><<<grid, THREADS, 0, s>>>(xt, ldx, M, K, inv_a, qt, st);
}

}  // namespace

// x: f32 (x_bf16 == 0) or bf16 rows, element [m, k] at x + m*ldx + k.
// q: int8 [M, K], contiguous. scale: f32 [M], written when dynamic (may be
// null otherwise). inv_a: the static multiplier (unused when dynamic).
// Returns cudaGetLastError().
MCAN_API int mcan_quantize_rows(const void* x, int x_bf16, long long ldx, int M, int K,
                                int dynamic, float inv_a, void* q, void* scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && K > 0) {
    if (x_bf16)
      launch<bf16>(x, ldx, M, K, dynamic, inv_a, q, scale, s);
    else
      launch<float>(x, ldx, M, K, dynamic, inv_a, q, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
