// residual_layernorm: out = LN(res + drop(y (+ bias))) with the reference
// LayerNorm: gamma * (r - mean) / (std + 1e-6) + beta, std Bessel-corrected
// (divided by D - 1), eps added to the std. All arithmetic in f32, rounded
// as the JAX kernel it stands for: the serving kernels and model.apply
// divide by (std + eps); the train kernels multiply by its reciprocal
// (sga_train.py::_ln_fwd :100), flag `reciprocal`.
// residual_layernorm_bwd: the gradient of that LayerNorm, and of the
// dropout on its sublayer input.
//
// Replaces: the residual + LayerNorm epilogues of the TPU block kernels
//   mcan_vqa_tpu/ops/sga_block.py::_ln (:145) as called by
//   _sga_kernel_fusedproj (LN1 :297, LN2 :310, LN3 :318) and _sa_kernel
//   (LN1 :1010, LN2 :1017); the train kernels' residual + dropout + LN of
//   mcan_vqa_tpu/ops/sga_train.py::_fwd_kernel (:453, :468, :475; r =
//   x + _drop(y1) and so on, r3 saved), and their backward _ln_bwd_u
//   (:122-142) in _bwd_ffn_kernel_sav (:596) and _bwd_att_kernel (:687,
//   :736), which recomputes r1 / r2 from the residual and the sublayer
//   output (_bwd_att_kernel_sav reads them as saved); the same LN1 / LN2
//   forward and backward of mcan_vqa_tpu/ops/sa_train.py::_fwd_body
//   (:155, :161) and _bwd_body (:222, :247). The block's input stream
//   arrives bf16 and becomes f32 (:258); v1 and v2 stay f32 between the
//   sub-steps (:297, :310); only the block's output is cast to the stream
//   dtype (:320). So the residual may be bf16
//   or f32, and the kernel writes an f32 copy (the next residual), a bf16
//   copy (the next matmul's operand), or both. The saved pre-LN sum r (r3
//   of _fwd_kernel :481-485, r1 / r2 under att_saves :486-493, r2 of
//   mcan_vqa_tpu/ops/sa_train.py::_fwd_body :165-169) is written f32, or
//   bf16 under the train kernels' bf16_saves (save_dtype, :959-976); the
//   backward reads it back as it was saved, and reads a bf16 upstream
//   gradient (gv2 under bf16_saves, :1032) as bf16, widening both on load.
//
// Bounds on an H100: memory -- forward ~14 bytes moved per element for
// ~10 FLOPs, backward ~20 bytes for ~20 FLOPs.
// Design: one warp per row of D = 32 * VPT, the row held in registers
// (VPT values per lane, lane-strided so each load is coalesced), mean and
// centred sum of squares by warp shuffles; 8 rows per 256-thread block.
// The backward recomputes r, the normalised u = (r - mean) / (std + eps)
// and the std from the residual inputs -- never from the LN output -- and
// writes per element dr, dy = drop(dr) and g * u; the column sums that
// give dgamma / dbeta / the bias gradients are a separate pass
// (col_sum.cu), so every sum runs in a fixed order.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256, ROWS_PER_BLOCK = THREADS / 32;

// y + bias through the dropout keep-mask (x inv_keep), or 0 when y is null
__device__ __forceinline__ float sublayer(const float* y, const float* bias,
                                          const unsigned char* mask, float inv_keep, size_t e,
                                          int c) {
  if (y == nullptr) return 0.0f;
  float t = y[e];
  if (bias != nullptr) t += bias[c];
  if (mask != nullptr) t = mask[e] ? t * inv_keep : 0.0f;
  return t;
}

template <int VPT, typename ResT>
__global__ void __launch_bounds__(THREADS)
residual_layernorm_kernel(const ResT* __restrict__ res, const float* __restrict__ y,
                          const float* __restrict__ bias, const unsigned char* __restrict__ mask,
                          float inv_keep, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float* __restrict__ out_f32,
                          bf16* __restrict__ out_bf16, float* __restrict__ out_r,
                          bf16* __restrict__ out_r16, int rows, float eps, int reciprocal) {
  constexpr int D = 32 * VPT;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * D;

  float r[VPT];
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int c = lane + 32 * t;
    const float v = to_f32(res[base + c]) + sublayer(y, bias, mask, inv_keep, base + c, c);
    if (out_r != nullptr) out_r[base + c] = v;
    if (out_r16 != nullptr) out_r16[base + c] = to_bf16(v);
    r[t] = v;
    sum += v;
  }
  const float mean = warp_sum(sum) / D;
  float ss = 0.0f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    r[t] -= mean;
    ss += r[t] * r[t];
  }
  const float denom = sqrtf(warp_sum(ss) / (D - 1)) + eps;
  const float inv = 1.0f / denom;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int c = lane + 32 * t;
    const float o = (reciprocal ? gamma[c] * (r[t] * inv) : gamma[c] * r[t] / denom) + beta[c];
    if (out_f32 != nullptr) out_f32[base + c] = o;
    if (out_bf16 != nullptr) out_bf16[base + c] = to_bf16(o);
  }
}

// _ln_bwd_u (sga_train.py:122-142), per row:
//   c = r - mean, std = sqrt(sum(c^2) / (D - 1)), inv = 1 / (std + eps)
//   sg = gamma * g, dstd = -sum(sg * c) * inv^2, k = dstd / ((D - 1) std)
//   dc = sg * inv + c * k, dr = dc - mean(dc), u = c * inv
template <int VPT, typename GT, typename RT>
__global__ void __launch_bounds__(THREADS)
residual_layernorm_bwd_kernel(const GT* __restrict__ g, const RT* __restrict__ res,
                              const float* __restrict__ y, const float* __restrict__ bias,
                              const unsigned char* __restrict__ mask, float inv_keep,
                              const float* __restrict__ gamma, float* __restrict__ dr,
                              float* __restrict__ dy32, bf16* __restrict__ dy16,
                              float* __restrict__ gu, int rows, float eps) {
  constexpr int D = 32 * VPT;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * D;

  float c[VPT], sg[VPT];
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int col = lane + 32 * t;
    c[t] = to_f32(res[base + col]) + sublayer(y, bias, mask, inv_keep, base + col, col);
    sum += c[t];
  }
  const float mean = warp_sum(sum) / D;
  float ss = 0.0f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    c[t] -= mean;
    ss += c[t] * c[t];
  }
  const float stdv = sqrtf(warp_sum(ss) / (D - 1));
  const float inv = 1.0f / (stdv + eps);
  float dot = 0.0f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int col = lane + 32 * t;
    sg[t] = gamma[col] * to_f32(g[base + col]);
    dot += sg[t] * c[t];
  }
  const float dstd = -warp_sum(dot) * (inv * inv);
  const float kk = dstd / ((D - 1) * stdv);
  float dsum = 0.0f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    sg[t] = sg[t] * inv + c[t] * kk;  // dc
    dsum += sg[t];
  }
  const float dmean = warp_sum(dsum) / D;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int col = lane + 32 * t;
    const size_t e = base + col;
    const float d = sg[t] - dmean;
    dr[e] = d;
    gu[e] = to_f32(g[e]) * (c[t] * inv);
    const float dyv = mask == nullptr ? d : (mask[e] ? d * inv_keep : 0.0f);
    if (dy32 != nullptr) dy32[e] = dyv;
    if (dy16 != nullptr) dy16[e] = to_bf16(dyv);
  }
}

template <int VPT>
void launch(const void* res, int res_bf16, const void* y, const void* bias, const void* mask,
            float inv_keep, const void* gamma, const void* beta, void* out_f32, void* out_bf16,
            void* out_r, void* out_r16, int rows, float eps, int reciprocal, cudaStream_t s) {
  const int grid = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const float* yf = static_cast<const float*>(y);
  const float* bf = static_cast<const float*>(bias);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const float* gf = static_cast<const float*>(gamma);
  const float* btf = static_cast<const float*>(beta);
  float* of = static_cast<float*>(out_f32);
  bf16* ob = static_cast<bf16*>(out_bf16);
  float* orr = static_cast<float*>(out_r);
  bf16* orr16 = static_cast<bf16*>(out_r16);
  if (res_bf16)
    residual_layernorm_kernel<VPT, bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(res), yf, bf, mk, inv_keep, gf, btf, of, ob, orr, orr16, rows,
        eps, reciprocal);
  else
    residual_layernorm_kernel<VPT, float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(res), yf, bf, mk, inv_keep, gf, btf, of, ob, orr, orr16, rows,
        eps, reciprocal);
}

template <int VPT, typename GT, typename RT>
void launch_bwd_t(const void* g, const void* res, const void* y, const void* bias,
                  const void* mask, float inv_keep, const void* gamma, void* dr, void* dy32,
                  void* dy16, void* gu, int rows, float eps, cudaStream_t s) {
  const int grid = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  residual_layernorm_bwd_kernel<VPT, GT, RT><<<grid, THREADS, 0, s>>>(
      static_cast<const GT*>(g), static_cast<const RT*>(res), static_cast<const float*>(y),
      static_cast<const float*>(bias), static_cast<const unsigned char*>(mask), inv_keep,
      static_cast<const float*>(gamma), static_cast<float*>(dr), static_cast<float*>(dy32),
      static_cast<bf16*>(dy16), static_cast<float*>(gu), rows, eps);
}

template <int VPT>
void launch_bwd(const void* g, int g_bf16, const void* res, int res_bf16, const void* y,
                const void* bias, const void* mask, float inv_keep, const void* gamma, void* dr,
                void* dy32, void* dy16, void* gu, int rows, float eps, cudaStream_t s) {
#define MCAN_LN_BWD_ARGS g, res, y, bias, mask, inv_keep, gamma, dr, dy32, dy16, gu, rows, eps, s
  if (g_bf16 && res_bf16) launch_bwd_t<VPT, bf16, bf16>(MCAN_LN_BWD_ARGS);
  else if (g_bf16) launch_bwd_t<VPT, bf16, float>(MCAN_LN_BWD_ARGS);
  else if (res_bf16) launch_bwd_t<VPT, float, bf16>(MCAN_LN_BWD_ARGS);
  else launch_bwd_t<VPT, float, float>(MCAN_LN_BWD_ARGS);
#undef MCAN_LN_BWD_ARGS
}

}  // namespace

// res [rows, D] bf16 (res_bf16 != 0) or f32; y [rows, D] f32 or null; bias,
// gamma, beta [D] f32 (bias may be null); mask: null or uint8 keep-mask
// [rows, D] on y + bias (x inv_keep); out_f32 / out_bf16 / out_r / out_r16
// [rows, D], each may be null (out_r / out_r16: the pre-LN sum r, f32 /
// bf16). reciprocal != 0: scale
// by 1 / (std + eps) instead of dividing. D must be 512 (MCAN-small) or
// 1024 (MCAN-large). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for another D.
MCAN_API int mcan_residual_layernorm(const void* res, int res_bf16, const void* y,
                                     const void* bias, const void* mask, float inv_keep,
                                     const void* gamma, const void* beta, void* out_f32,
                                     void* out_bf16, void* out_r, void* out_r16, int rows, int D,
                                     float eps, int reciprocal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    switch (D) {
      case 512: launch<16>(res, res_bf16, y, bias, mask, inv_keep, gamma, beta, out_f32, out_bf16, out_r, out_r16, rows, eps, reciprocal, s); break;
      case 1024: launch<32>(res, res_bf16, y, bias, mask, inv_keep, gamma, beta, out_f32, out_bf16, out_r, out_r16, rows, eps, reciprocal, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// g (the gradient of the LN output) and res [rows, D], each f32 or bf16
// (g_bf16, res_bf16), y [rows, D] f32 or null (then r = res), bias [D] or
// null, mask null or uint8 [rows, D], gamma [D].
// r = res + drop(y + bias). Writes dr = dLN/dr . g, dy = drop(dr) as f32
// and/or bf16 (either may be null) and gu = g * u, all [rows, D].
MCAN_API int mcan_residual_layernorm_bwd(const void* g, int g_bf16, const void* res,
                                         int res_bf16, const void* y, const void* bias,
                                         const void* mask, float inv_keep,
                                         const void* gamma, void* dr, void* dy32, void* dy16,
                                         void* gu, int rows, int D, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    switch (D) {
      case 512: launch_bwd<16>(g, g_bf16, res, res_bf16, y, bias, mask, inv_keep, gamma, dr, dy32, dy16, gu, rows, eps, s); break;
      case 1024: launch_bwd<32>(g, g_bf16, res, res_bf16, y, bias, mask, inv_keep, gamma, dr, dy32, dy16, gu, rows, eps, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
