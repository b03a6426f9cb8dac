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
// Design: one warp per row. At D = 256, 512 and 1024 (hidden 256,
// MCAN-small, MCAN-large) the row is held in registers, D / 32 values per
// lane, lane-strided so each load is coalesced, the width a template
// constant: every load an immediate offset from one address, all in
// flight together; 8 rows per 256-thread block. Any other multiple of 32
// up to 2048 (every width the JAX package serves and trains) takes the
// rolled kernel: 4 rows per 128-thread block, each row staged in shared
// memory (8 KB at 2048), the loops rolled. The input dtypes and the keep
// source (a keep-mask or none, or the drawn bits) are template parameters
// of both. Mean and centred sum of squares by warp shuffles; each lane sums
// its columns lane, lane + 32, ... in order in either kernel.
// The backward (residual_layernorm_bwd.cu) recomputes r, the normalised
// u = (r - mean) / (std + eps) and the std from the residual inputs --
// never from the LN output -- and writes per element dr, dy = drop(dr) and
// g * u; the column sums that give dgamma / dbeta / the bias gradients are
// a separate pass (col_sum.cu), so every sum runs in a fixed order.
// Dropout on y + bias: a uint8 keep-mask, or the seeded Philox keep source
// (common.cuh) of the train kernels' in-kernel dropout (sga_train.py::
// _fwd_kernel_prng :507 sites Y1 / Y2 / Y3, sa_train.py::_fwd_kernel_prng
// :179 sites Y1 / Y2, and their backward kernels :617, :812, :1202, :295,
// :314, which regenerate the same bits): row = b * rows + r, e = r * D + c.
#include <math.h>

#include "residual_layernorm.cuh"

namespace {

using ln::ROLLED_ROWS;
using ln::ROLLED_THREADS;
using ln::ROWS_PER_BLOCK;
using ln::THREADS;

// the row in registers, D = 32 * VPT
template <int VPT, typename ResT, bool DRAWN>
__global__ void __launch_bounds__(THREADS)
residual_layernorm_kernel(const ResT* __restrict__ res, const float* __restrict__ y,
                          const float* __restrict__ bias, const unsigned char* __restrict__ mask,
                          Philox keep, float inv_keep, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float* __restrict__ out_f32,
                          bf16* __restrict__ out_bf16, float* __restrict__ out_r,
                          bf16* __restrict__ out_r16, int rows, float eps, int reciprocal) {
  constexpr int D = 32 * VPT;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  const unsigned long long kb = DRAWN ? ln::drawn_bits(keep, row, D, lane, VPT) : 0ull;

  float r[VPT];
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int c = lane + 32 * t;
    float v = to_f32(res[base + c]);
    if (y != nullptr) {  // + drop(y + bias)
      float u = y[base + c];
      if (bias != nullptr) u += bias[c];
      v += ln::drop_in<DRAWN>(u, mask, (kb >> t) & 1ull, base + c, inv_keep);
    }
    if (out_r != nullptr) out_r[base + c] = v;
    if (out_r16 != nullptr) out_r16[base + c] = to_bf16(v);
    r[t] = v;
    sum += v;
  }
  const float denom = ln::centre_regs(r, VPT, D, sum, eps);
  const float inv = 1.0f / denom;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int c = lane + 32 * t;
    const float o = (reciprocal ? gamma[c] * (r[t] * inv) : gamma[c] * r[t] / denom) + beta[c];
    if (out_f32 != nullptr) out_f32[base + c] = o;
    if (out_bf16 != nullptr) out_bf16[base + c] = to_bf16(o);
  }
}

// any other width: the row staged in shared memory, the loops rolled
template <typename ResT, bool DRAWN>
__global__ void __launch_bounds__(ROLLED_THREADS)
residual_layernorm_rolled_kernel(const ResT* __restrict__ res, const float* __restrict__ y,
                                 const float* __restrict__ bias,
                                 const unsigned char* __restrict__ mask, Philox keep,
                                 float inv_keep, const float* __restrict__ gamma,
                                 const float* __restrict__ beta, float* __restrict__ out_f32,
                                 bf16* __restrict__ out_bf16, float* __restrict__ out_r,
                                 bf16* __restrict__ out_r16, int rows, int D, float eps,
                                 int reciprocal) {
  __shared__ float rs[ROLLED_ROWS][ln::MAX_D];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row = blockIdx.x * ROLLED_ROWS + w;
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  float* r = rs[w];  // each lane reads back only the columns it wrote

  float sum = 0.0f;
  for (int c = lane; c < D; c += 32) {
    float v = to_f32(res[base + c]);
    if (y != nullptr) {
      float u = y[base + c];
      if (bias != nullptr) u += bias[c];
      const bool k = DRAWN && philox_keep_rows(keep, row, D, c);
      v += ln::drop_in<DRAWN>(u, mask, k, base + c, inv_keep);
    }
    if (out_r != nullptr) out_r[base + c] = v;
    if (out_r16 != nullptr) out_r16[base + c] = to_bf16(v);
    r[c] = v;
    sum += v;
  }
  const float denom = ln::centre_row(r, D, lane, sum, eps);
  const float inv = 1.0f / denom;
  for (int c = lane; c < D; c += 32) {
    const float o = (reciprocal ? gamma[c] * (r[c] * inv) : gamma[c] * r[c] / denom) + beta[c];
    if (out_f32 != nullptr) out_f32[base + c] = o;
    if (out_bf16 != nullptr) out_bf16[base + c] = to_bf16(o);
  }
}

struct Args {
  const void *res, *y, *bias, *mask;
  Philox keep;
  float inv_keep;
  const void *gamma, *beta;
  void *out_f32, *out_bf16, *out_r, *out_r16;
  int rows, D;
  float eps;
  int reciprocal;
};

// VPT > 0: the row-in-registers kernel; 0: the rolled one
template <int VPT, typename ResT, bool DRAWN>
void launch_t(const Args& a, cudaStream_t s) {
#define MCAN_LN_PTRS static_cast<const ResT*>(a.res), static_cast<const float*>(a.y),          \
                     static_cast<const float*>(a.bias),                                        \
                     static_cast<const unsigned char*>(a.mask), a.keep, a.inv_keep,           \
                     static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),   \
                     static_cast<float*>(a.out_f32), static_cast<bf16*>(a.out_bf16),          \
                     static_cast<float*>(a.out_r), static_cast<bf16*>(a.out_r16), a.rows
  if constexpr (VPT > 0) {
    const int grid = (a.rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    residual_layernorm_kernel<VPT, ResT, DRAWN><<<grid, THREADS, 0, s>>>(
        MCAN_LN_PTRS, a.eps, a.reciprocal);
  } else {
    const int grid = (a.rows + ROLLED_ROWS - 1) / ROLLED_ROWS;
    residual_layernorm_rolled_kernel<ResT, DRAWN><<<grid, ROLLED_THREADS, 0, s>>>(
        MCAN_LN_PTRS, a.D, a.eps, a.reciprocal);
  }
#undef MCAN_LN_PTRS
}

template <int VPT>
void launch(int res_bf16, const Args& a, cudaStream_t s) {
  if (a.keep.on) {
    if (res_bf16) launch_t<VPT, bf16, true>(a, s);
    else launch_t<VPT, float, true>(a, s);
  } else {
    if (res_bf16) launch_t<VPT, bf16, false>(a, s);
    else launch_t<VPT, float, false>(a, s);
  }
}

}  // namespace

// res [rows, D] bf16 (res_bf16 != 0) or f32; y [rows, D] f32 or null; bias,
// gamma, beta [D] f32 (bias may be null); mask: null or uint8 keep-mask
// [rows, D] on y + bias (x inv_keep); keep_on != 0 draws that mask in place
// (mask null then): Philox key (seed, site), keep_rows rows per sample,
// keep iff word < thresh. out_f32 / out_bf16 / out_r / out_r16 [rows, D],
// each may be null (out_r / out_r16: the pre-LN sum r, f32 / bf16).
// reciprocal != 0: scale by 1 / (std + eps) instead of dividing. D must be
// a multiple of 32, at most 2048. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another D.
MCAN_API int mcan_residual_layernorm(const void* res, int res_bf16, const void* y,
                                     const void* bias, const void* mask, float inv_keep,
                                     int keep_on, unsigned seed, unsigned site, unsigned thresh,
                                     int keep_rows, const void* gamma, const void* beta,
                                     void* out_f32, void* out_bf16, void* out_r, void* out_r16,
                                     int rows, int D, float eps, int reciprocal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!ln::width_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{res, y, bias, mask, Philox{keep_on, seed, site, thresh, keep_rows}, inv_keep,
               gamma, beta, out_f32, out_bf16, out_r, out_r16, rows, D, eps, reciprocal};
  if (rows > 0) {
    switch (ln::vpt_of(D)) {
      case 8: launch<8>(res_bf16, a, s); break;
      case 16: launch<16>(res_bf16, a, s); break;
      case 32: launch<32>(res_bf16, a, s); break;
      default: launch<0>(res_bf16, a, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
