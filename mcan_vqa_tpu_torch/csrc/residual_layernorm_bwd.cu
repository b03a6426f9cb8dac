// residual_layernorm_bwd: the gradient of residual_layernorm.cu's
// LayerNorm, out = LN(res + drop(y (+ bias))), and of the dropout on its
// sublayer input; the train kernels' backward _ln_bwd_u
// (mcan_vqa_tpu/ops/sga_train.py:122-142) in _bwd_ffn_kernel_sav (:596),
// _bwd_att_kernel (:687, :736) and _bwd_att_kernel_sav, and the LN1 / LN2
// backward of mcan_vqa_tpu/ops/sa_train.py::_bwd_body (:222, :247), with
// their _prng bodies (:617, :812, :1202; sa_train.py :295, :314), which
// regenerate the forward's keep bits. Numerics, layout, dropout and design
// as in residual_layernorm.cu: one warp per row, held in registers at D =
// 256, 512 and 1024 and staged in shared memory (the centred row) by the
// rolled kernel at any other width; the dtypes of g and res and the keep
// source template parameters.
#include <math.h>

#include "residual_layernorm.cuh"

namespace {

using ln::ROLLED_ROWS;
using ln::ROLLED_THREADS;
using ln::ROWS_PER_BLOCK;
using ln::THREADS;

// _ln_bwd_u (sga_train.py:122-142), per row:
//   c = r - mean, std = sqrt(sum(c^2) / (D - 1)), inv = 1 / (std + eps)
//   sg = gamma * g, dstd = -sum(sg * c) * inv^2, k = dstd / ((D - 1) std)
//   dc = sg * inv + c * k, dr = dc - mean(dc), u = c * inv
// the row in registers, D = 32 * VPT
template <int VPT, typename GT, typename RT, bool DRAWN>
__global__ void __launch_bounds__(THREADS)
residual_layernorm_bwd_kernel(const GT* __restrict__ g, const RT* __restrict__ res,
                              const float* __restrict__ y, const float* __restrict__ bias,
                              const unsigned char* __restrict__ mask, Philox keep,
                              float inv_keep, const float* __restrict__ gamma,
                              float* __restrict__ dr, float* __restrict__ dy32,
                              bf16* __restrict__ dy16, float* __restrict__ gu, int rows,
                              float eps) {
  constexpr int D = 32 * VPT;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  // the keep source gates y + bias in r (with y) and the gradient dy (always)
  const unsigned long long kb = DRAWN ? ln::drawn_bits(keep, row, D, lane, VPT) : 0ull;

  float c[VPT], sg[VPT];
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < VPT; ++t) {
    const int col = lane + 32 * t;
    float v = to_f32(res[base + col]);
    if (y != nullptr) {
      float u = y[base + col];
      if (bias != nullptr) u += bias[col];
      v += ln::drop_in<DRAWN>(u, mask, (kb >> t) & 1ull, base + col, inv_keep);
    }
    c[t] = v;
    sum += v;
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
    const size_t e = base + lane + 32 * t;
    const float d = sg[t] - dmean;
    dr[e] = d;
    gu[e] = to_f32(g[e]) * (c[t] * inv);
    const float dyv = ln::drop_in<DRAWN>(d, mask, (kb >> t) & 1ull, e, inv_keep);
    if (dy32 != nullptr) dy32[e] = dyv;
    if (dy16 != nullptr) dy16[e] = to_bf16(dyv);
  }
}

// any other width: the centred row staged in shared memory, the loops
// rolled, gamma * g and the keep decision recomputed where needed
template <typename GT, typename RT, bool DRAWN>
__global__ void __launch_bounds__(ROLLED_THREADS)
residual_layernorm_bwd_rolled_kernel(const GT* __restrict__ g, const RT* __restrict__ res,
                                     const float* __restrict__ y, const float* __restrict__ bias,
                                     const unsigned char* __restrict__ mask, Philox keep,
                                     float inv_keep, const float* __restrict__ gamma,
                                     float* __restrict__ dr, float* __restrict__ dy32,
                                     bf16* __restrict__ dy16, float* __restrict__ gu, int rows,
                                     int D, float eps) {
  __shared__ float cs[ROLLED_ROWS][ln::MAX_D];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row = blockIdx.x * ROLLED_ROWS + w;
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  float* c = cs[w];  // each lane reads back only the columns it wrote

  float sum = 0.0f;
  for (int col = lane; col < D; col += 32) {
    float v = to_f32(res[base + col]);
    if (y != nullptr) {
      float u = y[base + col];
      if (bias != nullptr) u += bias[col];
      const bool k = DRAWN && philox_keep_rows(keep, row, D, col);
      v += ln::drop_in<DRAWN>(u, mask, k, base + col, inv_keep);
    }
    c[col] = v;
    sum += v;
  }
  const float mean = warp_sum(sum) / D;
  float ss = 0.0f;
  for (int col = lane; col < D; col += 32) {
    const float d = c[col] - mean;
    c[col] = d;
    ss += d * d;
  }
  const float stdv = sqrtf(warp_sum(ss) / (D - 1));
  const float inv = 1.0f / (stdv + eps);
  float dot = 0.0f;
  for (int col = lane; col < D; col += 32)
    dot += gamma[col] * to_f32(g[base + col]) * c[col];
  const float dstd = -warp_sum(dot) * (inv * inv);
  const float kk = dstd / ((D - 1) * stdv);
  float dsum = 0.0f;
  for (int col = lane; col < D; col += 32)
    dsum += gamma[col] * to_f32(g[base + col]) * inv + c[col] * kk;
  const float dmean = warp_sum(dsum) / D;
  for (int col = lane; col < D; col += 32) {
    const size_t e = base + col;
    const float gv = to_f32(g[e]);
    const float d = (gamma[col] * gv * inv + c[col] * kk) - dmean;
    dr[e] = d;
    gu[e] = gv * (c[col] * inv);
    const bool k = DRAWN && philox_keep_rows(keep, row, D, col);
    const float dyv = ln::drop_in<DRAWN>(d, mask, k, e, inv_keep);
    if (dy32 != nullptr) dy32[e] = dyv;
    if (dy16 != nullptr) dy16[e] = to_bf16(dyv);
  }
}

struct Args {
  const void *g, *res, *y, *bias, *mask;
  Philox keep;
  float inv_keep;
  const void* gamma;
  void *dr, *dy32, *dy16, *gu;
  int rows, D;
  float eps;
};

// VPT > 0: the row-in-registers kernel; 0: the rolled one
template <int VPT, typename GT, typename RT, bool DRAWN>
void launch_t(const Args& a, cudaStream_t s) {
#define MCAN_LN_BWD_PTRS static_cast<const GT*>(a.g), static_cast<const RT*>(a.res),            \
                         static_cast<const float*>(a.y), static_cast<const float*>(a.bias),      \
                         static_cast<const unsigned char*>(a.mask), a.keep, a.inv_keep,          \
                         static_cast<const float*>(a.gamma), static_cast<float*>(a.dr),          \
                         static_cast<float*>(a.dy32), static_cast<bf16*>(a.dy16),                \
                         static_cast<float*>(a.gu), a.rows
  if constexpr (VPT > 0) {
    const int grid = (a.rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    residual_layernorm_bwd_kernel<VPT, GT, RT, DRAWN><<<grid, THREADS, 0, s>>>(
        MCAN_LN_BWD_PTRS, a.eps);
  } else {
    const int grid = (a.rows + ROLLED_ROWS - 1) / ROLLED_ROWS;
    residual_layernorm_bwd_rolled_kernel<GT, RT, DRAWN><<<grid, ROLLED_THREADS, 0, s>>>(
        MCAN_LN_BWD_PTRS, a.D, a.eps);
  }
#undef MCAN_LN_BWD_PTRS
}

template <int VPT, bool DRAWN>
void launch_k(int g_bf16, int res_bf16, const Args& a, cudaStream_t s) {
  if (g_bf16 && res_bf16) launch_t<VPT, bf16, bf16, DRAWN>(a, s);
  else if (g_bf16) launch_t<VPT, bf16, float, DRAWN>(a, s);
  else if (res_bf16) launch_t<VPT, float, bf16, DRAWN>(a, s);
  else launch_t<VPT, float, float, DRAWN>(a, s);
}

template <int VPT>
void launch(int g_bf16, int res_bf16, const Args& a, cudaStream_t s) {
  if (a.keep.on) launch_k<VPT, true>(g_bf16, res_bf16, a, s);
  else launch_k<VPT, false>(g_bf16, res_bf16, a, s);
}

}  // namespace

// g (the gradient of the LN output) and res [rows, D], each f32 or bf16
// (g_bf16, res_bf16), y [rows, D] f32 or null (then r = res), bias [D] or
// null, mask null or uint8 [rows, D] (or keep_on, as in the forward),
// gamma [D]. r = res + drop(y + bias). Writes dr = dLN/dr . g, dy =
// drop(dr) as f32 and/or bf16 (either may be null) and gu = g * u, all
// [rows, D]. D as in the forward.
MCAN_API int mcan_residual_layernorm_bwd(const void* g, int g_bf16, const void* res,
                                         int res_bf16, const void* y, const void* bias,
                                         const void* mask, float inv_keep, int keep_on,
                                         unsigned seed, unsigned site, unsigned thresh,
                                         int keep_rows, const void* gamma, void* dr, void* dy32,
                                         void* dy16, void* gu, int rows, int D, float eps,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!ln::width_ok(D)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{g, res, y, bias, mask, Philox{keep_on, seed, site, thresh, keep_rows}, inv_keep,
               gamma, dr, dy32, dy16, gu, rows, D, eps};
  if (rows > 0) {
    switch (ln::vpt_of(D)) {
      case 8: launch<8>(g_bf16, res_bf16, a, s); break;
      case 16: launch<16>(g_bf16, res_bf16, a, s); break;
      case 32: launch<32>(g_bf16, res_bf16, a, s); break;
      default: launch<0>(g_bf16, res_bf16, a, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
