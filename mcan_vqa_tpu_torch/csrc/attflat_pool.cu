// attflat_pool: the part of AttFlat between its two products, per sample b:
//   logits[l, g] = h[b, l, :] . w2[:, g] + b2[g] + pad[b, l] * -1e9
//   att[b, :, g] = softmax over l of logits[:, g]          (f32)
//   pooled[b, g * D + d] = bf16(sum_l bf16(att[b, l, g]) * bf16(x[b, l, d]))
//
// Replaces: mcan_vqa_tpu/ops/attflat.py::_attflat_kernel (attflat_pallas,
//   call :72), which keeps one sample's whole AttFlat chain in VMEM: the
//   MLP, the mask, the softmax over L, the glimpse-weighted sum and the
//   merge. Here the MLP's first product (h = relu(x . W1 + b1), bf16) and
//   the merge (pooled . Wm + bm) run on gemm_bias_act (ops/attflat.py), and
//   this kernel does what lies between them: the 512-wide logit product,
//   the mask, the softmax and the pooling, with the [L, G] logits and
//   weights never leaving shared memory. Its outputs are what the merge
//   reads (pooled, bf16: the kernel's flat.astype(bfloat16)) and the
//   weights the TPU kernel returns (att, f32).
//
// Numerics, as in _attflat_kernel: h and w2 bf16, the logit sums in f32,
//   + b2, then the pad row's logits + -1e9 (an addition, as the kernel's
//   pad * _NEG_INF: in f32 -1e9 absorbs any logit under 32, so a fully
//   padded sample gets a uniform softmax, as model.apply's where gives);
//   max, exp and sum over L in f32, att = e / sum; the pooling of bf16
//   operands in f32, rounded once to bf16.
//
// Bounds on an H100: per sample L x (Fm + D) x 2 bytes read, a few kFLOP:
//   bytes, a few microseconds at B = 64; at B = 1 one block, latency.
// Design (simple first): one block of 8 warps per sample; one warp per row
//   for the logits (lanes along Fm, a shuffle sum per glimpse), one warp
//   per glimpse for the softmax (lanes along L), then every thread one
//   (glimpse, column) of the pooled vector, summed over l in order, the
//   reads of x coalesced along D. The logits live in dynamic shared memory
//   (L x G f32, at most 48 KB).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
attflat_pool_kernel(const bf16* __restrict__ h, long long ldh, const bf16* __restrict__ w2,
                    const float* __restrict__ b2, const unsigned char* __restrict__ pad,
                    const void* __restrict__ x, int x_f32, bf16* __restrict__ pooled,
                    float* __restrict__ att, int L, int Fm, int G, int D) {
  extern __shared__ float lg[];  // [L][G]: the logits, then bf16(att)
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int l = warp; l < L; l += WARPS) {
    const bf16* hr = h + (size_t)(b * L + l) * ldh;
    const bool padded = pad[(size_t)b * L + l] != 0;
    for (int g = 0; g < G; ++g) {
      float part = 0.0f;
      for (int f = lane; f < Fm; f += 32) part += to_f32(hr[f]) * to_f32(w2[(size_t)f * G + g]);
      const float s = warp_sum(part) + b2[g];
      if (lane == 0) lg[l * G + g] = s + (padded ? -1e9f : 0.0f);
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += WARPS) {
    float mx = -INFINITY;
    for (int l = lane; l < L; l += 32) mx = fmaxf(mx, lg[l * G + g]);
    const float m = warp_max(mx);
    float part = 0.0f;
    for (int l = lane; l < L; l += 32) part += expf(lg[l * G + g] - m);
    const float sum = warp_sum(part);
    for (int l = lane; l < L; l += 32) {
      const float a = expf(lg[l * G + g] - m) / sum;
      att[((size_t)b * L + l) * G + g] = a;
      lg[l * G + g] = to_f32(to_bf16(a));
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float acc = 0.0f;
    if (x_f32) {
      const float* xb = static_cast<const float*>(x) + (size_t)b * L * D + d;
      for (int l = 0; l < L; ++l) acc += lg[l * G + g] * to_f32(to_bf16(xb[(size_t)l * D]));
    } else {
      const bf16* xb = static_cast<const bf16*>(x) + (size_t)b * L * D + d;
      for (int l = 0; l < L; ++l) acc += lg[l * G + g] * to_f32(xb[(size_t)l * D]);
    }
    pooled[(size_t)b * G * D + e] = to_bf16(acc);
  }
}

}  // namespace

// h: bf16 [B * L, Fm] (row stride ldh); w2: bf16 [Fm, G] contiguous; b2: f32
// [G]; pad: uint8 [B, L], 1 = PAD; x: [B, L, D] contiguous, f32 (x_f32 !=
// 0) or bf16; pooled: bf16 [B, G * D]; att: f32 [B, L, G]. L x G at most
// 12288 (the logits in 48 KB of shared memory). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for another shape.
MCAN_API int mcan_attflat_pool(const void* h, long long ldh, const void* w2, const void* b2,
                               const void* pad, const void* x, int x_f32, void* pooled,
                               void* att, int B, int L, int Fm, int G, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || G < 1 || Fm < 1 || D < 1 || L * G > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0)
    attflat_pool_kernel<<<B, THREADS, L * G * static_cast<int>(sizeof(float)), s>>>(
        static_cast<const bf16*>(h), ldh, static_cast<const bf16*>(w2),
        static_cast<const float*>(b2), static_cast<const unsigned char*>(pad), x, x_f32,
        static_cast<bf16*>(pooled), static_cast<float*>(att), L, Fm, G, D);
  return static_cast<int>(cudaGetLastError());
}
