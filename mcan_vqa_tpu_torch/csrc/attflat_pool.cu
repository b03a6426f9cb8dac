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
// Bounds on an H100: per sample L x (Fm + D) x 2 bytes read and a few
//   kFLOP: bytes, 1.5 us for MCAN-small's image AttFlat at B = 64 (h and x
//   3.9 MB each); at B = 1 a few kB: latency.
// Design: each sample is one thread-block cluster of C CTAs (the plan's
//   ranks, ops/kernels.py::attflat_plan: enough that B x C CTAs cover the
//   card, at most 8, and few enough that each rank computes at least 6
//   logit rows: below that the cluster barrier and the gather cost more
//   than the rank sheds), 8 warps each:
//   1. rank r computes the logits of rows l = r, r + C, ...: a warp a row,
//      lanes along Fm with 16-byte loads of h (and of w2 at one glimpse),
//      a shuffle sum, + b2 and the pad term, into its shared memory;
//   2. a cluster barrier; each rank copies the other ranks' rows from their
//      shared memory (distributed shared memory), then arrives on the
//      cluster barrier it waits on before it exits (no CTA leaves while a
//      peer still reads its rows);
//   3. every rank runs the softmax over L (a warp a glimpse), with the same
//      inputs and so the same bits; rank 0 writes att, once;
//   4. rank r pools its chunk of the D columns (the plan's chunk, a
//      multiple of 8): a unit is 16 bytes of a row of x (8 bf16 or 4 f32
//      values; 1 where x's width does not allow it), the L rows dealt to
//      row groups of threads, each summing its rows in order, and the
//      groups' partials added in group order: a fixed order, so two runs
//      give the same bits. The assignment depends on the shape alone, so
//      each thread loads the first rows of x it pools before step 1: the
//      load latency passes behind steps 1-3.
// Any L x G up to 12288 (the logits and the weights, 96 KB of shared memory
// at most), f32 or bf16 x, any Fm and D.
#include <math.h>

#include "sm90_mainloop.cuh"

namespace attflat {

using namespace sm90;

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_RANKS = 8;
constexpr int MAX_UNIT = 8;   // values a pooling unit: 16 bytes of bf16

// the dynamic shared memory of a call: the logits and the weights [L][G],
// then the pooling partials (at most a unit of floats a thread)
inline int smem_bytes(int L, int G) { return (2 * L * G + THREADS * MAX_UNIT) * 4; }

__device__ __forceinline__ void load_unit(float (&v)[8], const bf16* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __low2float(h2[e]);
    v[2 * e + 1] = __high2float(h2[e]);
  }
}

__device__ __forceinline__ void load_unit(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = to_f32(to_bf16(q.x));   // the pooling's bf16(x)
  v[1] = to_f32(to_bf16(q.y));
  v[2] = to_f32(to_bf16(q.z));
  v[3] = to_f32(to_bf16(q.w));
}

template <typename X>
__device__ __forceinline__ void load_unit(float (&v)[1], const X* p) {
  v[0] = to_f32(to_bf16(*p));
}

// X: x's type; V: the values of a pooling unit (8 bf16 or 4 f32 where D and
// x allow 16-byte loads, else 1)
template <typename X, int V>
__global__ void __launch_bounds__(THREADS)
attflat_pool_kernel(const bf16* __restrict__ h, long long ldh, int h_vec,
                    const bf16* __restrict__ w2, const float* __restrict__ b2,
                    const unsigned char* __restrict__ pad, const X* __restrict__ x,
                    bf16* __restrict__ pooled, float* __restrict__ att, int L, int Fm, int G,
                    int D, int chunk) {
  extern __shared__ float sm[];
  float* lg = sm;              // [L][G]: the logits, this rank's rows, then every row
  float* pw = sm + L * G;      // [L][G]: bf16(att)
  float* red = pw + L * G;     // the pooling's partials [row group][unit][V]
  const int rank = static_cast<int>(cluster_rank()), ranks = static_cast<int>(cluster_size());
  const int b = static_cast<int>(cluster_index());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the pooling's work (step 4), fixed by the shape: this rank's columns lo
  // .. lo + n - 1 in units of V columns x G glimpses; RG row groups of TU
  // threads, the group rg summing each unit's rows rg, rg + RG, ... in
  // order. The first PRE rows of the thread's first unit are loaded now, so
  // that their latency passes while the logits are formed and exchanged.
  constexpr int PRE = 4;
  const int lo = rank * chunk, n = min(D, lo + chunk) - lo;
  const int NU = (n + V - 1) / V, U = G * NU;
  const int RG = U >= THREADS ? 1 : min(L, THREADS / U), TU = THREADS / RG;
  const int rg = tid / TU, u0 = tid % TU;
  const X* xb = x + static_cast<size_t>(b) * L * D;
  float pre[PRE][V];
  if (rg < RG && u0 < U) {
#pragma unroll
    for (int i = 0; i < PRE; ++i) {
      const int l = rg + i * RG;
      if (l < L) load_unit(pre[i], xb + static_cast<size_t>(l) * D + lo + (u0 % NU) * V);
    }
  }

  // 1. this rank's rows of logits
  for (int l = rank + ranks * warp; l < L; l += ranks * WARPS) {
    const bf16* hr = h + static_cast<size_t>(b * L + l) * ldh;
    const bool padded = pad[static_cast<size_t>(b) * L + l] != 0;
    for (int g = 0; g < G; ++g) {
      float part = 0.0f;
      if (h_vec) {
        for (int f = 8 * lane; f < Fm; f += 8 * 32) {
          float hv[8], wv[8];
          load_unit(hv, hr + f);
          if (G == 1) {
            load_unit(wv, w2 + f);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) wv[e] = to_f32(w2[static_cast<size_t>(f + e) * G + g]);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) part += hv[e] * wv[e];
        }
      } else {
        for (int f = lane; f < Fm; f += 32)
          part += to_f32(hr[f]) * to_f32(w2[static_cast<size_t>(f) * G + g]);
      }
      const float s = warp_sum(part) + b2[g];
      if (lane == 0) lg[l * G + g] = s + (padded ? -1e9f : 0.0f);
    }
  }
  cluster_sync();

  // 2. the other ranks' rows
  for (int i = tid; i < L * G; i += THREADS) {
    const int owner = (i / G) % ranks;
    if (owner != rank) lg[i] = peer_f32(lg + i, static_cast<unsigned>(owner));
  }
  cluster_arrive();   // this CTA's reads of its peers are done
  __syncthreads();

  // 3. the softmax over L, a warp a glimpse; rank 0 writes att
  for (int g = warp; g < G; g += WARPS) {
    float mx = -INFINITY;
    for (int l = lane; l < L; l += 32) mx = fmaxf(mx, lg[l * G + g]);
    const float m = warp_max(mx);
    float part = 0.0f;
    for (int l = lane; l < L; l += 32) part += expf(lg[l * G + g] - m);
    const float sum = warp_sum(part);
    for (int l = lane; l < L; l += 32) {
      const float a = expf(lg[l * G + g] - m) / sum;
      if (rank == 0) att[(static_cast<size_t>(b) * L + l) * G + g] = a;
      pw[l * G + g] = to_f32(to_bf16(a));
    }
  }
  __syncthreads();

  // 4. the pooling of this rank's columns, then the row groups' partials
  // added in group order
  const size_t ob = static_cast<size_t>(b) * G * D;
  if (rg < RG) {
    for (int u = u0; u < U; u += TU) {
      const int g = u / NU, col = lo + (u % NU) * V;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      int l = rg;
      if (u == u0) {   // the rows loaded ahead
#pragma unroll
        for (int i = 0; i < PRE; ++i, l += RG) {
          if (l < L) {
            const float w = pw[l * G + g];
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] += w * pre[i][e];
          }
        }
      }
      for (; l < L; l += RG) {
        const float w = pw[l * G + g];
        float v[V];
        load_unit(v, xb + static_cast<size_t>(l) * D + col);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += w * v[e];
      }
      if (RG == 1) {
#pragma unroll
        for (int e = 0; e < V; ++e) pooled[ob + static_cast<size_t>(g) * D + col + e] = to_bf16(acc[e]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) red[(rg * U + u) * V + e] = acc[e];
      }
    }
  }
  if (RG > 1) {
    __syncthreads();
    for (int i = tid; i < U * V; i += THREADS) {
      const int u = i / V, e = i % V;
      float s = red[u * V + e];
      for (int r = 1; r < RG; ++r) s += red[(r * U + u) * V + e];
      pooled[ob + static_cast<size_t>(u / NU) * D + lo + (u % NU) * V + e] = to_bf16(s);
    }
  }
  cluster_wait();   // no peer reads this CTA's logits any more
}

template <typename X, int V>
int launch(const void* h, long long ldh, int h_vec, const void* w2, const void* b2, const void* pad,
           const void* x, void* pooled, void* att, int B, int L, int Fm, int G, int D, int ranks,
           int chunk, int smem, cudaStream_t s) {
  auto kernel = attflat_pool_kernel<X, V>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_cluster(kernel, B * ranks, THREADS, smem, ranks, s, static_cast<const bf16*>(h), ldh,
                     h_vec, static_cast<const bf16*>(w2), static_cast<const float*>(b2),
                     static_cast<const unsigned char*>(pad), static_cast<const X*>(x),
                     static_cast<bf16*>(pooled), static_cast<float*>(att), L, Fm, G, D, chunk);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace attflat

// h: bf16 [B * L, Fm] (row stride ldh); w2: bf16 [Fm, G] contiguous; b2: f32
// [G]; pad: uint8 [B, L], 1 = PAD; x: [B, L, D] contiguous, f32 (x_f32 !=
// 0) or bf16; pooled: bf16 [B, G * D]; att: f32 [B, L, G]. L x G at most
// 12288. The plan (ops/kernels.py::attflat_plan): `ranks` CTAs a sample (a
// cluster, at most 8), each pooling `chunk` columns (a multiple of 8; the
// last rank what is left, at least one), `smem` bytes of dynamic shared
// memory. Returns cudaGetLastError() or the launch's error, or
// cudaErrorInvalidValue for another shape or plan.
MCAN_API int mcan_attflat_pool(const void* h, long long ldh, const void* w2, const void* b2,
                               const void* pad, const void* x, int x_f32, void* pooled,
                               void* att, int B, int L, int Fm, int G, int D, int ranks,
                               int chunk, int smem, void* stream) {
  using namespace attflat;
  if (L < 1 || G < 1 || Fm < 1 || D < 1 || L * G > 12288 || ranks < 1 || ranks > MAX_RANKS ||
      chunk < 8 || chunk % 8 != 0 || (ranks - 1) * chunk >= D || ranks * chunk < D ||
      smem != smem_bytes(L, G))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int h_vec = Fm % 8 == 0 && ldh % 8 == 0 && aligned(h) && (G != 1 || aligned(w2));
#define MCAN_ATTFLAT_ARGS h, ldh, h_vec, w2, b2, pad, x, pooled, att, B, L, Fm, G, D, ranks, chunk, \
                          smem, s
  if (x_f32)
    return D % 4 == 0 && aligned(x) ? launch<float, 4>(MCAN_ATTFLAT_ARGS)
                                    : launch<float, 1>(MCAN_ATTFLAT_ARGS);
  return D % 8 == 0 && aligned(x) ? launch<bf16, 8>(MCAN_ATTFLAT_ARGS)
                                  : launch<bf16, 1>(MCAN_ATTFLAT_ARGS);
#undef MCAN_ATTFLAT_ARGS
}
