// The stages of a persistent block kernel: one cooperative launch runs a
// whole stack of layers (csrc/sga_decoder.cu, csrc/sa_encoder.cu), each
// layer a fixed sequence of the stages below with a grid-wide barrier
// between two stages that depend on each other. Each stage is a
// __device__ function that walks its work items (GEMM tiles, (sample,
// head, query rows) attention items, LayerNorm rows) in a grid-stride
// loop, so any grid size that fits the card co-resident computes the same
// result, bit for bit: every work item is done by one block in a fixed
// order, and no stage uses atomics.
//
// Replaces: the per-layer bodies of the TPU's all-layer kernels,
//   mcan_vqa_tpu/ops/sga_block.py::_sga_decoder_kernel (:483),
//   ::_sga_decoder_kernel_extkv (:646) and ::_sa_encoder_kernel (:848).
//   On the TPU every layer's weights sit in VMEM for the whole launch
//   (50.3 MB for MCAN-small's decoder), so one grid step carries its G
//   samples through every layer. An H100 SM has 228 KB of shared memory:
//   the weights cannot stay on chip, so here every stage streams them from
//   HBM (or the 50 MB L2) tile by tile, and the grid-wide barrier takes the
//   place of the TPU's layer loop inside one grid step. What the single
//   launch keeps is the TPU kernel's launch count: one per stack, where
//   the per-block engine issues ~10 kernels per block.
//
// Numerics, as in those kernels and as the per-block kernels of the port
// (gemm_sm90.cu, masked_attention.cu, residual_layernorm.cu) round:
//   * GEMM: bf16 operands, f32 accumulation, + bias, ReLU, one rounding to
//     the output type;
//   * attention: scores in f32 from bf16 q and k, PAD keys at -1e9 per
//     sample, f32 softmax, the probabilities rounded to bf16 before P.V,
//     P.V in f32, the output rounded to bf16 for the merge;
//   * LayerNorm: r = res + (y + bias) in f32, the Bessel-corrected std, eps
//     added to the std (sga_block.py:145-151), an f32 and a bf16 copy out.
//
// Bounds on an H100: at B = 1 each stage has one or two dozen work items
// and the stack is latency-bound (the barriers, the first weight bytes);
// at B = 64 the image-stream GEMMs (M = 3840) are bound by the bf16
// tensor-core rate. Design (simple first): WMMA 16x16x16 on 64x64 output
// tiles by 8 warps, K in steps of 32 through a two-stage cp.async
// pipeline; attention in key chunks of 64 (two per lane), three
// passes over the chunks (row max, row sum, then P.V), so the
// probabilities are normalised before their bf16 rounding whatever the
// key count; the LayerNorm one warp per row, re-reading the row from
// global memory (L2) in each of its three passes.
// Not yet: wgmma, TMA, keeping a row block's stream in shared memory
// between stages, fewer barriers.
#pragma once

#include <cooperative_groups.h>
#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace persistent {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int BM = 64, BN = 64, BK = 32, SKEW = 8;
constexpr int A_LD = BK + SKEW, B_LD = BN + SKEW;
constexpr int A_ELEMS = BM * A_LD, B_ELEMS = BK * B_LD;
constexpr int GEMM_SMEM = 2 * (A_ELEMS + B_ELEMS) * 2 + WARPS * 256 * 4;  // 27,648 bytes
constexpr int QR = 32;            // query rows per attention item (4 per warp)
constexpr int KC = 64;            // keys per chunk (2 per lane)
constexpr int MAX_DH = 256;
constexpr int MAX_C = MAX_DH / 32;  // output columns per lane
constexpr float NEG_INF = -1e9f;

// dynamic shared memory of a stack at head width Dh: the larger of the
// GEMM's tiles and the attention's q rows, k^T and v chunks
inline int smem_bytes(int Dh) {
  const int att = (QR * Dh + 2 * KC * Dh) * 2;
  return att > GEMM_SMEM ? att : GEMM_SMEM;
}

__device__ __forceinline__ void grid_barrier() { cooperative_groups::this_grid().sync(); }

// ---------------------------------------------------------------------------
// GEMM: out[M, N] = A[M, K] . W[K, N] (+ bias, ReLU), bf16 operands
// ---------------------------------------------------------------------------

struct GemmJob {
  const bf16* A;
  long long lda;
  const bf16* W;
  long long ldw;
  int M, N, K;
  const float* bias;  // [N] or null
  int relu;
  float* o32;         // either output may be null
  bf16* o16;
  long long ldo;
};

__device__ __forceinline__ int gemm_tiles(const GemmJob& j) {
  return ((j.M + BM - 1) / BM) * ((j.N + BN - 1) / BN);
}

// one 64x64 output tile of a job; ends with the block's shared memory free
__device__ inline void gemm_tile(const GemmJob& j, int tile, unsigned char* smem) {
  using namespace nvcuda;
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][BM][A_LD]
  bf16* Bs = As + 2 * A_ELEMS;               // [2][BK][B_LD]
  float* Cs = reinterpret_cast<float*>(Bs + 2 * B_ELEMS);  // [WARPS][16 * 16]
  const int tiles_n = (j.N + BN - 1) / BN;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  // one 16-byte chunk of A (64 rows x 4 chunks) and one of W (32 rows x 8
  // chunks) per thread and stage; past M / N / K zero-filled
  auto load = [&](int stage, int k0) {
    {
      const int r = tid >> 2, c = (tid & 3) * 8;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < j.M && gk < j.K;
      cp_async16(&As[stage * A_ELEMS + r * A_LD + c], ok ? j.A + (size_t)gm * j.lda + gk : j.A,
                 ok);
    }
    {
      const int r = tid >> 3, c = (tid & 7) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < j.K && gn < j.N;
      cp_async16(&Bs[stage * B_ELEMS + r * B_LD + c], ok ? j.W + (size_t)gk * j.ldw + gn : j.W,
                 ok);
    }
    cp_async_commit();
  };

  const int nk = (j.K + BK - 1) / BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load(st ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &As[st * A_ELEMS + wm * A_LD + kk], A_LD);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[st * B_ELEMS + kk * B_LD + wn + 16 * t], B_LD);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
    __syncthreads();  // the next load overwrites this stage
  }

  float* cs = Cs + warp * 256;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    wmma::store_matrix_sync(cs, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int gr = m0 + wm + e / 16, gc = n0 + wn + 16 * t + e % 16;
      if (gr < j.M && gc < j.N) {
        float v = cs[e];
        if (j.bias != nullptr) v += j.bias[gc];
        if (j.relu) v = fmaxf(v, 0.0f);
        if (j.o32 != nullptr) j.o32[(size_t)gr * j.ldo + gc] = v;
        if (j.o16 != nullptr) j.o16[(size_t)gr * j.ldo + gc] = to_bf16(v);
      }
    }
    __syncwarp();
  }
}

// the tiles of one or two independent GEMMs, grid-stride
__device__ inline void gemm_stage(const GemmJob& a, const GemmJob* b, unsigned char* smem) {
  const int ta = gemm_tiles(a), total = ta + (b != nullptr ? gemm_tiles(*b) : 0);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    if (t < ta)
      gemm_tile(a, t, smem);
    else
      gemm_tile(*b, t - ta, smem);
  }
}

// ---------------------------------------------------------------------------
// masked attention per (sample, head, QR query rows)
// ---------------------------------------------------------------------------

struct AttJob {
  const bf16* q;   // element [b, h, i, d] at q + b*q_bs + i*q_rs + h*Dh + d
  long long q_bs, q_rs;
  const void* k;   // bf16, or f32 when kv_f32; [b, h, j, d] at k + b*kv_bs + h*kv_hs + j*kv_rs + d
  const void* v;   // the same strides as k
  int kv_f32;
  long long kv_bs, kv_hs, kv_rs;
  const unsigned char* pad;  // [B, Lk], 1 = PAD
  bf16* out;       // [b, i, h*Dh + d] at out + (b*Lq + i)*o_rs + h*Dh + d
  long long o_rs;
  int B, H, Lq, Lk, Dh;
  float scale;
};

__device__ __forceinline__ int att_items(const AttJob& j) {
  return j.B * j.H * ((j.Lq + QR - 1) / QR);
}

__device__ __forceinline__ float load_f32(const void* p, int f32, size_t e) {
  return f32 ? static_cast<const float*>(p)[e] : to_f32(static_cast<const bf16*>(p)[e]);
}

// scores of query row qrow against the chunk's keys lane, lane + 32
// (NEG_INF-free: the caller masks)
__device__ __forceinline__ void chunk_scores(const bf16* qrow, const bf16* kts, int Dh, int lane,
                                             float s[2]) {
  s[0] = s[1] = 0.0f;
  for (int d = 0; d < Dh; ++d) {
    const float qd = to_f32(qrow[d]);
    s[0] += qd * to_f32(kts[d * KC + lane]);
    s[1] += qd * to_f32(kts[d * KC + lane + 32]);
  }
}

__device__ inline void att_item(const AttJob& j, int item, unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_blocks = (j.Lq + QR - 1) / QR;
  const int bh = item / row_blocks, r0 = (item % row_blocks) * QR;
  const int b = bh / j.H, h = bh % j.H, Dh = j.Dh;
  const int nq = min(QR, j.Lq - r0);
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [QR][Dh]
  bf16* kts = qs + QR * Dh;                  // [Dh][KC]: lane j reads kts[d][j]
  bf16* vs = kts + Dh * KC;                  // [KC][Dh]
  const bf16* qb = j.q + (size_t)b * j.q_bs + (size_t)h * Dh;
  const size_t kv0 = (size_t)b * j.kv_bs + (size_t)h * j.kv_hs;
  const unsigned char* pad = j.pad + (size_t)b * j.Lk;

  for (int e = tid; e < nq * Dh; e += THREADS)
    qs[e] = qb[(size_t)(r0 + e / Dh) * j.q_rs + e % Dh];

  const int nck = (j.Lk + KC - 1) / KC;
  // stage key chunk c: k^T always, v when with_v
  auto stage = [&](int c, bool with_v) {
    __syncthreads();  // every warp is done with the previous chunk
    const int k0 = c * KC, nk = min(KC, j.Lk - k0);
    for (int e = tid; e < nk * Dh; e += THREADS) {
      const int r = e / Dh, d = e % Dh;
      const size_t g = kv0 + (size_t)(k0 + r) * j.kv_rs + d;
      kts[d * KC + r] = to_bf16(load_f32(j.k, j.kv_f32, g));
      if (with_v) vs[r * Dh + d] = to_bf16(load_f32(j.v, j.kv_f32, g));
    }
    __syncthreads();
  };
  // the chunk's scores of the warp's t-th row, PAD keys at NEG_INF, keys
  // past the chunk flagged by ok
  auto scores = [&](int c, int i, float s[2], bool ok[2]) {
    chunk_scores(qs + i * Dh, kts, Dh, lane, s);
    const int k0 = c * KC;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kj = k0 + lane + 32 * u;
      ok[u] = kj < j.Lk;
      s[u] = ok[u] && pad[kj] ? NEG_INF : s[u] * j.scale;
    }
  };

  constexpr int RW = QR / WARPS;  // rows per warp: i = warp + WARPS * t
  float mx[RW], sum[RW];
#pragma unroll
  for (int t = 0; t < RW; ++t) {
    mx[t] = -INFINITY;
    sum[t] = 0.0f;
  }
  // pass 1: each row's max
  for (int c = 0; c < nck; ++c) {
    stage(c, nck == 1);
#pragma unroll
    for (int t = 0; t < RW; ++t) {
      const int i = warp + WARPS * t;
      if (i >= nq) continue;
      float s[2];
      bool ok[2];
      scores(c, i, s, ok);
      float m = mx[t];
      if (ok[0]) m = fmaxf(m, s[0]);
      if (ok[1]) m = fmaxf(m, s[1]);
      mx[t] = m;
    }
  }
#pragma unroll
  for (int t = 0; t < RW; ++t) mx[t] = warp_max(mx[t]);
  // pass 2: each row's sum of exp(s - max)
  for (int c = 0; c < nck; ++c) {
    if (nck > 1) stage(c, false);
#pragma unroll
    for (int t = 0; t < RW; ++t) {
      const int i = warp + WARPS * t;
      if (i >= nq) continue;
      float s[2];
      bool ok[2];
      scores(c, i, s, ok);
      sum[t] += (ok[0] ? expf(s[0] - mx[t]) : 0.0f) + (ok[1] ? expf(s[1] - mx[t]) : 0.0f);
    }
  }
#pragma unroll
  for (int t = 0; t < RW; ++t) sum[t] = warp_sum(sum[t]);
  // pass 3: the probabilities, rounded to bf16, times V
  float o[RW][MAX_C];
#pragma unroll
  for (int t = 0; t < RW; ++t)
#pragma unroll
    for (int cc = 0; cc < MAX_C; ++cc) o[t][cc] = 0.0f;
  for (int c = 0; c < nck; ++c) {
    if (nck > 1) stage(c, true);
    const int nk = min(KC, j.Lk - c * KC);
#pragma unroll
    for (int t = 0; t < RW; ++t) {
      const int i = warp + WARPS * t;
      if (i >= nq) continue;
      float s[2];
      bool ok[2];
      scores(c, i, s, ok);
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        p[u] = ok[u] ? to_f32(to_bf16(expf(s[u] - mx[t]) / sum[t])) : 0.0f;
      for (int r = 0; r < nk; ++r) {
        const float pr = __shfl_sync(0xffffffffu, r < 32 ? p[0] : p[1], r & 31);
#pragma unroll
        for (int cc = 0; cc < MAX_C; ++cc) {
          const int d = lane + 32 * cc;
          if (d < Dh) o[t][cc] += pr * to_f32(vs[r * Dh + d]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < RW; ++t) {
    const int i = warp + WARPS * t;
    if (i >= nq) continue;
    bf16* orow = j.out + (size_t)(b * j.Lq + r0 + i) * j.o_rs + (size_t)h * Dh;
#pragma unroll
    for (int cc = 0; cc < MAX_C; ++cc) {
      const int d = lane + 32 * cc;
      if (d < Dh) orow[d] = to_bf16(o[t][cc]);
    }
  }
  __syncthreads();  // shared memory free for the next item or stage
}

__device__ inline void att_stage(const AttJob& j, unsigned char* smem) {
  const int n = att_items(j);
  for (int it = blockIdx.x; it < n; it += gridDim.x) att_item(j, it, smem);
}

// ---------------------------------------------------------------------------
// residual + bias + Std-LayerNorm per row
// ---------------------------------------------------------------------------

struct LnJob {
  const float* res;   // [M, D]
  const float* y;     // [M, D]
  const float* bias;  // [D] or null
  const float* gamma;
  const float* beta;
  float* o32;         // either may be null
  bf16* o16;
  int M, D;
  float eps;
};

__device__ __forceinline__ float ln_r(const LnJob& j, size_t e, int d) {
  const float y = j.bias != nullptr ? j.y[e] + j.bias[d] : j.y[e];
  return j.res[e] + y;
}

__device__ inline void ln_stage(const LnJob& j) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < j.M; row += nw) {
    const size_t base = (size_t)row * j.D;
    float s = 0.0f;
    for (int d = lane; d < j.D; d += 32) s += ln_r(j, base + d, d);
    const float mean = warp_sum(s) / j.D;
    float ss = 0.0f;
    for (int d = lane; d < j.D; d += 32) {
      const float c = ln_r(j, base + d, d) - mean;
      ss += c * c;
    }
    const float den = sqrtf(warp_sum(ss) / (j.D - 1)) + j.eps;
    for (int d = lane; d < j.D; d += 32) {
      const float c = ln_r(j, base + d, d) - mean;
      const float v = j.gamma[d] * c / den + j.beta[d];
      if (j.o32 != nullptr) j.o32[base + d] = v;
      if (j.o16 != nullptr) j.o16[base + d] = to_bf16(v);
    }
  }
}

// an input in its stored type -> an f32 and / or a bf16 copy, grid-stride
__device__ inline void convert_stage(const void* x, int x_f32, long long n, float* o32, bf16* o16) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * THREADS) {
    const float v = load_f32(x, x_f32, e);
    if (o32 != nullptr) o32[e] = v;
    if (o16 != nullptr) o16[e] = to_bf16(v);
  }
}

// ---------------------------------------------------------------------------
// the cooperative launch
// ---------------------------------------------------------------------------

// Launch kernel(params) cooperatively with THREADS threads and Dh's shared
// memory on as many blocks as fit co-resident on the card (at most
// max_blocks > 0, and at most `useful`, the largest stage's work items).
// info (host, may be null) <- grid, blocks per SM, SMs, shared memory bytes.
// Returns the CUDA error: cudaErrorCooperativeLaunchTooLarge where not one
// block fits an SM, cudaErrorNotSupported on a card without cooperative
// launch.
template <typename Params>
int launch_cooperative(void (*kernel)(Params), const Params& params, int Dh, int useful,
                       int max_blocks, int* info, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int smem = smem_bytes(Dh);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = per_sm * sms;
  if (useful > 0 && useful < grid) grid = useful;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  if (info != nullptr) {
    info[0] = grid;
    info[1] = per_sm;
    info[2] = sms;
    info[3] = smem;
  }
  Params p = params;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS),
                                  args, static_cast<size_t>(smem), stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace persistent
