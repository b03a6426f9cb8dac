// ffn_ln_blocked: out[M, D] = StdLayerNorm(x + relu(x . W1 + b1) . W2 + b2),
// f32 out, with the hidden h [M, F] never written to device memory.
//
// Replaces: mcan_vqa_tpu/ops/fused_ffn.py::_ffn_ln_blocked_kernel (:121,
//   called by fused_ffn_ln_blocked at :174). The TPU kernel walks a grid
//   (M / TM, F / TF), rows outer: per F tile it forms h = relu(x . W1[:, f]
//   + b1[f]) for its row tile, adds h . W2[f, :] into an f32 accumulator in
//   VMEM, and on the last F tile adds the residual and b2 and takes the LN.
//   Here one block owns a row tile and walks the F tiles in a loop inside
//   the block (the TPU's sequential F axis), so the accumulator and every h
//   tile stay in shared memory.
//
// Numerics, as the TPU kernel: x read as f32 (an f32 or a bf16 x), rounded
//   to bf16 for the first product; W1, W2 bf16; each product summed in f32;
//   h = relu(. + b1) rounded to bf16 (h.astype(bfloat16), fused_ffn.py:141);
//   the second product summed over the F tiles in F order; r = (x + acc) +
//   b2 in f32; the reference LayerNorm (Bessel std, eps on the std,
//   divided), written f32. A row's sums run in one fixed order whatever the
//   grid, and no float atomics are used: two runs give equal bits.
//
// Shapes taken: D a multiple of 128 up to 2048 (256, 512, 1024, 2048 are
//   the widths the port serves); the row tile TM = ffn::tile_m(D) (64 for
//   D <= 512, 32 for D <= 1024, else 16), so the f32 accumulator TM x D
//   stays within 128 KB; the F tile TF = ffn::tile_f(TM) = 4096 / TM (64,
//   128, 256), and F a multiple of TF; any M (rows past M are zero-filled
//   on load and never stored).
//
// Bounds on an H100: at MCAN-large (D 1024, F 4096, M 3840 at B=64) the
//   two products are 64.4 GFLOP, 0.065 ms at the bf16 peak; the bytes the
//   function must move (x, out, the 16.8 MB of weights) 0.005 ms at 3.35
//   TB/s. What this design pays on top: each block re-reads all of W1 and
//   W2 (16.8 MB at MCAN-large) from L2, once per row tile (the M-outer cost
//   fused_ffn.py:199-209 names), 120 tiles at M 3840; and the accumulator
//   makes one shared-memory round trip per F tile. At B=1 (M 60) two
//   blocks do all the work: latency-bound.
// Design (simple first): 8 warps; WMMA 16x16x16 bf16 fragments with f32
//   accumulation. Per F tile, phase 1: the 16 fragments of h [TM, TF] (two
//   per warp), K = D streamed in W1 tiles through a two-stage cp.async
//   pipeline, x resident in shared memory as bf16; the fragments staged in
//   f32, then + b1, ReLU and the bf16 rounding into h. Phase 2: acc [TM, D]
//   += h . W2[f, :], 128 columns at a time (one 16-column fragment column
//   per warp), W2 tiles through the same pipeline, the accumulator
//   fragments loaded from and stored back to shared memory. Then one warp
//   per row for the residual and the LN.
// Not yet: wgmma, TMA, a split of F across blocks at small M.
#include <mma.h>

#include "ffn_ln.cuh"
#include "residual_layernorm.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int BK = 32, SKEW = 8, FSKEW = 4;
constexpr int CHUNK = 16 * WARPS;            // phase 2's columns: one fragment column per warp
constexpr int STAGE = BK * (CHUNK + SKEW);   // bf16 elements of one W tile stage

using ffn::tile_f;
// W1 tile rows: BK1 x (TF + SKEW) fits one stage
__host__ __device__ constexpr int bk1(int tm) { return tile_f(tm) <= 128 ? 32 : 16; }

// dynamic shared memory: x (bf16), the accumulator (f32), h (bf16), two W
// stages (the f32 staging of h's fragments aliases them)
__host__ __device__ constexpr int smem_bytes(int tm, int D) {
  return tm * (D + SKEW) * 2 + tm * (D + FSKEW) * 4 + tm * (tile_f(tm) + SKEW) * 2 +
         2 * STAGE * 2;
}

template <int TM>
__global__ void __launch_bounds__(THREADS)
ffn_ln_blocked_kernel(const void* __restrict__ x, int x_f32, const bf16* __restrict__ W1,
                      const float* __restrict__ b1, const bf16* __restrict__ W2,
                      const float* __restrict__ b2, const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ out, int M, int D,
                      int F, float eps) {
  constexpr int TF = tile_f(TM), BK1 = bk1(TM), FR = TM / 16;
  constexpr int LDH = TF + SKEW, LDS = TF + FSKEW, LDW1 = TF + SKEW, LDW2 = CHUNK + SKEW;
  constexpr int FCOLS = TF / 16;  // h's fragment columns; TM x TF = 16 fragments
  static_assert((TM / 16) * FCOLS == 2 * WARPS, "two h fragments per warp");
  static_assert(TM * LDS * 4 <= 2 * STAGE * 2, "h's f32 staging fits the W stages");
  static_assert(BK1 * LDW1 <= STAGE, "a W1 tile fits one stage");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = D + SKEW, lda = D + FSKEW;
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);                    // [TM][ldx]
  float* Acc = reinterpret_cast<float*>(Xs + TM * ldx);            // [TM][lda]
  bf16* Hs = reinterpret_cast<bf16*>(Acc + TM * lda);              // [TM][LDH]
  bf16* Ws = Hs + TM * LDH;                                        // [2][STAGE]
  float* Sf = reinterpret_cast<float*>(Ws);                        // [TM][LDS], phase 1 out
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * TM;

  // x rounded to bf16 (rows past M zero), the accumulator zeroed
  for (int c = tid; c < TM * D / 8; c += THREADS) {
    const int r = c / (D / 8), cc = (c % (D / 8)) * 8, gm = m0 + r;
    *reinterpret_cast<uint4*>(&Xs[r * ldx + cc]) =
        gm < M ? ffn::x8_bf16(x, x_f32, (size_t)gm * D + cc) : make_uint4(0, 0, 0, 0);
  }
  for (int e = tid; e < TM * lda; e += THREADS) Acc[e] = 0.0f;

  // W1[k0 : k0 + BK1, f0 : f0 + TF] and W2[f0 + k0 : + BK, n0 : n0 + CHUNK]
  auto load_w1 = [&](int st, int k0, int f0) {
    bf16* ws = Ws + st * STAGE;
    for (int c = tid; c < BK1 * TF / 8; c += THREADS) {
      const int r = c / (TF / 8), cc = (c % (TF / 8)) * 8;
      cp_async16(&ws[r * LDW1 + cc], W1 + (size_t)(k0 + r) * F + f0 + cc, true);
    }
  };
  auto load_w2 = [&](int st, int k0, int n0) {
    bf16* ws = Ws + st * STAGE;
    for (int c = tid; c < BK * CHUNK / 8; c += THREADS) {
      const int r = c / (CHUNK / 8), cc = (c % (CHUNK / 8)) * 8;
      cp_async16(&ws[r * LDW2 + cc], W2 + (size_t)(k0 + r) * D + n0 + cc, true);
    }
  };

  for (int f0 = 0; f0 < F; f0 += TF) {
    // ---- phase 1: h = relu(x . W1[:, f0 : f0 + TF] + b1), fragments 2w, 2w + 1
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[2];
    wmma::fill_fragment(hacc[0], 0.0f);
    wmma::fill_fragment(hacc[1], 0.0f);
    const int nk = D / BK1;
    __syncthreads();  // the stages are free (the last phase 2 read them)
    load_w1(0, 0, f0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < nk) {
        load_w1(st ^ 1, (kt + 1) * BK1, f0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* ws = Ws + st * STAGE;
#pragma unroll
      for (int kk = 0; kk < BK1; kk += 16) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int id = 2 * warp + i, fr = id / FCOLS, fc = id % FCOLS;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, &Xs[fr * 16 * ldx + kt * BK1 + kk], ldx);
          wmma::load_matrix_sync(b, &ws[kk * LDW1 + fc * 16], LDW1);
          wmma::mma_sync(hacc[i], a, b, hacc[i]);
        }
      }
      __syncthreads();  // the next iteration's loads overwrite this stage
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = 2 * warp + i, fr = id / FCOLS, fc = id % FCOLS;
      wmma::store_matrix_sync(&Sf[fr * 16 * LDS + fc * 16], hacc[i], LDS, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < TM * TF; e += THREADS) {
      const int r = e / TF, c = e % TF;
      Hs[r * LDH + c] = to_bf16(fmaxf(Sf[r * LDS + c] + b1[f0 + c], 0.0f));
    }
    __syncthreads();  // h is complete; the stages are free again

    // ---- phase 2: acc[:, n0 : n0 + CHUNK] += h . W2[f0 : f0 + TF, n0 : ...]
    constexpr int KT = TF / BK;
    const int nt = (D / CHUNK) * KT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FR];
    load_w2(0, f0, 0);
    cp_async_commit();
    for (int t = 0; t < nt; ++t) {
      const int nc = t / KT, kc = t % KT, st = t & 1;
      if (t + 1 < nt) {
        load_w2(st ^ 1, f0 + ((t + 1) % KT) * BK, ((t + 1) / KT) * CHUNK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float* ablk = &Acc[nc * CHUNK + warp * 16];
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < FR; ++i)
          wmma::load_matrix_sync(acc[i], ablk + i * 16 * lda, lda, wmma::mem_row_major);
      }
      const bf16* ws = Ws + st * STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &ws[kk * LDW2 + warp * 16], LDW2);
#pragma unroll
        for (int i = 0; i < FR; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, &Hs[i * 16 * LDH + kc * BK + kk], LDH);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
      if (kc == KT - 1) {
#pragma unroll
        for (int i = 0; i < FR; ++i)
          wmma::store_matrix_sync(ablk + i * 16 * lda, acc[i], lda, wmma::mem_row_major);
      }
      __syncthreads();  // the next iteration's loads overwrite this stage
    }
  }
  __syncthreads();

  // ---- the residual and the LN: one warp per row, lane's columns lane + 32 t
  for (int r = warp; r < TM; r += WARPS) {
    const int gm = m0 + r;
    if (gm >= M) break;
    float* a = Acc + r * lda;
    const size_t rb = (size_t)gm * D;
    float sum = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float v = (ffn::x_at(x, x_f32, rb + c) + a[c]) + b2[c];
      a[c] = v;
      sum += v;
    }
    const float denom = ln::centre_row(a, D, lane, sum, eps);
    for (int c = lane; c < D; c += 32) out[rb + c] = gamma[c] * a[c] / denom + beta[c];
  }
}

template <int TM>
int launch(const void* x, int x_f32, const void* W1, const void* b1, const void* W2,
           const void* b2, const void* gamma, const void* beta, void* out, int M, int D, int F,
           float eps, cudaStream_t s) {
  // the opt-in is per device: set it on every call
  const int smem = smem_bytes(TM, D);
  const cudaError_t err = cudaFuncSetAttribute(
      ffn_ln_blocked_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_ln_blocked_kernel<TM><<<(M + TM - 1) / TM, THREADS, smem, s>>>(
      x, x_f32, static_cast<const bf16*>(W1), static_cast<const float*>(b1),
      static_cast<const bf16*>(W2), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(out), M, D, F, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, D] f32 (x_f32 == 1) or bf16, contiguous, 16-byte aligned; W1 [D, F]
// and W2 [F, D] bf16, contiguous, 16-byte aligned; b1 [F], b2, gamma, beta
// [D] f32; out [M, D] f32. D a multiple of 128 up to 2048, F a multiple of
// ffn::tile_f(ffn::tile_m(D)), M > 0. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another shape.
MCAN_API int mcan_ffn_ln_blocked(const void* x, int x_f32, const void* W1, const void* b1,
                                 const void* W2, const void* b2, const void* gamma,
                                 const void* beta, void* out, int M, int D, int F, float eps,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tm = ffn::tile_m(D);
  if (tm == 0 || F <= 0 || F % tile_f(tm) != 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define MCAN_FFN_LN_ARGS x, x_f32, W1, b1, W2, b2, gamma, beta, out, M, D, F, eps, s
  if (tm == 64) return launch<64>(MCAN_FFN_LN_ARGS);
  if (tm == 32) return launch<32>(MCAN_FFN_LN_ARGS);
  return launch<16>(MCAN_FFN_LN_ARGS);
#undef MCAN_FFN_LN_ARGS
}
