// gemm_ln: out[M, D] = StdLayerNorm(res + a . W + b) with the reference
// LayerNorm, gamma * (r - mean) / (std + 1e-6) + beta, std Bessel-corrected
// (divided by D - 1), eps added to the std. The pre-LN sum r never leaves
// the SM.
//
// Replaces: the Pallas kernels of the per-sub-op serving path
//   mcan_vqa_tpu/ops/fused_ffn.py::_proj_ln_kernel (fused_proj_ln, call
//   :100): the attention merge projection + residual + LN, with a the f32
//   attention output [M, D] and W the merge weight [D, D]; and the second
//   half of ::_ffn_ln_kernel (fused_ffn_ln, call :340): the ReLU hidden h
//   [M, F] bf16 (from gemm_bias_act) . W2 [F, D] + b2 + the residual x,
//   then the LN. The TPU kernels keep a row tile's product and its LN in
//   VMEM; here one block owns BM whole rows, all D columns, and stages
//   y = a . W in shared memory for the LN epilogue.
//
// Numerics, as in those kernels: a rounded to bf16 (an f32 a on load, as
//   _proj_ln_kernel's a.astype(bfloat16), fused_ffn.py:66), W bf16, the
//   products summed in f32, y + b, then r = f32(res) + y, then the LN in f32
//   (residual_layernorm.cuh's centre_row, the LayerNorm kernels' row
//   statistics), divided by (std + eps) as model.apply does; the output
//   rounded once to the residual's dtype (a bf16 or an f32 stream).
//
// Bounds on an H100: at MCAN-small B=64 the merge site (M 3840, K = D = 512)
//   moves 16.2 MB (4.9 us at 3.35 TB/s) for 2.0 GFLOP (2.0 us at the bf16
//   peak); the FFN site (K = 2048) 6.3 MB more of h and 8.1 GFLOP. At B=1
//   (M 14 or 60) it is one or two blocks: latency.
// Design (simple first): 8 warps; BM = 32 rows per block for D up to 1024,
//   16 past it, so that y fits (BM x D f32 <= 128 KB); the D columns in
//   chunks of 128, 16 per warp, each chunk a K loop of bf16 WMMA 16x16x16
//   fragments with f32 accumulation over a two-stage pipeline (W by
//   cp.async; a by cp.async when bf16, rounded on load when f32); each
//   chunk's fragments stored into y; then one warp per row adds b and the
//   residual, takes the row's statistics and writes the row. W is read
//   once per block (M / BM times in all, from L2). Columns past D and rows
//   past M are zero-filled on load and never stored, so any M and any D
//   that is a multiple of 8 up to 2048 is exact.
// Not yet: wgmma, TMA, a persistent schedule, split-K at B = 1.
#include <mma.h>

#include "residual_layernorm.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int BN = 16 * WARPS;  // the columns of one chunk: a fragment column per warp
constexpr int BK = 32, SKEW = 8, YSKEW = 4;
constexpr int LDA = BK + SKEW, LDW = BN + SKEW;
constexpr int Y_FLOATS = 32768;  // the y stage: BM x D f32 <= 128 KB

// bytes of dynamic shared memory: the a and W stages, then y [BM][dp + YSKEW]
constexpr int smem_bytes(int bm, int dp) {
  return 2 * bm * LDA * 2 + 2 * BK * LDW * 2 + bm * (dp + YSKEW) * 4;
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
gemm_ln_kernel(const void* __restrict__ A, int a_f32, long long lda, const bf16* __restrict__ W,
               long long ldw, const float* __restrict__ bias, const void* __restrict__ res,
               int res_bf16, long long ldr, const float* __restrict__ gamma,
               const float* __restrict__ beta, void* __restrict__ out, long long ldo, int M,
               int D, int K, float eps) {
  constexpr int FR = BM / 16;  // fragment rows per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);             // [2][BM][LDA]
  bf16* Ws = As + 2 * BM * LDA;                             // [2][BK][LDW]
  float* Ys = reinterpret_cast<float*>(Ws + 2 * BK * LDW);  // [BM][ldy]
  const int ldy = (D + BN - 1) / BN * BN + YSKEW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const bf16 zero = to_bf16(0.0f);

  // a: BM rows of BK values, chunks of 8 along k; an f32 a is rounded to
  // bf16 here (a uniform branch: one instance serves both dtypes)
  auto load_a = [&](int st, int k0) {
    bf16* as = As + st * BM * LDA;
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      const bool ok = gm < M && gk < K;
      if (!a_f32) {
        const bf16* a = static_cast<const bf16*>(A);
        cp_async16(&as[r * LDA + cc], ok ? a + (size_t)gm * lda + gk : a, ok);
      } else {
        __align__(16) bf16 v[8];
        if (ok) {
          const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(A) +
                                                              (size_t)gm * lda + gk);
          const float4 x0 = src[0], x1 = src[1];
          v[0] = to_bf16(x0.x); v[1] = to_bf16(x0.y); v[2] = to_bf16(x0.z); v[3] = to_bf16(x0.w);
          v[4] = to_bf16(x1.x); v[5] = to_bf16(x1.y); v[6] = to_bf16(x1.z); v[7] = to_bf16(x1.w);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = zero;
        }
        *reinterpret_cast<uint4*>(&as[r * LDA + cc]) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };
  // W: BK rows of the chunk's BN columns, chunks of 8 along n
  auto load_w = [&](int st, int k0, int n0) {
    bf16* ws = Ws + st * BK * LDW;
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + cc;
      const bool ok = gk < K && gn < D;
      cp_async16(&ws[r * LDW + cc], ok ? W + (size_t)gk * ldw + gn : W, ok);
    }
  };

  const int nk = (K + BK - 1) / BK;
  for (int n0 = 0; n0 < D; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FR];
#pragma unroll
    for (int i = 0; i < FR; ++i) wmma::fill_fragment(acc[i], 0.0f);
    load_a(0, 0);
    load_w(0, 0, n0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt & 1;
      if (kt + 1 < nk) {
        load_a(st ^ 1, (kt + 1) * BK);
        load_w(st ^ 1, (kt + 1) * BK, n0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* as = As + st * BM * LDA;
      const bf16* ws = Ws + st * BK * LDW;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &ws[kk * LDW + warp * 16], LDW);
#pragma unroll
        for (int i = 0; i < FR; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, &as[i * 16 * LDA + kk], LDA);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
      __syncthreads();  // the next iteration's loads overwrite this stage
    }
#pragma unroll
    for (int i = 0; i < FR; ++i)
      wmma::store_matrix_sync(&Ys[i * 16 * ldy + n0 + warp * 16], acc[i], ldy,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // the LN epilogue: one warp per row, each lane its columns lane + 32 t
  for (int r = warp; r < BM; r += WARPS) {
    const int gm = m0 + r;
    if (gm >= M) break;
    float* y = Ys + r * ldy;
    const size_t rb = (size_t)gm * ldr, ob = (size_t)gm * ldo;
    float sum = 0.0f;
    for (int c = lane; c < D; c += 32) {
      float u = y[c];
      if (bias != nullptr) u += bias[c];
      const float v = (res_bf16 ? to_f32(static_cast<const bf16*>(res)[rb + c])
                                : static_cast<const float*>(res)[rb + c]) + u;
      y[c] = v;
      sum += v;
    }
    const float denom = ln::centre_row(y, D, lane, sum, eps);
    for (int c = lane; c < D; c += 32) {
      const float o = gamma[c] * y[c] / denom + beta[c];
      if (res_bf16) static_cast<bf16*>(out)[ob + c] = to_bf16(o);
      else static_cast<float*>(out)[ob + c] = o;
    }
  }
}

template <int BM>
int launch(const void* A, int a_f32, long long lda, const void* W, long long ldw,
           const void* bias, const void* res, int res_bf16, long long ldr, const void* gamma,
           const void* beta, void* out, long long ldo, int M, int D, int K, float eps,
           cudaStream_t s) {
  // opt in once per instantiation to the largest y this BM takes (a CUDA
  // graph capture may later record the launch; the attribute call is no
  // stream work)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(gemm_ln_kernel<BM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes(BM, Y_FLOATS / BM));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int dp = (D + BN - 1) / BN * BN;
  gemm_ln_kernel<BM><<<(M + BM - 1) / BM, THREADS, smem_bytes(BM, dp), s>>>(
      A, a_f32, lda, static_cast<const bf16*>(W), ldw, static_cast<const float*>(bias), res,
      res_bf16, ldr, static_cast<const float*>(gamma), static_cast<const float*>(beta), out,
      ldo, M, D, K, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A: [M, K] bf16 (a_f32 == 0) or f32, row stride lda (a multiple of 8, A
// 16-byte aligned); W: bf16 [K, D], row stride ldw (a multiple of 8, 16-byte
// aligned); bias [D] f32 or null; res: [M, D] f32 (res_bf16 == 0) or bf16,
// row stride ldr; gamma, beta [D] f32; out: [M, D] in res's dtype, row
// stride ldo. K and D multiples of 8, D between 8 and 2048. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another shape.
MCAN_API int mcan_gemm_ln(const void* A, int a_f32, long long lda, const void* W, long long ldw,
                          const void* bias, const void* res, int res_bf16, long long ldr,
                          const void* gamma, const void* beta, void* out, long long ldo, int M,
                          int D, int K, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > ln::MAX_D || D % 8 != 0 || K < 8 || K % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const int dp = (D + BN - 1) / BN * BN;
#define MCAN_GEMM_LN_ARGS A, a_f32, lda, W, ldw, bias, res, res_bf16, ldr, gamma, beta, out, ldo, \
                          M, D, K, eps, s
  if (dp <= Y_FLOATS / 32) return launch<32>(MCAN_GEMM_LN_ARGS);
  return launch<16>(MCAN_GEMM_LN_ARGS);
#undef MCAN_GEMM_LN_ARGS
}
