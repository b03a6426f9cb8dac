// gemm_s8: C[M, N] = dequant(A[M, K] . W[K, N]) with int8 operands and an
// exact int32 accumulator, then the dequantizing epilogue of the TPU
// kernels' int8 dots, in their order and rounding:
//   dynamic (per-row activation scales sx):  v = f32(acc) * (sx[m] * sw[n])
//   static  (one calibrated scale a):        v = f32(acc) * (a * sw[n])
//   then + bias[n], then ReLU; written f32 and/or bf16 (one rounding each).
//
// Replaces: the int8 matmuls inside the TPU kernels
//   mcan_vqa_tpu/ops/quant.py::_sga_kernel_qffn (:1057) and
//   ::_sa_kernel_qffn (:1184) -- ``_qdot`` (:253) and ``_qdot_static``
//   (:263): jax.lax.dot_general(int8, int8, preferred_element_type=int32),
//   then y.astype(f32) * (s_x * s_w) + bias. The sites: the FFN's w1 [D, F]
//   and w2 [F, D], the fused self-attention qkv [D, 3D] (at D >= 1024 or
//   level >= 2), and at level 3 the merges [D, D] and the cross q [D, D].
//
// Numerics: the int32 sums are exact (|acc| <= 127 * 127 * K), so any
// summation order gives the same accumulator; the conversion to f32 rounds
// to nearest even and the epilogue uses __fmul_rn / __fadd_rn (no FMA
// contraction), so the output equals the plain version's bit for bit.
//
// Bounds on an H100: at B=64 the SGA block's w1 site (M = 3840, K = 512,
// N = 2048) is 8.1 GOP, 4.1 us at the int8 tensor-core peak (1,979 TOP/s),
// against 1.0 MB of weight, 2.0 MB of codes in and 31 MB of f32 out
// (10 us at 3.35 TB/s): the f32 output bounds it. Design (simple first):
// WMMA signed-char m16n16k16 fragments with int32 accumulation, 64x64
// output tiles per 4-warp block (each warp 32x32), K in steps of 64 bytes
// through a two-stage cp.async pipeline. A WMMA fragment must start on a
// 32-byte boundary, which a 16-byte step along a row would break, so each
// operand tile is stored in shared memory as 16-byte-wide slabs: A as
// [k / 16][m][16], W as [n / 16][k][16] (row stride 16, every fragment on
// a 256-byte boundary). W stays in the JAX [K, N] layout (read row-major by
// WMMA). Rows past M are zero-filled on load and masked on store.
// Not yet: wgmma, TMA, the static quantization of the next site fused into
// this epilogue.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 64, SLAB = 16, THREADS = 128;

struct Epilogue {
  const float* sx;      // [M] per-row activation scales, or null (static)
  float a;              // the static activation scale (when sx is null)
  const float* sw;      // [N] per-out-channel weight scales
  const float* bias;    // [N] or null
  int relu;
  float* out_f32;       // either output may be null
  bf16* out_bf16;
  long long ldo;
};

__global__ void __launch_bounds__(THREADS)
gemm_s8_kernel(const signed char* __restrict__ A, long long lda, const signed char* __restrict__ W,
               long long ldw, int M, int N, int K, Epilogue ep) {
  __shared__ __align__(128) signed char As[2][BK / SLAB][BM][SLAB];
  __shared__ __align__(128) signed char Ws[2][BN / SLAB][BK][SLAB];
  __shared__ __align__(128) int Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  auto load_tile = [&](int st, int k0) {
    // A: BM rows of BK bytes, 16-byte chunks along k, chunk s -> slab s
    for (int c = tid; c < BM * (BK / SLAB); c += THREADS) {
      const int r = c / (BK / SLAB), s = c % (BK / SLAB);
      const int gm = m0 + r, gk = k0 + s * SLAB;
      const bool ok = gm < M && gk < K;
      cp_async16(&As[st][s][r][0], ok ? A + (size_t)gm * lda + gk : A, ok);
    }
    // W: BK rows of BN bytes, 16-byte chunks along n, chunk s -> slab s
    for (int c = tid; c < BK * (BN / SLAB); c += THREADS) {
      const int r = c / (BN / SLAB), s = c % (BN / SLAB);
      const int gk = k0 + r, gn = n0 + s * SLAB;
      const bool ok = gk < K && gn < N;
      cp_async16(&Ws[st][s][r][0], ok ? W + (size_t)gk * ldw + gn : W, ok);
    }
    cp_async_commit();
  };

  const int nk = (K + BK - 1) / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile(st ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < BK / SLAB; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[st][s][wm + i * 16][0], SLAB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Ws[st][(wn + j * 16) / SLAB][s * SLAB][0], SLAB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  int* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = m0 + wm + i * 16 + e / 16;
        const int gc = n0 + wn + j * 16 + e % 16;
        if (gr < M && gc < N) {
          const float sc = __fmul_rn(ep.sx != nullptr ? ep.sx[gr] : ep.a, ep.sw[gc]);
          float v = __fmul_rn(__int2float_rn(cs[e]), sc);
          if (ep.bias != nullptr) v = __fadd_rn(v, ep.bias[gc]);
          if (ep.relu) v = fmaxf(v, 0.0f);
          if (ep.out_f32 != nullptr) ep.out_f32[(size_t)gr * ep.ldo + gc] = v;
          if (ep.out_bf16 != nullptr) ep.out_bf16[(size_t)gr * ep.ldo + gc] = to_bf16(v);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// A: int8 [M, K] (row stride lda), W: int8 [K, N] (row stride ldw), both
// 16-byte aligned with K, N, lda and ldw multiples of 16 (the wrapper
// checks). sx: f32 [M] or null, then `a` is the static scale. sw: f32 [N].
// bias: f32 [N] or null. Outputs: [M, N] with row stride ldo, either may
// be null. Returns cudaGetLastError().
MCAN_API int mcan_gemm_s8(const void* A, long long lda, const void* W, long long ldw, int M,
                          int N, int K, const void* sx, float a, const void* sw, const void* bias,
                          int relu, void* out_f32, void* out_bf16, long long ldo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Epilogue ep{static_cast<const float*>(sx), a, static_cast<const float*>(sw),
              static_cast<const float*>(bias), relu, static_cast<float*>(out_f32),
              static_cast<bf16*>(out_bf16), ldo};
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_s8_kernel<<<grid, THREADS, 0, s>>>(static_cast<const signed char*>(A), lda,
                                            static_cast<const signed char*>(W), ldw, M, N, K,
                                            ep);
  }
  return static_cast<int>(cudaGetLastError());
}
