// gemm_w4bf16: C[M, N] = A[M, K] . Wf + bias with bf16 operands and f32
// accumulation, where Wf is dequantized from a nibble-packed int4 weight
// while its tile is staged into shared memory:
//   Wf[k, n] = bf16(f32(q[k, n]) * s4[k / 128, n]),   q in [-7, 7]
// then + bias[n], then ReLU; written f32 and/or bf16 (one rounding each).
//
// Replaces: the int4 matmuls inside the TPU kernels
//   mcan_vqa_tpu/ops/quant.py::_sga_kernel_qffn (:1057) and
//   ::_sa_kernel_qffn (:1184) at qffn levels 6 and 7 -- ``_qdot_w4bf16``
//   (:307): the weight unpacked (``_unpack_w4``, :81) and multiplied by its
//   group scales in f32, rounded to bf16, then ONE bf16 MXU product of
//   bf16(x) with f32 accumulation, + bias. No activation is quantized (the
//   static scale ``a`` is unused). The sites: the FFN's w1 and w2 (levels 6
//   and 7) and the fused self-attention qkv (level 7).
//
// Weight layout: that of gemm_s4.cu (``_quant_w4``): P int8 [K/2, N], rows k
// and k + K/2 in the low and high nibbles of P[k, n]; s4 f32 [K/128, N].
//
// Numerics: Wf is formed with __fmul_rn and one round-to-nearest-even to
// bf16, the plain version's bits; the products of two bf16 values are
// exact in f32, and the f32 sums run in another order than the plain
// version's f32 matmul, so the outputs agree within gemm_bias_act's
// tolerance (accumulation order), not bit for bit.
//
// Bounds on an H100: the same bytes as gemm_s4 at B=1 (the packed weight);
// at B=64 the bf16 tensor-core rate or the f32 output, as the bf16
// forward products. Design (simple first): an NN skeleton -- bf16 WMMA
// 16x16x16 fragments with f32 accumulation, 64x64 output tiles per 4-warp
// block, K in steps of 32 through a two-stage cp.async pipeline -- with
// the B tile copied as packed bytes (32 rows x 64 bytes, one 16-byte chunk
// a thread) and dequantized by the thread that copied it into the bf16
// tile that WMMA reads. K-tiles of 32 rows never straddle the two nibble halves or a
// scale group (K a multiple of 128, so K/2 of 64). No dequantized copy of
// the weight is stored.
// Not yet: wgmma, TMA, split-K at B=1.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, SKEW = 8, THREADS = 128, GROUP = 128;
constexpr int LDA = BK + SKEW, LDB = BN + SKEW;

struct Epilogue {
  const float* s4;      // [K / GROUP, N] group scales
  const float* bias;    // [N] or null
  int relu;
  float* out_f32;       // either output may be null
  bf16* out_bf16;
  long long ldo;
};

__global__ void __launch_bounds__(THREADS)
gemm_w4bf16_kernel(const bf16* __restrict__ A, long long lda,
                   const unsigned char* __restrict__ P, long long ldp, int M, int N, int K,
                   Epilogue ep) {
  __shared__ __align__(128) bf16 As[2][BM * LDA];
  __shared__ __align__(128) unsigned char Wraw[2][BK][BN];
  __shared__ __align__(128) bf16 Bs[2][BK * LDB];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int half = K / 2;
  // this thread's chunk of the packed B tile: row wr, bytes [wc, wc + 16)
  const int wr = tid / (BN / 16), wc = (tid % (BN / 16)) * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_tile = [&](int st, int k0) {
    // A: BM rows of BK bf16, chunks of 8 along k
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      const bool ok = gm < M && gk < K;
      cp_async16(&As[st][r * LDA + cc], ok ? A + (size_t)gm * lda + gk : A, ok);
    }
    const int p = (k0 < half ? k0 : k0 - half) + wr;
    const int gn = n0 + wc;
    const bool ok = gn < N;
    cp_async16(&Wraw[st][wr][wc], ok ? P + (size_t)p * ldp + gn : P, ok);
    cp_async_commit();
  };

  // this thread's packed chunk of stage st -> 16 bf16 values of the B tile
  auto dequant_chunk = [&](int st, int k0) {
    const bool hi = k0 >= half;
    const float* sg = ep.s4 + (size_t)(k0 / GROUP) * N;
    __align__(16) bf16 w[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const unsigned b = Wraw[st][wr][wc + e];
      const int q = static_cast<int>(hi ? b >> 4 : b & 0xFu) - 8;
      const int gn = n0 + wc + e;
      const float sc = gn < N ? sg[gn] : 0.0f;
      w[e] = to_bf16(__fmul_rn(static_cast<float>(q), sc));
    }
    uint4* dst = reinterpret_cast<uint4*>(&Bs[st][wr * LDB + wc]);
    dst[0] = reinterpret_cast<const uint4*>(w)[0];
    dst[1] = reinterpret_cast<const uint4*>(w)[1];
  };

  const int nk = K / BK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile(st ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    dequant_chunk(st, kt * BK);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[st][(wm + i * 16) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[st][kk * LDB + wn + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  float* cs = Cs[warp];
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
          float v = cs[e];
          if (ep.bias != nullptr) v += ep.bias[gc];
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

// A: bf16 [M, K] (row stride lda, a multiple of 8); P: packed int8 [K/2, N]
// (row stride ldp, a multiple of 16); s4: f32 [K/128, N] contiguous. K a
// multiple of 128, N of 16, A and P 16-byte aligned (the wrapper checks).
// bias: f32 [N] or null. Outputs: [M, N] with row stride ldo, either may be
// null. Returns cudaGetLastError().
MCAN_API int mcan_gemm_w4bf16(const void* A, long long lda, const void* P, long long ldp,
                              const void* s4, int M, int N, int K, const void* bias, int relu,
                              void* out_f32, void* out_bf16, long long ldo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Epilogue ep{static_cast<const float*>(s4), static_cast<const float*>(bias), relu,
              static_cast<float*>(out_f32), static_cast<bf16*>(out_bf16), ldo};
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_w4bf16_kernel<<<grid, THREADS, 0, s>>>(static_cast<const bf16*>(A), lda,
                                                static_cast<const unsigned char*>(P), ldp, M, N,
                                                K, ep);
  }
  return static_cast<int>(cudaGetLastError());
}
