// gemm: C[M, N] = op(A) . op(B) with an elementwise epilogue, bf16 operands,
// f32 accumulation. Three layouts, one kernel template:
//   NN  C = A[M,K] . B[K,N]       forward products (gemm_bias_act)
//   NT  C = A[M,K] . B[N,K]^T     dX = dY . W^T   (gemm_dx)
//   TN  C = A[K,M]^T . B[K,N]     dW = X^T . dY   (gemm_dw)
//
// Replaces: the matmuls inside the TPU block kernels
//   mcan_vqa_tpu/ops/sga_block.py::_sga_kernel_fusedproj (:239) and
//   ::_sa_kernel (:967) -- the fused qkv [D,3D], the cross query [D,D], the
//   two merges [D,D] and the FFN [D,F] / [F,D] dots, each
//   jnp.dot(bf16, bf16, preferred_element_type=f32) + bias;
//   and those of the train kernels mcan_vqa_tpu/ops/sga_train.py:
//   _fwd_kernel (:415; the forward products with the h1 dropout on the
//   ReLU output), _bwd_ffn_kernel_sav (:576; dy3 . W2^T with the ReLU /
//   dropout gradient epilogue, da1 . W1^T + the residual gr3, the dW
//   partials v2^T da1 and h1d^T dy3) and _bwd_att_kernel (:631; the five
//   dX products, the dW partials of _mm_tn :382 accumulated in-kernel by
//   _acc :390); _bwd_att_kernel_sav (:1183), the same minus the four
//   projection recomputes; and mcan_vqa_tpu/ops/sa_train.py::_fwd_body
//   (:130) and _bwd_body (:188), the SA block's forward and backward
//   products.
//
// Bounds on an H100: at B=64 the image-stream products (M = 3840, K = 512,
// N = 512..2048; MCAN-large per micro-batch of 32: M = 1920, K = 1024,
// N = 1024..4096) carry 2-16 GFLOP each and are bound by the bf16
// tensor-core rate; the dW products reduce over all M rows.
//
// Design (simple first): bf16 WMMA 16x16x16 fragments with f32
// accumulation, 64x64 output tiles per 4-warp block (each warp 32x32), K
// in steps of 32 through a two-stage cp.async pipeline in shared memory.
// A transposed operand is staged in its stored layout and read by WMMA as
// column-major, so no operand is ever transposed in memory. Rows, columns
// and reduction steps past M / N / K are zero-filled on load and masked on
// store, so a ragged M, a last column tile past N (any N that is a
// multiple of 8, hidden 480 say) and, for dW, a ragged number of rows are
// exact; every output element is written. A dW tile
// is summed by one block over all of K in a fixed order: no atomics, the
// result is the same bit for bit on every run. The epilogue, in order: +
// bias, ReLU, dropout keep-mask (x inv_keep) read from a uint8 tensor or
// drawn in place by Philox (common.cuh; the h1 site of the train forward's
// FFN, _fwd_kernel_prng :507, sa_train.py::_fwd_kernel_prng :179; its
// backward needs no draw: the gate below reads the kept ReLU output),
// gradient gate (x inv_keep where a bf16 tensor is > 0, else 0), + an f32
// residual; then one rounding to each requested output type (f32 and/or
// bf16).
// Not yet: wgmma, TMA, persistent tiles, split-K for the dW products.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32, SKEW = 8;
constexpr int THREADS = 128;

struct Epilogue {
  const float* bias;            // [N] or null
  int relu;
  const unsigned char* mask;    // [M, N] dropout keep-mask or null
  long long ldm;
  const bf16* gate;             // [M, N]: keep (x inv_keep) where > 0
  long long ldg;
  float inv_keep;
  Philox keep;                  // or the seeded keep source of the mask
  const float* res;             // [M, N] f32 added last, or null
  long long ldr;
  float* out_f32;               // either output may be null
  long long ldo32;
  bf16* out_bf16;
  long long ldo16;
};

// One stage of an operand tile in shared memory. ROWS x COLS bf16 with a
// skew against bank conflicts; a chunk is 8 consecutive bf16 (16 bytes).
template <int ROWS, int COLS>
struct Tile {
  static constexpr int LD = COLS + SKEW;
  static constexpr int ELEMS = ROWS * LD;
  static constexpr int CHUNKS = ROWS * COLS / 8;
};

// A_T: A is stored [K, M] (row stride lda) and read as its transpose.
// B_T: B is stored [N, K] (row stride ldb) and read as its transpose.
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, long long lda, const bf16* __restrict__ B,
            long long ldb, int M, int N, int K, Epilogue ep) {
  using TA = typename std::conditional<A_T, Tile<BK, BM>, Tile<BM, BK>>::type;
  using TB = typename std::conditional<B_T, Tile<BN, BK>, Tile<BK, BN>>::type;
  __shared__ __align__(128) bf16 As[2][TA::ELEMS];
  __shared__ __align__(128) bf16 Bs[2][TB::ELEMS];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_tile = [&](int stage, int k0) {
    // A: tile rows are m (A_T: k), chunks run along k (A_T: m)
    for (int c = tid; c < TA::CHUNKS; c += THREADS) {
      constexpr int CPR = (A_T ? BM : BK) / 8;  // chunks per tile row
      const int r = c / CPR, cc = (c % CPR) * 8;
      const int gm = A_T ? m0 + cc : m0 + r;
      const int gk = A_T ? k0 + r : k0 + cc;
      const bool ok = gm < M && gk < K;
      const bf16* src = ok ? (A_T ? A + (size_t)gk * lda + gm : A + (size_t)gm * lda + gk) : A;
      cp_async16(&As[stage][r * TA::LD + cc], src, ok);
    }
    // B: tile rows are k (B_T: n), chunks run along n (B_T: k)
    for (int c = tid; c < TB::CHUNKS; c += THREADS) {
      constexpr int CPR = (B_T ? BK : BN) / 8;
      const int r = c / CPR, cc = (c % CPR) * 8;
      const int gn = B_T ? n0 + r : n0 + cc;
      const int gk = B_T ? k0 + cc : k0 + r;
      const bool ok = gn < N && gk < K;
      const bf16* src = ok ? (B_T ? B + (size_t)gn * ldb + gk : B + (size_t)gk * ldb + gn) : B;
      cp_async16(&Bs[stage][r * TB::LD + cc], src, ok);
    }
    cp_async_commit();
  };

  using LayA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using LayB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;

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
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + i * 16;
        // element (m, k): row-major at [m][k], column-major (A_T) at [k][m]
        const bf16* p = A_T ? &As[st][kk * TA::LD + m] : &As[st][m * TA::LD + kk];
        wmma::load_matrix_sync(a[i], p, TA::LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + j * 16;
        // element (k, n): row-major at [k][n], column-major (B_T) at [n][k]
        const bf16* p = B_T ? &Bs[st][n * TB::LD + kk] : &Bs[st][kk * TB::LD + n];
        wmma::load_matrix_sync(b[j], p, TB::LD);
      }
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
          if (ep.mask != nullptr) v = ep.mask[(size_t)gr * ep.ldm + gc] ? v * ep.inv_keep : 0.0f;
          if (ep.keep.on) v = philox_keep_rows(ep.keep, gr, N, gc) ? v * ep.inv_keep : 0.0f;
          if (ep.gate != nullptr)
            v = to_f32(ep.gate[(size_t)gr * ep.ldg + gc]) > 0.0f ? v * ep.inv_keep : 0.0f;
          if (ep.res != nullptr) v = ep.res[(size_t)gr * ep.ldr + gc] + v;
          if (ep.out_f32 != nullptr) ep.out_f32[(size_t)gr * ep.ldo32 + gc] = v;
          if (ep.out_bf16 != nullptr) ep.out_bf16[(size_t)gr * ep.ldo16 + gc] = to_bf16(v);
        }
      }
      __syncwarp();
    }
  }
}

template <bool A_T, bool B_T>
void launch(const void* A, long long lda, const void* B, long long ldb, int M, int N, int K,
            const Epilogue& ep, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<A_T, B_T><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb, M, N, K, ep);
}

}  // namespace

// layout: 0 = NN (A [M,K], B [K,N]), 1 = NT (A [M,K], B stored [N,K]),
// 2 = TN (A stored [K,M], B [K,N]). Leading dimensions are in elements.
// Every pointer may be null except A, B and at least one output.
// keep_on != 0 draws the dropout keep-mask in place of `mask` (null then):
// Philox key (seed, site), rows per sample keep_rows, keep iff word < thresh.
// Chunks of
// 8 bf16 are loaded whole: the dimension each operand's rows run along
// must be a multiple of 8 and both operands 16-byte aligned (the wrapper
// checks). Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unknown layout.
MCAN_API int mcan_gemm(int layout, const void* A, long long lda, const void* B, long long ldb,
                       int M, int N, int K, const void* bias, int relu, const void* mask,
                       long long ldm, const void* gate, long long ldg, float inv_keep,
                       int keep_on, unsigned seed, unsigned site, unsigned thresh,
                       int keep_rows, const void* res, long long ldr, void* out_f32, long long ldo32,
                       void* out_bf16, long long ldo16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Epilogue ep{static_cast<const float*>(bias), relu, static_cast<const unsigned char*>(mask), ldm,
              static_cast<const bf16*>(gate), ldg, inv_keep,
              Philox{keep_on, seed, site, thresh, keep_rows}, static_cast<const float*>(res), ldr,
              static_cast<float*>(out_f32), ldo32, static_cast<bf16*>(out_bf16), ldo16};
  if (M > 0 && N > 0) {
    switch (layout) {
      case 0: launch<false, false>(A, lda, B, ldb, M, N, K, ep, s); break;
      case 1: launch<false, true>(A, lda, B, ldb, M, N, K, ep, s); break;
      case 2: launch<true, false>(A, lda, B, ldb, M, N, K, ep, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
