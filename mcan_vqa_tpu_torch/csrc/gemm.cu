// gemm: C[M, N] = A[M, K] . B[K, N] with an elementwise epilogue, bf16
// operands, f32 accumulation: the forward products (gemm_bias_act). The
// backward products dX = dY . W^T and dW = X^T . dY run on gemm_sm90.cu.
//
// Replaces: the matmuls inside the TPU block kernels
//   mcan_vqa_tpu/ops/sga_block.py::_sga_kernel_fusedproj (:239) and
//   ::_sa_kernel (:967) -- the fused qkv [D,3D], the cross query [D,D], the
//   two merges [D,D] and the FFN [D,F] / [F,D] dots, each
//   jnp.dot(bf16, bf16, preferred_element_type=f32) + bias;
//   and the forward products of the train kernels
//   mcan_vqa_tpu/ops/sga_train.py: _fwd_kernel (:415; with the h1 dropout
//   on the ReLU output) and the projection recomputes of _bwd_att_kernel
//   (:631); and mcan_vqa_tpu/ops/sa_train.py::_fwd_body (:130).
//
// Bounds on an H100: at B=64 the image-stream products (M = 3840, K = 512,
// N = 512..2048; MCAN-large per micro-batch of 32: M = 1920, K = 1024,
// N = 1024..4096) carry 2-16 GFLOP each and are bound by the bf16
// tensor-core rate.
//
// Design (simple first): bf16 WMMA 16x16x16 fragments with f32
// accumulation, 64x64 output tiles per 4-warp block (each warp 32x32), K
// in steps of 32 through a two-stage cp.async pipeline in shared memory.
// Rows, columns and reduction steps past M / N / K are zero-filled on load
// and masked on store, so a ragged M and a last column tile past N (any N
// that is a multiple of 8, hidden 480 say) are exact; every output element
// is written. The epilogue, in order: + bias, ReLU, dropout keep-mask (x
// inv_keep) read from a uint8 tensor or drawn in place by Philox
// (common.cuh; the h1 site of the train forward's FFN, _fwd_kernel_prng
// :507, sa_train.py::_fwd_kernel_prng :179); then one rounding to the
// requested output type (f32 or bf16).
// Not yet: this product on gemm_sm90.cu's wgmma + TMA mainloop (its
// Philox epilogue with it), persistent tiles.
#include <mma.h>

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
  float inv_keep;
  Philox keep;                  // or the seeded keep source of the mask
  float* out_f32;               // one of the outputs is null
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

// A [M, K] (row stride lda) . B [K, N] (row stride ldb)
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, long long lda, const bf16* __restrict__ B,
            long long ldb, int M, int N, int K, Epilogue ep) {
  using TA = Tile<BM, BK>;
  using TB = Tile<BK, BN>;
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
    // A: tile rows are m, chunks run along k
    for (int c = tid; c < TA::CHUNKS; c += THREADS) {
      constexpr int CPR = BK / 8;  // chunks per tile row
      const int r = c / CPR, cc = (c % CPR) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      const bool ok = gm < M && gk < K;
      cp_async16(&As[stage][r * TA::LD + cc], ok ? A + (size_t)gm * lda + gk : A, ok);
    }
    // B: tile rows are k, chunks run along n
    for (int c = tid; c < TB::CHUNKS; c += THREADS) {
      constexpr int CPR = BN / 8;
      const int r = c / CPR, cc = (c % CPR) * 8;
      const int gn = n0 + cc, gk = k0 + r;
      const bool ok = gn < N && gk < K;
      cp_async16(&Bs[stage][r * TB::LD + cc], ok ? B + (size_t)gk * ldb + gn : B, ok);
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
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[st][(wm + i * 16) * TA::LD + kk], TA::LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][kk * TB::LD + wn + j * 16], TB::LD);
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
          if (ep.out_f32 != nullptr) ep.out_f32[(size_t)gr * ep.ldo32 + gc] = v;
          if (ep.out_bf16 != nullptr) ep.out_bf16[(size_t)gr * ep.ldo16 + gc] = to_bf16(v);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// A [M, K] and B [K, N], leading dimensions in elements. Every pointer may
// be null except A, B and one output. keep_on != 0 draws the dropout
// keep-mask in place of `mask` (null then): Philox key (seed, site), rows
// per sample keep_rows, keep iff word < thresh. Chunks of 8 bf16 are loaded
// whole: K, N and the row strides must be multiples of 8 and both operands
// 16-byte aligned (the wrapper checks). Returns cudaGetLastError().
MCAN_API int mcan_gemm(const void* A, long long lda, const void* B, long long ldb, int M, int N,
                       int K, const void* bias, int relu, const void* mask, long long ldm,
                       float inv_keep, int keep_on, unsigned seed, unsigned site, unsigned thresh,
                       int keep_rows, void* out_f32, long long ldo32, void* out_bf16, long long ldo16,
                       void* stream) {
  Epilogue ep{static_cast<const float*>(bias), relu, static_cast<const unsigned char*>(mask), ldm,
              inv_keep, Philox{keep_on, seed, site, thresh, keep_rows},
              static_cast<float*>(out_f32), ldo32, static_cast<bf16*>(out_bf16), ldo16};
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb, M, N, K, ep);
  }
  return static_cast<int>(cudaGetLastError());
}
