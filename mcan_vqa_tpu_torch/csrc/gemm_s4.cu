// gemm_s4: C[M, N] = the grouped int4 product of the TPU kernels' static
// int4 sites, with int8 activation codes and a nibble-packed int4 weight:
//   for each K-group gi of 128 rows, in order:
//     t_gi = f32(int32 sum_{k in gi} A[m, k] * W[k, n]) * (a * s4[gi, n])
//   v = t_0 + t_1 + ... (left to right), then + bias[n], then ReLU;
//   written f32 and/or bf16 (one rounding each).
//
// Replaces: the int4 matmuls inside the TPU kernels
//   mcan_vqa_tpu/ops/quant.py::_sga_kernel_qffn (:1057) and
//   ::_sa_kernel_qffn (:1184) at qffn levels 4 and 5 -- ``_qdot_static4``
//   (:282): the packed weight unpacked in-register (``_unpack_w4``, :81),
//   one int8 dot_general per K-group with an int32 result, each dequantized
//   by its group's scales and summed in f32. The sites: the FFN's w1 [D, F]
//   and w2 [F, D] (levels 4, 5) and the fused self-attention qkv [D, 3D]
//   (level 5).
//
// Weight layout (``_quant_w4``, quant.py:56): P is int8 [K/2, N]; rows k
// and k + K/2 of W share the byte P[k, n] = (q_lo + 8) | (q_hi + 8) << 4,
// q in [-7, 7]. s4 is f32 [K/128, N].
//
// Numerics: each group's int32 sum is exact, so any summation order gives
// the same accumulator; the conversion to f32 rounds to nearest even and
// the epilogue uses __fmul_rn / __fadd_rn in the plain version's order (no
// FMA contraction), so the output equals the plain version bit for bit.
//
// Bounds on an H100: at B=1 (M = 14 or 60) a site is bound by its weight
// bytes -- 0.5 MB of packed w1 at MCAN-small, 2 MB at MCAN-large, against
// 1-4 MB for the int8 weight: halving them is what the level is for. At
// B=64 (M = 3840) the w1 site is 8.1 GOP, 4.1 us at the int8 tensor-core
// peak, and its f32 output (31 MB, 9.4 us at 3.35 TB/s) bounds it.
// Design (simple first): the skeleton of the port's first int8 GEMM --
// WMMA signed-char m16n16k16 fragments, 64x64 output tiles per 4-warp
// block, a two-stage cp.async pipeline, 16-byte-wide slabs in shared
// memory -- with the K-tile equal to one scale group (128 rows). Row k
// of a tile comes from packed row k (low nibbles) for k < K/2, else from
// packed row k - K/2 (high
// nibbles), row by row: at K a multiple of 128 but not of 256 (hidden 384,
// 640, 896) one group straddles the two halves. The int4 weight is read
// from HBM as it is stored, and each thread unpacks the 16-byte chunks it
// copied, in place, into int8 values (no unpacked copy of the weight is
// ever stored). The
// int32 fragments are cleared per group; each group's epilogue goes
// through shared memory into 32 f32 running sums per lane.
// Not yet: wgmma, TMA (gemm_sm90.cu's S8 instance, with a stage that
// unpacks the nibbles in shared memory), split-K for the B=1 sites (a w1
// site fills 32 of the 132 SMs at M <= 64).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 128, SLAB = 16, THREADS = 128;
constexpr int A_CHUNKS = BM * (BK / SLAB), W_CHUNKS = BK * (BN / SLAB);

struct Epilogue {
  float a;              // the static activation scale
  const float* s4;      // [K / BK, N] group scales
  const float* bias;    // [N] or null
  int relu;
  float* out_f32;       // either output may be null
  bf16* out_bf16;
  long long ldo;
};

// a packed word -> four int8 values: the low (hi = 0) or high nibbles,
// minus 8, byte by byte (__vsub4 wraps each byte on its own)
__device__ __forceinline__ unsigned unpack4(unsigned w, bool hi) {
  const unsigned nib = (hi ? w >> 4 : w) & 0x0F0F0F0Fu;
  return __vsub4(nib, 0x08080808u);
}

__global__ void __launch_bounds__(THREADS)
gemm_s4_kernel(const signed char* __restrict__ A, long long lda,
               const unsigned char* __restrict__ P, long long ldp, int M, int N, int K,
               Epilogue ep) {
  __shared__ __align__(128) signed char As[2][BK / SLAB][BM][SLAB];
  __shared__ __align__(128) signed char Ws[2][BN / SLAB][BK][SLAB];
  __shared__ __align__(128) int Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int half = K / 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  float y[2][2][8] = {};  // the running f32 sums of this lane's 32 outputs

  auto load_tile = [&](int st, int k0) {
    // A: BM rows of BK codes, 16-byte chunks along k, chunk s -> slab s
    for (int c = tid; c < A_CHUNKS; c += THREADS) {
      const int r = c / (BK / SLAB), s = c % (BK / SLAB);
      const int gm = m0 + r;
      const bool ok = gm < M;
      cp_async16(&As[st][s][r][0], ok ? A + (size_t)gm * lda + k0 + s * SLAB : A, ok);
    }
    // W: BK packed rows of BN bytes, chunk s along n -> slab s; row k of W
    // is packed row k, or k - K/2 past the low half
    for (int c = tid; c < W_CHUNKS; c += THREADS) {
      const int r = c / (BN / SLAB), s = c % (BN / SLAB);
      const int k = k0 + r, pr = k < half ? k : k - half;
      const int gn = n0 + s * SLAB;
      const bool ok = gn < N;
      cp_async16(&Ws[st][s][r][0], ok ? P + (size_t)pr * ldp + gn : P, ok);
    }
    cp_async_commit();
  };

  // this thread's own W chunks of stage st, once its copies have landed
  auto unpack_tile = [&](int st, int k0) {
    for (int c = tid; c < W_CHUNKS; c += THREADS) {
      const int r = c / (BN / SLAB), s = c % (BN / SLAB);
      const bool hi = k0 + r >= half;
      uint4* p = reinterpret_cast<uint4*>(&Ws[st][s][r][0]);
      uint4 v = *p;
      v.x = unpack4(v.x, hi);
      v.y = unpack4(v.y, hi);
      v.z = unpack4(v.z, hi);
      v.w = unpack4(v.w, hi);
      *p = v;
    }
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
    unpack_tile(st, kt * BK);
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
    // this group's epilogue: dequantize its exact sums, add them in order
    const float* sg = ep.s4 + (size_t)kt * N;
    int* cs = Cs[warp];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int e = lane + 32 * t;
          const int gc = n0 + wn + j * 16 + e % 16;
          const float sc = gc < N ? __fmul_rn(ep.a, sg[gc]) : 0.0f;
          const float v = __fmul_rn(__int2float_rn(cs[e]), sc);
          y[i][j][t] = kt == 0 ? v : __fadd_rn(y[i][j][t], v);
        }
        __syncwarp();
        wmma::fill_fragment(acc[i][j], 0);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int e = lane + 32 * t;
        const int gr = m0 + wm + i * 16 + e / 16;
        const int gc = n0 + wn + j * 16 + e % 16;
        if (gr < M && gc < N) {
          float v = y[i][j][t];
          if (ep.bias != nullptr) v = __fadd_rn(v, ep.bias[gc]);
          if (ep.relu) v = fmaxf(v, 0.0f);
          if (ep.out_f32 != nullptr) ep.out_f32[(size_t)gr * ep.ldo + gc] = v;
          if (ep.out_bf16 != nullptr) ep.out_bf16[(size_t)gr * ep.ldo + gc] = to_bf16(v);
        }
      }
    }
  }
}

}  // namespace

// A: int8 [M, K] codes (row stride lda); P: packed int8 [K/2, N] (row stride
// ldp); s4: f32 [K/128, N] contiguous. K a multiple of 128 (one group per
// K-tile), N, lda and ldp multiples of 16, A and P
// 16-byte aligned (the wrapper checks). a: the static activation scale.
// bias: f32 [N] or null. Outputs: [M, N] with row stride ldo, either may be
// null. Returns cudaGetLastError().
MCAN_API int mcan_gemm_s4(const void* A, long long lda, const void* P, long long ldp,
                          const void* s4, int M, int N, int K, float a, const void* bias,
                          int relu, void* out_f32, void* out_bf16, long long ldo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Epilogue ep{a, static_cast<const float*>(s4), static_cast<const float*>(bias), relu,
              static_cast<float*>(out_f32), static_cast<bf16*>(out_bf16), ldo};
  if (M > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_s4_kernel<<<grid, THREADS, 0, s>>>(static_cast<const signed char*>(A), lda,
                                            static_cast<const unsigned char*>(P), ldp, M, N, K,
                                            ep);
  }
  return static_cast<int>(cudaGetLastError());
}
