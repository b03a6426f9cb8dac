// gemm_sm90: the port's products on Hopper's asynchronous tensor cores,
// one mainloop for three bf16 layouts (f32 accumulation) and one int8 one
// (exact int32 accumulation):
//   NN  C[M,N] = A[M,K] . B[K,N]       the forward   (gemm_bias_act)
//   NT  C[M,N] = A[M,K] . B[N,K]^T     dX = dY . W^T (gemm_dx)
//   TN  C[M,N] = A[K,M]^T . B[K,N]     dW = X^T . dY (gemm_dw)
//   S8  C[M,N] = dequant(A[M,K] . B[N,K]^T), int8  (gemm_s8)
//
// Replaces: the forward dots of the TPU block kernels, each
//   jnp.dot(bf16, bf16, preferred_element_type=f32) + bias:
//   mcan_vqa_tpu/ops/sga_block.py::_sga_kernel_fusedproj (:285) and
//   ::_sa_kernel (:967) -- the fused qkv [D,3D], the cross query [D,D], the
//   merges [D,D], the FFN [D,F] / [F,D]; the train forward
//   mcan_vqa_tpu/ops/sga_train.py::_fwd_body (:415, the h1 dropout on the
//   ReLU output drawn by _fwd_kernel_prng :507) and the projection
//   recomputes of _bwd_att_kernel (:631); sa_train.py::_fwd_body (:130)
//   and _fwd_kernel_prng (:179). And the backward products inside the TPU
//   train kernels: sga_train.py::_mm_bt (dY . W^T; in the FFN backward
//   with the ReLU / dropout gate where(h1d > 0, inv_keep * dh1d, 0) at
//   :597-599, and the residual added to the next product's output) and
//   ::_mm_tn (:382, the dW partial of one grid step) summed over the
//   sequential grid by ::_acc (:390), in _bwd_ffn_kernel_sav (:576),
//   _bwd_att_kernel (:631) and _bwd_att_kernel_sav (:1183); and the same
//   products of mcan_vqa_tpu/ops/sa_train.py::_bwd_body (:188). S8: the
//   int8 dots of the TPU serving kernels, mcan_vqa_tpu/ops/quant.py::_qdot
//   (:253) and ::_qdot_static (:263) -- dot_general(int8, int8,
//   preferred_element_type=int32).astype(f32) * (s_x * s_w) + bias -- inside
//   _sga_kernel_qffn / _sa_kernel_qffn (pallas_call :1326 / :1412), the
//   full-int8 _qsga_kernel / _qsa_kernel (:539 / :599) and the static-int8
//   aux sites.
//
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the MCAN-small B=64
// step (M = R = 3840 rows, 512 <= K, N <= 2048) each product carries 2-8
// GFLOP, 2-8 us at the tensor-core peak. A forward product moves its
// operands, a bias and one output (f32 or bf16; the train forward's FFN
// product a byte mask too): 2-21 MB, 1-6 us, near the ridge. The dX
// products move 6-69 MB (f32 and bf16 outputs, the bf16 gate, the f32
// residual), so they are bound by bytes (2-21 us); a dW product moves 6-24
// MB (2-7 us) and sits near the ridge. An S8 product is bound by its bytes
// (the f32 output above all): the level-1 w1 site of the B=64 decoder (M
// 3840, K 512, N 2048) is 8.1 GOP, 4.1 us at 1,979 TOP/s, against 33.6 MB,
// 10.0 us at 3.35 TB/s.
//
// Design. One mainloop (sm90_mainloop.cuh's produce / consume, which the
// all-layer stacks' GEMM stages run too, persistent_stages.cuh), templated
// on the layout (each operand K-major or MN-major) and on the tile width BN
// (128 or 64; the tile height is 128).
// A block is a producer warp and one or two consumer warpgroups:
//   * the producer's lane 0 keeps TMA loads (cp.async.bulk.tensor, 2-D
//     tensor maps encoded on the host per call, 128-byte swizzle) in flight
//     into a ring of STAGES tiles of K = 64 in dynamic shared memory, each
//     guarded by a full and an empty mbarrier. Boxes that run past M, N or
//     K are zero-filled by the TMA unit, so a ragged edge needs no mask on
//     the load and contributes exact zeros;
//   * the consumers issue wgmma.mma_async m64nBNk16 with both operands read
//     from shared memory through matrix descriptors: an operand stored
//     with K contiguous is read K-major (a [M,K] of NN, dy [M,K] and w
//     [N,K] of dX), one stored with M or N contiguous MN-major through
//     wgmma's transpose bits (w [K,N] of NN, x [R,m] and dy [R,n] of dW):
//     nothing is transposed in memory; one wgmma group stays in flight
//     while the next stage is awaited;
//   * the epilogue runs from the accumulator registers, stores masked at
//     the M and N edges: every output element is written. Its loads go out
//     in batches ahead of the stores they feed.
// S8 reads both operands K-major (wgmma's transpose bits exist only for
// 16-bit types): the int8 weight, [K, N] in the JAX shape, is stored with
// K contiguous (strides (1, ld)), so its tensor map sees it as [N, K] rows,
// as NT's B. A K-tile is 128 int8 values, 128 bytes a row, as the bf16
// K-tile of 64: the same boxes, swizzle, descriptors and ring, the wgmma
// m64nBNk32.s32.s8.s8 in four 32-byte steps a K-tile. The sums are exact,
// so their order is free. Its epilogue, from the s32 accumulators (the f32
// fragment's layout): f32(acc) * (sx[m] or a, times sw[n]) in that order,
// + bias[n], ReLU, one rounding to each requested output -- each step one
// correctly rounded operation (__fmul_rn, __fadd_rn), so the result equals
// the plain version's bit for bit. sw[n] and bias[n] of the tile's columns
// are loaded as the item starts and staged in shared memory after its
// mainloop (two slots by item parity); sx[m] of the thread's rows in
// registers. f32 rows go out as pairs where the address allows (an odd N,
// 3129 or 1, leaves every other row's pairs unaligned: those go out one by
// one), bf16 rows as 16-byte pieces after a quad transpose where N % 8 ==
// 0, else as pairs or single values. Never split.
//
// BN 128: two consumer warpgroups of one 64-row half each, one block per
// SM, 6 stages; BN 64: one warpgroup for both halves, two blocks per SM, 4
// stages each (Cfg). The blocks are persistent: each walks work items
// (one split of one tile) in a fixed stride, its producer loading the next
// item while the consumers run this one's epilogue.
//
// The reduction over R (dW) runs across `splits` blocks per output tile
// (split-K): split s takes the whole K-tiles [s T / S, (s + 1) T / S).
// Each block writes its f32 partial to a workspace the wrapper allocates,
// in the accumulator's own register order (coalesced float4 rows), then
// bumps the tile's counter (the only atomic). The last block to arrive
// reads the S partials back and sums them in split order 0 .. S-1, runs
// the epilogue and puts the counter back to 0 for the next launch. The
// summation order is fixed, so the bits do not depend on which block runs
// first: two runs give equal bits. The plan (tile width, splits, grid,
// workspace) is chosen from the shape alone by ops/kernels.py::gemm_plan;
// NN and NT never split.
//
// The epilogues. NN, in order: + bias[col], ReLU, the dropout keep-mask
// (uint8 [M, N]) or its Philox source (x inv_keep, else 0), then one
// rounding to f32 or bf16. NT: the gradient gate (x inv_keep where the
// bf16 gate is > 0, else 0), + an f32 residual, then one rounding to each
// requested output (f32 and / or bf16). The seeded NN epilogue is an
// instance of its own, so the products without dropout do not carry its
// registers.
//
// Not yet: an epilogue staged through shared memory with TMA stores (the
// dX products with two outputs and a gate run at 2.6-3x their bound; the
// epilogue does not overlap the next item's products), thread-block
// clusters with multicast loads, a split of the B=1 forward products (N
// 512 is 4-8 tiles), cheaper Philox keep bits (on an H100 the seeded FFN
// product of the MCAN-small step takes 1.7x the unseeded one's time).
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "sm90_mainloop.cuh"

namespace sm90 {

// BN 128: two consumer warpgroups, each one 64-row half of the tile (64
// accumulators a thread), one block per SM and a ring of 6 stages; BN 64:
// one warpgroup for both halves (64 accumulators), two blocks per SM of 4
// stages each. Either way a thread holds 64 accumulators and every SM
// works on 128 x 128 outputs at a time: ptxas caps a thread at 168
// registers once an SM sub-partition runs three warps, and 128
// accumulators a thread spilled there.
template <int BN>
struct Cfg {
  static constexpr int WGS = BN / 64;             // consumer warpgroups
  static constexpr int HALVES = 2 / WGS;          // 64-row halves each
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int BLOCKS_PER_SM = 3 - WGS;
  static constexpr int STAGES = BN == 128 ? 6 : 4;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, 1 KB of slack to align it, the barriers and a flag
  static constexpr int SMEM = SWIZZLE_ATOM + STAGES * STAGE_BYTES + 16 * STAGES + 16;
};

// the layouts (mcan_gemm_sm90's `layout`, the kernel's template argument;
// S8 is mcan_gemm_sm90_s8's)
constexpr int NT = 1, TN = 2, NN = 3, S8 = 4;

// the dynamic shared memory of an instance: the ring and, for S8, two
// slots of the item's column scales and biases
template <int LAYOUT, int BN>
constexpr int smem_bytes() {
  return Cfg<BN>::SMEM + (LAYOUT == S8 ? 2 * 2 * BN * 4 : 0);
}

// The S8 epilogue's arguments, a type of their own, so that the bf16
// instances keep their parameter block: with three more fields in
// Epilogue the compiler reloaded the NT / TN epilogue's pointers from the
// constant bank element by element, and on an H100 dX and dW ran 5-39%
// slower.
struct S8Epilogue {
  const float* sx;    // [M] per-row activation scales, or null and then
  float a;            // the static scale a
  const float* sw;    // [N] per-column weight scales
  const float* bias;  // [N] or null
  int relu;
  float* out_f32;     // either output may be null; both dense [M, N]
  bf16* out_bf16;
  long long ldo;
};

template <int LAYOUT>
using EpilogueOf = std::conditional_t<LAYOUT == S8, S8Epilogue, Epilogue>;

// The s8 product's per-item state: thread t < BN loads the weight scale
// and bias of the tile's column n0 + t as the item starts (0 past N), to
// store them into the item's slot of shared memory once the mainloop is
// done, so their latency hides behind it; every thread loads the
// activation scales of its 2 HALVES rows (r0 + 64 h + 8 hi at 2 h + hi):
// sx[m], or the static a.
template <int BN>
struct S8State {
  static constexpr int HALVES = Cfg<BN>::HALVES;
  float sw, bias, sx[2 * HALVES];

  __device__ __forceinline__ void start(const S8Epilogue& ep, int tid, int r0, int n0, int M, int N) {
    const bool in = tid < BN && n0 + tid < N;
    sw = in ? __ldg(ep.sw + n0 + tid) : 0.0f;
    bias = in && ep.bias != nullptr ? __ldg(ep.bias + n0 + tid) : 0.0f;
#pragma unroll
    for (int i = 0; i < 2 * HALVES; ++i) {
      const int row = r0 + 64 * (i / 2) + 8 * (i % 2);
      sx[i] = ep.sx == nullptr ? ep.a : row < M ? __ldg(ep.sx + row) : 0.0f;
    }
  }
};

// one element of the s8 epilogue, in the TPU kernel's order and rounding
__device__ __forceinline__ float dequant(int q, float sx, float sw, float bias,
                                         const S8Epilogue& ep) {
  float v = __fmul_rn(__int2float_rn(q), __fmul_rn(sx, sw));
  if (ep.bias != nullptr) v = __fadd_rn(v, bias);
  return ep.relu ? fmaxf(v, 0.0f) : v;
}

// The s8 epilogue from the accumulator registers (the layout of
// nn_epilogue's): the slot holds the tile's sw[BN] then bias[BN]; the
// thread's pairs of columns (col, col + 1) read them as float2. Every
// output element is written: rows past M and columns past N are masked.
template <int BN>
__device__ __forceinline__ void s8_epilogue(const int (&acc)[Cfg<BN>::HALVES][BN / 2],
                                            const float* slot, const S8State<BN>& st, int lane,
                                            int r0, int c0, int n0, int M, int N,
                                            const S8Epilogue& ep) {
  constexpr int HALVES = Cfg<BN>::HALVES, ACC = BN / 2, PAIRS = ACC / 4;
  const float* csw = slot + (c0 - n0);
  const float* cb = slot + BN + (c0 - n0);
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = r0 + 64 * h + 8 * hi;
      const float sx = st.sx[2 * h + hi];
#pragma unroll
      for (int g = 0; g < PAIRS; g += 4) {   // pairs g .. g + 3: columns 8 g .. 8 g + 31
        float v[8];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = 4 * (g + s) + 2 * hi;
          const float2 w = *reinterpret_cast<const float2*>(csw + 8 * (g + s));
          const float2 b = *reinterpret_cast<const float2*>(cb + 8 * (g + s));
          v[2 * s] = dequant(acc[h][j], sx, w.x, b.x, ep);
          v[2 * s + 1] = dequant(acc[h][j + 1], sx, w.y, b.y, ep);
        }
        if (ep.out_f32 != nullptr) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int col = c0 + 8 * (g + s);
            const size_t o = static_cast<size_t>(row) * ep.ldo + col;
            if (row >= M || col >= N) continue;
            if (col + 1 < N && (o & 1) == 0) {
              *reinterpret_cast<float2*>(ep.out_f32 + o) = make_float2(v[2 * s], v[2 * s + 1]);
            } else {   // an odd N: the pair straddles 8 bytes, or ends the row
              ep.out_f32[o] = v[2 * s];
              if (col + 1 < N) ep.out_f32[o + 1] = v[2 * s + 1];
            }
          }
        }
        if (ep.out_bf16 != nullptr) {
          if (N % 8 == 0) {   // the warp agrees: a quad's 8 columns as 16 bytes
            unsigned a[4];
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const __nv_bfloat162 b2 = __halves2bfloat162(to_bf16(v[2 * s]), to_bf16(v[2 * s + 1]));
              a[s] = *reinterpret_cast<const unsigned*>(&b2);
            }
            quad_transpose(a, lane);   // a: columns 8 (g + lane % 4) .. + 7 of the row
            const int col = c0 - 2 * (lane & 3) + 8 * (g + (lane & 3));
            if (row < M && col < N)
              *reinterpret_cast<uint4*>(ep.out_bf16 + static_cast<size_t>(row) * ep.ldo + col) =
                  make_uint4(a[0], a[1], a[2], a[3]);
          } else {
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const int col = c0 + 8 * (g + s);
              const size_t o = static_cast<size_t>(row) * ep.ldo + col;
              if (row >= M || col >= N) continue;
              if (col + 1 < N && (o & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(ep.out_bf16 + o) =
                    __halves2bfloat162(to_bf16(v[2 * s]), to_bf16(v[2 * s + 1]));
              } else {
                ep.out_bf16[o] = to_bf16(v[2 * s]);
                if (col + 1 < N) ep.out_bf16[o + 1] = to_bf16(v[2 * s + 1]);
              }
            }
          }
        }
      }
    }
  }
}

// LAYOUT NT: both operands K-major (dX); TN: both MN-major (dW); NN: A
// K-major, B MN-major (the forward); S8: both K-major, int8 (the int8
// dots). SEEDED (NN only): the keep-mask drawn by Philox in the epilogue.
// Persistent: block b takes work items b, b + grid, ... (item w = split
// w / tiles of tile w % tiles), its producer loading the next item's
// K-tiles while the consumers run this one's epilogue.
template <int LAYOUT, int BN, bool SEEDED>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, Cfg<BN>::BLOCKS_PER_SM)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 int M, int N, int k_tiles, int splits, EpilogueOf<LAYOUT> ep, float* __restrict__ ws,
                 int* __restrict__ counters) {
  using C = Cfg<BN>;
  using Acc = std::conditional_t<LAYOUT == S8, int, float>;   // s32 or f32 sums
  constexpr int STAGES = C::STAGES, HALVES = C::HALVES, CONSUMERS = C::CONSUMERS;
  constexpr int ACC = BN / 2;                  // accumulators of one 64-row half
  constexpr int KE = LAYOUT == S8 ? 2 * BK : BK;   // elements a K-tile: 128 bytes a row
  constexpr int TA = LAYOUT == TN ? 1 : 0;     // wgmma transpose bits: A MN-major
  constexpr int TB = LAYOUT == NT || LAYOUT == S8 ? 0 : 1;   // B MN-major
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + SWIZZLE_ATOM - 1) & ~(SWIZZLE_ATOM - 1);
  const uint32_t bars = base + STAGES * C::STAGE_BYTES;   // full[s], then empty[s]
  int* last_flag = reinterpret_cast<int*>(smem_raw + (bars - raw) + 16 * STAGES);
  float* s8_cols = reinterpret_cast<float*>(smem_raw + (bars - raw) + 16 * STAGES + 16);   // S8

  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * tiles_n;
  const int items = tiles * splits;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the producer warp: lane 0 keeps the ring full, item after item
    if (tid == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&ta)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tb)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item it(w, tiles, tiles_n, BN, k_tiles, splits);
        produce<STAGES, C::STAGE_BYTES>(base, bars, stage, phase, it.nk, C::STAGE_BYTES,
                                        [&](uint32_t a, uint32_t full, int i) {
          const uint32_t b = a + C::A_BYTES;
          const int k0 = (it.kt0 + i) * KE;
          if (TA) {
            // x [R, m]: two boxes of 64 m-columns x BK rows
            tma_load(a, &ta, full, it.m0, k0);
            tma_load(a + BOX, &ta, full, it.m0 + 64, k0);
          } else {
            // a, dy [M, K], the int8 codes: 128 rows x 128 bytes
            tma_load(a, &ta, full, k0, it.m0);
          }
          if (TB) {
            // dy [R, n], w [K, N]: BN / 64 boxes of 64 n-columns x BK rows
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) tma_load(b + j * BOX, &tb, full, it.n0 + 64 * j, k0);
          } else {
            // w [N, K], the int8 weight's K-major rows: BN rows x 128 bytes
            tma_load(b, &tb, full, k0, it.n0);
          }
        });
      }
    }
    return;
  }

  // ---- the consumer warpgroups: warpgroup wg computes the 64-row halves
  // wg HALVES .. (wg + 1) HALVES - 1 of each tile
  const int wg = tid / 128, t = tid % 128;
  const int warp = t >> 5, lane = t & 31;
  int stage = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it(w, tiles, tiles_n, BN, k_tiles, splits);
    Acc acc[HALVES][ACC];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[h][j] = 0;
    // NN, S8: the thread's first row and column pair; NN's bias and keep
    // bits, S8's scales and bias
    const int r0 = it.m0 + wg * HALVES * 64 + warp * 16 + (lane >> 2);
    const int c0 = it.n0 + (lane & 3) * 2;
    NNState<HALVES, ACC, SEEDED> nn;
    if constexpr (LAYOUT == NN) nn.start(ep, r0, c0, N);
    S8State<BN> s8;
    if constexpr (LAYOUT == S8) s8.start(ep, tid, r0, it.n0, M, N);

    consume<TA, TB, STAGES, C::STAGE_BYTES>(acc, base, bars, stage, phase, it.nk,
                                            wg * HALVES * BOX, C::A_BYTES, [&] {
      if constexpr (SEEDED) {   // while the products run
        if (nn.drawn < nn.DRAWS) nn.template draw<2>(ep, lane, r0, c0, M, N);
      }
    });

    if constexpr (LAYOUT == NT || LAYOUT == TN) if (splits > 1) {
      // this split's partial; the last block of the tile sums them all
      if (!split_sum<HALVES, ACC, CONSUMERS>(acc, ws, counters, it.tile, it.split, splits, tid,
                                             last_flag))
        continue;
    }

    if constexpr (LAYOUT == NN) {
      nn_epilogue<HALVES, ACC, SEEDED>(acc, nn, lane, r0, c0, M, N, ep);
      continue;
    }
    if constexpr (LAYOUT == S8) {
      // sw[BN], then bias[BN], in the slot of the item's parity
      float* slot = s8_cols + ((w - blockIdx.x) / gridDim.x & 1) * 2 * BN;
      if (tid < BN) {
        slot[tid] = s8.sw;
        slot[BN + tid] = s8.bias;
      }
      consumer_sync<CONSUMERS>();
      s8_epilogue<BN>(acc, slot, s8, lane, r0, c0, it.n0, M, N, ep);
      continue;
    }
    if constexpr (LAYOUT == NT || LAYOUT == TN) {
      // ---- the epilogue from registers: accumulator j of half h holds row
      // 64 (wg HALVES + h) + 16 warp + lane / 4 + 8 ((j / 2) % 2), column
      // 8 (j / 4) + 2 (lane % 4) + j % 2 of the tile. The gate and residual
      // of CH accumulators are loaded before any of their stores: the
      // compiler may not move a load past a store that could alias it, so
      // a load between stores would wait out a memory round trip each.
      constexpr int CH = 16;
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        const int row0 = it.m0 + (wg * HALVES + h) * 64 + warp * 16 + (lane >> 2);
#pragma unroll
        for (int j0 = 0; j0 < ACC; j0 += CH) {
          float g[CH], r[CH];
#pragma unroll
          for (int j = j0; j < j0 + CH; j += 2) {
            const int row = row0 + 8 * ((j >> 1) & 1), col = it.n0 + (j >> 2) * 8 + (lane & 3) * 2;
            const bool in = row < M && col < N;   // N is even: col + 1 < N too
            if (ep.gate != nullptr && in) {
              const bf16* gp = ep.gate + static_cast<size_t>(row) * ep.ldg + col;
              g[j - j0] = to_f32(gp[0]);
              g[j - j0 + 1] = to_f32(gp[1]);
            }
            if (ep.res != nullptr && in) {
              const float* rp = ep.res + static_cast<size_t>(row) * ep.ldr + col;
              r[j - j0] = rp[0];
              r[j - j0 + 1] = rp[1];
            }
          }
#pragma unroll
          for (int j = j0; j < j0 + CH; j += 2) {
            const int row = row0 + 8 * ((j >> 1) & 1), col = it.n0 + (j >> 2) * 8 + (lane & 3) * 2;
            if (row < M && col < N) {
              float v0 = acc[h][j], v1 = acc[h][j + 1];
              if (ep.gate != nullptr) {
                v0 = g[j - j0] > 0.0f ? v0 * ep.inv_keep : 0.0f;
                v1 = g[j - j0 + 1] > 0.0f ? v1 * ep.inv_keep : 0.0f;
              }
              if (ep.res != nullptr) {
                v0 = r[j - j0] + v0;
                v1 = r[j - j0 + 1] + v1;
              }
              const size_t o = static_cast<size_t>(row) * ep.ldo + col;
              if (ep.out_f32 != nullptr)
                *reinterpret_cast<float2*>(ep.out_f32 + o) = make_float2(v0, v1);
              if (ep.out_bf16 != nullptr)
                *reinterpret_cast<__nv_bfloat162*>(ep.out_bf16 + o) =
                    __halves2bfloat162(to_bf16(v0), to_bf16(v1));
            }
          }
        }
      }
    }
  }
}

template <int LAYOUT, int BN, bool SEEDED>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, int M, int N, int k_tiles, int splits,
           int grid, const EpilogueOf<LAYOUT>& ep, float* ws, int* counters, cudaStream_t stream) {
  auto kernel = gemm_sm90_kernel<LAYOUT, BN, SEEDED>;
  constexpr int smem = smem_bytes<LAYOUT, BN>();
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, Cfg<BN>::THREADS, smem, stream>>>(ta, tb, M, N, k_tiles, splits, ep, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

template <int LAYOUT, bool SEEDED>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, int M, int N, int k_tiles, int splits,
           int bn, int grid, const EpilogueOf<LAYOUT>& ep, float* ws, int* counters,
           cudaStream_t stream) {
  return bn == 128 ? launch<LAYOUT, 128, SEEDED>(ta, tb, M, N, k_tiles, splits, grid, ep, ws, counters, stream)
                   : launch<LAYOUT, 64, SEEDED>(ta, tb, M, N, k_tiles, splits, grid, ep, ws, counters, stream);
}

}  // namespace sm90

// layout 1 = NT (A = dy [M, K], B = w stored [N, K]), 2 = TN (A = x stored
// [K, M], B = dy [K, N]), 3 = NN (A = a [M, K], B = w [K, N]); leading
// dimensions in elements, multiples of 8, both operands 16-byte aligned
// (the wrapper checks). bn (128 or 64) and splits (1 .. the K-tiles of 64;
// 1 unless TN) are the plan of ops/kernels.py::gemm_plan; splits > 1 needs
// `workspace` (splits x the tiles x 128 x bn f32) and `counters` (an int per
// output tile, 0 before the launch and left 0). The epilogue arguments of
// one layout are null / 0 for the others: NT's gate (row stride ldg) and
// residual (ldr); NN's bias, relu, the uint8 keep-mask [M, N] (row stride
// ldm, even, 2-byte aligned) or, keep_on != 0, its Philox source (key
// (seed, site), keep_rows rows per sample, keep iff word < thresh); both
// scale kept values by inv_keep. NN writes one output. The outputs are
// dense [M, N] (row stride N). Returns cudaGetLastError(), the error of the
// shared-memory attribute, or cudaErrorInvalidValue for an argument the
// kernel does not take or a tensor map that cuTensorMapEncodeTiled refuses.
MCAN_API int mcan_gemm_sm90(int layout, const void* A, long long lda, const void* B, long long ldb,
                            int M, int N, int K, int bn, int splits, int grid, const void* gate,
                            long long ldg, float inv_keep, const void* res, long long ldr,
                            const void* bias, int relu, const void* mask, long long ldm,
                            int keep_on, unsigned seed, unsigned site, unsigned thresh,
                            int keep_rows, void* out_f32, void* out_bf16, void* workspace,
                            void* counters, void* stream) {
  using namespace sm90;
  const int k_tiles = (K + BK - 1) / BK;
  const bool nn = layout == NN;
  if ((layout != NT && layout != TN && !nn) || (bn != 128 && bn != 64) || M < 0 || N < 0 ||
      K < 0 || splits < 1 || splits > (k_tiles > 0 ? k_tiles : 1) ||
      (nn && keep_on && (mask != nullptr || keep_rows < 1)) ||
      (!nn && (bias != nullptr || relu || mask != nullptr || keep_on)) ||
      (nn && (gate != nullptr || res != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // an empty output (whose tensors may have no storage): nothing to launch
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (grid < 1 || (splits > 1 && (layout != TN || workspace == nullptr || counters == nullptr)) ||
      (out_f32 == nullptr && out_bf16 == nullptr) ||
      (nn && out_f32 != nullptr && out_bf16 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;   // untouched when K = 0: no tile is loaded
  if (K > 0) {
    // A: MN-major (TN) in two 64 x 64 boxes a stage, else K-major in one
    // of 128 rows; B: MN-major (TN, NN) in bn / 64 boxes, else K-major
    const bool ok = (layout == TN ? make_map(&ta, A, 2, M, K, lda, 64, 64)
                                  : make_map(&ta, A, 2, K, M, lda, 64, BM)) &&
                    (layout == NT ? make_map(&tb, B, 2, K, N, ldb, 64, bn)
                                  : make_map(&tb, B, 2, N, K, ldb, 64, 64));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    memset(&ta, 0, sizeof ta);
    memset(&tb, 0, sizeof tb);
  }
  const Epilogue ep{static_cast<const bf16*>(gate),  ldg, inv_keep, static_cast<const float*>(res), ldr,
                    static_cast<float*>(out_f32),   static_cast<bf16*>(out_bf16), N,
                    static_cast<const float*>(bias), relu, static_cast<const unsigned char*>(mask), ldm,
                    Philox{keep_on, seed, site, thresh, keep_rows}};
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == NT) return launch<NT, false>(ta, tb, M, N, k_tiles, splits, bn, grid, ep, ws, cnt, s);
  if (layout == TN) return launch<TN, false>(ta, tb, M, N, k_tiles, splits, bn, grid, ep, ws, cnt, s);
  return keep_on ? launch<NN, true>(ta, tb, M, N, k_tiles, splits, bn, grid, ep, ws, cnt, s)
                 : launch<NN, false>(ta, tb, M, N, k_tiles, splits, bn, grid, ep, ws, cnt, s);
}

// The int8 product (layout S8): A = the int8 codes [M, K] (row stride lda
// bytes), B = the int8 weight stored K-major, rows of K bytes for each of
// its N columns (row stride ldb bytes: the [K, N] weight with strides (1,
// ldb)); K, lda and ldb multiples of 16, both 16-byte aligned (the wrapper
// checks). Then f32(acc) * (sx[m] * sw[n]) with sx f32 [M], or, sx null,
// f32(acc) * (a * sw[n]); + bias[n] (f32 [N] or null); ReLU where relu;
// written dense [M, N] to out_f32 and / or out_bf16 (at least one). bn
// and grid are ops/kernels.py::gemm_plan's (never split). Returns
// cudaGetLastError(), the error of the shared-memory attribute, or
// cudaErrorInvalidValue for an argument the kernel does not take or a
// tensor map that cuTensorMapEncodeTiled refuses.
MCAN_API int mcan_gemm_sm90_s8(const void* A, long long lda, const void* B, long long ldb, int M,
                               int N, int K, int bn, int grid, const void* sx, float a,
                               const void* sw, const void* bias, int relu, void* out_f32,
                               void* out_bf16, void* stream) {
  using namespace sm90;
  if ((bn != 128 && bn != 64) || M < 0 || N < 0 || K < 0 || K % 16 != 0 || sw == nullptr ||
      (out_f32 == nullptr && out_bf16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;   // untouched when K = 0: no tile is loaded
  if (K > 0) {
    if (!make_map(&ta, A, 1, K, M, lda, 2 * BK, BM) || !make_map(&tb, B, 1, K, N, ldb, 2 * BK, bn))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    memset(&ta, 0, sizeof ta);
    memset(&tb, 0, sizeof tb);
  }
  const S8Epilogue ep{static_cast<const float*>(sx),   a, static_cast<const float*>(sw),
                      static_cast<const float*>(bias), relu, static_cast<float*>(out_f32),
                      static_cast<bf16*>(out_bf16),    N};
  return launch<S8, false>(ta, tb, M, N, (K + 2 * BK - 1) / (2 * BK), 1, bn, grid, ep, nullptr, nullptr,
                           static_cast<cudaStream_t>(stream));
}

// the dynamic shared memory of the bf16 instances (layout 1-3) or the int8
// ones (4) of tile width bn (128 or 64)
MCAN_API int mcan_gemm_sm90_smem(int layout, int bn) {
  using namespace sm90;
  if (bn != 128 && bn != 64) return -1;
  if (layout == S8) return bn == 128 ? smem_bytes<S8, 128>() : smem_bytes<S8, 64>();
  return bn == 128 ? smem_bytes<NN, 128>() : smem_bytes<NN, 64>();
}