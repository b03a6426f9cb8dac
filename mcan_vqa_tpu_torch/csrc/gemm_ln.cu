// gemm_ln: out[M, D] = StdLayerNorm(res + a . W + b) with the reference
// LayerNorm, gamma * (r - mean) / (std + 1e-6) + beta, std Bessel-corrected
// (divided by D - 1), eps added to the std. The pre-LN sum r never leaves
// the registers.
//
// Replaces: the Pallas kernels of the per-sub-op serving path
//   mcan_vqa_tpu/ops/fused_ffn.py::_proj_ln_kernel (fused_proj_ln, call
//   :100): the attention merge projection + residual + LN, with a the f32
//   attention output [M, D] and W the merge weight [D, D]; and the second
//   half of ::_ffn_ln_kernel (fused_ffn_ln, call :340): the ReLU hidden h
//   [M, F] bf16 (from gemm_bias_act) . W2 [F, D] + b2 + the residual x,
//   then the LN. The TPU kernels keep a row tile's product and its LN in
//   VMEM; here a row block's D columns are spread over the CTAs of one
//   thread-block cluster, which exchange the LN's row statistics through
//   distributed shared memory.
//
// Numerics, as in those kernels: a rounded to bf16 (an f32 a as
//   _proj_ln_kernel's a.astype(bfloat16), fused_ffn.py:69, round to nearest
//   even), W bf16, the products summed in f32, then r = f32(res) + (y + b),
//   the row's mean and Bessel variance in f32, divided by (std + eps) as
//   model.apply does; the output rounded once to the residual's dtype (a
//   bf16 or an f32 stream).
//
// Bounds on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at MCAN-small B=64 the
//   decoder's merge (M 3840, K = D = 512, f32 a) moves 16.2 MB (4.8 us) for
//   2.0 GFLOP (2.0 us); its FFN (K 2048, bf16 h) 25.5 MB (7.6 us) for 8.1
//   GFLOP (8.1 us): both near the ridge, the merge bound by bytes. At B = 1
//   (M 14 or 60) the weight's bytes (0.5 / 2 MB) bound it, and in practice
//   the latency of the K-tiles a CTA walks in order.
//
// Design. The product runs on sm90_mainloop.cuh's TMA ring and wgmma, as
// gemm_sm90.cu's NN instance does: a CTA is one or two consumer warpgroups
// (64 rows of the output each, BN columns: wgmma m64nBNk16, BN 64, 128 or
// 256) and a producer warp whose lane 0 keeps TMA loads of K-tiles of 64 in
// flight into a ring of STAGES slots (128-byte swizzle, zero-filled past M,
// K and D); W [K, D] is read MN-major through wgmma's transpose bit, never
// transposed in memory.
//   * bf16 a (the FFN): both operands from shared-memory descriptors.
//   * f32 a (the merges): TMA cannot convert, so the slot holds the f32 box
//     (two boxes of 32 values a K-tile, 128-byte rows, swizzled) and each
//     thread builds its bf16 A fragments in registers (ld.shared of float2,
//     one cvt.rn.bf16x2.f32 a pair: the bits of bf16(a)) for wgmma's
//     register-A form (consume_rs, as gemm_int4.cu's W4 builds its
//     dequantized weight). The other way, a converting stage that writes a
//     swizzled bf16 slot back, costs a store, a proxy fence and a barrier
//     of the warpgroup a K-tile, and doubles the slot's shared-memory
//     traffic; the registers cost one f32 read a value and nothing else.
// A row block's D columns belong to the C = ceil(D / BN) CTAs of one
// cluster, rank c owning columns [c BN, (c + 1) BN), so every row's LN sees
// all D columns while each tile stays in its warpgroup's registers (64 x
// 2048 f32 is 512 KB: no CTA holds it). While the first K-tiles load, the
// consumers stage bias, gamma and beta of the CTA's columns in shared memory
// and fetch a bf16 residual (up to BN 128) into registers, else its rows
// into L2. The epilogue, from the accumulator registers (a thread holds rows
// g, g + 8 of its warp's 16, column pairs 8 j + 2 t; steps 2-4 are
// cluster_ln.cuh's, which the streaming FFN kernels share):
//   1. r = res + (acc + bias), 0 past D, in place of the accumulators (a
//      bf16 residual arrives as 16-byte pieces, which a quad transpose turns
//      into each lane's pairs);
//   2. each row's sum over the CTA's columns (the thread's values, then the
//      quad's four lanes by two xor shuffles: every lane the same bits), its
//      mean over those columns, and the sum of squares about that mean
//      (M2), into this CTA's shared memory;
//   3. one cluster barrier; every CTA reads the C (sum, M2, mean) of its
//      rows through distributed shared memory (one 16-byte load a rank, all
//      in flight at once) and combines them in rank order 0 .. C-1 by Chan
//      et al.'s pairwise update, M2 = sum_c M2_c + n_c (mean_c - mean)^2,
//      the two-pass variance without a second exchange: every CTA, and
//      every run, gets the same bits;
//   4. each CTA normalises its own columns from the registers, gamma (r -
//      mean) / (std + eps) + beta, the quotient from the correctly rounded
//      reciprocal of std + eps and one Markstein correction by the exact
//      residual (div_by: branch-free, so the quotients interleave; the
//      compiler's division checks each one for its slow path, a branch that
//      serialised them), and stores them: bf16 as 16-byte pieces after a
//      quad transpose, f32 as pairs;
//   5. its last remote read comes before a cluster arrive, and it waits on
//      that barrier before it exits, so no CTA leaves while a peer reads
//      its shared memory.
// The producer warp takes part in the cluster barriers (it does not exit
// early, as gemm_sm90.cu's does), converged first (__syncwarp): lanes that
// waited at the cluster barrier while lane 0 still issued loads slowed its
// issue. The plan -- the tile, C, the grid, the stages and the shared
// memory -- is ops/kernels.py::gemm_ln_plan's, made in Python from the
// shape alone; the C entry checks it against the instance and derives
// none of it. C is at most 8, the portable cluster size: D up to 512 takes
// BN 64 or 128, up to 1024 BN 128, up to 2048 BN 256 (m64n256k16, 128
// accumulators a thread). 128 x 128 tiles (two warpgroups) halve the
// weight's reloads from L2 where they still fill the card (the decoder's
// 3840 rows); few row blocks take 64 x 64 (the most CTAs, a deep ring).
// Each CTA loads its own A box, though the C CTAs of a cluster read the
// same one. A multicast of it (8-row swizzle atoms dealt round the ranks,
// each slot freed by an arrival from every CTA's consumers) was built and
// timed on the card: every MCAN site ran slower with it (small atoms; the
// slowest CTA of a cluster gates every slot), so it was taken out.
// Not yet: split-K at small M (at B = 1 a row block is one cluster of C
// CTAs walking all of K in order), a persistent schedule, a TMA store of
// the output, clusters past 8 CTAs (more CTAs at D 1536 / 2048).
#include <cstdint>
#include <cstring>

#include "cluster_ln.cuh"
#include "residual_layernorm.cuh"
#include "sm90_mainloop.cuh"

namespace gemm_ln {

using namespace sm90;
using cln::MAX_CLUSTER;

// An instance: f32 or bf16 a, WGS consumer warpgroups of 64 rows each (BM =
// 64 WGS rows a CTA), BN columns. 64 x 128 lets two CTAs share an SM (the
// ring in at most 96 KB, at most 204 registers a thread); the others run
// one CTA an SM, 64 x 64 with a deep ring (the plan takes it where the CTAs
// are few: B = 1, the encoder): at B = 1 the K-tiles of a merge all load
// at once, and an FFN's in three rounds.
template <int A_F32, int WGS, int BN>
struct Cfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS, THREADS = CONSUMERS + 32;
  static constexpr int A_BOXES = A_F32 ? 2 : 1;   // a K-tile's 128-byte boxes (f32: 32 values a row)
  static constexpr int A_BYTES = WGS * A_BOXES * BOX;
  static constexpr int B_BYTES = BN / 64 * BOX;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = WGS == 2 ? (A_F32 ? 4 : 6)
                                : BN == 256 ? 4 : BN == 128 ? (A_F32 ? 3 : 4) : (A_F32 ? 8 : 12);
  static constexpr int ACC = BN / 2;
  static constexpr int BLOCKS_PER_SM = WGS == 1 && BN == 128 ? 2 : 1;
  // the ring, 1 KB of slack to align it, the barriers, the rows' (sum, M2,
  // mean) in 16 bytes each, then bias, gamma and beta of the CTA's columns
  static constexpr int SMEM = SWIZZLE_ATOM + STAGES * STAGE_BYTES + 16 * STAGES + 4 * BM * 4 + 3 * BN * 4;
};

template <int A_F32, int WGS, int BN>
__global__ void __launch_bounds__(Cfg<A_F32, WGS, BN>::THREADS, Cfg<A_F32, WGS, BN>::BLOCKS_PER_SM)
gemm_ln_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
               const float* __restrict__ bias, const void* __restrict__ res, int res_bf16,
               long long ldr, const float* __restrict__ gamma, const float* __restrict__ beta,
               void* __restrict__ out, long long ldo, int M, int D, int k_tiles, float eps) {
  using C = Cfg<A_F32, WGS, BN>;
  constexpr int STAGES = C::STAGES, ACC = C::ACC, BM = C::BM, CONSUMERS = C::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + SWIZZLE_ATOM - 1) & ~(SWIZZLE_ATOM - 1);
  const uint32_t bars = base + STAGES * C::STAGE_BYTES;   // full[s], then empty[s]
  float* stats = reinterpret_cast<float*>(smem_raw + (bars - raw) + 16 * STAGES);   // [BM] x (sum, M2, mean, -)
  float* vecs = stats + 4 * BM;   // bias, gamma, beta [BN] each

  const int tid = threadIdx.x;
  const unsigned rank = cluster_rank(), ranks = cluster_size();
  const int m0 = static_cast<int>(cluster_index()) * BM;
  const int n0 = static_cast<int>(rank) * BN;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the producer warp: lane 0 keeps the ring full; the warp stays for
    // the epilogue's cluster barrier
    if (tid == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&ta)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      produce<STAGES, C::STAGE_BYTES>(base, bars, stage, phase, k_tiles, C::STAGE_BYTES,
                                      [&](uint32_t a, uint32_t full, int i) {
        const int k0 = i * BK;
        // A: box x of K-tile i (k0 + 32 x for f32) holds the BM rows, 128
        // bytes each, at a + x WGS BOX
#pragma unroll
        for (int x = 0; x < C::A_BOXES; ++x) tma_load(a + x * WGS * BOX, &ta, full, k0 + 32 * x, m0);
        // W [K, D]: BN / 64 boxes of 64 columns x 64 k-rows (MN-major)
        const uint32_t b = a + C::A_BYTES;
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) tma_load(b + j * BOX, &tw, full, n0 + 64 * j, k0);
      });
    }
    __syncwarp();       // lanes 1 .. 31 wait here, not at the cluster barrier
    cluster_sync();     // the rows' statistics are written
    cluster_arrive();   // (nothing of the peers' to read)
    cluster_wait();
    return;
  }

  // ---- the consumer warpgroups: warpgroup wg takes rows m0 + 64 wg .. + 63,
  // columns n0 .. n0 + BN - 1
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const int rl = 64 * wg + 16 * warp + (lane >> 2);   // the thread's rows rl, rl + 8 of the tile
  const int r0 = m0 + rl;
  const int c0 = n0 + 2 * t;
  // 1 / the CTA's columns, 1 / D, 1 / (D - 1): the statistics' scales
  const float inv_nc = 1.0f / (min(D, n0 + BN) - n0), inv_d = 1.0f / D, inv_d1 = 1.0f / (D - 1);
  // bias, gamma and beta of the CTA's columns into shared memory while the
  // first K-tiles load
  for (int i = tid; i < 3 * BN; i += CONSUMERS) {
    const int col = n0 + i % BN, which = i / BN;
    const float* v = which == 0 ? bias : which == 1 ? gamma : beta;
    vecs[i] = col < D && v != nullptr ? __ldg(v + col) : 0.0f;
  }
  // the residual: bf16 up to 128 columns, the thread's 16-byte pieces (row
  // r0 + 8 hi, columns n0 + 8 (g4 + t) ..) fetched into registers now, so
  // that their latency passes behind the mainloop; else its rows into L2
  constexpr int RQ = BN <= 128 ? ACC / 8 : 1;
  const bool held = BN <= 128 && res_bf16;
  uint4 rq[RQ];
  if (held) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = r0 + 8 * (i & 1), col = n0 + 8 * (4 * (i >> 1) + t);
      rq[i] = row < M && col < D ? *reinterpret_cast<const uint4*>(static_cast<const bf16*>(res) +
                                                                   static_cast<size_t>(row) * ldr + col)
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int esize = res_bf16 ? 2 : 4;
    const int bytes = (min(D, n0 + BN) - n0) * esize;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = r0 + 8 * hi;
      if (row >= M) continue;
      const char* p = static_cast<const char*>(res) + (static_cast<size_t>(row) * ldr + n0) * esize;
      for (int off = 128 * t; off < bytes; off += 512)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
    }
  }

  float acc[1][ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[0][j] = 0.0f;
  {
    int stage = 0;
    uint32_t phase = 0;
    if constexpr (A_F32) {
      auto load_a = [&](uint32_t slot, int, int, uint32_t(&f)[BK / 16][4]) {
        f32_frags(slot + wg * BOX, WGS * BOX, warp, lane, f);
      };
      consume_rs<STAGES, C::STAGE_BYTES, ACC, 1>(acc[0], base, bars, stage, phase, k_tiles,
                                                 C::A_BYTES, load_a);
    } else {
      consume<0, 1, STAGES, C::STAGE_BYTES>(acc, base, bars, stage, phase, k_tiles, wg * BOX,
                                            C::A_BYTES, [] {});
    }
  }
  consumer_sync<CONSUMERS>();   // the columns' vectors are in shared memory

  // ---- the LayerNorm epilogue. Accumulator j holds row rl + 8 ((j / 2) %
  // 2), column c0 + 8 (j / 4) + j % 2: pair p = j / 4 of row half hi = (j /
  // 2) % 2.
  const float* vb = vecs - n0;   // by column
  const float* vg = vecs + BN - n0;
  const float* vbe = vecs + 2 * BN - n0;
  // 1. r = res + (acc + bias), 0 past D, and the rows' sums over the CTA's
  // columns
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int g4 = 0; g4 < ACC / 4; g4 += 4) {   // pairs g4 .. g4 + 3
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float v[8];
      if (held)
        cln::unpack_res(v, rq[BN <= 128 ? 2 * (g4 >> 2) + hi : 0], lane);
      else
        cln::load_res(v, res, res_bf16, ldr, r0 + 8 * hi, M, c0, g4, lane, D);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c0 + 8 * (g4 + q), j = 4 * (g4 + q) + 2 * hi;
        const bool in = col < D;   // D % 8 == 0: col + 1 < D too
        acc[0][j] = in ? v[2 * q] + (acc[0][j] + vb[col]) : 0.0f;
        acc[0][j + 1] = in ? v[2 * q + 1] + (acc[0][j + 1] + vb[col + 1]) : 0.0f;
        s[hi] += acc[0][j];
        s[hi] += acc[0][j + 1];
      }
    }
  }
  // 2. the CTA's mean of each row and the sum of squares about it (M2)
  cln::row_stats(acc[0], s, inv_nc, c0, D, t, stats, rl);
  cluster_sync();
  // 3. the row's mean and M2 from the C ranks' (sum, M2, mean) in rank order
  float mean[2], denom[2], inv[2];
  cln::combine(stats, rl, static_cast<int>(ranks), D, BN, inv_d, inv_d1, eps, mean, denom, inv);
  cluster_arrive();   // this CTA's last read of a peer's shared memory is done

  // 4. normalise the CTA's columns and store them
  cln::normalise_store(acc[0], mean, denom, inv, vg, vbe, out, res_bf16, ldo, r0, c0, M, D, lane);
  cluster_wait();   // no peer reads this CTA's shared memory any more
}

// one launch of an instance (C its Cfg) in clusters of `cluster` CTAs
template <typename C, typename Kernel>
int launch(Kernel kernel, const CUtensorMap& ta, const CUtensorMap& tw, const float* bias,
           const void* res, int res_bf16, long long ldr, const float* gamma, const float* beta,
           void* out, long long ldo, int M, int D, int k_tiles, float eps, int cluster, int grid,
           cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_cluster(kernel, grid, C::THREADS, C::SMEM, cluster, s, ta, tw, bias, res, res_bf16, ldr,
                     gamma, beta, out, ldo, M, D, k_tiles, eps);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The instances: (f32 a, rows, columns) -> f(Cfg, kernel) for one of them, or
// `none` for a tile without an instance
template <int A_F32, typename F, typename R>
R with_instance(int bm, int bn, F&& f, R none) {
  if (bm == 64 && bn == 64) return f(Cfg<A_F32, 1, 64>{}, gemm_ln_kernel<A_F32, 1, 64>);
  if (bm == 64 && bn == 128) return f(Cfg<A_F32, 1, 128>{}, gemm_ln_kernel<A_F32, 1, 128>);
  if (bm == 64 && bn == 256) return f(Cfg<A_F32, 1, 256>{}, gemm_ln_kernel<A_F32, 1, 256>);
  if (bm == 128 && bn == 128) return f(Cfg<A_F32, 2, 128>{}, gemm_ln_kernel<A_F32, 2, 128>);
  return none;
}

template <typename F, typename R>
R with_instance(int a_f32, int bm, int bn, F&& f, R none) {
  return a_f32 ? with_instance<1>(bm, bn, f, none) : with_instance<0>(bm, bn, f, none);
}

}  // namespace gemm_ln

// A: [M, K] bf16 (a_f32 == 0) or f32, row stride lda (a multiple of 8),
// 16-byte aligned; W: bf16 [K, D], row stride ldw (a multiple of 8), 16-byte
// aligned; bias [D] f32 or null; res: [M, D] f32 (res_bf16 == 0; row stride
// even, 8-byte aligned) or bf16 (row stride a multiple of 8, 16-byte
// aligned); gamma, beta [D] f32; out: [M, D] in res's dtype, row stride ldo
// (a multiple of 8), 16-byte aligned. K and D multiples of 8, D between 8
// and 2048. The plan (ops/kernels.py::gemm_ln_plan): bm (64 or 128) rows and
// bn (64, 128 or 256) columns a CTA, clusters of `cluster` = ceil(D / bn)
// CTAs (at most 8), grid = cluster x ceil(M / bm), k_tiles = ceil(K / 64),
// the instance's stages and dynamic shared memory. Returns cudaGetLastError() or the launch's error,
// or cudaErrorInvalidValue for a plan or an argument the kernel does not
// take or a tensor map that cuTensorMapEncodeTiled refuses.
MCAN_API int mcan_gemm_ln(const void* A, int a_f32, long long lda, const void* W, long long ldw,
                          const void* bias, const void* res, int res_bf16, long long ldr,
                          const void* gamma, const void* beta, void* out, long long ldo, int M,
                          int D, int K, float eps, int bm, int bn, int cluster, int grid,
                          int k_tiles, int stages, int smem, void* stream) {
  using namespace gemm_ln;
  const int inst_stages =
      with_instance(a_f32, bm, bn, [](auto c, auto) { return decltype(c)::STAGES; }, -1);
  const int inst_smem = with_instance(a_f32, bm, bn, [](auto c, auto) { return decltype(c)::SMEM; }, -1);
  if (D < 8 || D > ln::MAX_D || D % 8 != 0 || K < 8 || K % 8 != 0 || M < 0 || inst_stages < 0 ||
      cluster < 1 || cluster > MAX_CLUSTER || cluster * bn < D || (cluster - 1) * bn >= D ||
      k_tiles != (K + BK - 1) / BK || stages != inst_stages || smem != inst_smem || ldo % 8 != 0 ||
      (res_bf16 ? ldr % 8 != 0 : ldr % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  if (grid != cluster * ((M + bm - 1) / bm)) return static_cast<int>(cudaErrorInvalidValue);
  // A: one bm-row box a K-tile (f32: two of 32 values); W: 64 columns x 64
  // k-rows a box
  CUtensorMap ta, tw;
  const bool ok = (a_f32 ? make_map_flat(&ta, A, 4, K, M, lda, 32, bm, CU_TENSOR_MAP_SWIZZLE_128B)
                         : make_map(&ta, A, 2, K, M, lda, 64, bm)) &&
                  make_map(&tw, W, 2, D, K, ldw, 64, 64);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  return with_instance(a_f32, bm, bn, [&](auto c, auto kernel) {
    return launch<decltype(c)>(kernel, ta, tw, b, res, res_bf16, ldr, g, be, out, ldo, M, D, k_tiles,
                               eps, cluster, grid, s);
  }, static_cast<int>(cudaErrorInvalidValue));
}

// an instance's dynamic shared memory (-1: no instance of that tile), and
// how many of its clusters of `cluster` CTAs the card holds at once (0:
// none; -1: no instance, or the query failed)
MCAN_API int mcan_gemm_ln_smem(int a_f32, int bm, int bn) {
  return gemm_ln::with_instance(a_f32, bm, bn, [](auto c, auto) { return decltype(c)::SMEM; }, -1);
}

MCAN_API int mcan_gemm_ln_max_clusters(int a_f32, int bm, int bn, int cluster) {
  if (cluster < 1 || cluster > gemm_ln::MAX_CLUSTER) return -1;
  return gemm_ln::with_instance(a_f32, bm, bn, [&](auto c, auto kernel) {
    using C = decltype(c);
    return sm90::max_active_clusters(kernel, C::THREADS, C::SMEM, cluster);
  }, -1);
}
