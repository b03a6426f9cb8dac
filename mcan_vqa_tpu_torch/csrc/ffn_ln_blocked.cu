// ffn_ln_blocked: out[M, D] = StdLayerNorm(x + relu(x . W1 + b1) . W2 + b2),
// f32 out, with the hidden h [M, F] never written to device memory.
//
// Replaces: mcan_vqa_tpu/ops/fused_ffn.py::_ffn_ln_blocked_kernel (:121,
//   called by fused_ffn_ln_blocked at :174). The TPU kernel walks a grid
//   (M / TM, F / TF), rows outer: per F tile it forms h = relu(x . W1[:, f]
//   + b1[f]) for its row tile, adds h . W2[f, :] into an f32 accumulator in
//   VMEM, and on the last F tile adds the residual and b2 and takes the LN.
//   Here a 64-row block is one thread-block cluster of C CTAs that walks
//   the F tiles in a loop (the TPU's sequential F axis); rank c owns the
//   output columns [c BN, (c + 1) BN), whose f32 accumulator stays in its
//   warpgroup's registers across the whole walk.
//
// Numerics: ffn_ln.cuh's (those of the TPU kernel). The second product is
//   summed over the F tiles in F order; at small M the F tiles are split
//   into ranges, one cluster each, whose partial sums are added in range
//   order (below): the order is the plan's, so two runs give equal bits.
//
// Shapes taken: D a multiple of 128 up to 2048, F a multiple of 8 (the
//   wrapper keeps the parent's F steps, 64 / 128 / 256 by width; TMA's zero
//   fill covers an F tile past F), any M (rows past M are zero-filled on
//   load and never stored).
//
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at MCAN-large B=64 (M
//   3840, D 1024, F 4096) the two products are 64.4 GFLOP, 0.065 ms; the
//   bytes the function must move (x, out, the 16.8 MB of weights) 0.005 ms:
//   bound by operations. What the M-outer order pays on top, from L2: each
//   row block reads all of W1 and W2 once (one CTA of its cluster each
//   byte: 16.8 MB x 60 row blocks), and each CTA its row block of x once
//   per F tile (F / 64 x x's bytes in all: 1 GB of f32 x at MCAN-large);
//   the ring's depth, which the h pieces bound, sets how fast a CTA takes
//   them in (a probe on the card: a shallower ring, slower by much).
//   At B=1 (M 60) one row block: latency-bound, hence the split of F.
//
// Design (ffn_ln.cuh's three steps per F tile, on sm90_mainloop.cuh's TMA
// ring and wgmma). A CTA is one consumer warpgroup (64 rows) and a producer
// warp whose lane 0 keeps TMA loads in flight into a ring of slots (as
// many as the shared memory beside the h pieces holds, up to 8).
// The cluster's F tile is TF = 64 C hidden units; rank c forms the 64 of
// them at c 64 .. (its K-tiles: x's 64 x 64 box, or two f32 boxes, and
// W1's 64 x 64 box, MN-major), so its piece is one 64 x 64 bf16 box, the
// K-tile c of the second product's A operand; the second product streams
// W2's rows of the F tile, BN / 64 boxes a K-tile (MN-major), through the
// same ring. So each weight byte is read once per row block, by one CTA
// of its cluster, not once per 32-row tile by every block (the parent).
// The epilogue is cluster_ln.cuh's (gemm_ln.cu's), x as the residual.
//
// Small M: where the row blocks' clusters leave most of the card idle, the
// plan splits the F tiles into `splits` ranges, one cluster each (grid =
// C x row blocks x splits). Each CTA writes its partial sum of the range
// to a workspace (coalesced, [row block][rank][split][float4][thread]); the
// cluster's rank 0 counts its row block's arrivals (the only atomic, one
// counter per row block, reset by the last for the next launch) and tells
// its cluster through distributed shared memory; the last cluster to
// arrive reads every range's partial back in range order (its own too, as
// written) and runs the epilogue. So the bits do not depend on which
// cluster ran last. h still never leaves shared memory.
//
// The plan -- BN, C, TF, the splits, the grid, the ring's depth and the
// shared memory -- is ops/kernels.py::ffn_ln_plan's, made in Python from the
// shape alone; the C entry checks it and derives none of it.
#include <cstdint>

#include "ffn_ln.cuh"

namespace {

using namespace sm90;
using ffn::Args;
using ffn::CONSUMERS;
using ffn::THREADS;

// An instance: f32 or bf16 x, BN output columns a CTA. A slot holds the
// larger of a first-product K-tile (x, W1's box) and a second-product one
// (W2's BN / 64 boxes); the plan sets the ring's depth.
template <int X_F32, int BN>
struct Cfg {
  static constexpr int X_BYTES = (X_F32 ? 2 : 1) * BOX;
  static constexpr int P1_BYTES = X_BYTES + BOX;
  static constexpr int P2_BYTES = BN / 64 * BOX;
  static constexpr int SLOT = P1_BYTES > P2_BYTES ? P1_BYTES : P2_BYTES;
  static constexpr int ACC = BN / 2;
  // 1 KB of slack to align the ring; the ring; the cluster's h pieces (C
  // boxes); the ring's barriers, hfull / hfree / sfull; the rows' (sum, M2,
  // mean) in 16 bytes each; b2, gamma and beta of the CTA's columns; the
  // last-cluster flag
  static constexpr int smem(int C, int stages) {
    return 1024 + stages * SLOT + C * BOX + 16 * stages + 32 + ffn::ROWS * 16 + 3 * BN * 4 + 16;
  }
};

template <int X_F32, int BN>
__global__ void __launch_bounds__(THREADS, 1)
ffn_ln_blocked_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
                      const __grid_constant__ CUtensorMap tw2, Args a, int splits, int f_tiles,
                      int stages) {
  using C = Cfg<X_F32, BN>;
  constexpr int SLOT = C::SLOT, ACC = C::ACC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + SWIZZLE_ATOM - 1) & ~(SWIZZLE_ATOM - 1);
  const int rank = static_cast<int>(cluster_rank()), ranks = static_cast<int>(cluster_size());
  const uint32_t hbuf = base + stages * SLOT;              // [ranks] boxes
  const uint32_t bars = hbuf + ranks * BOX;                // full[s], empty[s]
  const uint32_t hfull = bars + 16 * stages, hfree = hfull + 8, sfull = hfree + 8;
  float* stats = reinterpret_cast<float*>(smem_raw + (bars - raw) + 16 * stages + 32);
  float* vecs = stats + 4 * ffn::ROWS;
  float* flag = vecs + 3 * BN;

  const int tid = threadIdx.x;
  const int cid = static_cast<int>(cluster_index());
  const int split = cid % splits, rb = cid / splits;
  const int m0 = rb * ffn::ROWS, n0 = rank * BN;
  const int TF = 64 * ranks;
  const int ft0 = static_cast<int>(static_cast<long long>(split) * f_tiles / splits);
  const int ft1 = static_cast<int>(static_cast<long long>(split + 1) * f_tiles / splits);
  const int k_tiles = a.D / BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), 4);   // the consumer warps
    }
    mbar_init(hfull, 1);
    mbar_init(hfree, ranks);
    mbar_init(sfull, ranks);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every CTA's barriers exist before a peer arrives on them

  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.0f;

  if (tid >= CONSUMERS) {
    // ---- the producer warp: lane 0 keeps the ring full
    if (tid == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tw1)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tw2)) : "memory");
      ffn::Ring ring{base, bars, stages, 0, 0};
      for (int ft = ft0; ft < ft1; ++ft) {
        const int f0 = ft * TF;
        ffn::produce<SLOT>(ring, k_tiles, C::P1_BYTES, [&](uint32_t slot, uint32_t full, int i) {
          ffn::load_x<X_F32>(slot, &tx, full, i * BK, m0);
          tma_load(slot + C::X_BYTES, &tw1, full, f0 + 64 * rank, i * BK);   // W1 [D, F]
        });
        ffn::produce<SLOT>(ring, ranks, C::P2_BYTES, [&](uint32_t slot, uint32_t full, int k) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) tma_load(slot + j * BOX, &tw2, full, n0 + 64 * j, f0 + 64 * k);
        });
      }
    }
    __syncwarp();   // lanes 1 .. 31 wait here, not at the cluster barriers below
  } else {
    // ---- the consumer warpgroup
    const int warp = tid >> 5, lane = tid & 31;
    ffn::stage_vecs<BN>(vecs, a, n0, tid);
    const ffn::XOp<X_F32> xop{warp, lane};
    const uint32_t piece = hbuf + rank * BOX;
    ffn::Ring ring{base, bars, stages, 0, 0};
    for (int ft = ft0; ft < ft1; ++ft) {
      const int lt = ft - ft0;
      // phase 1: this rank's 64 hidden units of the F tile
      float hacc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) hacc[j] = 0.0f;
      ffn::ring_mma<SLOT, X_F32 != 0>(
          hacc, ring, k_tiles, lane, xop,
          [](uint32_t slot, int, int kk) { return desc(slot + C::X_BYTES + kk * 16 * 128, BOX, SWIZZLE_ATOM); });
      // exchange: the piece, once every peer is done with the last F tile's h
      if (lt > 0) mbar_wait_cluster(hfree, (lt - 1) & 1);
      ffn::write_piece<64>(hacc, a.b1, ft * TF + 64 * rank, a.F, piece, warp, lane);
      ffn::send_piece(piece, BOX, hfull, rank, ranks, tid);
      mbar_wait_cluster(hfull, lt & 1);
      // phase 2: acc += h [64, TF] . W2[F tile, the CTA's columns]; K-tile k
      // of h is rank k's piece
      ffn::ring_mma<SLOT, false>(
          acc, ring, ranks, lane,
          [hbuf](uint32_t, int k, int kk) { return desc(hbuf + k * BOX + kk * 32, BOX, SWIZZLE_ATOM); },
          [](uint32_t slot, int, int kk) { return desc(slot + kk * 16 * 128, BOX, SWIZZLE_ATOM); });
      ffn::arrive_all<false>(hfree, ranks, tid);
    }
  }

  bool last = true;
  if (splits > 1) {
    // this range's partial into the workspace, then the row block's count
    constexpr int Q = ACC / 4;
    float4* slots = reinterpret_cast<float4*>(a.ws) +
                    static_cast<size_t>(rb * ranks + rank) * splits * Q * CONSUMERS;
    if (tid < CONSUMERS) {
      float4* mine = slots + static_cast<size_t>(split) * Q * CONSUMERS;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        __stcg(mine + q * CONSUMERS + tid, make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
      __threadfence();
    }
    cluster_sync();   // every rank's partial is written
    if (rank == 0 && tid == 0) {
      const bool l = atomicAdd(&a.counters[rb], 1) == splits - 1;
      if (l) a.counters[rb] = 0;   // ready for the next launch
      *flag = l ? 1.0f : 0.0f;
    }
    cluster_sync();
    last = peer_f32(flag, 0) != 0.0f;
    cluster_sync();   // rank 0's flag is read
    if (last && tid < CONSUMERS) {
      __threadfence();
      for (int s = 0; s < splits; ++s) {
        const float4* p = slots + static_cast<size_t>(s) * Q * CONSUMERS + tid;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 v = __ldcg(p + q * CONSUMERS);
          acc[4 * q] = s == 0 ? v.x : acc[4 * q] + v.x;
          acc[4 * q + 1] = s == 0 ? v.y : acc[4 * q + 1] + v.y;
          acc[4 * q + 2] = s == 0 ? v.z : acc[4 * q + 2] + v.z;
          acc[4 * q + 3] = s == 0 ? v.w : acc[4 * q + 3] + v.w;
        }
      }
    }
  }
  if (!last) return;   // the whole cluster: another cluster sums this row block
  if (tid < CONSUMERS) {
    consumer_sync<CONSUMERS>();   // the columns' vectors are in shared memory
    ffn::residual_ln<BN, false>(acc, a, vecs - n0, vecs + BN - n0, vecs + 2 * BN - n0, stats, sfull, 0, 0,
                                m0, n0, ranks, tid);
  }
  cluster_sync();   // no peer reads this CTA's statistics or arrives on it any more
}

// The instances: (f32 x, columns) -> f(Cfg, kernel), or `none`
template <int X_F32, typename F, typename R>
R with_instance(int bn, F&& f, R none) {
  if (bn == 64) return f(Cfg<X_F32, 64>{}, ffn_ln_blocked_kernel<X_F32, 64>);
  if (bn == 128) return f(Cfg<X_F32, 128>{}, ffn_ln_blocked_kernel<X_F32, 128>);
  if (bn == 256) return f(Cfg<X_F32, 256>{}, ffn_ln_blocked_kernel<X_F32, 256>);
  return none;
}

template <typename F, typename R>
R with_instance(int x_f32, int bn, F&& f, R none) {
  return x_f32 ? with_instance<1>(bn, f, none) : with_instance<0>(bn, f, none);
}

}  // namespace

// x: [M, D] f32 (x_f32 == 1) or bf16, contiguous, 16-byte aligned; W1 [D, F]
// and W2 [F, D] bf16, contiguous, 16-byte aligned; b1 [F], b2, gamma, beta
// [D] f32; out [M, D] f32. ws: splits x the row blocks' 64 x C BN f32
// partials (null unsplit); counters: one int32 per row block, zeroed (null
// unsplit). plan (ops/kernels.py::FfnLnPlan.fields, `n` ints): bn, cluster,
// f_width (the F tile, 64 x cluster), f_steps (its tiles over F), splits,
// row_blocks, grid, stages, smem. Returns cudaGetLastError() or the
// launch's error, or cudaErrorInvalidValue for a shape or a plan the
// kernel does not take, or a tensor map that cuTensorMapEncodeTiled refuses.
MCAN_API int mcan_ffn_ln_blocked(const void* x, int x_f32, const void* W1, const void* b1,
                                 const void* W2, const void* b2, const void* gamma,
                                 const void* beta, void* out, void* ws, void* counters, int M, int D,
                                 int F, float eps, const int* plan, int n, void* stream) {
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (plan == nullptr || n != 9 || !ffn::shape_ok(M, D, F)) return inval;
  const int bn = plan[0], cluster = plan[1], tf = plan[2], f_tiles = plan[3], splits = plan[4],
            row_blocks = plan[5], grid = plan[6], stages = plan[7], smem = plan[8];
  const int inst_smem =
      with_instance(x_f32, bn, [&](auto c, auto) { return decltype(c)::smem(cluster, stages); }, -1);
  if (inst_smem < 0 || bn != ffn::bn_of(D) || cluster != (D + bn - 1) / bn || cluster > ffn::MAX_CLUSTER ||
      tf != 64 * cluster || f_tiles != (F + tf - 1) / tf || splits < 1 || splits > f_tiles ||
      row_blocks != (M + ffn::ROWS - 1) / ffn::ROWS || grid != cluster * row_blocks * splits ||
      stages < ffn::MIN_STAGES || stages > ffn::MAX_STAGES || smem != inst_smem || smem > ffn::SMEM_MAX ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return inval;
  CUtensorMap tx, tw1, tw2;
  if (!ffn::map_x(&tx, x, x_f32, M, D) || !make_map(&tw1, W1, 2, F, D, F, 64, 64) ||
      !make_map(&tw2, W2, 2, D, F, D, 64, 64))
    return inval;
  const Args args{x,
                  x_f32,
                  static_cast<const float*>(b1),
                  static_cast<const float*>(b2),
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(beta),
                  static_cast<float*>(out),
                  static_cast<float*>(ws),
                  static_cast<int*>(counters),
                  M,
                  D,
                  F,
                  eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(x_f32, bn, [&](auto, auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = launch_cluster(kernel, grid, THREADS, smem, cluster, s, tx, tw1, tw2, args, splits, f_tiles,
                         stages);
    if (e != cudaSuccess) cudaGetLastError();   // clear it: the caller raises on the returned code
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }, inval);
}
