// ffn_ln_wstationary: out[M, D] = StdLayerNorm(x + relu(x . W1 + b1) . W2 +
// b2), f32 out, with every weight byte fetched from device memory once.
//
// Replaces: mcan_vqa_tpu/ops/fused_ffn.py::_ffn_ln_wstationary_kernel
//   (:201, called by fused_ffn_ln_weight_stationary at :263). The TPU kernel
//   walks a grid (F / TF, M / TM), F outer: each weight tile W1[:, f],
//   W2[f, :] is fetched once and reused across every row tile, the partial
//   products h . W2[f, :] are summed into the output block in F order, and
//   the residual + LN run on the last F step.
//
// Design. F is cut into ranges of C x TS hidden units; a range belongs to
// one thread-block cluster of C CTAs, rank c holding W1[:, its TS units]
// (D x TS, MN-major, the swizzle of 2 TS-byte rows) and W2[the range's rows,
// its BN output columns] (MN-major, 128-byte swizzle) in shared memory,
// loaded by TMA once per call and kept while the cluster walks every 64-row
// tile of x (a cluster walks ranges c, c + clusters, ... when the plan caps
// the clusters). Per row tile, ffn_ln.cuh's three steps: rank c forms its h
// slice relu(x . W1[:, slice] + b1) (x's K-tiles through a TMA ring), the
// slices cross the cluster as bf16 pieces (bulk copies of distributed
// shared memory), and rank c adds h [64, C TS] . W2[range, its columns]
// into its columns (one wgmma chain over the range, in F order).
//   The other way round -- each rank W2's rows of its slice, its full-width
//   part h_c . W2[slice c, :] and a reduce-scatter of the C f32 parts in
//   rank order through distributed shared memory -- was not taken: the
//   parts are 64 x D f32
//   (256 KB at D 1024): they fit no CTA beside its weights, and they would
//   cross the cluster as (C - 1) / C x 256 KB a tile, where the bf16 pieces
//   are (C - 1) x 64 x TS x 2 bytes (28 KB at MCAN-large). Holding W2 by
//   columns instead of by rows takes the same shared memory and leaves one
//   exchange of h, as in ffn_ln_blocked.cu.
// The chain between clusters: range g's sum of a row tile's columns is
// added to range g - 1's, in F order, through the output (f32, at L2):
// rank c of range g waits until rank c of range g - 1 has written its
// running sum of the tile (a flag per row tile and rank, an acquire /
// release pair at gpu scope), adds its own, writes it back and raises the
// flag to g + 1. Only the C clusters' columns travel, F / (C TS) steps (16
// at MCAN-large), not one per TS slice (128 in the parent). The last range
// adds the residual and b2 and runs cluster_ln.cuh's LayerNorm over its
// ranks. A range waits only on a lower range, every cluster of the grid is
// resident at once (the C entry checks the grid against
// cudaOccupancyMaxActiveClusters and refuses a larger one), and a cluster
// walks its ranges in increasing order: the lowest unfinished range always
// moves, so the chain never waits on a cluster that cannot be scheduled. A
// chain that stops moving anyway is a fault: after SPIN_LIMIT_NS the launch
// traps (an error the wrapper raises) rather than holding the card.
//
// Numerics: ffn_ln.cuh's (those of the TPU kernel). The second product is
//   summed over each range in F order, the ranges' sums added in range
//   order (range 0's sum, then + range 1's, ...): the order is the plan's
//   (C and TS from the shape alone), not the grid's, so two runs and any
//   cap on the clusters give equal bits.
//
// Shapes taken: D a multiple of 128 up to 2048, F a multiple of 8 (the
//   wrapper keeps the parent's F steps, 32 / 16 by width; TMA's zero fill
//   covers a range past F), any M.
//
// Bounds on an H100: the same function as ffn_ln_blocked.cu, so the same
//   bound (MCAN-large B=64: 64.4 GFLOP, 0.065 ms at the bf16 peak). What
//   this design pays on top: every CTA reads every row tile of x once per
//   range it holds (F / TS x x's bytes in all, from L2: 503 MB of f32 x at
//   MCAN-large) through a ring that the weights leave 4 slots of f32 (a
//   probe on the card: each slot fewer, slower by much), and the chain's
//   running sums go through L2 once per range (2 x 4 M D bytes a range);
//   the pipeline drains in F / (C TS) + M / 64 steps, each a row tile's
//   whole serial path (x's K-tiles, the exchange, the second product, the
//   chain), and the card holds 15 clusters of 8 at this shared memory, so
//   MCAN-large's 16 ranges take two rounds (a cluster walks a second range
//   once its first is done).
#include <cstdint>

#include "ffn_ln.cuh"

namespace {

using namespace sm90;
using ffn::Args;
using ffn::CONSUMERS;
using ffn::THREADS;

// An instance: f32 or bf16 x, BN output columns and TS hidden units a CTA.
// The ring holds x's K-tiles only, as many as the shared memory beside the
// weights holds (up to 8: the plan's).
template <int X_F32, int BN, int TS>
struct Cfg {
  static constexpr int ROW = 2 * TS;                 // bytes of a W1 / h row: the swizzle span
  static constexpr int PIECE = ffn::ROWS * ROW;      // a rank's h piece
  static constexpr int SLOT = (X_F32 ? 2 : 1) * BOX;
  static constexpr int ACC = BN / 2;
  __host__ __device__ static constexpr int w2_tiles(int C) { return (C * TS + BK - 1) / BK; }
  // 1 KB of slack; W1's slice; W2's rows of the range (K-tiles of 64 x
  // BN / 64 boxes); the cluster's h pieces; the ring; its barriers, then
  // hfull / hfree / sfull / sfree / wfull / wfree (64 bytes); the rows'
  // statistics. Every byte goes to the ring: b2, gamma and beta are read
  // from device memory (L1), and one buffer of statistics is reused behind
  // sfree, which at MCAN-large leaves room for a fourth f32 slot.
  static constexpr int smem(int D, int C, int stages) {
    return 1024 + D * ROW + w2_tiles(C) * (BN / 64) * BOX + C * PIECE + stages * SLOT + 16 * stages + 64 +
           ffn::ROWS * 16;
  }
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until flag >= want; a chain that stops moving traps
constexpr unsigned long long SPIN_LIMIT_NS = 20ull * 1000 * 1000 * 1000;
__device__ __forceinline__ void wait_for(const int* flag, int want) {
  const unsigned long long t0 = global_ns();
  while (load_acquire(flag) < want) {
    __nanosleep(32);
    if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
  }
}

template <int X_F32, int BN, int TS>
__global__ void __launch_bounds__(THREADS, 1)
ffn_ln_wstationary_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
                          const __grid_constant__ CUtensorMap tw2, Args a, int n_ranges, int tiles,
                          int stages) {
  using C = Cfg<X_F32, BN, TS>;
  constexpr int SLOT = C::SLOT, ACC = C::ACC, ROW = C::ROW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const int rank = static_cast<int>(cluster_rank()), ranks = static_cast<int>(cluster_size());
  const int D = a.D, range = ranks * TS, w2_tiles = C::w2_tiles(ranks);
  const uint32_t w1s = (raw + SWIZZLE_ATOM - 1) & ~(SWIZZLE_ATOM - 1);   // [D][ROW]
  const uint32_t w2s = w1s + D * ROW;                                    // [w2_tiles][BN / 64] boxes
  const uint32_t hbuf = w2s + w2_tiles * (BN / 64) * BOX;                // [ranks] pieces
  const uint32_t rbase = hbuf + ranks * C::PIECE;                        // x's ring
  const uint32_t bars = rbase + stages * SLOT;                            // full[s], empty[s]
  const uint32_t hfull = bars + 16 * stages, hfree = hfull + 8, sfull = hfree + 8, sfree = sfull + 8,
                 wfull = sfree + 8, wfree = wfull + 8;
  float* stats = reinterpret_cast<float*>(smem_raw + (bars - raw) + 16 * stages + 64);   // [64][4]

  const int tid = threadIdx.x;
  const int cid = static_cast<int>(cluster_index()), clusters = static_cast<int>(gridDim.x) / ranks;
  const int n0 = rank * BN, k_tiles = D / BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), 4);   // the consumer warps
    }
    mbar_init(hfull, 1);
    mbar_init(hfree, ranks);
    mbar_init(sfull, ranks);
    mbar_init(sfree, ranks);
    mbar_init(wfull, 1);
    mbar_init(wfree, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every CTA's barriers exist before a peer arrives on them

  if (tid >= CONSUMERS) {
    // ---- the producer warp: lane 0 loads each range's weights once, then
    // keeps x's K-tiles coming for every row tile
    if (tid == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tw1)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tw2)) : "memory");
      ffn::Ring ring{rbase, bars, stages, 0, 0};
      int lg = 0;
      for (int g = cid; g < n_ranges; g += clusters, ++lg) {
        const int f0 = g * range;
        if (lg > 0) mbar_wait(wfree, (lg - 1) & 1);   // the last range's products are done
        mbar_expect_tx(wfull, static_cast<uint32_t>(D * ROW + w2_tiles * (BN / 64) * BOX));
        for (int kt = 0; kt < k_tiles; ++kt)   // W1 [D, F]: TS columns x 64 rows a box
          tma_load(w1s + kt * BK * ROW, &tw1, wfull, f0 + rank * TS, kt * BK);
        for (int kt = 0; kt < w2_tiles; ++kt)   // W2 [F, D]
          for (int j = 0; j < BN / 64; ++j)
            tma_load(w2s + (kt * (BN / 64) + j) * BOX, &tw2, wfull, n0 + 64 * j, f0 + kt * BK);
        for (int i = 0; i < tiles; ++i)
          ffn::produce<SLOT>(ring, k_tiles, SLOT, [&](uint32_t slot, uint32_t full, int k) {
            ffn::load_x<X_F32>(slot, &tx, full, k * BK, i * ffn::ROWS);
          });
      }
    }
    __syncwarp();
  } else {
    // ---- the consumer warpgroup
    const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
    const int rl = 16 * warp + (lane >> 2), c0 = n0 + 2 * t;
    const ffn::XOp<X_F32> xop{warp, lane};
    const uint32_t piece = hbuf + rank * C::PIECE;
    const int steps = range / 16;   // the second product's wgmma steps
    ffn::Ring ring{rbase, bars, stages, 0, 0};
    int lt = 0, nln = 0;
    int lg = 0;
    for (int g = cid; g < n_ranges; g += clusters, ++lg) {
      const int fc = g * range + rank * TS;
      const bool last = g == n_ranges - 1;
      mbar_wait(wfull, lg & 1);
      for (int i = 0; i < tiles; ++i, ++lt) {
        const int m0 = i * ffn::ROWS;
        // phase 1: h slice [64, TS] = x's row tile . W1's slice
        float hacc[TS / 2];
#pragma unroll
        for (int j = 0; j < TS / 2; ++j) hacc[j] = 0.0f;
        ffn::ring_mma<SLOT, X_F32 != 0>(
            hacc, ring, k_tiles, lane, xop, [w1s](uint32_t, int k, int kk) {
              return desc_sw(w1s + (k * (BK / 16) + kk) * 16 * ROW, 16, 8 * ROW, ROW);
            });
        // exchange
        if (lt > 0) mbar_wait_cluster(hfree, (lt - 1) & 1);
        ffn::write_piece<TS>(hacc, a.b1, fc, a.F, piece, warp, lane);
        ffn::send_piece(piece, C::PIECE, hfull, rank, ranks, tid);
        mbar_wait_cluster(hfull, lt & 1);
        // phase 2: acc = h [64, range] . W2[range, the CTA's columns], the
        // pieces' TS / 16 steps each in rank order
        float acc[ACC];
#pragma unroll
        for (int j = 0; j < ACC; ++j) acc[j] = 0.0f;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll 1
        for (int s = 0; s < steps; ++s) {
          const uint64_t da = desc_sw(hbuf + (s / (TS / 16)) * C::PIECE + (s % (TS / 16)) * 32, 16, 8 * ROW, ROW);
          const uint64_t db = desc(w2s + (s >> 2) * (BN / 64) * BOX + (s & 3) * 16 * 128, BOX, SWIZZLE_ATOM);
          wgmma<0, 1>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        ffn::arrive_all<false>(hfree, ranks, tid);
        // the chain: + range g - 1's running sum of these columns
        const int r0 = m0 + rl;
        int* flag = a.counters + i * ranks + rank;
        if (g > 0) {
          if (tid == 0) wait_for(flag, g);
          consumer_sync<CONSUMERS>();
#pragma unroll
          for (int j = 0; j < ACC; j += 2) {
            const int row = r0 + 8 * ((j >> 1) & 1), col = c0 + 8 * (j >> 2);
            if (row < a.M && col < D) {
              const float2 p = __ldcg(reinterpret_cast<const float2*>(a.out + static_cast<size_t>(row) * D + col));
              acc[j] = p.x + acc[j];
              acc[j + 1] = p.y + acc[j + 1];
            }
          }
        }
        if (last) {
          ffn::residual_ln<BN, true>(acc, a, a.b2, a.gamma, a.beta, stats, sfull, sfree, nln, m0, n0, ranks,
                                     tid);
          ++nln;
        } else {
#pragma unroll
          for (int j = 0; j < ACC; j += 2) {
            const int row = r0 + 8 * ((j >> 1) & 1), col = c0 + 8 * (j >> 2);
            if (row < a.M && col < D)
              __stcg(reinterpret_cast<float2*>(a.out + static_cast<size_t>(row) * D + col),
                     make_float2(acc[j], acc[j + 1]));
          }
          __threadfence();
          consumer_sync<CONSUMERS>();
          if (tid == 0) store_release(flag, g + 1);
        }
      }
      consumer_sync<CONSUMERS>();   // every consumer is done with the range's weights
      if (tid == 0) mbar_arrive(wfree);
    }
  }
  cluster_sync();   // no peer reads this CTA's shared memory or arrives on it any more
}

// The instances: (f32 x, columns, hidden units a CTA) -> f(Cfg, kernel), or
// `none`
template <int X_F32, typename F, typename R>
R with_instance(int bn, int ts, F&& f, R none) {
  if (bn == 64 && ts == 32) return f(Cfg<X_F32, 64, 32>{}, ffn_ln_wstationary_kernel<X_F32, 64, 32>);
  if (bn == 128 && ts == 32) return f(Cfg<X_F32, 128, 32>{}, ffn_ln_wstationary_kernel<X_F32, 128, 32>);
  if (bn == 256 && ts == 16) return f(Cfg<X_F32, 256, 16>{}, ffn_ln_wstationary_kernel<X_F32, 256, 16>);
  return none;
}

template <typename F, typename R>
R with_instance(int x_f32, int bn, int ts, F&& f, R none) {
  return x_f32 ? with_instance<1>(bn, ts, f, none) : with_instance<0>(bn, ts, f, none);
}

}  // namespace

// x: [M, D] f32 (x_f32 == 1) or bf16, contiguous, 16-byte aligned; W1 [D,
// F] and W2 [F, D] bf16, contiguous, 16-byte aligned; b1 [F], b2, gamma,
// beta [D] f32; out [M, D] f32 (written and read as the running sum);
// flags: one int32 per row tile and rank, zeroed. plan
// (ops/kernels.py::FfnLnPlan.fields, `n` ints): bn, cluster, f_width (the
// range, cluster x ts), f_steps (its ranges over F), ts, row_blocks (the
// row tiles), clusters, grid, stages, smem. info (host, may be null) <-
// grid, clusters, the clusters the card holds at once, shared memory
// bytes. Returns the CUDA error: cudaErrorInvalidValue for a shape or plan
// the kernel does not take, cudaErrorCooperativeLaunchTooLarge where the
// card cannot hold the plan's clusters at once.
MCAN_API int mcan_ffn_ln_wstationary(const void* x, int x_f32, const void* W1, const void* b1,
                                     const void* W2, const void* b2, const void* gamma,
                                     const void* beta, void* out, void* flags, int M, int D, int F,
                                     float eps, const int* plan, int n, int* info, void* stream) {
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (plan == nullptr || n != 10 || !ffn::shape_ok(M, D, F) || flags == nullptr) return inval;
  const int bn = plan[0], cluster = plan[1], range = plan[2], n_ranges = plan[3], ts = plan[4],
            tiles = plan[5], clusters = plan[6], grid = plan[7], stages = plan[8], smem = plan[9];
  const int inst_smem =
      with_instance(x_f32, bn, ts, [&](auto c, auto) { return decltype(c)::smem(D, cluster, stages); }, -1);
  if (inst_smem < 0 || bn != ffn::bn_of(D) || cluster != (D + bn - 1) / bn || cluster > ffn::MAX_CLUSTER ||
      range != cluster * ts || n_ranges != (F + range - 1) / range || tiles != (M + ffn::ROWS - 1) / ffn::ROWS ||
      clusters < 1 || clusters > n_ranges || grid != clusters * cluster || stages < ffn::MIN_STAGES ||
      stages > ffn::MAX_STAGES || smem != inst_smem || smem > ffn::SMEM_MAX)
    return inval;
  const CUtensorMapSwizzle sw1 = ts == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tx, tw1, tw2;
  if (!ffn::map_x(&tx, x, x_f32, M, D) || !make_map(&tw1, W1, 2, F, D, F, ts, BK, sw1) ||
      !make_map(&tw2, W2, 2, D, F, D, 64, BK))
    return inval;
  const Args args{x,
                  x_f32,
                  static_cast<const float*>(b1),
                  static_cast<const float*>(b2),
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(beta),
                  static_cast<float*>(out),
                  nullptr,
                  static_cast<int*>(flags),
                  M,
                  D,
                  F,
                  eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(x_f32, bn, ts, [&](auto, auto kernel) {
    const int fit = max_active_clusters(kernel, THREADS, smem, cluster);
    if (fit < 0) {
      const cudaError_t q = cudaGetLastError();   // clear it: the caller raises on the returned code
      return static_cast<int>(q != cudaSuccess ? q : cudaErrorInvalidValue);
    }
    if (info != nullptr) {
      info[0] = grid;
      info[1] = clusters;
      info[2] = fit;
      info[3] = smem;
    }
    if (clusters > fit) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const cudaError_t e = launch_cluster(kernel, grid, THREADS, smem, cluster, s, tx, tw1, tw2, args,
                                         n_ranges, tiles, stages);
    if (e != cudaSuccess) cudaGetLastError();   // clear it: the caller raises on the returned code
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }, inval);
}

// How many clusters of `cluster` CTAs of the instance (f32 x, bn, ts) at
// `smem` bytes the card holds at once (0: none; -1: no instance, or the
// query failed): the most clusters a plan may launch
MCAN_API int mcan_ffn_ln_wstationary_max_clusters(int x_f32, int bn, int ts, int cluster, int smem) {
  if (cluster < 1 || cluster > ffn::MAX_CLUSTER) return -1;
  return with_instance(x_f32, bn, ts, [&](auto, auto kernel) {
    return max_active_clusters(kernel, THREADS, smem, cluster);
  }, -1);
}
