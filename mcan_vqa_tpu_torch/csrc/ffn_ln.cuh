// What ffn_ln_blocked.cu and ffn_ln_wstationary.cu share. Both compute
// out[M, D] = StdLayerNorm(x + relu(x . W1 + b1) . W2 + b2), f32 out, in
// two products per step of the hidden (F) axis:
//   phase 1: rank c of a thread-block cluster forms its slice of h =
//     relu(x . W1[:, slice] + b1) for a 64-row tile (wgmma, x's K-tiles
//     through a TMA ring), rounds it to bf16 and writes it into its own
//     shared memory as one K-major piece of the second product's A operand;
//   exchange: the piece goes to every peer by a bulk copy of distributed
//     shared memory (cp.async.bulk shared::cta -> shared::cluster), which
//     completes on the peer's `hfull` mbarrier; the peers' pieces land the
//     same way, so every CTA holds the cluster's whole bf16 h [64, C x PW];
//   phase 2: acc[64, the rank's BN columns] += h . W2[slice rows, columns],
//     W2 read MN-major through wgmma's transpose bit.
// Then the residual, b2 and cluster_ln.cuh's LayerNorm over the cluster.
//
// Ordering inside a cluster is by mbarriers, never a cluster barrier in
// the loop: the producer warp keeps issuing TMA loads while the consumers
// exchange, and a cluster barrier would wait for it. `hfull` (count 1,
// expect-tx the peers' bytes) says the cluster's pieces are in; each
// rank's consumers, once their second product is done with h, arrive on
// every rank's `hfree` (count C), which a rank waits on before it writes
// its next piece (a bulk copy into a peer's h only follows the peer's
// arrival). The LayerNorm's row statistics go the same way: each rank
// arrives on every rank's `sfull` (count C), with release at cluster scope,
// once its statistics are written, then reads the peers' with
// ld.shared::cluster (and, where a CTA reuses its statistics' buffer, on
// every rank's `sfree` once it has read them). Each CTA's arrivals go out
// in parallel, lane r of warp 0 to rank r; `hfree`'s are plain (CTA-scope)
// remote arrivals, as CUTLASS's cluster pipelines free a slot that only the
// async proxy touches. A multicast of x's K-tiles over the cluster, which
// gemm_ln.cu tried for its A, ran slower here too (PERF.md §6):
// each CTA loads its own.
//
// Numerics, as the TPU kernels (mcan_vqa_tpu/ops/fused_ffn.py:121, :201):
// x read as f32 (from an f32 or a bf16 x) and rounded to bf16 for the first
// product (TMA stages an f32 x as f32, and the A fragments are rounded in
// registers: the bits of bf16(x)); W1, W2 bf16; each product summed in f32;
// h = relu(. + b1) rounded to bf16 (h.astype(bfloat16), fused_ffn.py:141);
// r = (x + acc) + b2 in f32; the reference LayerNorm (Bessel std, eps on
// the std, divided). No float atomics; every sum runs in an order fixed by
// the plan: two runs give the same bits.
#pragma once

#include "cluster_ln.cuh"
#include "sm90_mainloop.cuh"

namespace ffn {

using namespace sm90;

constexpr int ROWS = 64;                        // a row tile: one consumer warpgroup
constexpr int CONSUMERS = 128, THREADS = CONSUMERS + 32;
constexpr int MAX_CLUSTER = cln::MAX_CLUSTER;
constexpr int MAX_D = 2048;
constexpr int MIN_STAGES = 2, MAX_STAGES = 8;   // a ring's depth
constexpr int SMEM_MAX = 232448;                // a block's dynamic shared memory at most

struct Args {
  const void* x;    // [M, D] f32 (x_f32) or bf16
  int x_f32;
  const float *b1, *b2, *gamma, *beta;
  float* out;       // [M, D] f32
  float* ws;        // ffn_ln_blocked: the split partials; else null
  int* counters;    // ffn_ln_blocked: a counter per row block; ffn_ln_wstationary: the chain's flags
  int M, D, F;
  float eps;
};

// A ring of `stages` slots of SLOT bytes at `base` (the plan fills the
// shared memory left beside the kernel's other buffers with them), its
// full[s] / empty[s] mbarriers at `bars` (8 bytes each), and one side's
// position in it (the producer's or the consumers')
struct Ring {
  uint32_t base, bars;
  int stages, stage, phase;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The producer's side (sm90_mainloop.cuh's produce, at a run-time depth):
// for each of nk K-tiles, wait for the slot to be free, arm its full
// barrier with the bytes to come, load(slot, full barrier, i)
template <int SLOT, typename Load>
__device__ __forceinline__ void produce(Ring& r, int nk, uint32_t bytes, Load&& load) {
  for (int i = 0; i < nk; ++i) {
    mbar_wait(r.empty(r.stage), r.phase ^ 1);
    const uint32_t full = r.full(r.stage);
    mbar_expect_tx(full, bytes);
    load(r.base + r.stage * SLOT, full, i);
    r.advance();
  }
}

// The K-tiles of one product for one warpgroup, each through the ring:
// acc += A . B over nk K-tiles of 64. A is bf16 K-major at a_op(slot, i, kk)
// (a descriptor), or, A_REG, the fragments a_op(slot, i, f) builds in
// registers (an f32 x); B is b_op(slot, i, kk), MN-major. As
// sm90_mainloop.cuh's consume / consume_rs: one wgmma group in flight while
// the next slot is awaited, the previous slot released once its group is
// done (lane 0 of each consumer warp arrives on its empty barrier, count
// 4), two fragment sets alternating under A_REG.
template <int SLOT, bool A_REG, int ACC, typename AOp, typename BOp>
__device__ __forceinline__ void ring_mma(float (&acc)[ACC], Ring& r, int nk, int lane, AOp&& a_op,
                                         BOp&& b_op) {
  uint32_t frags[2][BK / 16][4];
  int prev = 0;
  auto step = [&](uint32_t(&cur)[BK / 16][4], uint32_t(&other)[BK / 16][4], int i) {
    mbar_wait(r.full(r.stage), r.phase);
    const uint32_t slot = r.base + r.stage * SLOT;
    if constexpr (A_REG) a_op(slot, i, cur);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (A_REG)
        wgmma_rs<1>(acc, cur[kk], b_op(slot, i, kk));
      else
        wgmma<0, 1>(acc, a_op(slot, i, kk), b_op(slot, i, kk));
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous K-tile's group is done with its slot
    fence_acc(acc);
    if constexpr (A_REG) fence_regs(other);
    if (i > 0 && lane == 0) mbar_arrive(r.empty(prev));
    prev = r.stage;
    r.advance();
  };
  for (int i = 0; i < nk; i += 2) {   // the sets alternate: indices known at compile time
    step(frags[0], frags[1], i);
    if (i + 1 < nk) step(frags[1], frags[0], i + 1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if constexpr (A_REG) {
    fence_regs(frags[0]);
    fence_regs(frags[1]);
  }
  if (nk > 0 && lane == 0) mbar_arrive(r.empty(prev));
}

// The x K-tile of rows m0 .. m0 + 63 at column k0 into a ring slot: one
// 64 x 64 bf16 box, or two 64 x 32 f32 boxes BOX apart
template <int X_F32>
__device__ __forceinline__ void load_x(uint32_t slot, const CUtensorMap* tx, uint32_t full, int k0,
                                       int m0) {
#pragma unroll
  for (int b = 0; b < (X_F32 ? 2 : 1); ++b) tma_load(slot + b * BOX, tx, full, k0 + 32 * b, m0);
}

// The A operand of x's K-tile in a slot: a descriptor of the bf16 box, or
// the f32 boxes' fragments rounded to bf16 (gemm_ln.cu's f32 a)
template <int X_F32>
struct XOp {
  int warp, lane;
  __device__ __forceinline__ uint64_t operator()(uint32_t slot, int, int kk) const {
    return desc(slot + kk * 32, BOX, SWIZZLE_ATOM);
  }
  __device__ __forceinline__ void operator()(uint32_t slot, int, uint32_t (&f)[BK / 16][4]) const {
    f32_frags(slot, BOX, warp, lane, f);
  }
};

// h = relu(hacc + b1) of the thread's accumulators (a 64 x PW product: row
// 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4), + 1), rounded to
// bf16 into the K-major piece at `piece` whose rows are 2 PW bytes under
// that swizzle; b1 read from hidden unit fc on, 0 past F
template <int PW>
__device__ __forceinline__ void write_piece(const float (&hacc)[PW / 2], const float* __restrict__ b1,
                                            int fc, int F, uint32_t piece, int warp, int lane) {
  constexpr int ROW = 2 * PW;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j4 = 0; j4 < PW / 8; ++j4) {
    const int col = fc + 8 * j4 + 2 * t;   // F % 8 == 0: col < F, col + 1 < F together
    const float bb0 = col < F ? __ldg(b1 + col) : 0.0f, bb1 = col < F ? __ldg(b1 + col + 1) : 0.0f;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = 16 * warp + g + 8 * hi, j = 4 * j4 + 2 * hi;
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(fmaxf(hacc[j] + bb0, 0.0f), fmaxf(hacc[j + 1] + bb1, 0.0f));
      const uint32_t off = swizzled(row * ROW + 16 * j4 + 4 * t, ROW);
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(piece + off),
                   "r"(*reinterpret_cast<const uint32_t*>(&p))
                   : "memory");
    }
  }
}

// This rank's piece (`bytes` at `piece`, written by every consumer thread)
// to the C - 1 peers, and this CTA's hfull armed for theirs; every consumer
// thread takes part, thread 0 issues
__device__ __forceinline__ void send_piece(uint32_t piece, uint32_t bytes, uint32_t hfull, int rank,
                                           int ranks, int tid) {
  fence_proxy_async();   // the piece's generic stores, before the bulk copies read it
  consumer_sync<CONSUMERS>();
  if (tid == 0) {
    mbar_expect_tx(hfull, static_cast<uint32_t>(ranks - 1) * bytes);
    for (int r = 0; r < ranks; ++r)
      if (r != rank) copy_to_peer(piece, bytes, hfull, static_cast<unsigned>(r));
  }
}

// One arrival of this CTA on the mbarrier `bar` of every rank, once every
// consumer thread is past what it orders, lane r of warp 0 on rank r's.
// DATA: the consumers' generic shared-memory writes before it (the row
// statistics, which peers read with ld.shared::cluster) are released at
// cluster scope; else (h consumed: only the async proxy touches it) the
// arrival is the plain one.
template <bool DATA>
__device__ __forceinline__ void arrive_all(uint32_t bar, int ranks, int tid) {
  consumer_sync<CONSUMERS>();
  if (tid < ranks) {
    if (DATA)
      mbar_arrive_peer(bar, static_cast<unsigned>(tid));
    else
      mbar_arrive_remote(bar, static_cast<unsigned>(tid));
  }
}

// The columns' b2, gamma and beta (BN each, 0 past D) into shared memory
template <int BN>
__device__ __forceinline__ void stage_vecs(float* vecs, const Args& a, int n0, int tid) {
  for (int i = tid; i < 3 * BN; i += CONSUMERS) {
    const int col = n0 + i % BN, which = i / BN;
    const float* v = which == 0 ? a.b2 : which == 1 ? a.gamma : a.beta;
    vecs[i] = col < a.D ? __ldg(v + col) : 0.0f;
  }
}

// The epilogue of one 64-row tile from acc (this rank's BN columns of x .
// W1 ... . W2 summed over all of F): r = (x + acc) + b2, the LayerNorm over
// the cluster's C ranks, out written f32. vb / vg / vbe: b2, gamma and beta
// by column, in shared memory (0 past D) or, GLOBAL, the vectors in device
// memory (read only below D). The row statistics in `stats` go to every
// rank's `sfull`, the n-th LayerNorm of the kernel waiting on phase n % 2;
// where a CTA runs more than one (sfree != 0), it first waits until every
// rank has read its last ones (`sfree`, count C) and, once it has read the
// peers', arrives on every rank's.
template <int BN, bool GLOBAL>
__device__ __forceinline__ void residual_ln(float (&acc)[BN / 2], const Args& a, const float* vb,
                                            const float* vg, const float* vbe, float* stats,
                                            uint32_t sfull, uint32_t sfree, int n, int m0, int n0,
                                            int ranks, int tid) {
  constexpr int ACC = BN / 2;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int rl = 16 * warp + (lane >> 2), r0 = m0 + rl, c0 = n0 + 2 * t;
  const int D = a.D;
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int g4 = 0; g4 < ACC / 4; g4 += 4) {   // pairs g4 .. g4 + 3
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float v[8];
      cln::load_res(v, a.x, !a.x_f32, D, r0 + 8 * hi, a.M, c0, g4, lane, D);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c0 + 8 * (g4 + q), j = 4 * (g4 + q) + 2 * hi;
        const bool in = col < D;
        acc[j] = in ? (v[2 * q] + acc[j]) + vb[col] : 0.0f;
        acc[j + 1] = in ? (v[2 * q + 1] + acc[j + 1]) + vb[col + 1] : 0.0f;
        s[hi] += acc[j];
        s[hi] += acc[j + 1];
      }
    }
  }
  const float inv_nc = 1.0f / (min(D, n0 + BN) - n0), inv_d = 1.0f / D, inv_d1 = 1.0f / (D - 1);
  if (sfree != 0 && n > 0) mbar_wait_cluster(sfree, (n - 1) & 1);
  cln::row_stats(acc, s, inv_nc, c0, D, t, stats, rl);
  arrive_all<true>(sfull, ranks, tid);
  mbar_wait_cluster(sfull, n & 1);
  float mean[2], denom[2], inv[2];
  cln::combine(stats, rl, ranks, D, BN, inv_d, inv_d1, a.eps, mean, denom, inv);
  if (sfree != 0) arrive_all<true>(sfree, ranks, tid);
  cln::normalise_store<ACC, GLOBAL>(acc, mean, denom, inv, vg, vbe, a.out, 0, D, r0, c0, a.M, D, lane);
}

// the tensor map of x: K-tiles of 64 bf16, or of 2 x 32 f32 (128-byte
// swizzled rows), 64 rows a box
inline bool map_x(CUtensorMap* tx, const void* x, int x_f32, int M, int D) {
  return x_f32 ? make_map_flat(tx, x, 4, D, M, D, 32, ROWS, CU_TENSOR_MAP_SWIZZLE_128B)
               : make_map(tx, x, 2, D, M, D, 64, ROWS);
}

// the operands' shared checks: D a multiple of 128 up to 2048, F a
// multiple of 8 (TMA's 16-byte rows), M > 0
inline bool shape_ok(int M, int D, int F) {
  return M > 0 && D >= 128 && D <= MAX_D && D % 128 == 0 && F > 0 && F % 8 == 0;
}

// the instance of one output width a rank owns: 64 up to D 512, 128 up
// to 1024, 256 up to 2048 (ops/kernels.py::ffn_ln_plan's rule)
inline int bn_of(int D) { return D <= 512 ? 64 : D <= 1024 ? 128 : 256; }

}  // namespace ffn
