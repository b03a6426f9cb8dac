// The stages of a persistent block kernel: one cooperative launch runs a
// whole stack of layers (csrc/sga_decoder.cu, csrc/sa_encoder.cu), each
// layer a fixed sequence of the stages below with a grid-wide barrier
// between two stages that depend on each other. Each stage is a
// __device__ function that walks its work items (GEMM tiles or splits of
// one, (sample, head, query rows) attention items, LayerNorm rows) in a
// grid-stride loop, so any grid size that fits the card co-resident
// computes the same result, bit for bit: every work item is done by one
// block in a fixed order, and a split GEMM tile is summed in split order
// by whichever block arrives last.
//
// Replaces: the per-layer bodies of the TPU's all-layer kernels,
//   mcan_vqa_tpu/ops/sga_block.py::_sga_decoder_kernel (:483),
//   ::_sga_decoder_kernel_extkv (:646) and ::_sa_encoder_kernel (:848).
//   On the TPU every layer's weights sit in VMEM for the whole launch
//   (50.3 MB for MCAN-small's decoder), so one grid step carries its G
//   samples through every layer. An H100 SM has 228 KB of shared memory:
//   the weights cannot stay on chip, so here every stage streams them from
//   HBM (or the 50 MB L2) tile by tile, and the grid-wide barrier takes the
//   place of the TPU's layer loop inside one grid step. What the single
//   launch keeps is the TPU kernel's launch count: one per stack, where
//   the per-block engine issues ~10 kernels per block.
//
// Numerics, as in those kernels and as the per-block kernels of the port
// (gemm_sm90.cu, masked_attention.cu, residual_layernorm.cu) round:
//   * GEMM: bf16 operands, f32 accumulation, + bias, ReLU, one rounding to
//     the output type;
//   * attention: scores in f32 from bf16 q and k, PAD keys at -1e9 per
//     sample, f32 softmax, the probabilities rounded to bf16 before P.V,
//     P.V in f32, the output rounded to bf16 for the merge;
//   * LayerNorm: r = res + (y + bias) in f32, the Bessel-corrected std, eps
//     added to the std (sga_block.py:145-151), an f32 and a bf16 copy out.
//
// Bounds on an H100: at B = 1 a stage's products have one 64-row tile of
// output and stream a 0.5-2 MB weight, so the stack is bound by how many
// SMs read each weight and by the barriers; at B = 64 the image-stream
// products (M = 3840) are bound by the bf16 tensor-core rate. Design:
//   * a block is two consumer warpgroups and one producer warp, one block
//     per SM (the ring below takes 192 KB);
//   * GEMM: gemm_sm90.cu's mainloop (sm90_mainloop.cuh's produce /
//     consume): the producer's lane 0 loads K-tiles of 64 by TMA into a
//     ring of six 32 KB slots, the activation through a 2-D map, the
//     stacked weight [L, K, N] through a 3-D one at the layer's index, read
//     MN-major by wgmma; tiles of 128 x 128 (each warpgroup a 64-row half,
//     m64n128), 128 x 64 (a half each, m64n64) or 64 x 128 (a 64-column
//     half each, m64n64), and a split of K over several blocks where the
//     tiles alone would leave most SMs idle (B = 1, 8): the split sum of
//     gemm_sm90.cu's dW, in split order by the last block to arrive, then
//     the forward's epilogue from the registers. ops/kernels.py::
//     stack_plan fixes tile, split, workspace and counters from the shape;
//     this file takes them as given;
//   * attention: masked_attention.cu's block items (attention_fwd.cuh, on
//     mma.sync with ldmatrix; the one-block instance where Dh and Lk <= 128,
//     the long one past that) over the ring's shared memory, with the rows
//     kernels.attention_plan gives that kernel and the head padded to one
//     of four instances (AttPlan below), several items a block at once in
//     groups of its warps; the stack's probabilities are that kernel's;
//   * LayerNorm: a warp a row, y, the residual and the bias read once into
//     registers as 16-byte loads at D 256 / 512 / 1024 (residual_
//     layernorm.cuh's centre_regs), a rolled row re-read from L2 at other
//     widths; the f32 and bf16 copies written from the same values;
//   * each stage's body (a GEMM item, an attention instance, the LayerNorm
//     rows) is a function of its own, so ptxas allocates its registers
//     apart from the others' (gemm_item below says why).
// Not done: an L2 prefetch of the next stage's weight before each barrier
// (cp.async.bulk.prefetch.tensor) measured 1-4% slower at B = 1, 8 and 64
// on the card (PERF.md §6), and was taken out.
// Barriers: every layer keeps its grid barriers (11 in the decoder, 7 in
// the encoder); none could go without a stage reading rows that another
// block writes. Before each barrier every thread fences the generic proxy
// against the async one (fence.proxy.async): the next stage's TMA reads
// what this one stored, and its shared memory held attention's staging.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "attention_fwd.cuh"
#include "residual_layernorm.cuh"
#include "sm90_mainloop.cuh"

namespace persistent {

constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int THREADS = CONSUMERS + 32;        // + the producer warp
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 6;
constexpr int A_BYTES = 128 * sm90::BK * 2;    // up to two 64-row boxes of A
constexpr int SLOT = A_BYTES + 128 * sm90::BK * 2;   // + up to two 64-column boxes of W
constexpr int RING = STAGES * SLOT;            // 196,608 bytes
// the ring (aligned to the swizzle atom), its full / empty barriers and the
// split sum's flag
constexpr int SMEM = static_cast<int>(sm90::SWIZZLE_ATOM) + RING + 16 * STAGES + 16;
constexpr int MAX_DH = 256;

// the grid-wide barrier, fenced so that the async proxy (the next stage's
// TMA loads, into shared memory the attention staged through) sees what the
// generic proxy wrote before it
__device__ __forceinline__ void grid_barrier() {
  asm volatile("fence.proxy.async;" ::: "memory");
  cooperative_groups::this_grid().sync();
  asm volatile("fence.proxy.async;" ::: "memory");
}

// ---------------------------------------------------------------------------
// GEMM: out[M, N] = A[M, K] . W[l][K, N] (+ bias[l], ReLU), bf16 operands
// ---------------------------------------------------------------------------

// One product of a stage, as the host sets it up: A through the 2-D tensor
// map maps[a] (rows of K bf16), the stacked weight [L, K, N] through the 3-D
// map maps[w]; the plan's tile bm x bn and K splits, and where a split
// product's partials (ws, floats) and tile counters (cnt) start.
struct GemmJob {
  int a, w;
  int M, N, K;
  int bm, bn, splits, ws, cnt;
  const float* bias;   // [L, N] or null
  int relu;
  float* o32;          // exactly one output, dense [M, N]
  bf16* o16;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int gemm_items(const GemmJob& j) {
  return cdiv(j.M, j.bm) * cdiv(j.N, j.bn) * j.splits;
}

// work item w of a job: split w / tiles of tile w % tiles, K-tiles [kt0,
// kt0 + nk)
struct StackItem {
  int tile, split, m0, n0, kt0, nk;
  __device__ __forceinline__ StackItem(const GemmJob& j, int w) {
    const int tiles_n = cdiv(j.N, j.bn), tiles = cdiv(j.M, j.bm) * tiles_n;
    const int k_tiles = cdiv(j.K, sm90::BK);
    tile = w % tiles;
    split = w / tiles;
    m0 = tile / tiles_n * j.bm;
    n0 = tile % tiles_n * j.bn;
    kt0 = split * k_tiles / j.splits;
    nk = (split + 1) * k_tiles / j.splits - kt0;
  }
};

// the ring's place, carried by each thread from stage to stage (the
// producer and the consumers walk the same items)
struct Ring {
  uint32_t base, bars;
  int stage;
  uint32_t phase;
};

// One work item on the consumer warpgroups: warpgroup wg takes rows 64 wg
// of a 128-row tile, or columns 64 wg of a 64-row one; ACC 64 is m64n128,
// 32 m64n64. Returns the ring's place after the item. The bias and the
// ReLU are applied to the summed accumulators here, in the forward
// epilogue's order (the same bits), and nn_epilogue only rounds and
// stores: loaded as the item starts, as gemm_sm90.cu does, the bias pairs
// held ACC / 2 registers through the mainloop and the m64n128 item spilled
// (9% of the B = 64 decoder on the card, PERF.md §6). Like every stage's
// body (the attention instances, the LayerNorm rows) it is a function of
// its own: ptxas allocates each body's registers apart, where inlined into
// one kernel the four attention instances made it spill 6.5 KB of
// registers, which every stage then ran through.
template <int ACC>
__device__ __noinline__ Ring gemm_item(const GemmJob& j, const StackItem it, int l, Ring r,
                                       float* ws, int* counters, int* last_flag, int tid) {
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool tall = j.bm == 128;
  const int r0 = it.m0 + (tall ? 64 * wg : 0) + 16 * warp + (lane >> 2);
  const int c0 = it.n0 + (tall ? 0 : 64 * wg) + 2 * (lane & 3);
  float acc[1][ACC];
#pragma unroll
  for (int c = 0; c < ACC; ++c) acc[0][c] = 0.0f;
  sm90::consume<0, 1, STAGES, SLOT>(acc, r.base, r.bars, r.stage, r.phase, it.nk,
                                    tall ? wg * sm90::BOX : 0,
                                    A_BYTES + (tall ? 0 : wg * sm90::BOX), [] {});
  // split: a thread whose rows all lie past M moves no partial
  if (j.splits > 1 && !sm90::split_sum<1, ACC, CONSUMERS>(acc, ws + j.ws, counters + j.cnt,
                                                          it.tile, it.split, j.splits, tid,
                                                          last_flag, r0 < j.M))
    return r;
  // accumulator q holds column c0 + 8 (q / 4) + q % 2
  const float* bias = j.bias != nullptr ? j.bias + static_cast<size_t>(l) * j.N : nullptr;
  if (bias != nullptr || j.relu) {
    float2 b[ACC / 4];
#pragma unroll
    for (int p = 0; p < ACC / 4; ++p) {
      const int col = c0 + 8 * p;
      b[p] = bias != nullptr && col < j.N ? make_float2(__ldg(bias + col), __ldg(bias + col + 1))
                                          : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int q = 0; q < ACC; ++q) {
      const float x = bias != nullptr ? acc[0][q] + (q & 1 ? b[q / 4].y : b[q / 4].x) : acc[0][q];
      acc[0][q] = j.relu ? fmaxf(x, 0.0f) : x;
    }
  }
  const sm90::Epilogue ep{nullptr, 0, 1.0f, nullptr, 0, j.o32, j.o16, j.N, nullptr, 0,
                          nullptr, 0, Philox{0, 0u, 0u, 0u, 0}};
  sm90::NNState<1, ACC, false> st;
  st.start(ep, r0, c0, j.N);
  sm90::nn_epilogue<1, ACC, false>(acc, st, lane, r0, c0, j.M, j.N, ep);
  return r;
}

// The items of one or two independent products of layer l, grid-stride.
// Every thread of the block calls it.
__device__ __forceinline__ void gemm_stage(const CUtensorMap* maps, const GemmJob& a,
                                           const GemmJob* b, int l, Ring& r, float* ws,
                                           int* counters, int* last_flag) {
  const int tid = threadIdx.x;
  const int ia = gemm_items(a), total = ia + (b != nullptr ? gemm_items(*b) : 0);
  if (tid >= CONSUMERS) {
    if (tid != CONSUMERS) return;
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const GemmJob& j = w < ia ? a : *b;
      const StackItem it(j, w < ia ? w : w - ia);
      const int na = j.bm / 64, nw = j.bn / 64;
      const CUtensorMap* ma = &maps[j.a];
      const CUtensorMap* mw = &maps[j.w];
      sm90::produce<STAGES, SLOT>(r.base, r.bars, r.stage, r.phase, it.nk,
                                  (na + nw) * sm90::BOX, [&](uint32_t s, uint32_t full, int i) {
        const int k0 = (it.kt0 + i) * sm90::BK;
        for (int h = 0; h < na; ++h) sm90::tma_load(s + h * sm90::BOX, ma, full, k0, it.m0 + 64 * h);
        for (int c = 0; c < nw; ++c)
          sm90::tma_load_3d(s + A_BYTES + c * sm90::BOX, mw, full, it.n0 + 64 * c, k0, l);
      });
    }
    return;
  }
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    const GemmJob& j = w < ia ? a : *b;
    const StackItem it(j, w < ia ? w : w - ia);
    r = j.bm == 128 && j.bn == 128 ? gemm_item<64>(j, it, l, r, ws, counters, last_flag, tid)
                                   : gemm_item<32>(j, it, l, r, ws, counters, last_flag, tid);
  }
}

// ---------------------------------------------------------------------------
// masked attention: masked_attention.cu's block items over the ring
// ---------------------------------------------------------------------------

// The attention plan of a stage (kernels.stack_plan: attention_plan's
// instance and rows, the head width padded to one of the four instances
// below): instance 0 (one block, dhp 64 with kc 64 keys or dhp 128 with
// 128) or 1 (long, dhp 128 or 256); the rows of an item are in Args::rows.
// Zero columns past Dh and keys past Lk add nothing to a sum, so each row
// is the one masked_attention.cu's own instance for the shape computes.
// Four instances, not that kernel's twelve: inlined into the stack, the
// twelve made it spill (PERF.md §6). groups: the items a block runs at once, each
// on 256 / groups consumer threads and a slice of the ring, where the
// standalone kernel fills an SM with several blocks of one item each.
struct AttPlan {
  int instance, dhp, kc, groups;
};

template <int DHP, int NT>
__device__ __noinline__ void att_one_block(const Args& a, int item, unsigned char* smem, Group g) {
  attention_one_block<DHP, NT>(a, item, smem, g);
}

template <int DHP>
__device__ __noinline__ void att_long(const Args& a, int item, unsigned char* smem, Group g) {
  attention_long<DHP>(a, item, smem, g);
}

__device__ __forceinline__ void att_item(const Args& a, const AttPlan& ap, int item,
                                         unsigned char* smem, const Group& g) {
  if (ap.instance == 0) {
    if (ap.dhp == 64) return att_one_block<64, 8>(a, item, smem, g);
    return att_one_block<128, 16>(a, item, smem, g);
  }
  if (ap.dhp == 128) return att_long<128>(a, item, smem, g);
  return att_long<256>(a, item, smem, g);
}

// Every (sample, head, row tile) item: group g of the block's consumer warps
// takes items blockIdx.x + gridDim.x (g + groups k), so the items spread over
// the blocks first; each group syncs on its own named barrier (2 + g) and
// stages in its own slice of the ring. The producer warp takes none.
__device__ __forceinline__ void att_stage(const Args& a, const AttPlan& ap, unsigned char* smem) {
  const int items = a.B * a.H * cdiv(a.Lq, a.rows);
  const int per = CONSUMERS / ap.groups, g = threadIdx.x / per;
  if (g >= ap.groups) return;
  const Group grp{static_cast<int>(threadIdx.x) - g * per, per, 2 + g};
  unsigned char* mine = smem + g * (RING / ap.groups);
  for (int it = blockIdx.x + gridDim.x * g; it < items; it += gridDim.x * ap.groups) {
    att_item(a, ap, it, mine, grp);
    grp.sync();   // the group's shared memory is free for its next item
  }
}

// ---------------------------------------------------------------------------
// residual + bias + Std-LayerNorm per row
// ---------------------------------------------------------------------------

struct LnJob {
  const float* res;   // [M, D]
  const float* y;     // [M, D]
  const float* bias;  // [D] or null
  const float* gamma;
  const float* beta;
  float* o32;         // either may be null
  bf16* o16;
  int M, D;
  float eps;
};

// D = 128 V: each lane's columns 4 lane + 128 v .. + 3 (v < V) read once
// into registers as 16-byte loads, and both copies written from them (the
// f32 as 16 bytes, the bf16 as 8). The job comes by value: read through a
// reference into this frame, its fields were reloaded after every store.
template <int V>
__device__ __noinline__ void ln_regs(const LnJob j) {
  constexpr int D = 128 * V;
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < j.M; row += nw) {
    const size_t base = (size_t)row * D;
    float r[4 * V];
    float sum = 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 4 * lane + 128 * v;
      float4 y = *reinterpret_cast<const float4*>(j.y + base + c);
      const float4 x = *reinterpret_cast<const float4*>(j.res + base + c);
      if (j.bias != nullptr) {
        const float4 b = *reinterpret_cast<const float4*>(j.bias + c);
        y = make_float4(y.x + b.x, y.y + b.y, y.z + b.z, y.w + b.w);
      }
      r[4 * v] = x.x + y.x;
      r[4 * v + 1] = x.y + y.y;
      r[4 * v + 2] = x.z + y.z;
      r[4 * v + 3] = x.w + y.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) sum += r[4 * v + k];
    }
    const float den = ln::centre_regs(r, 4 * V, D, sum, j.eps);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = 4 * lane + 128 * v;
      const float4 g = *reinterpret_cast<const float4*>(j.gamma + c);
      const float4 b = *reinterpret_cast<const float4*>(j.beta + c);
      const float4 o = make_float4(g.x * r[4 * v] / den + b.x, g.y * r[4 * v + 1] / den + b.y,
                                   g.z * r[4 * v + 2] / den + b.z, g.w * r[4 * v + 3] / den + b.w);
      if (j.o32 != nullptr) *reinterpret_cast<float4*>(j.o32 + base + c) = o;
      if (j.o16 != nullptr) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y), hi = __floats2bfloat162_rn(o.z, o.w);
        *reinterpret_cast<uint2*>(j.o16 + base + c) = make_uint2(
            *reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
      }
    }
  }
}

__device__ __forceinline__ float ln_r(const LnJob& j, size_t e, int d) {
  const float y = j.bias != nullptr ? j.y[e] + j.bias[d] : j.y[e];
  return j.res[e] + y;
}

// any other multiple of 32: the row re-read (from L2) in each pass
static __device__ __noinline__ void ln_rolled(const LnJob j) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < j.M; row += nw) {
    const size_t base = (size_t)row * j.D;
    float s = 0.0f;
    for (int d = lane; d < j.D; d += 32) s += ln_r(j, base + d, d);
    const float mean = warp_sum(s) / j.D;
    float ss = 0.0f;
    for (int d = lane; d < j.D; d += 32) {
      const float c = ln_r(j, base + d, d) - mean;
      ss += c * c;
    }
    const float den = sqrtf(warp_sum(ss) / (j.D - 1)) + j.eps;
    for (int d = lane; d < j.D; d += 32) {
      const float c = ln_r(j, base + d, d) - mean;
      const float v = j.gamma[d] * c / den + j.beta[d];
      if (j.o32 != nullptr) j.o32[base + d] = v;
      if (j.o16 != nullptr) j.o16[base + d] = to_bf16(v);
    }
  }
}

__device__ __forceinline__ void ln_stage(const LnJob& j) {
  switch (j.D) {
    case 256: return ln_regs<2>(j);
    case 512: return ln_regs<4>(j);
    case 1024: return ln_regs<8>(j);
    default: return ln_rolled(j);
  }
}

__device__ __forceinline__ float load_f32(const void* p, int f32, size_t e) {
  return f32 ? static_cast<const float*>(p)[e] : to_f32(static_cast<const bf16*>(p)[e]);
}

// an input in its stored type -> an f32 and / or a bf16 copy, grid-stride
__device__ __forceinline__ void convert_stage(const void* x, int x_f32, long long n, float* o32,
                                              bf16* o16) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * THREADS) {
    const float v = load_f32(x, x_f32, e);
    if (o32 != nullptr) o32[e] = v;
    if (o16 != nullptr) o16[e] = to_bf16(v);
  }
}

// the ring's barriers, initialised once per launch by thread 0; -> the
// ring at the start, the split flag
__device__ __forceinline__ Ring ring_init(unsigned char* smem, int** last_flag) {
  const uint32_t raw = sm90::smem_addr(smem);
  const uint32_t base = (raw + sm90::SWIZZLE_ATOM - 1) & ~(sm90::SWIZZLE_ATOM - 1);
  const uint32_t bars = base + RING;
  *last_flag = reinterpret_cast<int*>(smem + (bars - raw) + 16 * STAGES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bars + 8 * s, 1);
      sm90::mbar_init(bars + 8 * (STAGES + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return Ring{base, bars, 0, 0u};
}

// the ring's first byte as a generic pointer: the attention's staging
__device__ __forceinline__ unsigned char* ring_bytes(unsigned char* smem, const Ring& r) {
  return smem + (r.base - sm90::smem_addr(smem));
}

// ---------------------------------------------------------------------------
// host: the plan's fields, the maps, the cooperative launch
// ---------------------------------------------------------------------------

constexpr int JOB_FIELDS = 5;   // bm, bn, splits, ws, cnt
constexpr int ATT_FIELDS = 5;   // instance, dhp, kc, rows, groups

// a GEMM job's plan as kernels.stack_plan gives it: tiles 128 x 128, 128 x
// 64 or 64 x 128, 1 .. the K-tiles splits; a split needs the workspace
inline bool take_job(GemmJob& j, const int* f, bool have_ws) {
  j.bm = f[0];
  j.bn = f[1];
  j.splits = f[2];
  j.ws = f[3];
  j.cnt = f[4];
  const int k_tiles = cdiv(j.K, sm90::BK);
  return (j.bm == 64 || j.bm == 128) && (j.bn == 64 || j.bn == 128) && !(j.bm == 64 && j.bn == 64) &&
         j.splits >= 1 && j.splits <= k_tiles && j.ws >= 0 && j.cnt >= 0 &&
         (j.splits == 1 || have_ws);
}

// an attention stage's plan, checked against the shape and against the
// ring it stages in
inline bool take_att(Args& a, AttPlan& ap, const int* f) {
  ap = AttPlan{f[0], f[1], f[2], f[4]};
  a.rows = f[3];
  bool ok;
  if (ap.instance == 0)
    ok = ((ap.dhp == 64 && ap.kc == 64) || (ap.dhp == 128 && ap.kc == 128)) && a.Dh <= ap.dhp &&
         a.Lk <= ap.kc;
  else
    ok = ap.instance == 1 && (ap.dhp == 128 || ap.dhp == 256) && a.Dh <= ap.dhp &&
         ap.kc == LONG_KC;
  const int cs = ap.instance == 1 && ap.dhp > 128 ? 2 : 1;
  const int staged = ap.instance == 0 || a.Lk <= LONG_KC ? 2 * cdiv(a.Lk, 16) * 16 : 4 * LONG_KC;
  const int g = ap.groups;
  return ok && (g == 1 || g == 2 || g == 4 || g == 8) && a.rows >= 16 && a.rows % 16 == 0 &&
         a.rows / 16 * cs * 32 <= CONSUMERS / g && (a.rows + staged) * (ap.dhp + 8) * 2 <= RING / g;
}

// the tensor map of an activation [rows, K] (bf16, row stride K) read in
// boxes of 64 rows x 64 columns
inline bool act_map(CUtensorMap* m, const void* p, int rows, int K) {
  return p == nullptr || sm90::make_map(m, p, 2, K, rows, K, 64, 64);
}

// the tensor map of a stacked weight [L, K, N] read in boxes of 64 K-rows x
// 64 columns of one layer
inline bool weight_map(CUtensorMap* m, const void* p, int L, int K, int N) {
  return p == nullptr || sm90::make_map3(m, p, N, K, L, 64, 64);
}

// Launch kernel(params) cooperatively with THREADS threads and SMEM bytes of
// dynamic shared memory on as many blocks as fit co-resident on the card
// (at most max_blocks > 0, and at most `useful`, the largest stage's work
// items). info (host, may be null) <- grid, blocks per SM, SMs, shared
// memory bytes. Returns the CUDA error: cudaErrorCooperativeLaunchTooLarge
// where not one block fits an SM, cudaErrorNotSupported on a card without
// cooperative launch.
template <typename Params>
int launch_cooperative(void (*kernel)(Params), const Params& params, int useful, int max_blocks,
                       int* info, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = per_sm * sms;
  if (useful > 0 && useful < grid) grid = useful;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  if (info != nullptr) {
    info[0] = grid;
    info[1] = per_sm;
    info[2] = sms;
    info[3] = SMEM;
  }
  Params p = params;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS), args,
                                  static_cast<size_t>(SMEM), stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace persistent
