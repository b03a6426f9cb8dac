// gemm_int4: the int4 serving levels' two products on Hopper's asynchronous
// tensor cores, each against a nibble-packed int4 weight with 128-row scale
// groups:
//   S4  y = t_0 + t_1 + ... (left to right) over the K-groups g, where
//       t_g = f32(exact int32 sum_{k in g} A[m, k] W[k, n]) * (a * s4[g, n]),
//       then + bias[n], ReLU; int8 codes A              (gemm_s4)
//   W4  y = A[M, K] . bf16(f32(W[k, n]) * s4[k / 128, n]) + bias[n], ReLU;
//       bf16 operands, f32 sums                           (gemm_w4bf16)
// written f32 and / or bf16 (W4: one of them), one rounding each.
//
// Replaces: the int4 matmuls inside the TPU kernels
//   mcan_vqa_tpu/ops/quant.py::_sga_kernel_qffn / ::_sa_kernel_qffn
//   (pallas_call :1326 / :1412). At qffn levels 4 and 5 ``_qdot_static4``
//   (:282): the packed weight unpacked in-register (``_unpack_w4``, :81),
//   one int8 dot_general per K-group with an int32 result, each dequantized
//   by its group's scales and summed in f32. At levels 6 and 7
//   ``_qdot_w4bf16`` (:307): the weight unpacked and multiplied by its group
//   scales in f32, rounded to bf16, then one bf16 product of bf16(x) with
//   f32 sums. The sites: the FFN's w1 [D, F] and w2 [F, D] (levels 4-7) and
//   the fused self-attention qkv [D, 3D] (levels 5 and 7).
//
// The packed weight (``_quant_w4``, ops/quant.py): P [K/2, N] with JAX's
// values -- rows k and k + K/2 of W in the low and high nibbles of P[k, n],
// q + 8 for q in [-7, 7] -- stored K-major (strides (1, ld)): for each column
// n one row of K/2 bytes. wgmma reads an 8-bit operand only K-major, so the
// engine stores the weight so once, where it quantizes it; it is never
// transposed per call. s4 is f32 [K/128, N].
//
// Bounds on an H100 (1,979 TOP/s int8, 989 TFLOP/s bf16, 3.35 TB/s): at B=1
// (M 14 or 60) a site is bound by its packed weight's bytes (MCAN-small w1
// 0.5 MB, 0.16 us; MCAN-large 2 MB), half the int8 weight's, which is what
// the level is for; in practice by the latency of the K-tiles that each
// block walks in order. At B=64 (M 3840) w1's f32 output bounds it (31 MB,
// 9.4 us at MCAN-small) and the other sites sit near the tensor cores' ridge.
//
// Design: sm90_mainloop.cuh's TMA ring, descriptors and wgmma, as
// gemm_sm90.cu's instances run them, with the operands swapped: the weight
// is wgmma's A operand, formed in the registers of the consumer threads from
// the slot's packed bytes, and the activations are its B operand, K-major
// in the slot as the TMA wrote them (consume_rs). A tile is 128 weight
// columns x MT activation rows (S4: 64; W4: 64 up to M 64, else 128): two
// consumer warpgroups of 64 columns each, a producer warp, one block an SM,
// persistent. Unpacked or dequantized codes never go back to shared memory,
// so there is no store, proxy fence or barrier between the TMA and the
// tensor cores: a first design that wrote them back into the slot for an
// SS wgmma was bound by shared memory (the write-back on top of both
// operands' reads) and its barriers. The output is written transposed from
// each warp's own staging rows (store_rows): a warp's store covers 16
// adjacent columns of 8 rows. At B=1 the wgmma's N is the padded batch.
//   * S4: a K-tile is one scale group, 128 codes. For each column the
//     producer loads the 128 packed bytes that hold the group's codes
//     (ops/kernels.py::w4_tile_boxes states the rule): the low nibbles of
//     bytes 128 t .. for a group below K/2, the high nibbles of bytes
//     128 t - K/2 .. above it, 128-byte swizzled. Where K % 256 != 0 one
//     group straddles K/2: its codes 0 .. 63 are the low nibbles of the last
//     64 bytes, its codes 64 .. 127 the high nibbles of bytes 0 .. 63, a
//     second box at byte 0 into a buffer of its own (one a block: one group
//     of an item straddles), guarded by its own mbarrier; its codes 64 ..
//     127 sit 64 bytes back, the same row's 16-byte chunk XOR 4. ldmatrix
//     gives each thread the packed bytes of its A fragment (columns g, g + 8
//     of the warp's 16, codes 4 t .. and 16 + 4 t ..), unpacked in the
//     registers four to a word (codes4). Then wgmma m64n64k32.s32.s8.s8 in
//     four steps, the first overwriting the accumulators (scale-d 0). Two
//     accumulator sets alternate between groups: group i + 1 is issued
//     before group i's per-group drain takes its exact int32 sums in the
//     plain version's order: v = f32(acc) * (a * s4[g, n]), y = g == 0 ? v :
//     y + v (y starts at -0.0, and -0.0 + v is v), each step one correctly
//     rounded __fmul_rn / __fadd_rn, a
//     thread's two scales read from the slot, where the TMA put the group's.
//     f32(acc) is exact by two full-rate operations (small_int_to_f32): the
//     conversion instruction's quarter rate made the drain the bound. 2 x 32
//     s32 and 32 f32 sums a thread (167 registers of the 168 that 288
//     threads leave; a 128 x 128 tile's 64 + 64 spilled). At small M the
//     plan splits K over whole groups by the prefix rule: split 0 sums
//     groups 0 .. e0 - 1 in order, every later split writes each group's
//     term to a workspace slot of its own, and the last block of the tile
//     (one counter, the only atomic) adds them to split 0's sum in group
//     order: the plain version's order, so its bits. Then + bias, ReLU,
//     one rounding to each requested output.
//   * W4: a K-tile is 64 rows of one group and one nibble half (K/2 is a
//     multiple of 64); the producer loads the 64 packed bytes of each column
//     (64-byte swizzle: the 16-byte loads of 8 columns hit 8 bank groups)
//     and the group's scales; each thread forms its fragments' bf16(f32(q) *
//     s4[g, n]) with __fmul_rn and one rounding (dequant_w4's bits; f32(q)
//     exact by two full-rate operations), and wgmma m64nMTk16.f32.bf16.bf16
//     reads them. One group stays in flight, its fragments in the other of
//     two register sets, while the next K-tile's are formed. The dequantized
//     weight never reaches memory. At small M the plan splits K, summed by
//     split_sum in a fixed order.
// The plan (tile, splits, grid) is ops/kernels.py::gemm_plan's.
//
// Not yet: each packed byte is fetched once for its low-nibble group and
// once for its high-nibble one (from L2: at the B=64 decoder S4's bare
// mainloop is bound by L2 bandwidth); a cluster that multicasts the weight
// box to two CTAs of neighbouring rows would halve that.
#include <cstdint>
#include <cstring>

#include "sm90_mainloop.cuh"

namespace sm90 {

constexpr int S4 = 5, W4 = 6;   // the layouts (ops/kernels.py _S4 / _W4)
constexpr int GROUP = 128;      // K-rows per scale group
constexpr int STAGE_PITCH = 20; // f32 an epilogue staging row: 16 columns + 4

// A tile of 128 weight columns x MT activation rows, transposed: the weight
// is wgmma's A operand (warpgroup c forms, in its registers, the fragments
// of columns 64 c .. 64 c + 63: 16 of them a warp), the activations its B
// operand (MT rows of 128 K-bytes, K-major, straight from the TMA). So a
// thread's MT / 2 accumulators hold D[n][m] for its two columns n and MT / 4
// row pairs m. A slot: the activations, then the packed weight box (S4: 128
// columns x 128 bytes, 128-byte swizzle; W4: 128 x 64 bytes, 64-byte
// swizzle). After the ring: S4's second box of a straddling group, the
// slots' group scales, the barriers. One block of two consumer warpgroups
// and a producer warp an SM.
template <int LAYOUT, int MT>
struct Int4Cfg {
  static constexpr int BN = 128, CONSUMERS = 256, THREADS = CONSUMERS + 32;
  static constexpr int ACC = MT / 2;
  static constexpr int A_BYTES = MT * 128;
  static constexpr int W_BYTES = LAYOUT == S4 ? BN * 128 : BN * 64;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;   // 1 KB multiples
  static constexpr int STAGES = LAYOUT == S4 ? 6 : MT == 128 ? 7 : 8;
  static constexpr int X_BYTES = LAYOUT == S4 ? BN * 128 : 0;
  static constexpr int SCALE_BYTES = BN * 4;
  // the bytes a K-tile's loads bring (a straddling S4 group X_BYTES more)
  static constexpr int TILE_BYTES = STAGE_BYTES + SCALE_BYTES;
  // each warp's epilogue staging rows (store_rows)
  static constexpr int STAGING = 8 * 64 * STAGE_PITCH * 4;
  // the ring, 1 KB of slack to align it, the second box, the scales, the
  // barriers (full, empty, the second box's), a flag and the staging rows
  static constexpr int SMEM = SWIZZLE_ATOM + STAGES * (STAGE_BYTES + SCALE_BYTES) + X_BYTES +
                              16 * STAGES + 16 + STAGING;
};

struct Int4Epilogue {
  float a;            // S4: the static activation scale
  const float* bias;  // [N] or null
  int relu;
  float* out_f32;     // dense [M, N]; S4: either or both, W4: one
  bf16* out_bf16;
};

// a packed word -> four int8 codes: its low (sh 0) or high (sh 4) nibbles n,
// n - 8 a byte: n + 0x78 <= 0x87 carries into no other byte, and the XOR
// with 0x80 maps 0x78 .. 0x87 to -8 .. 7
__device__ __forceinline__ uint32_t codes4(uint32_t w, int sh) {
  return (((w >> sh) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// The f32 value of an int32 of magnitude below 2^22, exactly (so the bits
// of __int2float_rn): the integer added to the bits of 1.5 x 2^23, whose
// mantissa's unit is 1, then 1.5 x 2^23 subtracted. Two full-rate
// operations: the conversion instruction runs at a quarter of their rate on
// an H100, and S4 converts every sum of every group. A group's sum is at
// most 128 x 127 x 7 in magnitude.
__device__ __forceinline__ float small_int_to_f32(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.0f;
}

// two packed bytes (bits 0 .. 15) -> bf16(f32(q) * s) of their low (sh 0) or
// high (sh 4) nibbles n, q = n - 8, the lower byte in the lower half; f32(q)
// as n in the mantissa of 2^23 minus 2^23 + 8 (exact, full rate)
__device__ __forceinline__ uint32_t dequant2(uint32_t w, int sh, float s) {
  const float f0 = __int_as_float(0x4B000000u | ((w >> sh) & 0xFu)) - 8388616.0f;
  const float f1 = __int_as_float(0x4B000000u | ((w >> (8 + sh)) & 0xFu)) - 8388616.0f;
  const __nv_bfloat162 b = __floats2bfloat162_rn(__fmul_rn(f0, s), __fmul_rn(f1, s));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The epilogue, transposed through the warp's own staging rows: the
// thread's accumulator j holds output row m = m0 + 8 (j / 4) + 2 t + j % 2,
// column n_w + g + 8 ((j / 2) % 2) (n_w: the warp's first of 16 columns);
// + bias (b2: its two columns'), ReLU, then 64 rows at a time into `stage`
// ([64][STAGE_PITCH] f32: these writes hit 32 banks), read back as 4
// adjacent columns a lane and written with one rounding to each requested
// output, 16 (f32) or 8 (bf16) bytes a store: a warp's store covers 16
// columns of 8 rows. Rows past M and columns past N are not stored.
template <int ACC>
__device__ __forceinline__ void store_rows(const float (&v)[ACC], const float (&b2)[2], float* stage,
                                           int m0, int n_w, int lane, int M, int N,
                                           const Int4Epilogue& ep) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < ACC / 32; ++p) {   // 64 rows a pass
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int j = 32 * p + jj;
      float x = ep.bias != nullptr ? __fadd_rn(v[j], b2[(jj >> 1) & 1]) : v[j];
      if (ep.relu) x = fmaxf(x, 0.0f);
      stage[(8 * (jj >> 2) + 2 * t + (jj & 1)) * STAGE_PITCH + g + 8 * ((jj >> 1) & 1)] = x;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int ml = 8 * r + (lane >> 2), m = m0 + 64 * p + ml, n = n_w + 4 * (lane & 3);
      const float4 x = *reinterpret_cast<const float4*>(stage + ml * STAGE_PITCH + 4 * (lane & 3));
      if (m >= M || n >= N) continue;   // N % 16 == 0: all 4 columns or none
      const size_t o = static_cast<size_t>(m) * N + n;
      if (ep.out_f32 != nullptr) *reinterpret_cast<float4*>(ep.out_f32 + o) = x;
      if (ep.out_bf16 != nullptr) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
        *reinterpret_cast<uint2*>(ep.out_bf16 + o) = make_uint2(
            *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
}

// Persistent, as gemm_sm90_kernel: block b takes work items b, b + grid, ...
// (item w = split w / tiles of tile w % tiles), its
// producer loading the next item's K-tiles while the consumers run this
// one's epilogue. ta: the activations; tp: the packed weight's K-major rows;
// ts: the scales [K/128, N].
template <int LAYOUT, int MT>
__global__ void __launch_bounds__(Int4Cfg<LAYOUT, MT>::THREADS, 1)
gemm_int4_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tp,
                 const __grid_constant__ CUtensorMap ts, int M, int N, int K, int k_tiles,
                 int splits, Int4Epilogue ep, float* __restrict__ ws, int* __restrict__ counters) {
  using C = Int4Cfg<LAYOUT, MT>;
  constexpr int STAGES = C::STAGES, CONSUMERS = C::CONSUMERS, BN = C::BN, ACC = C::ACC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + SWIZZLE_ATOM - 1) & ~(SWIZZLE_ATOM - 1);
  uint8_t* const smem = smem_raw + (base - raw);               // generic, at base
  const uint32_t xbox = base + STAGES * C::STAGE_BYTES;         // S4's second box
  const uint32_t scales = xbox + C::X_BYTES;                     // [STAGES][BN] f32
  const uint32_t bars = scales + STAGES * C::SCALE_BYTES;        // full[s], then empty[s]
  const uint32_t xbar = bars + 16 * STAGES;                      // the second box is free
  int* last_flag = reinterpret_cast<int*>(smem + (xbar - base) + 8);
  float* const staging = reinterpret_cast<float*>(smem + (xbar - base) + 16);
  const float* slot_scales = reinterpret_cast<const float*>(smem + (scales - base));
  const int half = K / 2;

  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN, tiles = (M + MT - 1) / MT * tiles_n;
  const int items = tiles * splits;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS);
    }
    mbar_init(xbar, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the producer warp: lane 0 keeps the ring full, item after item
    if (tid == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&ta)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tp)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&ts)) : "memory");
      int stage = 0;
      uint32_t phase = 0, xphase = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item it(w, tiles, tiles_n, BN, k_tiles, splits, MT);
        produce<STAGES, C::STAGE_BYTES>(base, bars, stage, phase, it.nk, C::TILE_BYTES,
                                        [&](uint32_t a, uint32_t full, int i) {
          const int t = it.kt0 + i;
          const uint32_t wt = a + C::A_BYTES;
          const uint32_t sc = scales + (a - base) / C::STAGE_BYTES * C::SCALE_BYTES;
          if constexpr (LAYOUT == S4) {
            // group t: the low nibbles of bytes k0 .. while below K/2, the
            // high nibbles of bytes max(k0 - K/2, 0) .. past it
            const int k0 = GROUP * t;
            const bool lo = k0 < half, hi = k0 + GROUP > half;
            if (lo && hi) {   // straddling: the second box, once its buffer is free
              mbar_wait(xbar, xphase ^ 1);
              xphase ^= 1;
              mbar_expect_more(full, C::X_BYTES);
            }
            tma_load(a, &ta, full, k0, it.m0);   // the codes: MT rows x 128
            if (lo) tma_load(wt, &tp, full, k0, it.n0);
            if (hi) tma_load(lo ? xbox : wt, &tp, full, k0 - half > 0 ? k0 - half : 0, it.n0);
            tma_load(sc, &ts, full, it.n0, t);
          } else {
            // 64 rows of one half: the low nibbles of bytes k0 .., or the
            // high nibbles of bytes k0 - K/2 ..
            const int k0 = BK * t;
            tma_load(a, &ta, full, k0, it.m0);   // x: MT rows x 64 bf16
            tma_load(wt, &tp, full, k0 < half ? k0 : k0 - half, it.n0);
            tma_load(sc, &ts, full, it.n0, k0 / GROUP);
          }
        });
      }
    }
    return;
  }

  // ---- the consumer warpgroups: warpgroup wg computes weight columns
  // n0 + 64 wg .. of each tile, warp `warp` 16 of them; lane: g = lane / 4
  // (columns g, g + 8 of the warp's 16), t = lane % 4 (rows 2 t, 2 t + 1 of
  // each 8)
  const int wg = tid / 128, warp = (tid % 128) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = 64 * wg + 16 * warp;   // the warp's first weight column in the tile
  float* const stage_rows = staging + (tid >> 5) * 64 * STAGE_PITCH;   // this warp's
  int stage = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it(w, tiles, tiles_n, BN, k_tiles, splits, MT);
    const int n_g = it.n0 + row_w + g;
    float b2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b2[h] = ep.bias != nullptr && n_g + 8 * h < N ? __ldg(ep.bias + n_g + 8 * h) : 0.0f;

    if constexpr (LAYOUT == S4) {
      int acc[2][ACC];   // two sets: a group drains while the next one runs
      // the running f32 sums over the groups, from -0.0: -0.0 + v is v bit
      // for bit, so the first group's term needs no select
      float y[ACC];
#pragma unroll
      for (int j = 0; j < ACC; ++j) y[j] = -0.0f;
      // split K (the prefix rule): split 0 sums groups 0 .. e0 - 1 in order;
      // every later split writes each group's term to a slot of its own, the
      // tile's slots being split 0's sum, then each group e0 .. in order
      const int e0 = k_tiles / splits, slots = 1 + k_tiles - e0;
      float4* const tile_ws =
          reinterpret_cast<float4*>(ws) + static_cast<size_t>(it.tile) * slots * (ACC / 4) * CONSUMERS;
      // lane L's ldmatrix row: column row_w + 8 ((L / 8) % 2) + L % 8; its
      // 16-byte half of a 32-byte step: L / 16
      const int lrow = row_w + 8 * ((lane >> 3) & 1) + (lane & 7);
      consume_rs_drain<STAGES, C::STAGE_BYTES, ACC>(
          acc, base, bars, stage, phase, it.nk, 0,
          [&](uint32_t slot, int, int i, uint32_t(&fr)[BK / 16][4]) {
            // the group's codes of the warp's 16 columns, unpacked in the
            // registers; a straddling group's codes 64 .. 127 from the
            // second box, 64 bytes back (chunk XOR 4 under the swizzle)
            const int k0 = GROUP * (it.kt0 + i);
            const bool straddle = k0 < half && k0 + GROUP > half;
            const int sh = k0 < half ? 0 : 4;
            const uint32_t wt = slot + C::A_BYTES;
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
              const int c = 2 * kk + (lane >> 4);   // the logical 16-byte chunk
              const bool second = straddle && kk >= 2;
              const uint32_t src = second ? xbox : wt;
              uint32_t r[4];
              ldmatrix_x4(r, src + lrow * 128 + (((second ? c ^ 4 : c) ^ (lrow & 7)) << 4));
              const int shk = straddle ? (kk >= 2 ? 4 : 0) : sh;
#pragma unroll
              for (int j = 0; j < 4; ++j) fr[kk][j] = codes4(r[j], shk);
            }
            if (straddle) mbar_arrive(xbar);
          },
          [&](int s, int i, const int(&sums)[ACC]) {   // i: the item's K-tile
            // the group's exact sums dequantized: into the running f32 sums,
            // in order, or (a later split) to the group's own slot
            const float* sc = slot_scales + s * BN + row_w + g;
            const float sa[2] = {__fmul_rn(ep.a, sc[0]), __fmul_rn(ep.a, sc[8])};
            float4* const term = tile_ws + static_cast<size_t>(1 + it.kt0 + i - e0) * (ACC / 4) * CONSUMERS;
#pragma unroll
            for (int q = 0; q < ACC / 4; ++q) {
              if (it.m0 + 8 * q >= M) continue;   // rows past M (the warp agrees)
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(small_int_to_f32(sums[4 * q + e]), sa[e >> 1]);
              if (it.split > 0) {
                __stcg(term + q * CONSUMERS + tid, make_float4(v[0], v[1], v[2], v[3]));
                continue;
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) y[4 * q + e] = __fadd_rn(y[4 * q + e], v[e]);
            }
          });
      if (splits > 1) {
        // split 0's sums to slot 0; the tile's counter (the only atomic);
        // the last block to arrive puts it back to 0, takes split 0's sums
        // and adds every later group's term in group order: the plain
        // version's order, whichever block ran first
#pragma unroll
        for (int q = 0; q < ACC / 4; ++q)
          if (it.split == 0 && it.m0 + 8 * q < M)
            __stcg(tile_ws + q * CONSUMERS + tid, make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]));
        __threadfence();
        consumer_sync<CONSUMERS>();
        if (tid == 0) {
          const int last = atomicAdd(&counters[it.tile], 1) == splits - 1;
          if (last) counters[it.tile] = 0;   // ready for the next launch
          *last_flag = last;
        }
        consumer_sync<CONSUMERS>();
        if (!*last_flag) continue;
        __threadfence();
#pragma unroll
        for (int q = 0; q < ACC / 4; ++q) {
          if (it.m0 + 8 * q >= M) continue;
          float4 p = __ldcg(tile_ws + q * CONSUMERS + tid);
          float s0 = p.x, s1 = p.y, s2 = p.z, s3 = p.w;
          for (int sl = 1; sl < slots; ++sl) {
            p = __ldcg(tile_ws + (static_cast<size_t>(sl) * (ACC / 4) + q) * CONSUMERS + tid);
            s0 = __fadd_rn(s0, p.x), s1 = __fadd_rn(s1, p.y);
            s2 = __fadd_rn(s2, p.z), s3 = __fadd_rn(s3, p.w);
          }
          y[4 * q] = s0, y[4 * q + 1] = s1, y[4 * q + 2] = s2, y[4 * q + 3] = s3;
        }
      }
      store_rows<ACC>(y, b2, stage_rows, it.m0, it.n0 + row_w, lane, M, N, ep);
    } else {
      float acc[1][ACC];
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[0][j] = 0.0f;
      consume_rs<STAGES, C::STAGE_BYTES, ACC>(
          acc[0], base, bars, stage, phase, it.nk, 0,
          [&](uint32_t slot, int s, int i, uint32_t(&fr)[BK / 16][4]) {
            // the K-tile's codes of the warp's columns g, g + 8, dequantized
            // in the registers: step kk's 16 codes are one 16-byte chunk of
            // the column's 64 packed bytes (physical chunk kk XOR (row / 2)
            // % 4 under the 64-byte swizzle); the thread's are bytes 2 t,
            // 2 t + 1 (k 2 t ..) and 8 + 2 t, 9 + 2 t (k 8 + 2 t ..)
            const int sh = BK * (it.kt0 + i) < half ? 0 : 4;
            const uint8_t* pk = smem + (slot - base) + C::A_BYTES;
            const float* sc = slot_scales + s * BN + row_w + g;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row_w + g + 8 * h;
              const float sr = sc[8 * h];
#pragma unroll
              for (int kk = 0; kk < BK / 16; ++kk) {
                const uint4 v = *reinterpret_cast<const uint4*>(
                    pk + row * 64 + ((kk ^ ((row >> 1) & 3)) << 4));
                const uint32_t lo = ((t >> 1) ? v.y : v.x) >> (16 * (t & 1));
                const uint32_t hi = ((t >> 1) ? v.w : v.z) >> (16 * (t & 1));
                fr[kk][h] = dequant2(lo, sh, sr);
                fr[kk][2 + h] = dequant2(hi, sh, sr);
              }
            }
          });
      // this split's partial; the last block of the tile sums them all
      if (splits > 1 &&
          !split_sum<1, ACC, CONSUMERS>(acc, ws, counters, it.tile, it.split, splits, tid,
                                        last_flag, it.m0 + 2 * t < M))
        continue;
      store_rows<ACC>(acc[0], b2, stage_rows, it.m0, it.n0 + row_w, lane, M, N, ep);
    }
  }
}

template <int LAYOUT, int MT>
int launch_int4(const CUtensorMap& ta, const CUtensorMap& tp, const CUtensorMap& ts, int M, int N,
                int K, int k_tiles, int splits, int grid, const Int4Epilogue& ep, float* ws,
                int* counters, cudaStream_t stream) {
  auto kernel = gemm_int4_kernel<LAYOUT, MT>;
  constexpr int smem = Int4Cfg<LAYOUT, MT>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, Int4Cfg<LAYOUT, MT>::THREADS, smem, stream>>>(ta, tp, ts, M, N, K, k_tiles, splits,
                                                              ep, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

// the checks both entries share: a tile the layout has (bm activation rows,
// the plan's, x bn = 128 weight columns), K a positive multiple of 128, N of
// 16, the packed weight's K-major rows of K/2 bytes (row stride ldp >= K/2, a
// multiple of 16), scales, an output
inline bool int4_args_ok(int layout, int bm, int bn, int M, int N, int K, long long ldp,
                         const void* s4, const void* out_f32, const void* out_bf16) {
  return (bm == 64 || (layout == W4 && bm == 128)) && bn == 128 && M >= 0 && N >= 0 &&
         K >= GROUP && K % GROUP == 0 && N % 16 == 0 && ldp >= K / 2 && ldp % 16 == 0 &&
         s4 != nullptr && (out_f32 != nullptr || out_bf16 != nullptr);
}

}  // namespace sm90

// The static int4 product (gemm_s4): A = the int8 codes [M, K] (row stride
// lda bytes, a multiple of 16), P = the packed weight stored K-major, for
// each of its N columns a row of K/2 bytes (row stride ldp bytes: the
// [K/2, N] weight with strides (1, ldp)), s4 = f32 [K/128, N] contiguous; K a
// multiple of 128, N of 16, A, P and s4 16-byte aligned (the wrapper
// checks). a: the static activation scale; bias f32 [N] or null; ReLU where
// relu; written dense [M, N] to out_f32 and / or out_bf16 (at least one).
// bm, bn (64 x 128), splits (1 .. K/128) and grid are ops/kernels.py::
// gemm_plan's; splits > 1 needs `workspace` (1 + K/128 - (K/128) / splits
// slots of 64 x 128 f32 a tile: split 0's sums, then each later group's
// term) and `counters` (an int per output tile, 0 before the launch and
// left 0). Returns cudaGetLastError(), the error of the shared-memory attribute, or
// cudaErrorInvalidValue for an argument the kernel does not take or a
// tensor map that cuTensorMapEncodeTiled refuses.
MCAN_API int mcan_gemm_s4(const void* A, long long lda, const void* P, long long ldp,
                          const void* s4, int M, int N, int K, int bm, int bn, int splits, int grid,
                          float a, const void* bias, int relu, void* out_f32, void* out_bf16,
                          void* workspace, void* counters, void* stream) {
  using namespace sm90;
  if (!int4_args_ok(S4, bm, bn, M, N, K, ldp, s4, out_f32, out_bf16) || lda % 16 != 0 ||
      splits < 1 || splits > K / GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (grid < 1 || (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tp, ts;
  if (!make_map(&ta, A, 1, K, M, lda, 2 * BK, bm) || !make_map(&tp, P, 1, K / 2, N, ldp, 2 * BK, bn) ||
      !make_map_flat(&ts, s4, 4, N, K / GROUP, N, bn, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Int4Epilogue ep{a, static_cast<const float*>(bias), relu, static_cast<float*>(out_f32),
                        static_cast<bf16*>(out_bf16)};
  return launch_int4<S4, 64>(ta, tp, ts, M, N, K, K / GROUP, splits, grid, ep,
                             static_cast<float*>(workspace), static_cast<int*>(counters),
                             static_cast<cudaStream_t>(stream));
}

// The bf16-dequant int4 product (gemm_w4bf16): A = x bf16 [M, K] (row stride
// lda elements, a multiple of 8), P and s4 as mcan_gemm_s4's; bias f32 [N]
// or null; ReLU where relu; written dense [M, N] to exactly one of out_f32
// and out_bf16. bm (64 or 128 activation rows), bn (128), splits (1 ..
// K/64) and grid are ops/kernels.py::gemm_plan's; splits > 1 needs
// `workspace` (splits x the tiles x bm x 128 f32) and `counters` (an int per
// output tile, 0 before the launch and left 0). Returns as mcan_gemm_s4.
MCAN_API int mcan_gemm_w4bf16(const void* A, long long lda, const void* P, long long ldp,
                              const void* s4, int M, int N, int K, int bm, int bn, int splits,
                              int grid, const void* bias, int relu, void* out_f32, void* out_bf16,
                              void* workspace, void* counters, void* stream) {
  using namespace sm90;
  if (!int4_args_ok(W4, bm, bn, M, N, K, ldp, s4, out_f32, out_bf16) || lda % 8 != 0 ||
      (out_f32 != nullptr && out_bf16 != nullptr) || splits < 1 || splits > K / BK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (grid < 1 || (splits > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tp, ts;
  if (!make_map(&ta, A, 2, K, M, lda, BK, bm) ||
      !make_map_flat(&tp, P, 1, K / 2, N, ldp, BK, bn, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_flat(&ts, s4, 4, N, K / GROUP, N, bn, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Int4Epilogue ep{0.0f, static_cast<const float*>(bias), relu, static_cast<float*>(out_f32),
                        static_cast<bf16*>(out_bf16)};
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm == 128 ? launch_int4<W4, 128>(ta, tp, ts, M, N, K, K / BK, splits, grid, ep, ws, cnt, s)
                   : launch_int4<W4, 64>(ta, tp, ts, M, N, K, K / BK, splits, grid, ep, ws, cnt, s);
}

// the dynamic shared memory of the int4 instance of layout 5 (S4) or 6 (W4)
// at bm activation rows a tile; -1 for any other
MCAN_API int mcan_gemm_int4_smem(int layout, int bm) {
  using namespace sm90;
  if (layout == S4 && bm == 64) return Int4Cfg<S4, 64>::SMEM;
  if (layout == W4 && bm == 64) return Int4Cfg<W4, 64>::SMEM;
  if (layout == W4 && bm == 128) return Int4Cfg<W4, 128>::SMEM;
  return -1;
}
