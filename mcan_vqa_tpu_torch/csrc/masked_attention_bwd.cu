// masked_attention_bwd: the gradients of one head's masked attention with
// dropout on the probabilities, per (sample, head), for every head width
// Dh <= 256 (MCAN-small 64, MCAN-large 128, hidden 2048 at 8 heads 256) and
// any Lq, Lk:
//   P = softmax(q k^T / sqrt(Dh), PAD keys -> -1e9)  (recomputed from q, k)
//   Pd = drop(P)              (keep-mask x inv_keep; the mask read, or drawn
//                              in place by Philox with the forward's key and
//                              counter: the _prng backward kernels,
//                              sga_train.py:812, :1202, sa_train.py:295,
//                              :314, regenerate the forward's bits)
//   dPd = dO v^T,  dV = Pd^T dO
//   dS = P * (drop(dPd) - rowsum(P * drop(dPd)))
//   dQ = dS k / sqrt(Dh),  dK = dS^T q / sqrt(Dh)
//
// Replaces: the per-head backward of the TPU train kernels
//   mcan_vqa_tpu/ops/sga_train.py::_bwd_att_kernel (:631; the loops at
//   :690-705 for the cross-attention and :739-772 for the self-attention,
//   with _softmax_bwd :250), the same loops of _bwd_att_kernel_sav (:1183,
//   from the saved qkv / qx) and those of
//   mcan_vqa_tpu/ops/sa_train.py::_bwd_body (:250-266). The TPU kernels
//   pack G samples into one score matrix under one collapsed additive mask
//   (_block_masks, sga_train.py:256-263); here each block holds one sample
//   and PAD keys score -1e9, so a fully padded sample attends uniformly to
//   its own keys only. Its score gradient is the softmax's, dS = P * (dP -
//   rowsum), as the TPU kernel's additive mask gives it at group 1.
//
// Numerics, as in the TPU kernel: q, k, v, dO are bf16 operands (f32 cross
// k/v rounded on load); scores, softmax and dS in f32; Pd and dS rounded to
// bf16 as the operands of the next products; every product sums in f32.
// No atomics: every output element is written once by one warp, and two
// runs give the same bits.
//
// Bounds on an H100: a MCAN train step's heads (14-60 rows, Dh 64 / 128)
// move ~0.5-1 GB a step for 9-18 GFLOP, so the bound is bytes; what costs
// is instructions and latency. Design: every product on the tensor cores,
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) with ldmatrix fragments and
// 16-byte cp.async staging, the forward's helpers (attention_mma.cuh).
// Two instances, picked by kernels.attention_bwd_plan:
//   * one-block (Dh <= 128, Lq and Lk <= 128: every MCAN-small and
//     MCAN-large train shape): a block per (sample, head). q, k in the
//     first cp.async group, dO, v in the second, [rows][Dh padded to 32 +
//     8] bf16. Phase 1, a warp per 16 query rows: S = Q.K^T with the
//     forward's `scores` and its softmax (`softmax_probs`), so P is the
//     forward one-block kernel's bit for bit; Pd written to shared memory
//     as bf16; dPd = dO.V^T; dS in registers, written as bf16; dQ = dS.K
//     from dS's C fragments as A tiles (`probs_to_a`) and K by
//     ldmatrix.trans (`pv`). Phase 2, after a barrier: dK = dS^T.Q and
//     dV = Pd^T.dO, the A tiles by ldmatrix.trans of the staged dS / Pd,
//     the B tiles by ldmatrix.trans of Q / dO; the work items (16 keys x
//     dK or dV x 32 columns) dealt round the warps, so the cross shape's
//     single key tile still spreads over four warps.
//   * long (Dh up to 256, or Lq or Lk past 128): two kernels, no atomics.
//     The rows kernel, a block per (sample, head, query tile), streams
//     64-key chunks of K and V through a two-stage cp.async ring, twice:
//     first each row's max, sum of exp and rowsum(exp * drop(dPd))
//     (online, rescaled as the max grows), written to `stats` with the
//     sum's reciprocal; then P = exp(x - max) / sum, dS and dQ += dS.K.
//     The keys kernel, a block per (sample, head, key tile), streams
//     64-row chunks of Q, dO and their stats the same way and computes
//     S^T = K.Q^T (and dPd^T = V.dO^T) with keys as the rows, so dS^T and
//     Pd^T are A tiles straight from the C fragments; a warp per 16 keys
//     and output (dK or dV), two column halves past Dh 128. Past Dh 128
//     two warps share a row tile of the rows kernel, each holding half of
//     dQ's columns, as the forward's long kernel does.
// The keep bits are the forward's: the same (sample, head, i * Lk + j)
// Philox counters or the mask bytes, drawn in rolled loops before the
// unrolled fragments come live. Every kernel declares
// __launch_bounds__(256, 1): without the minimum ptxas spilled the
// forward's instances.
#include "attention_mma.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int KC = 64;        // the long kernels' keys (queries) per chunk
constexpr int NTC = KC / 8;   // 8-wide C tiles of a chunk
constexpr int ITEM_COLS = 32; // one-block phase 2: the columns of a work item

struct Args {
  const void* q;  // bf16
  long long q_bs, q_hs, q_rs;
  const void *k, *v;
  long long kv_bs, kv_hs, kv_rs;
  int kv_f32;
  const unsigned char* kpad;
  const unsigned char* drop;
  Philox keep;
  float inv_keep;
  const void* dout;  // bf16
  long long do_bs, do_rs;
  float4* stats;  // long: [B * H, Lq] of (max, sum, rowsum(P * drop(dPd)), 1 / sum)
  float *dq, *dk, *dv;
  bf16 *dq16, *dk16, *dv16;
  long long dq_bs, dq_hs, dq_rs, dk_bs, dk_hs, dk_rs, dv_bs, dv_hs, dv_rs;
  int B, H, Lq, Lk, Dh;
  float scale;
  int rows, key_rows;  // long: query rows per rows-kernel block, keys per keys-kernel block
};

// a warp's gradient tile (16 rows from row0, columns col0 + 8 c + 2 tq +
// {0, 1}) times mul into out (f32) and out16 (bf16, may be null), row
// stride rs, rows below L and columns below Dh
template <int NC>
__device__ __forceinline__ void store_grad(float* out, bf16* out16, long long rs,
                                           const float (&o)[NC][4], float mul, int row0,
                                           int col0, int L, int Dh, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const bool pairs = Dh % 2 == 0 && rs % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0 &&
                     (out16 == nullptr || reinterpret_cast<uintptr_t>(out16) % 4 == 0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = col0 + 8 * c + 2 * tq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = row0 + g + 8 * hf;
      if (i >= L || col >= Dh) continue;
      const float v0 = o[c][2 * hf] * mul, v1 = o[c][2 * hf + 1] * mul;
      const long long off = i * rs + col;
      if (pairs) {
        *reinterpret_cast<float2*>(out + off) = make_float2(v0, v1);
        if (out16 != nullptr) *reinterpret_cast<unsigned*>(out16 + off) = pack_bf16(v0, v1);
      } else {
        out[off] = v0;
        if (out16 != nullptr) out16[off] = to_bf16(v0);
        if (col + 1 < Dh) {
          out[off + 1] = v1;
          if (out16 != nullptr) out16[off + 1] = to_bf16(v1);
        }
      }
    }
  }
}

// a warp's C tiles (16 rows, 8 NT columns) as bf16 into a shared-memory
// tile of row stride ld: 32-bit pairs, rows at or past `valid` zero
template <int NT>
__device__ __forceinline__ void put_tile(bf16* dst, int ld, const float (&x)[NT][4], int nt,
                                         int valid, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const bool in = g + 8 * hf < valid;
        *reinterpret_cast<unsigned*>(dst + (g + 8 * hf) * ld + 8 * t + 2 * tq) =
            in ? pack_bf16(x[t][2 * hf], x[t][2 * hf + 1]) : 0u;
      }
    }
  }
}

// e / l rounded as an IEEE division rounds, from r = 1 / l: normalise's
// arithmetic for one element (Markstein's step; a division for e in (0,
// 2^-60)), so the keys kernel's probabilities are the rows kernel's
__device__ __forceinline__ float div_rn(float e, float l, float r) {
  if (e > 0.0f && e < 0x1p-60f) return e / l;
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

// ---------------------------------------------------------------------------
// the one-block kernel: Dh <= 128, Lq and Lk <= 128
// ---------------------------------------------------------------------------

// DHP: Dh rounded up to 32; NT: the 8-key tiles a row holds (8: Lk <= 64,
// 16: Lk <= 128), as the forward's one-block kernel. Shared memory: Q and
// dO [Lq rounded up to 16][LD], K and V [Lk rounded up to 16][LD], then dS
// and Pd [Lq rounded up to 16][Lk rounded up to 16, + 8].
template <int DHP, int NT>
__global__ void __launch_bounds__(MAX_THREADS, 1) masked_attention_bwd_kernel(const Args a) {
  constexpr int LD = DHP + 8, NC = DHP / 8, PARTS = DHP / ITEM_COLS, PNC = ITEM_COLS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lq = a.Lq, Lk = a.Lk, Dh = a.Dh;
  const int lqp = (Lq + 15) & ~15, lkp = (Lk + 15) & ~15, lds = lkp + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + lqp * LD;
  bf16* ks = dos + lqp * LD;
  bf16* vs = ks + lkp * LD;
  bf16* dss = vs + lkp * LD;
  bf16* pds = dss + lqp * lds;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const long long kv_off = b * a.kv_bs + h * a.kv_hs;
  stage<DHP>(qs, make_src(a.q, 0, b * a.q_bs + h * a.q_hs, a.q_rs, Dh), 0, lqp, Lq, Dh);
  stage<DHP>(ks, make_src(a.k, a.kv_f32, kv_off, a.kv_rs, Dh), 0, lkp, Lk, Dh);
  cp_async_commit();
  stage<DHP>(dos, make_src(a.dout, 0, b * a.do_bs + h * Dh, a.do_rs, Dh), 0, lqp, Lq, Dh);
  stage<DHP>(vs, make_src(a.v, a.kv_f32, kv_off, a.kv_rs, Dh), 0, lkp, Lk, Dh);
  cp_async_commit();

  // while the copies fly: this thread's pad and keep bits (rows i0, i0 + 8)
  const int pairs = lkp / 16, row0 = warp * 16, i0 = row0 + (lane >> 2);
  const bool live = row0 < Lq;
  const bool dropping = a.drop != nullptr || a.keep.on;
  unsigned padb = 0, keepb[2] = {0u, 0u};
  if (live) {
    padb = byte_bits<NT>(a.kpad + (size_t)b * Lk + 2 * tq, Lk, 2 * tq, 2 * pairs);
    if (dropping) {
      const unsigned char* dropb = a.drop == nullptr ? nullptr : a.drop + (size_t)bh * Lq * Lk;
      const unsigned site = a.keep.site + h;
      keepb[0] = keep_bits<NT>(a.keep, Lq, Lk, dropb, site, b, i0, 2 * tq, 2 * pairs);
      keepb[1] = keep_bits<NT>(a.keep, Lq, Lk, dropb, site, b, i0 + 8, 2 * tq, 2 * pairs);
    }
  }
  auto kept = [&](int t, int c) { return !dropping || ((keepb[c >> 1] >> (2 * t + (c & 1))) & 1u); };
  const float scl = dropping ? a.inv_keep : 1.0f;

  // ---- phase 1: a warp per 16 query rows
  cp_async_wait<1>();  // Q and K
  __syncthreads();
  float s[NT][4];
  if (live) {
    scores<DHP, NT>(s, qs + row0 * LD, ks, pairs, lane);
    softmax_probs<NT>(s, a.scale, padb, past_bits<NT>(Lk, 2 * tq), 2 * pairs);
    float pd[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) pd[t][c] = kept(t, c) ? s[t][c] * scl : 0.0f;
    put_tile<NT>(pds + row0 * lds, lds, pd, 2 * pairs, Lq - row0, lane);
  }
  cp_async_wait<0>();  // dO and V
  __syncthreads();
  if (live) {
    float g[NT][4];
    scores<DHP, NT>(g, dos + row0 * LD, vs, pairs, lane);
    float part[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        g[t][c] = kept(t, c) ? g[t][c] * scl : 0.0f;
        part[c >> 1] += s[t][c] * g[t][c];
      }
    }
    const float dot[2] = {quad_sum(part[0]), quad_sum(part[1])};
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) g[t][c] = s[t][c] * (g[t][c] - dot[c >> 1]);
    put_tile<NT>(dss + row0 * lds, lds, g, 2 * pairs, Lq - row0, lane);
    // dQ = dS.K / sqrt(Dh): rows past Lq are not stored
    unsigned da[NT / 2][4];
    probs_to_a<NT>(da, g);
    float o[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
    pv<LD, NT, NC>(o, da, ks, pairs, lane);
    store_grad<NC>(a.dq + b * a.dq_bs + h * a.dq_hs,
                   a.dq16 == nullptr ? nullptr : a.dq16 + b * a.dq_bs + h * a.dq_hs, a.dq_rs, o,
                   a.scale, row0, 0, Lq, Dh, lane);
  }
  __syncthreads();  // every row's dS and Pd staged

  // ---- phase 2: dK = dS^T.Q / sqrt(Dh), dV = Pd^T.dO; item = (16 keys,
  // dK or dV, 32 columns). A tiles: ldmatrix.trans of the staged [query]
  // [key] dS / Pd (matrices: keys 0-7 / 8-15 of queries 0-7, then of
  // queries 8-15); B tiles: ldmatrix.trans of Q / dO rows, as pv reads V
  const int items = (lkp / 16) * 2 * PARTS, warps = blockDim.x >> 5;
  for (int it = warp; it < items; it += warps) {
    const int kt = it / (2 * PARTS), rem = it - kt * 2 * PARTS, is_dv = rem / PARTS;
    const int col0 = (rem - is_dv * PARTS) * ITEM_COLS;
    const bf16* at = (is_dv ? pds : dss) + ((lane & 7) + (lane >> 4) * 8) * lds + kt * 16 +
                     ((lane >> 3) & 1) * 8;
    const bf16* xb = (is_dv ? dos : qs) + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     (lane >> 4) * 8 + col0;
    float o[PNC][4];
#pragma unroll
    for (int c = 0; c < PNC; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
    for (int t = 0; t < lqp / 16; ++t) {
      unsigned fa[4];
      ldsm_x4_trans(fa, at + t * 16 * lds);
#pragma unroll
      for (int c = 0; c < PNC / 2; ++c) {
        unsigned fb[4];
        ldsm_x4_trans(fb, xb + t * 16 * LD + c * 16);
        mma16816(o[2 * c], fa, fb[0], fb[1]);
        mma16816(o[2 * c + 1], fa, fb[2], fb[3]);
      }
    }
    if (is_dv)
      store_grad<PNC>(a.dv + b * a.dv_bs + h * a.dv_hs,
                      a.dv16 == nullptr ? nullptr : a.dv16 + b * a.dv_bs + h * a.dv_hs, a.dv_rs,
                      o, 1.0f, kt * 16, col0, Lk, Dh, lane);
    else
      store_grad<PNC>(a.dk + b * a.dk_bs + h * a.dk_hs,
                      a.dk16 == nullptr ? nullptr : a.dk16 + b * a.dk_bs + h * a.dk_hs, a.dk_rs,
                      o, a.scale, kt * 16, col0, Lk, Dh, lane);
  }
}

// ---------------------------------------------------------------------------
// the long kernels: Dh up to 256, any Lq and Lk
// ---------------------------------------------------------------------------

// rows kernel. DHP: Dh rounded up to 64. Warp w: row tile w / CS, dQ
// columns [(w % CS) OC, + OC). Shared memory: Q and dO [rows][LD], then a
// two-stage ring of K and of V chunks [2][64][LD]; where every key fits one
// chunk (Lk <= 64), one stage of Lk rounded up to 16 rows, staged once for
// both passes.
template <int DHP>
__global__ void __launch_bounds__(MAX_THREADS, 1) attention_bwd_rows_kernel(const Args a) {
  constexpr int CS = DHP > 128 ? 2 : 1, OC = DHP / CS, NC = OC / 8, LD = DHP + 8, NT = NTC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = a.rows, Lq = a.Lq, Lk = a.Lk, Dh = a.Dh;
  const int chunks = (Lk + KC - 1) / KC, kcr = chunks > 1 ? KC : (Lk + 15) & ~15;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + rows * LD;
  bf16* kbuf = dos + rows * LD;  // stage s at kbuf + s * kcr * LD
  bf16* vbuf = kbuf + (chunks > 1 ? 2 : 1) * kcr * LD;

  const int tiles = (Lq + rows - 1) / rows;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x - bh * tiles) * rows;
  const int b = bh / a.H, h = bh - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int rt = warp / CS, col0 = (warp % CS) * OC;
  const int row0 = q0 + rt * 16, i0 = row0 + (lane >> 2);
  const bool live = row0 < Lq;
  const bf16* qw = qs + rt * 16 * LD;
  const bf16* dow = dos + rt * 16 * LD;

  const long long kv_off = b * a.kv_bs + h * a.kv_hs;
  const Src ksrc = make_src(a.k, a.kv_f32, kv_off, a.kv_rs, Dh);
  const Src vsrc = make_src(a.v, a.kv_f32, kv_off, a.kv_rs, Dh);
  const unsigned char* pad = a.kpad + (size_t)b * Lk;
  const bool dropping = a.drop != nullptr || a.keep.on;
  const unsigned char* dropb = a.drop == nullptr ? nullptr : a.drop + (size_t)bh * Lq * Lk;
  const unsigned site = a.keep.site + h;
  const float scl = dropping ? a.inv_keep : 1.0f;
  auto chunk_pairs = [&](int c) { return (min(KC, Lk - c * KC) + 15) / 16; };
  auto stage_kv = [&](int st, int c) {
    stage<DHP>(kbuf + st * kcr * LD, ksrc, c * KC, kcr, Lk, Dh);
    stage<DHP>(vbuf + st * kcr * LD, vsrc, c * KC, kcr, Lk, Dh);
  };
  // the chunk's scaled logits S and dropped dPd of the warp's rows, and
  // this thread's pad / keep bits, drawn before the copy is waited for
  auto chunk = [&](int c, float (&s)[NT][4], float (&g)[NT][4]) {
    const int pairs = chunk_pairs(c), j0 = c * KC + 2 * tq;
    unsigned padb = 0, keepb[2] = {0u, 0u};
    if (live) {
      padb = byte_bits<NT>(pad + j0, Lk, j0, 2 * pairs);
      if (dropping) {
        keepb[0] = keep_bits<NT>(a.keep, Lq, Lk, dropb, site, b, i0, j0, 2 * pairs);
        keepb[1] = keep_bits<NT>(a.keep, Lq, Lk, dropb, site, b, i0 + 8, j0, 2 * pairs);
      }
    }
    cp_async_wait<1>();
    __syncthreads();
    if (!live) return;
    const bf16* kc = kbuf + (c & 1) * kcr * LD;
    scores<DHP, NT>(s, qw, kc, pairs, lane);
    scores<DHP, NT>(g, dow, vbuf + (c & 1) * kcr * LD, pairs, lane);
    const unsigned past = past_bits<NT>(Lk, j0);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[t][k] = logit(s[t][k], a.scale, padb, past, 2 * t + (k & 1));
        const bool kept = !dropping || ((keepb[k >> 1] >> (2 * t + (k & 1))) & 1u);
        g[t][k] = kept ? g[t][k] * scl : 0.0f;
      }
    }
  };

  // pass 1: each row's max, sum of exp and sum of exp * drop(dPd), both
  // sums rescaled as the max grows
  stage<DHP>(qs, make_src(a.q, 0, b * a.q_bs + h * a.q_hs, a.q_rs, Dh), q0, rows, Lq, Dh);
  stage<DHP>(dos, make_src(a.dout, 0, b * a.do_bs + h * Dh, a.do_rs, Dh), q0, rows, Lq, Dh);
  stage_kv(0, 0);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f};
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) stage_kv((c + 1) & 1, c + 1);
    cp_async_commit();
    float s[NT][4], g[NT][4];
    chunk(c, s, g);
    if (live) {
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) cm[k >> 1] = fmaxf(cm[k >> 1], s[t][k]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float mn = fmaxf(m[hf], quad_max(cm[hf]));
        float pl = 0.0f, pu = 0.0f;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int k = 2 * hf; k < 2 * hf + 2; ++k) {
            const float e = expf(s[t][k] - mn);
            pl += e;
            pu += e * g[t][k];
          }
        }
        const float f = expf(m[hf] - mn);
        l[hf] = l[hf] * f + quad_sum(pl);
        u[hf] = u[hf] * f + quad_sum(pu);
        m[hf] = mn;
      }
    }
    __syncthreads();  // the chunk's stage is read no more
  }
  float dot[2] = {0.0f, 0.0f};
  if (live) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dot[hf] = u[hf] / l[hf];
      const int i = i0 + 8 * hf;
      if (warp % CS == 0 && tq == 0 && i < Lq)
        a.stats[(size_t)bh * Lq + i] = make_float4(m[hf], l[hf], dot[hf], 1.0f / l[hf]);
    }
  }

  // pass 2: P = exp(x - max) / sum, dS = P * (drop(dPd) - rowsum) rounded
  // to bf16, dQ += dS.K
  float o[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
  if (chunks > 1) stage_kv(0, 0);  // else chunk 0 is still staged
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) stage_kv((c + 1) & 1, c + 1);
    cp_async_commit();
    float s[NT][4], g[NT][4];
    chunk(c, s, g);
    if (live) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[t][k] = expf(s[t][k] - m[k >> 1]);
      normalise<NT>(s, l, NT);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) g[t][k] = s[t][k] * (g[t][k] - dot[k >> 1]);
      unsigned da[NT / 2][4];
      probs_to_a<NT>(da, g);
      pv<LD, NT, NC>(o, da, kbuf + (c & 1) * kcr * LD + col0, chunk_pairs(c), lane);
    }
    __syncthreads();
  }
  if (!live) return;
  store_grad<NC>(a.dq + b * a.dq_bs + h * a.dq_hs,
                 a.dq16 == nullptr ? nullptr : a.dq16 + b * a.dq_bs + h * a.dq_hs, a.dq_rs, o,
                 a.scale, row0, col0, Lq, Dh, lane);
}

// keys kernel. Warp w: key tile w / KS; output w % KS / CP (0: dK, 1: dV),
// columns [(w % CP) OC, + OC). Shared memory: K and V [key_rows][LD], then
// two-stage rings of Q and of dO chunks [2][64][LD] (one stage of Lq
// rounded up to 16 where Lq <= 64) and of their rows' stats [2][64].
template <int DHP>
__global__ void __launch_bounds__(MAX_THREADS, 1) attention_bwd_keys_kernel(const Args a) {
  constexpr int CP = DHP > 128 ? 2 : 1, KS = 2 * CP, OC = DHP / CP, NC = OC / 8, LD = DHP + 8;
  constexpr int NT = NTC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = a.key_rows, Lq = a.Lq, Lk = a.Lk, Dh = a.Dh;
  const int chunks = (Lq + KC - 1) / KC, qcr = chunks > 1 ? KC : (Lq + 15) & ~15;
  const int stages = chunks > 1 ? 2 : 1;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + rows * LD;
  bf16* qbuf = vs + rows * LD;  // stage s at qbuf + s * qcr * LD
  bf16* dobuf = qbuf + stages * qcr * LD;
  float4* sbuf = reinterpret_cast<float4*>(dobuf + stages * qcr * LD);

  const int tiles = (Lk + rows - 1) / rows;
  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x - bh * tiles) * rows;
  const int b = bh / a.H, h = bh - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int kt = warp / KS, is_dv = (warp % KS) / CP, col0 = (warp % CP) * OC;
  const int row0 = k0 + kt * 16, j0 = row0 + (lane >> 2);
  const bool live = row0 < Lk;
  const bf16* kw = ks + kt * 16 * LD;
  const bf16* vw = vs + kt * 16 * LD;

  const long long kv_off = b * a.kv_bs + h * a.kv_hs;
  const Src qsrc = make_src(a.q, 0, b * a.q_bs + h * a.q_hs, a.q_rs, Dh);
  const Src dosrc = make_src(a.dout, 0, b * a.do_bs + h * Dh, a.do_rs, Dh);
  const float4* stats = a.stats + (size_t)bh * Lq;
  const unsigned char* pad = a.kpad + (size_t)b * Lk;
  const bool dropping = a.drop != nullptr || a.keep.on;
  const unsigned char* dropb = a.drop == nullptr ? nullptr : a.drop + (size_t)bh * Lq * Lk;
  const unsigned site = a.keep.site + h;
  const float scl = dropping ? a.inv_keep : 1.0f;
  // rows (keys) j0 and j0 + 8: in range, PAD
  const bool rin[2] = {j0 < Lk, j0 + 8 < Lk};
  const bool rpad[2] = {rin[0] && pad[j0], rin[1] && pad[j0 + 8]};

  auto stage_q = [&](int st, int c) {
    stage<DHP>(qbuf + st * qcr * LD, qsrc, c * KC, qcr, Lq, Dh);
    stage<DHP>(dobuf + st * qcr * LD, dosrc, c * KC, qcr, Lq, Dh);
    for (int e = threadIdx.x; e < qcr; e += blockDim.x) {
      const int i = c * KC + e;
      cp_async16(sbuf + st * qcr + e, i < Lq ? stats + i : stats, i < Lq);
    }
  };

  stage<DHP>(ks, make_src(a.k, a.kv_f32, kv_off, a.kv_rs, Dh), k0, rows, Lk, Dh);
  stage<DHP>(vs, make_src(a.v, a.kv_f32, kv_off, a.kv_rs, Dh), k0, rows, Lk, Dh);
  stage_q(0, 0);
  cp_async_commit();
  float o[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) stage_q((c + 1) & 1, c + 1);
    cp_async_commit();
    const int ic = c * KC, pairs = (min(KC, Lq - ic) + 15) / 16;
    // keep bit 2 t + cc of row half hf (bit 32 hf + 2 t + cc of kb): query
    // ic + 8 t + 2 tq + cc, key j0 + 8 hf; one Philox word each (the pair's
    // keys are not neighbours); no array indexed in the rolled loop
    unsigned long long kb = 0;
    if (live && dropping) {
#pragma unroll 1
      for (int e = 0; e < 2 * 4 * pairs; ++e) {
        const int hf = e / (4 * pairs), r = e - hf * 4 * pairs;
        const int i = ic + 8 * (r >> 1) + 2 * tq + (r & 1), j = j0 + 8 * hf;
        if (i >= Lq || j >= Lk) continue;
        const unsigned x = static_cast<unsigned>(i) * Lk + j;
        const bool k = dropb != nullptr ? dropb[x] != 0
                                        : philox_word(a.keep.seed, site, b, x) < a.keep.thresh;
        kb |= (k ? 1ull : 0ull) << (32 * hf + r);
      }
    }
    const unsigned keepb[2] = {static_cast<unsigned>(kb), static_cast<unsigned>(kb >> 32)};
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const int st = c & 1;
      const bf16* qc = qbuf + st * qcr * LD;
      const bf16* doc = dobuf + st * qcr * LD;
      const float4* sc = sbuf + st * qcr;
      // S^T = K.Q^T: rows keys, columns queries
      float s[NT][4], g[NT][4];
      scores<DHP, NT>(s, kw, qc, pairs, lane);
      if (!is_dv) scores<DHP, NT>(g, vw, doc, pairs, lane);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int hf = k >> 1, col = 8 * t + 2 * tq + (k & 1), bit = 2 * t + (k & 1);
          const float4 w = sc[min(col, qcr - 1)];
          const bool in = rin[hf] && ic + col < Lq;
          const float x = rpad[hf] ? -1e9f : s[t][k] * a.scale;
          const float p = in ? div_rn(expf(x - w.x), w.y, w.w) : 0.0f;
          const bool kept = in && (!dropping || ((keepb[hf] >> bit) & 1u));
          s[t][k] = is_dv ? (kept ? p * scl : 0.0f)
                          : p * ((kept ? g[t][k] * scl : 0.0f) - w.z);
        }
      }
      unsigned pa[NT / 2][4];
      probs_to_a<NT>(pa, s);
      pv<LD, NT, NC>(o, pa, (is_dv ? doc : qc) + col0, pairs, lane);
    }
    __syncthreads();  // the chunk's stage is read no more
  }
  if (!live) return;
  if (is_dv)
    store_grad<NC>(a.dv + b * a.dv_bs + h * a.dv_hs,
                   a.dv16 == nullptr ? nullptr : a.dv16 + b * a.dv_bs + h * a.dv_hs, a.dv_rs, o,
                   1.0f, row0, col0, Lk, Dh, lane);
  else
    store_grad<NC>(a.dk + b * a.dk_bs + h * a.dk_hs,
                   a.dk16 == nullptr ? nullptr : a.dk16 + b * a.dk_bs + h * a.dk_hs, a.dk_rs, o,
                   a.scale, row0, col0, Lk, Dh, lane);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// dynamic shared memory (kernels.attention_bwd_plan computes the same):
// one-block: Q, dO, K, V rows and the dS, Pd tiles; rows kernel: Q and dO
// rows, then K and V whole (Lk <= 64) or two stages of 64-key chunks; keys
// kernel: K and V rows, then Q and dO whole (Lq <= 64) or two stages of
// 64-row chunks, and their stats
int one_block_smem(int dhp, int Lq, int Lk) {
  const int lqp = (Lq + 15) / 16 * 16, lkp = (Lk + 15) / 16 * 16;
  return (2 * (lqp + lkp) * (dhp + 8) + 2 * lqp * (lkp + 8)) * static_cast<int>(sizeof(bf16));
}

int streamed(int L) { return L <= KC ? (L + 15) / 16 * 16 : 2 * KC; }

int rows_smem(int dhp, int rows, int Lk) {
  return (2 * rows + 2 * streamed(Lk)) * (dhp + 8) * static_cast<int>(sizeof(bf16));
}

int keys_smem(int dhp, int rows, int Lq) {
  return (2 * rows + 2 * streamed(Lq)) * (dhp + 8) * static_cast<int>(sizeof(bf16)) +
         streamed(Lq) * static_cast<int>(sizeof(float4));
}

template <int DHP, int NT>
int launch_one(const Args& a, int grid, int threads, int smem, cudaStream_t s) {
  static bool opted_in = false;
  if (int err = opt_in(masked_attention_bwd_kernel<DHP, NT>, one_block_smem(DHP, 128, 8 * NT),
                       opted_in))
    return err;
  masked_attention_bwd_kernel<DHP, NT><<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_one_dh(const Args& a, int dhp, int grid, int threads, int smem, cudaStream_t s) {
  switch (dhp) {
    case 32: return launch_one<32, NT>(a, grid, threads, smem, s);
    case 64: return launch_one<64, NT>(a, grid, threads, smem, s);
    case 96: return launch_one<96, NT>(a, grid, threads, smem, s);
    default: return launch_one<128, NT>(a, grid, threads, smem, s);
  }
}

template <int DHP>
int launch_long(const Args& a, int grid, int threads, int smem, int key_grid, int key_threads,
                int key_smem, cudaStream_t s) {
  constexpr int CS = DHP > 128 ? 2 : 1;  // the most rows a block takes: 8 warps
  static bool rows_in = false, keys_in = false;
  if (int err = opt_in(attention_bwd_rows_kernel<DHP>, rows_smem(DHP, 128 / CS, 1 << 30),
                       rows_in))
    return err;
  if (int err = opt_in(attention_bwd_keys_kernel<DHP>, keys_smem(DHP, 64 / CS, 1 << 30),
                       keys_in))
    return err;
  attention_bwd_rows_kernel<DHP><<<grid, threads, smem, s>>>(a);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  attention_bwd_keys_kernel<DHP><<<key_grid, key_threads, key_smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: bf16, [b, h, i, d] at q + b*q_bs + h*q_hs + i*q_rs + d; k, v: bf16
// (kv_f32 == 0) or f32 with shared strides; kpad uint8 [B, Lk] (1 = PAD);
// drop: null or uint8 keep-mask [B, H, Lq, Lk] contiguous, or keep_on != 0
// (drop null then): the forward's Philox mask, key (seed, site + h); dout:
// bf16, [b, i, h*Dh + d] at dout + b*do_bs + i*do_rs + h*Dh + d. dq/dk/dv:
// f32, [b, h, row, d] at base + b*bs + h*hs + row*rs + d; the bf16 copies
// dq16/dk16/dv16 (each may be null) share their f32 twin's strides.
// Requires 1 <= Dh <= 256 and Lq, Lk >= 1. The plan (kernels.
// attention_bwd_plan): instance 0 (one-block: Dh <= dhp = Dh rounded up to
// 32 <= 128, Lq <= 128, Lk <= kc, kc 64 or 128; a block of `threads` per
// (sample, head), rows = Lq and key_rows = Lk rounded up to 16, no keys
// launch) or 1 (long: dhp = Dh rounded up to 64, kc 64; the rows kernel's
// grid blocks of threads = rows / 16 warps, twice that past Dh 128, then
// the keys kernel's key_grid blocks of key_threads = key_rows / 16 x 2
// warps, twice that past Dh 128; stats: f32 scratch of B * H * Lq * 4).
// smem / key_smem: dynamic shared memory. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or a plan it does not take.
MCAN_API int mcan_masked_attention_bwd(
    const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k, const void* v,
    long long kv_bs, long long kv_hs, long long kv_rs, int kv_f32, const void* kpad,
    const void* drop, float inv_keep, int keep_on, unsigned seed, unsigned site,
    unsigned thresh, const void* dout, long long do_bs, long long do_rs,
    void* dq, void* dq16, long long dq_bs, long long dq_hs, long long dq_rs, void* dk,
    void* dk16, long long dk_bs, long long dk_hs, long long dk_rs, void* dv, void* dv16,
    long long dv_bs, long long dv_hs, long long dv_rs, void* stats, int B, int H, int Lq,
    int Lk, int Dh, float scale, int instance, int dhp, int kc, int rows, int grid,
    int threads, int smem, int key_rows, int key_grid, int key_threads, int key_smem,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (Dh < 1 || Dh > 256 || Lq < 1 || Lk < 1 || H < 1) return invalid;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const long long bh = (long long)B * H;
  bool ok;
  if (instance == 0) {
    const int lqp = (Lq + 15) / 16 * 16, lkp = (Lk + 15) / 16 * 16;
    ok = (dhp == 32 || dhp == 64 || dhp == 96 || dhp == 128) && Dh <= dhp && Dh > dhp - 32 &&
         (kc == 64 || kc == 128) && Lk <= kc && Lq <= 128 && rows == lqp &&
         key_rows == lkp && grid == bh && threads % 32 == 0 && threads >= lqp * 2 &&
         threads <= MAX_THREADS && smem == one_block_smem(dhp, Lq, Lk) && key_grid == 0;
  } else {
    const int cs = dhp > 128 ? 2 : 1;
    ok = instance == 1 && (dhp == 64 || dhp == 128 || dhp == 192 || dhp == 256) &&
         Dh <= dhp && Dh > dhp - 64 && kc == KC && stats != nullptr && rows >= 16 &&
         rows % 16 == 0 && threads == rows / 16 * cs * 32 && threads <= MAX_THREADS &&
         grid == bh * ((Lq + rows - 1) / rows) && smem == rows_smem(dhp, rows, Lk) &&
         key_rows >= 16 && key_rows % 16 == 0 && key_threads == key_rows / 16 * 2 * cs * 32 &&
         key_threads <= MAX_THREADS && key_grid == bh * ((Lk + key_rows - 1) / key_rows) &&
         key_smem == keys_smem(dhp, key_rows, Lq);
  }
  if (!ok) return invalid;
  const Args a{q, q_bs, q_hs, q_rs, k, v, kv_bs, kv_hs, kv_rs, kv_f32,
               static_cast<const unsigned char*>(kpad), static_cast<const unsigned char*>(drop),
               Philox{keep_on, seed, site, thresh, 0}, inv_keep, dout, do_bs, do_rs,
               static_cast<float4*>(stats), static_cast<float*>(dq), static_cast<float*>(dk),
               static_cast<float*>(dv), static_cast<bf16*>(dq16), static_cast<bf16*>(dk16),
               static_cast<bf16*>(dv16), dq_bs, dq_hs, dq_rs, dk_bs, dk_hs, dk_rs, dv_bs, dv_hs,
               dv_rs, B, H, Lq, Lk, Dh, scale, rows, key_rows};
  if (instance == 0)
    return kc == 64 ? launch_one_dh<8>(a, dhp, grid, threads, smem, s)
                    : launch_one_dh<16>(a, dhp, grid, threads, smem, s);
  switch (dhp) {
    case 64: return launch_long<64>(a, grid, threads, smem, key_grid, key_threads, key_smem, s);
    case 128: return launch_long<128>(a, grid, threads, smem, key_grid, key_threads, key_smem, s);
    case 192: return launch_long<192>(a, grid, threads, smem, key_grid, key_threads, key_smem, s);
    default: return launch_long<256>(a, grid, threads, smem, key_grid, key_threads, key_smem, s);
  }
}
