// The forward attention's block items, shared by masked_attention.cu (a
// block per item) and the all-layer stacks' attention stage
// (persistent_stages.cuh, a grid-stride loop over the items), so both run
// one arithmetic: the one-block instance (Dh, Lk <= 128; every key staged
// at once, one pass) and the long one (any Dh <= 256, Lq, Lk; 64-key
// chunks, two passes). masked_attention.cu's header note gives the
// numerics and the design.
#pragma once

#include "attention_mma.cuh"

namespace {

// 8 warps. The kernels declare __launch_bounds__(MAX_THREADS, 1): without
// the minimum of one block ptxas held the <64, 8> instance to 64
// registers and spilled
constexpr int MAX_THREADS = 256;
constexpr int LONG_KC = 64;       // keys per chunk of the long kernel
constexpr int LONG_NT = LONG_KC / 8;

struct Args {
  const void* q;
  int q_f32;
  long long q_bs, q_hs, q_rs;
  const void *k, *v;
  long long kv_bs, kv_hs, kv_rs;
  int kv_f32;
  const unsigned char* kpad;
  const unsigned char* drop;
  Philox keep;
  float inv_keep;
  void* out;
  int out_f32;
  long long o_bs, o_rs;
  int B, H, Lq, Lk, Dh;
  float scale;
  int rows;  // query rows per block: 16 per warp (per pair of warps past Dh 128)
};

// ---------------------------------------------------------------------------
// the output
// ---------------------------------------------------------------------------

// the warp's O tile (16 rows from row0, columns col0 + 8 c + 2 tq + {0, 1})
// into out: f32 as pairs, bf16 through stg (the warp's 16 staged rows of
// row stride LD, at col0) as 16-byte rows
template <int LD, int NC>
__device__ __forceinline__ void store_out(const Args& a, const float (&o)[NC][4], bf16* stg,
                                          int b, int h, int row0, int col0, int lane) {
  const int g = lane >> 2, tq = lane & 3, Dh = a.Dh, Lq = a.Lq;
  if (a.out_f32) {
    float* out = static_cast<float*>(a.out) + b * a.o_bs + h * Dh;
    const bool vec = reinterpret_cast<uintptr_t>(out) % 8 == 0 && Dh % 2 == 0 && a.o_rs % 2 == 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = col0 + 8 * c + 2 * tq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = row0 + g + 8 * hf;
        if (i >= Lq || col >= Dh) continue;
        float* p = out + i * a.o_rs + col;
        if (vec) {
          *reinterpret_cast<float2*>(p) = make_float2(o[c][2 * hf], o[c][2 * hf + 1]);
        } else {
          p[0] = o[c][2 * hf];
          if (col + 1 < Dh) p[1] = o[c][2 * hf + 1];
        }
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<unsigned*>(stg + (g + 8 * hf) * LD + 8 * c + 2 * tq) =
          pack_bf16(o[c][2 * hf], o[c][2 * hf + 1]);
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.out) + b * a.o_bs + h * Dh;
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && Dh % 8 == 0 && a.o_rs % 8 == 0;
  for (int e = lane; e < 16 * NC; e += 32) {
    const int r = e / NC, c = (e - r * NC) * 8, i = row0 + r, col = col0 + c;
    if (i >= Lq || col >= Dh) continue;
    const bf16* src = stg + r * LD + c;
    bf16* dst = out + i * a.o_rs + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int u = 0; u < 8 && col + u < Dh; ++u) dst[u] = src[u];
    }
  }
}

// ---------------------------------------------------------------------------
// the one-block kernel: Dh <= 128, Lk <= 128, any Lq
// ---------------------------------------------------------------------------

// Block item blk (head (sample, head) blk / tiles, row tile blk % tiles)
// of the one-block instance: DHP is Dh rounded up to 32; NT the 8-key
// tiles a row holds (8: Lk <= 64, 16: Lk <= 128). Shared memory at
// smem_raw: Q [rows][LD], K and V [Lk rounded up to 16][LD]. Every thread
// of the group g (by default the block) calls it (the staging is
// group-wide); warps past rows / 16 take no rows. The caller synchronises
// the group before its next use of the shared memory.
template <int DHP, int NT>
__device__ __forceinline__ void attention_one_block(const Args& a, int blk,
                                                    unsigned char* smem_raw,
                                                    const Group g = block_group()) {
  constexpr int LD = DHP + 8, NC = DHP / 8;
  const int rows = a.rows, Lq = a.Lq, Lk = a.Lk, lkp = (Lk + 15) & ~15;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + rows * LD;
  bf16* vs = ks + lkp * LD;

  const int tiles = (Lq + rows - 1) / rows;
  const int bh = blk / tiles, q0 = (blk - bh * tiles) * rows;
  const int b = bh / a.H, h = bh - b * a.H;
  const int warp = g.t >> 5, lane = g.t & 31, tq = lane & 3;

  const long long kv_off = b * a.kv_bs + h * a.kv_hs;
  stage<DHP>(qs, make_src(a.q, a.q_f32, b * a.q_bs + h * a.q_hs, a.q_rs, a.Dh), q0, rows, Lq,
             a.Dh, g);
  stage<DHP>(ks, make_src(a.k, a.kv_f32, kv_off, a.kv_rs, a.Dh), 0, lkp, Lk, a.Dh, g);
  cp_async_commit();
  stage<DHP>(vs, make_src(a.v, a.kv_f32, kv_off, a.kv_rs, a.Dh), 0, lkp, Lk, a.Dh, g);
  cp_async_commit();

  // while the copies fly: this thread's pad and keep bits (rows i0, i0 + 8)
  const int pairs = lkp / 16, row0 = q0 + warp * 16, i0 = row0 + (lane >> 2);
  const bool live = warp < rows / 16 && row0 < Lq;
  const bool dropping = a.drop != nullptr || a.keep.on;
  unsigned padb = 0, keepb[2] = {0u, 0u};
  if (live) {
    padb = byte_bits<NT>(a.kpad + (size_t)b * Lk + 2 * tq, Lk, 2 * tq, 2 * pairs);
    if (dropping) {
      const unsigned char* dropb =
          a.drop == nullptr ? nullptr : a.drop + (size_t)bh * Lq * Lk;
      const unsigned site = a.keep.site + h;
      keepb[0] = keep_bits<NT>(a.keep, a.Lq, a.Lk, dropb, site, b, i0, 2 * tq, 2 * pairs);
      keepb[1] = keep_bits<NT>(a.keep, a.Lq, a.Lk, dropb, site, b, i0 + 8, 2 * tq, 2 * pairs);
    }
  }

  cp_async_wait<1>();  // Q and K
  g.sync();
  unsigned pa[NT / 2][4];
  if (live) {
    float s[NT][4];
    scores<DHP, NT>(s, qs + warp * 16 * LD, ks, pairs, lane);
    softmax_probs<NT>(s, a.scale, padb, past_bits<NT>(Lk, 2 * tq), 2 * pairs);
    if (dropping) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t < 2 * pairs) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[t][c] = (keepb[c >> 1] >> (2 * t + (c & 1))) & 1u ? s[t][c] * a.inv_keep : 0.0f;
        }
      }
    }
    probs_to_a<NT>(pa, s);
  }

  cp_async_wait<0>();  // V
  g.sync();
  if (!live) return;
  float o[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
  pv<LD, NT, NC>(o, pa, vs, pairs, lane);
  // the warp's Q rows are its own and read no more: they stage the output
  store_out<LD, NC>(a, o, qs + warp * 16 * LD, b, h, row0, 0, lane);
}

// ---------------------------------------------------------------------------
// the long kernel: Dh up to 256, any Lq and Lk
// ---------------------------------------------------------------------------

// Block item blk of the long instance: DHP is Dh rounded up to 64. Warp w:
// row tile w / CS, output columns [(w % CS) OC, + OC); warps past the
// item's rows take none. Shared memory: Q [rows][LD], then a two-stage ring
// of K and of V chunks [2][64][LD]; where every key fits one chunk (Lk <=
// 64), a single stage of Lk rounded up to 16 rows, staged once for both
// passes.
template <int DHP>
__device__ __forceinline__ void attention_long(const Args& a, int blk, unsigned char* smem_raw,
                                               const Group g = block_group()) {
  constexpr int CS = DHP > 128 ? 2 : 1, OC = DHP / CS, NC = OC / 8, LD = DHP + 8;
  constexpr int NT = LONG_NT, KC = LONG_KC;
  const int rows = a.rows, Lq = a.Lq, Lk = a.Lk, Dh = a.Dh;
  const int chunks = (Lk + KC - 1) / KC, kcr = chunks > 1 ? KC : (Lk + 15) & ~15;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kbuf = qs + rows * LD;  // stage s at kbuf + s * kcr * LD
  bf16* vbuf = kbuf + (chunks > 1 ? 2 : 1) * kcr * LD;

  const int tiles = (Lq + rows - 1) / rows;
  const int bh = blk / tiles, q0 = (blk - bh * tiles) * rows;
  const int b = bh / a.H, h = bh - b * a.H;
  const int warp = g.t >> 5, lane = g.t & 31, tq = lane & 3;
  const int rt = warp / CS, col0 = (warp % CS) * OC;
  const int row0 = q0 + rt * 16, i0 = row0 + (lane >> 2);
  const bool live = rt < rows / 16 && row0 < Lq;
  bf16* qw = qs + rt * 16 * LD;

  const long long kv_off = b * a.kv_bs + h * a.kv_hs;
  const Src ksrc = make_src(a.k, a.kv_f32, kv_off, a.kv_rs, Dh);
  const Src vsrc = make_src(a.v, a.kv_f32, kv_off, a.kv_rs, Dh);
  const unsigned char* pad = a.kpad + (size_t)b * Lk;
  auto chunk_pairs = [&](int c) { return (min(KC, Lk - c * KC) + 15) / 16; };

  auto logits = [&](float (&s)[NT][4], unsigned padb, unsigned past) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[t][k] = logit(s[t][k], a.scale, padb, past, 2 * t + (k & 1));
  };

  // pass 1: each row's max and sum of exp, the sum rescaled as the max grows
  stage<DHP>(qs, make_src(a.q, a.q_f32, b * a.q_bs + h * a.q_hs, a.q_rs, Dh), q0, rows, Lq, Dh, g);
  stage<DHP>(kbuf, ksrc, 0, kcr, Lk, Dh, g);
  if (chunks == 1) stage<DHP>(vbuf, vsrc, 0, kcr, Lk, Dh, g);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) stage<DHP>(kbuf + ((c + 1) & 1) * kcr * LD, ksrc, (c + 1) * KC, KC, Lk, Dh, g);
    cp_async_commit();
    const int pairs = chunk_pairs(c), kc0 = c * KC, j0 = kc0 + 2 * tq;
    const unsigned padb = live ? byte_bits<NT>(pad + j0, Lk, j0, 2 * pairs) : 0u;
    cp_async_wait<1>();
    g.sync();
    if (live) {
      float s[NT][4];
      scores<DHP, NT>(s, qw, kbuf + (c & 1) * kcr * LD, pairs, lane);
      logits(s, padb, past_bits<NT>(Lk, j0));
      float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) cm[k >> 1] = fmaxf(cm[k >> 1], s[t][k]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float mn = fmaxf(m[hf], quad_max(cm[hf]));
        float part = 0.0f;
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int k = 2 * hf; k < 2 * hf + 2; ++k) part += expf(s[t][k] - mn);
        l[hf] = l[hf] * expf(m[hf] - mn) + quad_sum(part);
        m[hf] = mn;
      }
    }
    g.sync();  // the chunk's stage is read no more
  }

  // pass 2: the probabilities exp(x - max) / sum, dropped, rounded to bf16,
  // and P.V
  const bool dropping = a.drop != nullptr || a.keep.on;
  const unsigned char* dropb = a.drop == nullptr ? nullptr : a.drop + (size_t)bh * Lq * Lk;
  const unsigned site = a.keep.site + h;
  float o[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
  if (chunks > 1) {  // else chunk 0's K and V are still staged
    stage<DHP>(kbuf, ksrc, 0, KC, Lk, Dh, g);
    stage<DHP>(vbuf, vsrc, 0, KC, Lk, Dh, g);
  }
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage<DHP>(kbuf + ((c + 1) & 1) * kcr * LD, ksrc, (c + 1) * KC, KC, Lk, Dh, g);
      stage<DHP>(vbuf + ((c + 1) & 1) * kcr * LD, vsrc, (c + 1) * KC, KC, Lk, Dh, g);
    }
    cp_async_commit();
    const int pairs = chunk_pairs(c), kc0 = c * KC, j0 = kc0 + 2 * tq;
    unsigned padb = 0, keepb[2] = {0u, 0u};
    if (live) {
      padb = byte_bits<NT>(pad + j0, Lk, j0, 2 * pairs);
      if (dropping) {
        keepb[0] = keep_bits<NT>(a.keep, a.Lq, a.Lk, dropb, site, b, i0, j0, 2 * pairs);
        keepb[1] = keep_bits<NT>(a.keep, a.Lq, a.Lk, dropb, site, b, i0 + 8, j0, 2 * pairs);
      }
    }
    cp_async_wait<1>();
    g.sync();
    if (live) {
      float s[NT][4];
      scores<DHP, NT>(s, qw, kbuf + (c & 1) * kcr * LD, pairs, lane);
      logits(s, padb, past_bits<NT>(Lk, j0));
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int k = 0; k < 4; ++k) s[t][k] = expf(s[t][k] - m[k >> 1]);
      }
      normalise<NT>(s, l, NT);
      if (dropping) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            s[t][k] = (keepb[k >> 1] >> (2 * t + (k & 1))) & 1u ? s[t][k] * a.inv_keep : 0.0f;
        }
      }
      unsigned pa[NT / 2][4];
      probs_to_a<NT>(pa, s);
      pv<LD, NT, NC>(o, pa, vbuf + (c & 1) * kcr * LD + col0, pairs, lane);
    }
    g.sync();  // the chunk's stage (and, after the last, Q) is read no more
  }
  if (!live) return;
  store_out<LD, NC>(a, o, qw + col0, b, h, row0, col0, lane);
}

}  // namespace
