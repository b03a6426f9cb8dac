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
//
// Bounds on an H100: Lq, Lk <= 128 and Dh <= 128 give at most 20 MFLOP
// per block -- bound by the latency of the loads and of the launch, not
// FLOPs. Design (simple first), for Dh <= 128 and Lq, Lk <= 128: one block
// of 8 warps per (sample, head); q,
// dO, k, v staged in bf16 dynamic shared memory, MAXL rows (64, or 128 for
// a longer sequence, chosen per call) by DHP columns (Dh rounded up to 32,
// zero past Dh; k and v rows padded to DHP + 2 so that lane j reading row j
// is free of bank conflicts): 49,664 bytes at Dh 64 and MAXL 64, 82,432 at
// Dh 128 and MAXL 64, 197,632 at Dh 128 and MAXL 128 (of the 232,448 a
// block may opt in to), opted in once per instantiation. Phase 1, one warp
// per query row: scores, softmax, dPd and dS in registers (lanes j + 32 s),
// dQ by shuffle broadcast of dS (lane l owns columns l, l + 32, ... below
// Dh); Pd and dS kept in shared memory. Phase 2, one warp per key row: dK
// and dV over the query rows. No atomics.
// Every other shape (Dh up to 256, any Lq, Lk) cannot hold the head in
// shared memory (the backward above already takes 197,632 bytes at Dh 128
// and 128 rows), so it runs as two kernels over chunks of 32 rows (DHP =
// Dh rounded up to 64, 128, 192 or 256; 66 KB of shared memory at 256):
// the rows kernel, a block per (sample, head, 32 query rows), makes a
// first pass over the key chunks for each row's max, sum and
// rowsum(P * drop(dPd)) (online, rescaled as the max grows), writes them
// to a scratch buffer, and a second pass that recomputes P per key chunk
// from them for dS and dQ; the keys kernel, a block per (sample, head, 32
// key rows), recomputes P and dS per query chunk from the saved row
// statistics for dK and dV. Both draw the forward's bits by the same
// (sample, head, i, j) counters, recompute the scores in the same order
// and round dS and Pd to bf16 as above.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <int DHP, int MAXL>
struct Smem {
  static constexpr int KPAD = DHP + 2;
  bf16 q[MAXL][DHP];
  bf16 dout[MAXL][DHP];
  bf16 k[MAXL][KPAD];
  bf16 v[MAXL][KPAD];
  bf16 pd[MAXL][MAXL];  // dropped probabilities
  bf16 ds[MAXL][MAXL];  // score gradients
};

// stage the head's k and v (bf16 or f32 in global memory) as bf16; rows
// past Lk and columns past Dh zero
template <typename KVT, int DHP, int MAXL>
__device__ __forceinline__ void stage_kv(const KVT* __restrict__ kb, const KVT* __restrict__ vb,
                                         long long kv_rs, int Lk, int Dh,
                                         Smem<DHP, MAXL>& s) {
  const bf16 zero = to_bf16(0.0f);
  for (int e = threadIdx.x; e < MAXL * DHP; e += THREADS) {
    const int r = e / DHP, d = e % DHP;
    const bool in = d < Dh && r < Lk;
    s.k[r][d] = in ? to_bf16(kb[r * kv_rs + d]) : zero;
    s.v[r][d] = in ? to_bf16(vb[r * kv_rs + d]) : zero;
  }
}

// k, v are f32 when kv_f32, else bf16: a uniform branch around the staging
// loop, so one instance serves both
template <int DHP, int MAXL>
__global__ void __launch_bounds__(THREADS)
masked_attention_bwd_kernel(const bf16* __restrict__ q, long long q_bs, long long q_hs,
                            long long q_rs, const void* __restrict__ k,
                            const void* __restrict__ v, long long kv_bs, long long kv_hs,
                            long long kv_rs, int kv_f32, const unsigned char* __restrict__ kpad,
                            const unsigned char* __restrict__ drop, Philox keep, float inv_keep,
                            const bf16* __restrict__ dout, long long do_bs, long long do_rs,
                            float* dq, bf16* dq16, long long dq_bs, long long dq_hs,
                            long long dq_rs, float* dk, bf16* dk16, long long dk_bs,
                            long long dk_hs, long long dk_rs, float* dv, bf16* dv16,
                            long long dv_bs, long long dv_hs, long long dv_rs, int H, int Lq,
                            int Lk, int Dh, float scale) {
  constexpr int C = DHP / 32;   // output columns per lane
  constexpr int S = MAXL / 32;  // score slots per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DHP, MAXL>& s = *reinterpret_cast<Smem<DHP, MAXL>*>(smem_raw);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + b * q_bs + h * q_hs;
  const long long kv_off = b * kv_bs + h * kv_hs;
  const bf16* dob = dout + b * do_bs + h * Dh;
  const bf16 zero = to_bf16(0.0f);

  // rows past Lq / Lk and columns past Dh are zero, so no lane reads
  // uninitialised values
  for (int e = tid; e < MAXL * DHP; e += THREADS) {
    const int r = e / DHP, d = e % DHP;
    const bool dd = d < Dh;
    s.q[r][d] = dd && r < Lq ? qb[r * q_rs + d] : zero;
    s.dout[r][d] = dd && r < Lq ? dob[r * do_rs + d] : zero;
  }
  if (kv_f32)
    stage_kv<float, DHP, MAXL>(static_cast<const float*>(k) + kv_off,
                               static_cast<const float*>(v) + kv_off, kv_rs, Lk, Dh, s);
  else
    stage_kv<bf16, DHP, MAXL>(static_cast<const bf16*>(k) + kv_off,
                              static_cast<const bf16*>(v) + kv_off, kv_rs, Lk, Dh, s);
  __syncthreads();

  const unsigned char* pad = kpad + (size_t)b * Lk;
  const unsigned char* dropb = drop == nullptr ? nullptr : drop + (size_t)blockIdx.x * Lq * Lk;
  const bool dropped = dropb != nullptr || keep.on;
  const unsigned site = keep.site + h;
  bool ok[S], padj[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int j = lane + 32 * t;
    ok[t] = j < Lk;
    padj[t] = ok[t] && pad[j];
  }

  // ---- phase 1: one warp per query row
  for (int i = warp; i < Lq; i += THREADS / 32) {
    // the forward's keep bits for the row first (bit t: key lane + 32 t)
    unsigned kbits = 0;
    if (keep.on) {
#pragma unroll 1
      for (int t = 0; t < S; ++t) {
        const int j = lane + 32 * t;
        if (j < Lk && philox_keep(keep, site, b, i * Lk + j)) kbits |= 1u << t;
      }
    }
    float sc[S], g[S];
#pragma unroll
    for (int t = 0; t < S; ++t) sc[t] = g[t] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < DHP; ++d) {
      const float qd = to_f32(s.q[i][d]), od = to_f32(s.dout[i][d]);
#pragma unroll
      for (int t = 0; t < S; ++t) {
        sc[t] += qd * to_f32(s.k[lane + 32 * t][d]);
        g[t] += od * to_f32(s.v[lane + 32 * t][d]);  // dPd[i, j]
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      sc[t] = padj[t] ? -1e9f : sc[t] * scale;
      if (ok[t]) mx = fmaxf(mx, sc[t]);
    }
    const float m = warp_max(mx);
    float p[S], part = 0.0f;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      p[t] = ok[t] ? expf(sc[t] - m) : 0.0f;
      part += p[t];
    }
    const float sum = warp_sum(part);
    const float scl = dropped ? inv_keep : 1.0f;
    float pd[S], dotp = 0.0f;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = lane + 32 * t;
      p[t] = p[t] / sum;
      bool kept = ok[t];
      if (dropb != nullptr) kept = kept && dropb[i * Lk + j];
      if (keep.on) kept = kept && ((kbits >> t) & 1u);
      pd[t] = kept ? p[t] * scl : 0.0f;
      g[t] = kept ? g[t] * scl : 0.0f;
      dotp += p[t] * g[t];
    }
    const float dot = warp_sum(dotp);
    float dsb[S];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = lane + 32 * t;
      // 0 at every PAD key of a row with a real key (there P is exactly 0)
      const bf16 db = to_bf16(p[t] * (g[t] - dot));
      s.pd[i][j] = to_bf16(pd[t]);
      s.ds[i][j] = db;
      dsb[t] = to_f32(db);
    }

    float a[C];  // dQ[i, d] for d = lane + 32 c
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = 0.0f;
    for (int j = 0; j < Lk; ++j) {
      float mine = dsb[0];
#pragma unroll
      for (int t = 1; t < S; ++t)
        if ((j >> 5) == t) mine = dsb[t];
      const float dj = __shfl_sync(0xffffffffu, mine, j & 31);
#pragma unroll
      for (int c = 0; c < C; ++c) a[c] += dj * to_f32(s.k[j][lane + 32 * c]);
    }
    const size_t o = (size_t)b * dq_bs + (size_t)h * dq_hs + (size_t)i * dq_rs;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (lane + 32 * c >= Dh) continue;
      const float val = a[c] * scale;
      dq[o + lane + 32 * c] = val;
      if (dq16 != nullptr) dq16[o + lane + 32 * c] = to_bf16(val);
    }
  }
  __syncthreads();

  // ---- phase 2: one warp per key row
  for (int j = warp; j < Lk; j += THREADS / 32) {
    float kk[C], vv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) kk[c] = vv[c] = 0.0f;
    for (int i = 0; i < Lq; ++i) {
      const float dsij = to_f32(s.ds[i][j]), pdij = to_f32(s.pd[i][j]);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kk[c] += dsij * to_f32(s.q[i][lane + 32 * c]);
        vv[c] += pdij * to_f32(s.dout[i][lane + 32 * c]);
      }
    }
    const size_t ok_ = (size_t)b * dk_bs + (size_t)h * dk_hs + (size_t)j * dk_rs;
    const size_t ov = (size_t)b * dv_bs + (size_t)h * dv_hs + (size_t)j * dv_rs;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d >= Dh) continue;
      const float kv = kk[c] * scale;
      dk[ok_ + d] = kv;
      dv[ov + d] = vv[c];
      if (dk16 != nullptr) dk16[ok_ + d] = to_bf16(kv);
      if (dv16 != nullptr) dv16[ov + d] = to_bf16(vv[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// the long kernels: Dh up to 256, any Lq and Lk
// ---------------------------------------------------------------------------

constexpr int LT = 32;       // rows per block and per chunk: one per lane
constexpr int LR = LT / 8;   // rows per warp: warp + 8 r

template <int DHP>
struct LongSmem {
  static constexpr int LD = DHP + 2;  // odd words per row: lane j reading row j is conflict-free
  bf16 a[LT][LD];  // rows kernel: the block's q; keys kernel: the block's k
  bf16 b[LT][LD];  // dout / v
  bf16 c[LT][LD];  // the chunk's k / q
  bf16 d[LT][LD];  // v / dout
  float st[LT][3]; // keys kernel: the chunk rows' max, sum, rowsum(P * drop(dPd))
};

struct Args {
  const bf16* q;
  long long q_bs, q_hs, q_rs;
  const void *k, *v;
  long long kv_bs, kv_hs, kv_rs;
  int kv_f32;
  const unsigned char* kpad;
  const unsigned char* drop;
  Philox keep;
  float inv_keep;
  const bf16* dout;
  long long do_bs, do_rs;
  float* stats;  // [B, H, Lq, 3]
  float *dq, *dk, *dv;
  bf16 *dq16, *dk16, *dv16;
  long long dq_bs, dq_hs, dq_rs, dk_bs, dk_hs, dk_rs, dv_bs, dv_hs, dv_rs;
  int B, H, Lq, Lk, Dh;
  float scale;
};

// rows [r0, r0 + LT) of a [L, Dh] matrix (row stride rs; bf16 or f32) as
// bf16 into dst, zero past L and past Dh
template <typename T, int DHP, int LD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long rs, int r0,
                                           int L, int Dh, bf16 (*dst)[LD]) {
  const bf16 zero = to_bf16(0.0f);
  for (int e = threadIdx.x; e < LT * DHP; e += THREADS) {
    const int r = e / DHP, d = e % DHP;
    dst[r][d] = d < Dh && r0 + r < L ? to_bf16(src[(r0 + r) * rs + d]) : zero;
  }
}

template <int DHP, int LD>
__device__ __forceinline__ void stage_kv_rows(const Args& a, const void* base, long long off,
                                              int r0, bf16 (*dst)[LD]) {
  if (a.kv_f32)
    stage_rows<float, DHP, LD>(static_cast<const float*>(base) + off, a.kv_rs, r0, a.Lk, a.Dh,
                               dst);
  else
    stage_rows<bf16, DHP, LD>(static_cast<const bf16*>(base) + off, a.kv_rs, r0, a.Lk, a.Dh,
                              dst);
}

// the keep of (query i, key j): the external mask's or the drawn bit
__device__ __forceinline__ bool kept_at(const Args& a, const unsigned char* dropb, unsigned site,
                                        int b, int i, int j) {
  if (dropb != nullptr) return dropb[(size_t)i * a.Lk + j] != 0;
  if (a.keep.on) return philox_keep(a.keep, site, b, i * a.Lk + j);
  return true;
}

template <int DHP>
__global__ void __launch_bounds__(THREADS) attention_bwd_rows_kernel(const Args a) {
  constexpr int C = DHP / 32;
  using Sm = LongSmem<DHP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int i0 = blockIdx.y * LT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Lq = a.Lq, Lk = a.Lk;
  const long long kv_off = b * a.kv_bs + h * a.kv_hs;
  stage_rows<bf16, DHP, Sm::LD>(a.q + b * a.q_bs + h * a.q_hs, a.q_rs, i0, Lq, a.Dh, s.a);
  stage_rows<bf16, DHP, Sm::LD>(a.dout + b * a.do_bs + h * a.Dh, a.do_rs, i0, Lq, a.Dh, s.b);
  const unsigned char* pad = a.kpad + (size_t)b * Lk;
  const unsigned char* dropb = a.drop == nullptr ? nullptr
                                                 : a.drop + (size_t)blockIdx.x * Lq * Lk;
  const bool dropped = dropb != nullptr || a.keep.on;
  const float scl = dropped ? a.inv_keep : 1.0f;
  const unsigned site = a.keep.site + h;

  // this lane's key j of the chunk against the warp's rows: scores and dPd
  auto products = [&](float (&sc)[LR], float (&g)[LR]) {
#pragma unroll
    for (int r = 0; r < LR; ++r) sc[r] = g[r] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DHP; ++d) {
      const float kd = to_f32(s.c[lane][d]), vd = to_f32(s.d[lane][d]);
#pragma unroll
      for (int r = 0; r < LR; ++r) {
        sc[r] += to_f32(s.a[warp + 8 * r][d]) * kd;
        g[r] += to_f32(s.b[warp + 8 * r][d]) * vd;
      }
    }
  };
  // the keep bits of the warp's rows against this lane's key (bit r)
  auto keep_bits = [&](int j) {
    unsigned bits = 0;
#pragma unroll 1
    for (int r = 0; r < LR; ++r) {
      const int i = i0 + warp + 8 * r;
      if (j < Lk && i < Lq && kept_at(a, dropb, site, b, i, j)) bits |= 1u << r;
    }
    return bits;
  };

  // pass 1: max, sum of exp and sum of exp * drop(dPd), rescaled as the max grows
  float m[LR], l[LR], t[LR];
#pragma unroll
  for (int r = 0; r < LR; ++r) {
    m[r] = -INFINITY;
    l[r] = t[r] = 0.0f;
  }
  for (int kc = 0; kc < Lk; kc += LT) {
    __syncthreads();
    stage_kv_rows<DHP, Sm::LD>(a, a.k, kv_off, kc, s.c);
    stage_kv_rows<DHP, Sm::LD>(a, a.v, kv_off, kc, s.d);
    __syncthreads();
    const int j = kc + lane;
    const bool okj = j < Lk, padj = okj && pad[j];
    const unsigned kb = keep_bits(j);
    float sc[LR], g[LR];
    products(sc, g);
#pragma unroll
    for (int r = 0; r < LR; ++r) {
      const float x = padj ? -1e9f : sc[r] * a.scale;
      const float mn = fmaxf(m[r], warp_max(okj ? x : -INFINITY));
      const float e = okj ? expf(x - mn) : 0.0f;
      const float gd = (kb >> r) & 1u ? g[r] * scl : 0.0f;
      const float f = expf(m[r] - mn);
      l[r] = l[r] * f + warp_sum(e);
      t[r] = t[r] * f + warp_sum(e * gd);
      m[r] = mn;
    }
  }
  float dot[LR];
#pragma unroll
  for (int r = 0; r < LR; ++r) {
    const int i = i0 + warp + 8 * r;
    dot[r] = t[r] / l[r];
    if (lane == 0 && i < Lq) {
      float* st = a.stats + ((size_t)blockIdx.x * Lq + i) * 3;
      st[0] = m[r];
      st[1] = l[r];
      st[2] = dot[r];
    }
  }

  // pass 2: P, dS = P * (drop(dPd) - dot) rounded to bf16, dQ = dS k
  float acc[LR][C];
#pragma unroll
  for (int r = 0; r < LR; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
  for (int kc = 0; kc < Lk; kc += LT) {
    __syncthreads();
    stage_kv_rows<DHP, Sm::LD>(a, a.k, kv_off, kc, s.c);
    stage_kv_rows<DHP, Sm::LD>(a, a.v, kv_off, kc, s.d);
    __syncthreads();
    const int j = kc + lane;
    const bool okj = j < Lk, padj = okj && pad[j];
    const unsigned kb = keep_bits(j);
    float sc[LR], g[LR], ds[LR];
    products(sc, g);
#pragma unroll
    for (int r = 0; r < LR; ++r) {
      const float x = padj ? -1e9f : sc[r] * a.scale;
      const float p = okj ? expf(x - m[r]) / l[r] : 0.0f;
      const float gd = (kb >> r) & 1u ? g[r] * scl : 0.0f;
      ds[r] = to_f32(to_bf16(p * (gd - dot[r])));
    }
    const int n = min(LT, Lk - kc);
    for (int jj = 0; jj < n; ++jj) {
#pragma unroll
      for (int r = 0; r < LR; ++r) {
        const float dj = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] += dj * to_f32(s.c[jj][lane + 32 * c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < LR; ++r) {
    const int i = i0 + warp + 8 * r;
    if (i >= Lq) continue;
    const size_t o = (size_t)b * a.dq_bs + (size_t)h * a.dq_hs + (size_t)i * a.dq_rs;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d >= a.Dh) continue;
      const float val = acc[r][c] * a.scale;
      a.dq[o + d] = val;
      if (a.dq16 != nullptr) a.dq16[o + d] = to_bf16(val);
    }
  }
}

template <int DHP>
__global__ void __launch_bounds__(THREADS) attention_bwd_keys_kernel(const Args a) {
  constexpr int C = DHP / 32;
  using Sm = LongSmem<DHP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int j0 = blockIdx.y * LT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Lq = a.Lq, Lk = a.Lk;
  const long long kv_off = b * a.kv_bs + h * a.kv_hs;
  stage_kv_rows<DHP, Sm::LD>(a, a.k, kv_off, j0, s.a);
  stage_kv_rows<DHP, Sm::LD>(a, a.v, kv_off, j0, s.b);
  const unsigned char* pad = a.kpad + (size_t)b * Lk;
  const unsigned char* dropb = a.drop == nullptr ? nullptr
                                                 : a.drop + (size_t)blockIdx.x * Lq * Lk;
  const bool dropped = dropb != nullptr || a.keep.on;
  const float scl = dropped ? a.inv_keep : 1.0f;
  const unsigned site = a.keep.site + h;
  const bf16* qb = a.q + b * a.q_bs + h * a.q_hs;
  const bf16* dob = a.dout + b * a.do_bs + h * a.Dh;
  const float* stats = a.stats + (size_t)blockIdx.x * Lq * 3;

  float dk[LR][C], dv[LR][C];
#pragma unroll
  for (int r = 0; r < LR; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[r][c] = dv[r][c] = 0.0f;
  for (int ic = 0; ic < Lq; ic += LT) {
    __syncthreads();
    stage_rows<bf16, DHP, Sm::LD>(qb, a.q_rs, ic, Lq, a.Dh, s.c);
    stage_rows<bf16, DHP, Sm::LD>(dob, a.do_rs, ic, Lq, a.Dh, s.d);
    for (int e = threadIdx.x; e < LT * 3; e += THREADS)
      s.st[e / 3][e % 3] = ic + e / 3 < Lq ? stats[(size_t)ic * 3 + e] : 0.0f;
    __syncthreads();
    // this lane's query row i against the warp's keys j = j0 + warp + 8 r
    const int i = ic + lane;
    const bool oki = i < Lq;
    unsigned kb = 0;
#pragma unroll 1
    for (int r = 0; r < LR; ++r) {
      const int j = j0 + warp + 8 * r;
      if (oki && j < Lk && kept_at(a, dropb, site, b, i, j)) kb |= 1u << r;
    }
    float sc[LR], g[LR];
#pragma unroll
    for (int r = 0; r < LR; ++r) sc[r] = g[r] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DHP; ++d) {
      const float qd = to_f32(s.c[lane][d]), od = to_f32(s.d[lane][d]);
#pragma unroll
      for (int r = 0; r < LR; ++r) {
        sc[r] += qd * to_f32(s.a[warp + 8 * r][d]);
        g[r] += od * to_f32(s.b[warp + 8 * r][d]);
      }
    }
    const float mi = s.st[lane][0], li = s.st[lane][1], doti = s.st[lane][2];
    float ds[LR], pd[LR];
#pragma unroll
    for (int r = 0; r < LR; ++r) {
      const int j = j0 + warp + 8 * r;
      const bool ok = oki && j < Lk;
      const float x = ok && pad[j] ? -1e9f : sc[r] * a.scale;
      const float p = ok ? expf(x - mi) / li : 0.0f;
      const bool kept = (kb >> r) & 1u;
      const float gd = kept ? g[r] * scl : 0.0f;
      ds[r] = to_f32(to_bf16(p * (gd - doti)));
      pd[r] = to_f32(to_bf16(kept ? p * scl : 0.0f));
    }
    const int n = min(LT, Lq - ic);
    for (int ii = 0; ii < n; ++ii) {
#pragma unroll
      for (int r = 0; r < LR; ++r) {
        const float dsi = __shfl_sync(0xffffffffu, ds[r], ii);
        const float pdi = __shfl_sync(0xffffffffu, pd[r], ii);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dk[r][c] += dsi * to_f32(s.c[ii][lane + 32 * c]);
          dv[r][c] += pdi * to_f32(s.d[ii][lane + 32 * c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < LR; ++r) {
    const int j = j0 + warp + 8 * r;
    if (j >= Lk) continue;
    const size_t ok_ = (size_t)b * a.dk_bs + (size_t)h * a.dk_hs + (size_t)j * a.dk_rs;
    const size_t ov = (size_t)b * a.dv_bs + (size_t)h * a.dv_hs + (size_t)j * a.dv_rs;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d >= a.Dh) continue;
      const float kv = dk[r][c] * a.scale;
      a.dk[ok_ + d] = kv;
      a.dv[ov + d] = dv[r][c];
      if (a.dk16 != nullptr) a.dk16[ok_ + d] = to_bf16(kv);
      if (a.dv16 != nullptr) a.dv16[ov + d] = to_bf16(dv[r][c]);
    }
  }
}

// opt in once per instantiation (a CUDA graph capture may later record the
// launch, and the attribute call is no stream work)
template <typename Kernel>
int opt_in(Kernel kernel, int smem, bool& done) {
  if (!done) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    done = true;
  }
  return 0;
}

template <int DHP, int MAXL>
int launch(const Args& a, cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(Smem<DHP, MAXL>));  // past 48 KB
  static bool opted_in = false;
  if (int err = opt_in(masked_attention_bwd_kernel<DHP, MAXL>, smem, opted_in)) return err;
  masked_attention_bwd_kernel<DHP, MAXL><<<a.B * a.H, THREADS, smem, s>>>(
      a.q, a.q_bs, a.q_hs, a.q_rs, a.k, a.v, a.kv_bs, a.kv_hs, a.kv_rs, a.kv_f32, a.kpad,
      a.drop, a.keep, a.inv_keep, a.dout, a.do_bs, a.do_rs, a.dq, a.dq16, a.dq_bs, a.dq_hs,
      a.dq_rs, a.dk, a.dk16, a.dk_bs, a.dk_hs, a.dk_rs, a.dv, a.dv16, a.dv_bs, a.dv_hs, a.dv_rs,
      a.H, a.Lq, a.Lk, a.Dh, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int MAXL>
int launch_dh(const Args& a, cudaStream_t s) {
  switch ((a.Dh + 31) / 32) {
    case 1: return launch<32, MAXL>(a, s);
    case 2: return launch<64, MAXL>(a, s);
    case 3: return launch<96, MAXL>(a, s);
    default: return launch<128, MAXL>(a, s);
  }
}

template <int DHP>
int launch_long(const Args& a, cudaStream_t s) {
  constexpr int smem = static_cast<int>(sizeof(LongSmem<DHP>));
  static bool rows_in = false, keys_in = false;
  if (int err = opt_in(attention_bwd_rows_kernel<DHP>, smem, rows_in)) return err;
  if (int err = opt_in(attention_bwd_keys_kernel<DHP>, smem, keys_in)) return err;
  attention_bwd_rows_kernel<DHP><<<dim3(a.B * a.H, (a.Lq + LT - 1) / LT), THREADS, smem, s>>>(a);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  attention_bwd_keys_kernel<DHP><<<dim3(a.B * a.H, (a.Lk + LT - 1) / LT), THREADS, smem, s>>>(a);
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
// Requires 1 <= Dh <= 256 and Lq, Lk >= 1: Dh <= 128 with Lq, Lk <= 128
// takes the one-block-per-head kernel; any other shape the two long
// kernels, which need `stats`, f32 scratch of B * H * Lq * 3. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another shape.
MCAN_API int mcan_masked_attention_bwd(
    const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k, const void* v,
    long long kv_bs, long long kv_hs, long long kv_rs, int kv_f32, const void* kpad,
    const void* drop, float inv_keep, int keep_on, unsigned seed, unsigned site,
    unsigned thresh, const void* dout, long long do_bs, long long do_rs,
    void* dq, void* dq16, long long dq_bs, long long dq_hs, long long dq_rs, void* dk,
    void* dk16, long long dk_bs, long long dk_hs, long long dk_rs, void* dv, void* dv16,
    long long dv_bs, long long dv_hs, long long dv_rs, void* stats, int B, int H, int Lq,
    int Lk, int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one_block = Dh <= 128 && Lq <= 128 && Lk <= 128;
  if (Dh < 1 || Dh > 256 || Lq < 1 || Lk < 1 || (!one_block && stats == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const bf16*>(q), q_bs, q_hs, q_rs, k, v, kv_bs, kv_hs, kv_rs, kv_f32,
               static_cast<const unsigned char*>(kpad), static_cast<const unsigned char*>(drop),
               Philox{keep_on, seed, site, thresh, 0}, inv_keep, static_cast<const bf16*>(dout),
               do_bs, do_rs, static_cast<float*>(stats), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv), static_cast<bf16*>(dq16),
               static_cast<bf16*>(dk16), static_cast<bf16*>(dv16), dq_bs, dq_hs, dq_rs, dk_bs,
               dk_hs, dk_rs, dv_bs, dv_hs, dv_rs, B, H, Lq, Lk, Dh, scale};
  if (one_block) return Lq <= 64 && Lk <= 64 ? launch_dh<64>(a, s) : launch_dh<128>(a, s);
  if (Dh <= 64) return launch_long<64>(a, s);
  if (Dh <= 128) return launch_long<128>(a, s);
  if (Dh <= 192) return launch_long<192>(a, s);
  return launch_long<256>(a, s);
}
