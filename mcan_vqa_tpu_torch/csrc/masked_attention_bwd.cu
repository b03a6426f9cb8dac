// masked_attention_bwd: the gradients of one head's masked attention with
// dropout on the probabilities, per (sample, head), for every head width
// Dh <= 128 (MCAN-small 64, MCAN-large 128) and Lq, Lk <= 128:
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
// FLOPs. Design (simple first): one block of 8 warps per (sample, head); q,
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

template <int DHP, int MAXL>
int launch(const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k,
           const void* v, long long kv_bs, long long kv_hs, long long kv_rs, int kv_f32,
           const void* kpad, const void* drop, const Philox& keep, float inv_keep,
           const void* dout, long long do_bs, long long do_rs, void* dq, void* dq16,
           long long dq_bs, long long dq_hs, long long dq_rs, void* dk, void* dk16,
           long long dk_bs, long long dk_hs, long long dk_rs, void* dv, void* dv16,
           long long dv_bs, long long dv_hs, long long dv_rs, int B, int H, int Lq, int Lk,
           int Dh, float scale, cudaStream_t s) {
  // > 48 KB: opt in, once per instantiation (a CUDA graph capture may
  // later record the launch, and the attribute call is no stream work)
  const int smem = static_cast<int>(sizeof(Smem<DHP, MAXL>));
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_kernel<DHP, MAXL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  masked_attention_bwd_kernel<DHP, MAXL><<<B * H, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), q_bs, q_hs, q_rs, k, v, kv_bs, kv_hs, kv_rs, kv_f32,
      static_cast<const unsigned char*>(kpad), static_cast<const unsigned char*>(drop), keep,
      inv_keep, static_cast<const bf16*>(dout), do_bs, do_rs, static_cast<float*>(dq),
      static_cast<bf16*>(dq16), dq_bs, dq_hs, dq_rs, static_cast<float*>(dk),
      static_cast<bf16*>(dk16), dk_bs, dk_hs, dk_rs, static_cast<float*>(dv),
      static_cast<bf16*>(dv16), dv_bs, dv_hs, dv_rs, H, Lq, Lk, Dh, scale);
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
// Requires 1 <= Dh <= 128 and 1 <= Lq, Lk <= 128. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another shape.
MCAN_API int mcan_masked_attention_bwd(
    const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k, const void* v,
    long long kv_bs, long long kv_hs, long long kv_rs, int kv_f32, const void* kpad,
    const void* drop, float inv_keep, int keep_on, unsigned seed, unsigned site,
    unsigned thresh, const void* dout, long long do_bs, long long do_rs,
    void* dq, void* dq16, long long dq_bs, long long dq_hs, long long dq_rs, void* dk,
    void* dk16, long long dk_bs, long long dk_hs, long long dk_rs, void* dv, void* dv16,
    long long dv_bs, long long dv_hs, long long dv_rs, int B, int H, int Lq, int Lk, int Dh,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh < 1 || Dh > 128 || Lq < 1 || Lq > 128 || Lk < 1 || Lk > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Philox keep{keep_on, seed, site, thresh, 0};
  const bool small = Lq <= 64 && Lk <= 64;
#define MCAN_BWD_ARGS q, q_bs, q_hs, q_rs, k, v, kv_bs, kv_hs, kv_rs, kv_f32, kpad, drop, keep, \
                      inv_keep, dout, do_bs, do_rs, dq, dq16, dq_bs, dq_hs, dq_rs, dk, dk16,     \
                      dk_bs, dk_hs, dk_rs, dv, dv16, dv_bs, dv_hs, dv_rs, B, H, Lq, Lk, Dh,     \
                      scale, s
#define MCAN_BWD_DH(MAXL)                                                     \
  switch ((Dh + 31) / 32) {                                                    \
    case 1: return launch<32, MAXL>(MCAN_BWD_ARGS);                           \
    case 2: return launch<64, MAXL>(MCAN_BWD_ARGS);                           \
    case 3: return launch<96, MAXL>(MCAN_BWD_ARGS);                           \
    default: return launch<128, MAXL>(MCAN_BWD_ARGS);                         \
  }
  if (small) { MCAN_BWD_DH(64) }
  MCAN_BWD_DH(128)
  return static_cast<int>(cudaErrorInvalidValue);
#undef MCAN_BWD_DH
#undef MCAN_BWD_ARGS
}
