// masked_attention_bwd: the gradients of one head's masked attention with
// dropout on the probabilities, per (sample, head), for head widths Dh = 64
// (MCAN-small) and Dh = 128 (MCAN-large):
//   P = softmax(q k^T / sqrt(Dh), PAD keys -> -1e9)  (recomputed from q, k)
//   Pd = drop(P)                                      (keep-mask x inv_keep)
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
// Bounds on an H100: Lq, Lk <= 64 and Dh <= 128 give at most 5 MFLOP per
// block -- bound by the latency of the loads and of the launch, not FLOPs.
// Design (simple first): one block of 8 warps per (sample, head); q, dO, k,
// v staged in bf16 dynamic shared memory (k and v rows padded to Dh + 2 so
// that lane j reading row j is free of bank conflicts; 49,664 bytes at Dh
// 64, 82,432 at Dh 128, opted in once per instantiation). Phase 1, one warp
// per query row: scores, softmax, dPd and dS in registers (lanes j and
// j + 32), dQ by shuffle broadcast of dS (lane l owns columns l, l + 32,
// ...); Pd and dS kept in shared memory. Phase 2, one warp per key row: dK
// and dV over the query rows. No atomics.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAXL = 64, THREADS = 256;

template <int DH>
struct Smem {
  static constexpr int KPAD = DH + 2;
  bf16 q[MAXL][DH];
  bf16 dout[MAXL][DH];
  bf16 k[MAXL][KPAD];
  bf16 v[MAXL][KPAD];
  bf16 pd[MAXL][MAXL];  // dropped probabilities
  bf16 ds[MAXL][MAXL];  // score gradients
};

template <typename KVT, int DH>
__global__ void __launch_bounds__(THREADS)
masked_attention_bwd_kernel(const bf16* __restrict__ q, long long q_bs, long long q_hs,
                            long long q_rs, const KVT* __restrict__ k,
                            const KVT* __restrict__ v, long long kv_bs, long long kv_hs,
                            long long kv_rs, const unsigned char* __restrict__ kpad,
                            const unsigned char* __restrict__ drop, float inv_keep,
                            const bf16* __restrict__ dout, long long do_bs, long long do_rs,
                            float* dq, bf16* dq16, long long dq_bs, long long dq_hs,
                            long long dq_rs, float* dk, bf16* dk16, long long dk_bs,
                            long long dk_hs, long long dk_rs, float* dv, bf16* dv16,
                            long long dv_bs, long long dv_hs, long long dv_rs, int H, int Lq,
                            int Lk, float scale) {
  constexpr int C = DH / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qb = q + b * q_bs + h * q_hs;
  const KVT* kb = k + b * kv_bs + h * kv_hs;
  const KVT* vb = v + b * kv_bs + h * kv_hs;
  const bf16* dob = dout + b * do_bs + h * DH;
  const bf16 zero = to_bf16(0.0f);

  // rows past Lq / Lk are zero, so no lane reads uninitialised values
  for (int e = tid; e < MAXL * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    s.q[r][d] = r < Lq ? qb[r * q_rs + d] : zero;
    s.dout[r][d] = r < Lq ? dob[r * do_rs + d] : zero;
    s.k[r][d] = r < Lk ? to_bf16(kb[r * kv_rs + d]) : zero;
    s.v[r][d] = r < Lk ? to_bf16(vb[r * kv_rs + d]) : zero;
  }
  __syncthreads();

  const unsigned char* pad = kpad + (size_t)b * Lk;
  const unsigned char* dropb = drop == nullptr ? nullptr : drop + (size_t)blockIdx.x * Lq * Lk;
  const int j0 = lane, j1 = lane + 32;
  const bool ok0 = j0 < Lk, ok1 = j1 < Lk;
  const bool pad0 = ok0 && pad[j0], pad1 = ok1 && pad[j1];

  // ---- phase 1: one warp per query row
  for (int i = warp; i < Lq; i += THREADS / 32) {
    float s0 = 0.0f, s1 = 0.0f, g0 = 0.0f, g1 = 0.0f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      const float qd = to_f32(s.q[i][d]), od = to_f32(s.dout[i][d]);
      s0 += qd * to_f32(s.k[j0][d]);
      s1 += qd * to_f32(s.k[j1][d]);
      g0 += od * to_f32(s.v[j0][d]);  // dPd[i, j]
      g1 += od * to_f32(s.v[j1][d]);
    }
    s0 = pad0 ? -1e9f : s0 * scale;
    s1 = pad1 ? -1e9f : s1 * scale;
    const float m = warp_max(fmaxf(ok0 ? s0 : -INFINITY, ok1 ? s1 : -INFINITY));
    const float e0 = ok0 ? expf(s0 - m) : 0.0f;
    const float e1 = ok1 ? expf(s1 - m) : 0.0f;
    const float sum = warp_sum(e0 + e1);
    const float p0 = e0 / sum, p1 = e1 / sum;
    const bool keep0 = ok0 && (dropb == nullptr || dropb[i * Lk + j0]);
    const bool keep1 = ok1 && (dropb == nullptr || dropb[i * Lk + j1]);
    const float scl = dropb == nullptr ? 1.0f : inv_keep;
    const float pd0 = keep0 ? p0 * scl : 0.0f, pd1 = keep1 ? p1 * scl : 0.0f;
    g0 = keep0 ? g0 * scl : 0.0f;
    g1 = keep1 ? g1 * scl : 0.0f;
    const float dot = warp_sum(p0 * g0 + p1 * g1);
    // 0 at every PAD key of a row with a real key (there P is exactly 0)
    const float ds0 = p0 * (g0 - dot);
    const float ds1 = p1 * (g1 - dot);
    const bf16 db0 = to_bf16(ds0), db1 = to_bf16(ds1);
    s.pd[i][j0] = to_bf16(pd0);
    s.pd[i][j1] = to_bf16(pd1);
    s.ds[i][j0] = db0;
    s.ds[i][j1] = db1;

    const float dsb0 = to_f32(db0), dsb1 = to_f32(db1);
    float a[C];  // dQ[i, d] for d = lane + 32 c
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = 0.0f;
    for (int j = 0; j < Lk; ++j) {
      const float dj = __shfl_sync(0xffffffffu, j < 32 ? dsb0 : dsb1, j & 31);
#pragma unroll
      for (int c = 0; c < C; ++c) a[c] += dj * to_f32(s.k[j][lane + 32 * c]);
    }
    const size_t o = (size_t)b * dq_bs + (size_t)h * dq_hs + (size_t)i * dq_rs;
#pragma unroll
    for (int c = 0; c < C; ++c) {
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
    const size_t ok = (size_t)b * dk_bs + (size_t)h * dk_hs + (size_t)j * dk_rs;
    const size_t ov = (size_t)b * dv_bs + (size_t)h * dv_hs + (size_t)j * dv_rs;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      const float kv = kk[c] * scale;
      dk[ok + d] = kv;
      dv[ov + d] = vv[c];
      if (dk16 != nullptr) dk16[ok + d] = to_bf16(kv);
      if (dv16 != nullptr) dv16[ov + d] = to_bf16(vv[c]);
    }
  }
}

template <typename KVT, int DH>
int launch(const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k,
           const void* v, long long kv_bs, long long kv_hs, long long kv_rs, const void* kpad,
           const void* drop, float inv_keep, const void* dout, long long do_bs, long long do_rs,
           void* dq, void* dq16, long long dq_bs, long long dq_hs, long long dq_rs, void* dk,
           void* dk16, long long dk_bs, long long dk_hs, long long dk_rs, void* dv, void* dv16,
           long long dv_bs, long long dv_hs, long long dv_rs, int B, int H, int Lq, int Lk,
           float scale, cudaStream_t s) {
  // > 48 KB: opt in, once per instantiation (a CUDA graph capture may
  // later record the launch, and the attribute call is no stream work)
  const int smem = static_cast<int>(sizeof(Smem<DH>));
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_kernel<KVT, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  masked_attention_bwd_kernel<KVT, DH><<<B * H, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), q_bs, q_hs, q_rs, static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), kv_bs, kv_hs, kv_rs, static_cast<const unsigned char*>(kpad),
      static_cast<const unsigned char*>(drop), inv_keep, static_cast<const bf16*>(dout), do_bs,
      do_rs, static_cast<float*>(dq), static_cast<bf16*>(dq16), dq_bs, dq_hs, dq_rs,
      static_cast<float*>(dk), static_cast<bf16*>(dk16), dk_bs, dk_hs, dk_rs,
      static_cast<float*>(dv), static_cast<bf16*>(dv16), dv_bs, dv_hs, dv_rs, H, Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: bf16, [b, h, i, d] at q + b*q_bs + h*q_hs + i*q_rs + d; k, v: bf16
// (kv_f32 == 0) or f32 with shared strides; kpad uint8 [B, Lk] (1 = PAD);
// drop: null or uint8 keep-mask [B, H, Lq, Lk] contiguous; dout: bf16,
// [b, i, h*Dh + d] at dout + b*do_bs + i*do_rs + h*Dh + d. dq/dk/dv: f32,
// [b, h, row, d] at base + b*bs + h*hs + row*rs + d; the bf16 copies
// dq16/dk16/dv16 (each may be null) share their f32 twin's strides.
// Requires Dh = 64 or 128 and 1 <= Lq, Lk <= 64. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another Dh.
MCAN_API int mcan_masked_attention_bwd(
    const void* q, long long q_bs, long long q_hs, long long q_rs, const void* k, const void* v,
    long long kv_bs, long long kv_hs, long long kv_rs, int kv_f32, const void* kpad,
    const void* drop, float inv_keep, const void* dout, long long do_bs, long long do_rs,
    void* dq, void* dq16, long long dq_bs, long long dq_hs, long long dq_rs, void* dk,
    void* dk16, long long dk_bs, long long dk_hs, long long dk_rs, void* dv, void* dv16,
    long long dv_bs, long long dv_hs, long long dv_rs, int B, int H, int Lq, int Lk, int Dh,
    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh != 64 && Dh != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
#define MCAN_BWD_ARGS q, q_bs, q_hs, q_rs, k, v, kv_bs, kv_hs, kv_rs, kpad, drop, inv_keep, dout, \
                      do_bs, do_rs, dq, dq16, dq_bs, dq_hs, dq_rs, dk, dk16, dk_bs, dk_hs, dk_rs, \
                      dv, dv16, dv_bs, dv_hs, dv_rs, B, H, Lq, Lk, scale, s
  if (kv_f32)
    return Dh == 64 ? launch<float, 64>(MCAN_BWD_ARGS) : launch<float, 128>(MCAN_BWD_ARGS);
  return Dh == 64 ? launch<bf16, 64>(MCAN_BWD_ARGS) : launch<bf16, 128>(MCAN_BWD_ARGS);
#undef MCAN_BWD_ARGS
}
