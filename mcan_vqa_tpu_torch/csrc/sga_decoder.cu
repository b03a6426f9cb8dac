// sga_decoder: every SGA decoder layer of MCAN in ONE cooperative launch.
//
// Replaces: mcan_vqa_tpu/ops/sga_block.py::fused_sga_decoder ->
//   _sga_decoder_kernel (body :483-575, call :606; serving mode 3: the
//   cross k/v projected inside from the final encoder output) and
//   ::fused_sga_decoder_extkv -> _sga_decoder_kernel_extkv (body :646-738,
//   call :772; modes 4 and 5: the cross k/v of every layer projected
//   outside, layer-major [B, L*H, Lq, Dh]).
//
// Per layer l, with a grid-wide barrier after each stage
// (csrc/persistent_stages.cuh):
//   1. qkv = bf16(x) . wqkv1[l] + bqkv1[l] -> bf16 [M, 3D]
//   2. self-attention over the sample's regions -> bf16 [M, D]
//   3. y = att . wm1[l] -> f32
//   4. v1 = LN1(x + (y + bm1[l])) -> f32 and bf16
//   5. qx = v1 . wq2[l] + bq2[l] -> bf16; in-kernel k/v (mode 3) also
//      kv = bf16(q) . wkv2[l] + bkv2[l] -> bf16 [B*Lq, 2D] (:548-550)
//   6. cross-attention against the question keys -> bf16
//   7. y = att . wm2[l] -> f32
//   8. v2 = LN2(v1 + (y + bm2[l]))
//   9. h = ReLU(v2 . w1[l] + b1[l]) -> bf16 [M, F]
//  10. y = h . w2[l] + b2[l] -> f32
//  11. x = LN3(v2 + y): f32 (and bf16 for the next layer's qkv)
// The image stream stays f32 from layer to layer and is rounded to the
// output type once, after the last layer (:502, :573; extkv :668, :736):
// unlike the per-block engine (mode 2), which casts every block's output
// to the stream type.
//
// Why one cooperative launch: the TPU kernel keeps every layer's weights
// (50.3 MB bf16 for MCAN-small with the cross k/v) resident in VMEM for the
// whole launch. No SM of an H100 holds more than 228 KB, so the weights
// stream from HBM (and the 50 MB L2) at every stage; what the single launch
// keeps is the TPU kernel's point for small batches -- one launch for the
// whole decoder where the per-block engine issues 12 per layer. Attention
// is per sample: the TPU kernel packs G samples under one collapsed mask
// (:505-516, :670-681), which lets a fully padded sample at G > 1 attend to
// its neighbours; here it takes a uniform softmax over its own keys, the
// model.apply result.
//
// Bounds on an H100 (chip_smoke.py [all-layer] computes them per call):
// MCAN-small at B = 1 by bytes, the 50.3 / 44.0 MB of weights (in-kernel /
// external k/v) over 3.35 TB/s, ~15 us; at B = 64 by operations, ~2.8
// GFLOP per sample at 989 TFLOP/s, ~0.18 ms. The 11 barriers a layer and
// the WMMA tiles keep it far above either.
#include <algorithm>

#include "persistent_stages.cuh"

namespace {

using namespace persistent;

enum Weight {
  W_QKV1, B_QKV1, W_M1, B_M1, LN1_S, LN1_B, W_KV2, B_KV2, W_Q2, B_Q2, W_M2, B_M2, LN2_S, LN2_B,
  W_1, B_1, W_2, B_2, LN3_S, LN3_B, N_WEIGHTS
};
enum Scratch { X32, XB, QKV, ATT, Y, V1, V1B, QX, V2, V2B, HB, QB, KV, N_SCRATCH };

struct Params {
  const void* v;   // [B, Lv, D] bf16 or f32
  int v_f32;
  const void* q;   // [B, Lq, D] bf16 or f32: in-kernel k/v; null: external
  int q_f32;
  const void* kq;  // external k/v: [b, l, h, j, d] at kq + b*kv_bs + l*kv_ls + h*kv_hs + j*kv_rs + d
  const void* vq;
  int kv_f32;
  long long kv_bs, kv_ls, kv_hs, kv_rs;
  const unsigned char* vpad;  // [B, Lv]
  const unsigned char* qpad;  // [B, Lq]
  const void* w[N_WEIGHTS];   // each stacked along a leading layer axis, contiguous
  void* s[N_SCRATCH];
  void* out;       // [B, Lv, D]
  int out_f32;
  int B, Lv, Lq, D, F, H, L;
  float scale, eps;
};

template <typename T>
__device__ __forceinline__ const T* layer(const Params& p, int w, int l, long long n) {
  return static_cast<const T*>(p.w[w]) + (size_t)l * n;
}

__global__ void __launch_bounds__(THREADS) sga_decoder_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F, M = p.B * p.Lv, Mq = p.B * p.Lq, Dh = D / p.H;
  const bool in_kernel_kv = p.q != nullptr;
  float* x32 = static_cast<float*>(p.s[X32]);
  bf16* xb = static_cast<bf16*>(p.s[XB]);
  bf16* qkv = static_cast<bf16*>(p.s[QKV]);
  bf16* att = static_cast<bf16*>(p.s[ATT]);
  float* y = static_cast<float*>(p.s[Y]);
  float* v1 = static_cast<float*>(p.s[V1]);
  bf16* v1b = static_cast<bf16*>(p.s[V1B]);
  bf16* qx = static_cast<bf16*>(p.s[QX]);
  float* v2 = static_cast<float*>(p.s[V2]);
  bf16* v2b = static_cast<bf16*>(p.s[V2B]);
  bf16* hb = static_cast<bf16*>(p.s[HB]);
  bf16* qb = static_cast<bf16*>(p.s[QB]);
  bf16* kv = static_cast<bf16*>(p.s[KV]);

  convert_stage(p.v, p.v_f32, (long long)M * D, x32, xb);
  if (in_kernel_kv) convert_stage(p.q, p.q_f32, (long long)Mq * D, nullptr, qb);
  grid_barrier();

  const long long DD = (long long)D * D;
  for (int l = 0; l < p.L; ++l) {
    const bool last = l == p.L - 1;
    // 1. the fused self-attention projection
    gemm_stage(GemmJob{xb, D, layer<bf16>(p, W_QKV1, l, 3 * DD), 3 * D, M, 3 * D, D,
                       layer<float>(p, B_QKV1, l, 3 * D), 0, nullptr, qkv, 3 * D},
               nullptr, smem);
    grid_barrier();
    // 2. self-attention: q, k, v are column blocks of qkv
    att_stage(AttJob{qkv, (long long)p.Lv * 3 * D, 3 * D, qkv + D, qkv + 2 * D, 0,
                     (long long)p.Lv * 3 * D, Dh, 3 * D, p.vpad, att, D, p.B, p.H, p.Lv, p.Lv,
                     Dh, p.scale},
              smem);
    grid_barrier();
    // 3. merge
    gemm_stage(GemmJob{att, D, layer<bf16>(p, W_M1, l, DD), D, M, D, D, nullptr, 0, y, nullptr,
                       D},
               nullptr, smem);
    grid_barrier();
    // 4. LN1
    ln_stage(LnJob{x32, y, layer<float>(p, B_M1, l, D), layer<float>(p, LN1_S, l, D),
                   layer<float>(p, LN1_B, l, D), v1, v1b, M, D, p.eps});
    grid_barrier();
    // 5. the cross query (and, in-kernel, the cross keys / values)
    const GemmJob kvjob{qb, D, layer<bf16>(p, W_KV2, l, 2 * DD), 2 * D, Mq, 2 * D, D,
                        layer<float>(p, B_KV2, l, 2 * D), 0, nullptr, kv, 2 * D};
    gemm_stage(GemmJob{v1b, D, layer<bf16>(p, W_Q2, l, DD), D, M, D, D,
                       layer<float>(p, B_Q2, l, D), 0, nullptr, qx, D},
               in_kernel_kv ? &kvjob : nullptr, smem);
    grid_barrier();
    // 6. cross-attention
    if (in_kernel_kv)
      att_stage(AttJob{qx, (long long)p.Lv * D, D, kv, kv + D, 0, (long long)p.Lq * 2 * D, Dh,
                       2 * D, p.qpad, att, D, p.B, p.H, p.Lv, p.Lq, Dh, p.scale},
                smem);
    else {
      const size_t lo = (size_t)l * p.kv_ls * (p.kv_f32 ? 4 : 2);
      att_stage(AttJob{qx, (long long)p.Lv * D, D, static_cast<const char*>(p.kq) + lo,
                       static_cast<const char*>(p.vq) + lo, p.kv_f32, p.kv_bs, p.kv_hs, p.kv_rs,
                       p.qpad, att, D, p.B, p.H, p.Lv, p.Lq, Dh, p.scale},
                smem);
    }
    grid_barrier();
    // 7. merge
    gemm_stage(GemmJob{att, D, layer<bf16>(p, W_M2, l, DD), D, M, D, D, nullptr, 0, y, nullptr,
                       D},
               nullptr, smem);
    grid_barrier();
    // 8. LN2
    ln_stage(LnJob{v1, y, layer<float>(p, B_M2, l, D), layer<float>(p, LN2_S, l, D),
                   layer<float>(p, LN2_B, l, D), v2, v2b, M, D, p.eps});
    grid_barrier();
    // 9. FFN up, ReLU, bf16 h
    gemm_stage(GemmJob{v2b, D, layer<bf16>(p, W_1, l, (long long)D * F), F, M, F, D,
                       layer<float>(p, B_1, l, F), 1, nullptr, hb, F},
               nullptr, smem);
    grid_barrier();
    // 10. FFN down
    gemm_stage(GemmJob{hb, F, layer<bf16>(p, W_2, l, (long long)F * D), D, M, D, F,
                       layer<float>(p, B_2, l, D), 0, y, nullptr, D},
               nullptr, smem);
    grid_barrier();
    // 11. LN3: the f32 stream, or after the last layer the output
    float* o32 = last ? (p.out_f32 ? static_cast<float*>(p.out) : nullptr) : x32;
    bf16* o16 = last ? (p.out_f32 ? nullptr : static_cast<bf16*>(p.out)) : xb;
    ln_stage(LnJob{v2, y, nullptr, layer<float>(p, LN3_S, l, D), layer<float>(p, LN3_B, l, D),
                   o32, o16, M, D, p.eps});
    if (!last) grid_barrier();
  }
}

}  // namespace

// v: [B, Lv, D] image stream, bf16 (v_f32 == 0) or f32; q: null, or [B, Lq,
// D] the final encoder output (bf16 or f32) for the in-kernel k/v; else kq,
// vq: every layer's cross keys / values, bf16 or f32, element [b, l, h, j,
// d] at kq + b*kv_bs + l*kv_ls + h*kv_hs + j*kv_rs + d (strides in
// elements; JAX's layer-major [B, L*H, Lq, Dh] has kv_ls = H*kv_hs).
// vpad / qpad: uint8 [B, Lv] / [B, Lq], 1 = PAD. w: host array of the 20
// stacked weights in the order wqkv1 [L, D, 3D], bqkv1 [L, 3D], wm1 [L, D,
// D], bm1, ln1_s, ln1_b [L, D], wkv2 [L, D, 2D], bkv2 [L, 2D] (both
// unused, may be null, with external k/v), wq2 [L, D, D], bq2, wm2, bm2,
// ln2_s, ln2_b, w1 [L, D, F], b1 [L, F], w2 [L, F, D], b2, ln3_s, ln3_b;
// matrices bf16, vectors f32, all contiguous. scratch: host array of the 13
// device buffers x32, xb, qkv, att, y, v1, v1b, qx, v2, v2b, h, qb, kv (f32
// where named 32 or y / v1 / v2, else bf16; [M, D] but qkv [M, 3D], h [M,
// F], qb [B*Lq, D], kv [B*Lq, 2D]; the last two only for the in-kernel
// k/v), each 16-byte aligned. out: [B, Lv, D], f32 when out_f32, else bf16.
// Requires D and F multiples of 8, D / H <= 256. info: see
// launch_cooperative. Returns the CUDA error of the launch.
MCAN_API int mcan_sga_decoder(const void* v, int v_f32, const void* q, int q_f32, const void* kq,
                              const void* vq, int kv_f32, long long kv_bs, long long kv_ls,
                              long long kv_hs, long long kv_rs, const void* vpad,
                              const void* qpad, const void* const* w, void* const* scratch,
                              void* out, int out_f32, int B, int Lv, int Lq, int D, int F, int H,
                              int L, float scale, float eps, int max_blocks, int* info,
                              void* stream) {
  if (B < 1 || Lv < 1 || Lq < 1 || L < 1 || H < 1 || D % H != 0 || D / H > MAX_DH || D % 8 != 0 ||
      F % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{v, v_f32, q, q_f32, kq, vq, kv_f32, kv_bs, kv_ls, kv_hs, kv_rs,
           static_cast<const unsigned char*>(vpad), static_cast<const unsigned char*>(qpad)};
  for (int i = 0; i < N_WEIGHTS; ++i) p.w[i] = w[i];
  for (int i = 0; i < N_SCRATCH; ++i) p.s[i] = scratch[i];
  p.out = out;
  p.out_f32 = out_f32;
  p.B = B;
  p.Lv = Lv;
  p.Lq = Lq;
  p.D = D;
  p.F = F;
  p.H = H;
  p.L = L;
  p.scale = scale;
  p.eps = eps;
  const int M = B * Lv, Mq = B * Lq, rows = (M + BM - 1) / BM;
  // the largest stage's work items: the FFN up, qkv or cross-q (+ k/v)
  // tiles, the attention items, the LayerNorm rows (WARPS to a block)
  const int useful = std::max(
      {rows * ((F + BN - 1) / BN), rows * ((3 * D + BN - 1) / BN),
       rows * ((D + BN - 1) / BN) + (q != nullptr ? ((Mq + BM - 1) / BM) * ((2 * D + BN - 1) / BN) : 0),
       B * H * ((Lv + QR - 1) / QR), (M + WARPS - 1) / WARPS});
  return persistent::launch_cooperative(sga_decoder_kernel, p, D / H, useful, max_blocks, info,
                                        static_cast<cudaStream_t>(stream));
}
