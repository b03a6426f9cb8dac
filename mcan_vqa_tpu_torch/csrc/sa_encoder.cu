// sa_encoder: every SA encoder layer of MCAN in ONE cooperative launch.
//
// Replaces: mcan_vqa_tpu/ops/sga_block.py::fused_sa_encoder ->
//   _sa_encoder_kernel (body :848-911, call :938; serving mode 5, the
//   latency engine: the whole encoder in one launch, the whole decoder in
//   another, csrc/sga_decoder.cu).
//
// Per layer l, with a grid-wide barrier after each stage
// (csrc/persistent_stages.cuh):
//   1. qkv = bf16(x) . wqkv[l] + bqkv[l] -> bf16 [M, 3D] (q rounded to
//      bf16 before the scores, :882)
//   2. self-attention over the sample's tokens -> bf16 [M, D]
//   3. y = att . wm[l] -> f32
//   4. x1 = LN1(x + (y + bm[l])) -> f32 and bf16
//   5. h = ReLU(x1 . w1[l] + b1[l]) -> bf16 [M, F]
//   6. y = h . w2[l] + b2[l] -> f32
//   7. x = LN2(x1 + y): f32 (and bf16 for the next layer's qkv)
// The question stream stays f32 from layer to layer and is rounded to the
// output type once, after the last layer (:865, :910).
//
// Why one cooperative launch: the TPU kernel keeps every layer's weights
// (37.7 MB bf16 for MCAN-small) resident in VMEM for the whole launch; an
// H100 SM holds 228 KB, so the weights stream from HBM (and the 50 MB L2)
// stage by stage, and the one launch keeps what the TPU kernel was built
// for at B = 1: one launch for the encoder where the per-block engine
// issues 7 per layer. Attention is per sample: the TPU kernel packs G
// samples (auto G = 128 // Lq: 9 at 14 tokens, reduced to divide B) under
// one collapsed mask (:870-874), which lets an all-PAD question attend to
// its neighbours' tokens; here it takes a uniform softmax over its own.
//
// Bounds on an H100 (chip_smoke.py [all-layer] computes them per call):
// MCAN-small at B = 1 by bytes (37.7 MB of weights, ~11 us); at B = 64 by
// operations (~0.034 ms). At 14 tokens a sample the GEMM stages have one
// or a few row tiles: latency-bound, far above either.
#include <algorithm>

#include "persistent_stages.cuh"

namespace {

using namespace persistent;

enum Weight { W_QKV, B_QKV, W_M, B_M, LN1_S, LN1_B, W_1, B_1, W_2, B_2, LN2_S, LN2_B, N_WEIGHTS };
enum Scratch { X32, XB, QKV, ATT, Y, X1, X1B, HB, N_SCRATCH };

struct Params {
  const void* x;   // [B, Lq, D] bf16 or f32
  int x_f32;
  const unsigned char* pad;  // [B, Lq]
  const void* w[N_WEIGHTS];  // each stacked along a leading layer axis, contiguous
  void* s[N_SCRATCH];
  void* out;       // [B, Lq, D]
  int out_f32;
  int B, Lq, D, F, H, L;
  float scale, eps;
};

template <typename T>
__device__ __forceinline__ const T* layer(const Params& p, int w, int l, long long n) {
  return static_cast<const T*>(p.w[w]) + (size_t)l * n;
}

__global__ void __launch_bounds__(THREADS) sa_encoder_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F, M = p.B * p.Lq, Dh = D / p.H;
  float* x32 = static_cast<float*>(p.s[X32]);
  bf16* xb = static_cast<bf16*>(p.s[XB]);
  bf16* qkv = static_cast<bf16*>(p.s[QKV]);
  bf16* att = static_cast<bf16*>(p.s[ATT]);
  float* y = static_cast<float*>(p.s[Y]);
  float* x1 = static_cast<float*>(p.s[X1]);
  bf16* x1b = static_cast<bf16*>(p.s[X1B]);
  bf16* hb = static_cast<bf16*>(p.s[HB]);

  convert_stage(p.x, p.x_f32, (long long)M * D, x32, xb);
  grid_barrier();

  const long long DD = (long long)D * D;
  for (int l = 0; l < p.L; ++l) {
    const bool last = l == p.L - 1;
    gemm_stage(GemmJob{xb, D, layer<bf16>(p, W_QKV, l, 3 * DD), 3 * D, M, 3 * D, D,
                       layer<float>(p, B_QKV, l, 3 * D), 0, nullptr, qkv, 3 * D},
               nullptr, smem);
    grid_barrier();
    att_stage(AttJob{qkv, (long long)p.Lq * 3 * D, 3 * D, qkv + D, qkv + 2 * D, 0,
                     (long long)p.Lq * 3 * D, Dh, 3 * D, p.pad, att, D, p.B, p.H, p.Lq, p.Lq,
                     Dh, p.scale},
              smem);
    grid_barrier();
    gemm_stage(GemmJob{att, D, layer<bf16>(p, W_M, l, DD), D, M, D, D, nullptr, 0, y, nullptr,
                       D},
               nullptr, smem);
    grid_barrier();
    ln_stage(LnJob{x32, y, layer<float>(p, B_M, l, D), layer<float>(p, LN1_S, l, D),
                   layer<float>(p, LN1_B, l, D), x1, x1b, M, D, p.eps});
    grid_barrier();
    gemm_stage(GemmJob{x1b, D, layer<bf16>(p, W_1, l, (long long)D * F), F, M, F, D,
                       layer<float>(p, B_1, l, F), 1, nullptr, hb, F},
               nullptr, smem);
    grid_barrier();
    gemm_stage(GemmJob{hb, F, layer<bf16>(p, W_2, l, (long long)F * D), D, M, D, F,
                       layer<float>(p, B_2, l, D), 0, y, nullptr, D},
               nullptr, smem);
    grid_barrier();
    float* o32 = last ? (p.out_f32 ? static_cast<float*>(p.out) : nullptr) : x32;
    bf16* o16 = last ? (p.out_f32 ? nullptr : static_cast<bf16*>(p.out)) : xb;
    ln_stage(LnJob{x1, y, nullptr, layer<float>(p, LN2_S, l, D), layer<float>(p, LN2_B, l, D),
                   o32, o16, M, D, p.eps});
    if (!last) grid_barrier();
  }
}

}  // namespace

// x: [B, Lq, D] question stream, bf16 (x_f32 == 0) or f32; pad: uint8 [B,
// Lq], 1 = PAD. w: host array of the 12 stacked weights in the order wqkv
// [L, D, 3D], bqkv [L, 3D], wm [L, D, D], bm, ln1_s, ln1_b [L, D], w1 [L,
// D, F], b1 [L, F], w2 [L, F, D], b2, ln2_s, ln2_b [L, D]; matrices bf16,
// vectors f32, all contiguous. scratch: host array of the 8 device buffers
// x32, xb, qkv, att, y, x1, x1b, h (f32: x32, y, x1; else bf16; [M, D] but
// qkv [M, 3D] and h [M, F]), each 16-byte aligned. out: [B, Lq, D], f32
// when out_f32, else bf16. Requires D and F multiples of 8, D / H <= 256.
// info: see launch_cooperative. Returns the CUDA error of the launch.
MCAN_API int mcan_sa_encoder(const void* x, int x_f32, const void* pad, const void* const* w,
                             void* const* scratch, void* out, int out_f32, int B, int Lq, int D,
                             int F, int H, int L, float scale, float eps, int max_blocks,
                             int* info, void* stream) {
  if (B < 1 || Lq < 1 || L < 1 || H < 1 || D % H != 0 || D / H > MAX_DH || D % 8 != 0 ||
      F % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, x_f32, static_cast<const unsigned char*>(pad)};
  for (int i = 0; i < N_WEIGHTS; ++i) p.w[i] = w[i];
  for (int i = 0; i < N_SCRATCH; ++i) p.s[i] = scratch[i];
  p.out = out;
  p.out_f32 = out_f32;
  p.B = B;
  p.Lq = Lq;
  p.D = D;
  p.F = F;
  p.H = H;
  p.L = L;
  p.scale = scale;
  p.eps = eps;
  const int M = B * Lq, rows = (M + BM - 1) / BM;
  const int useful = std::max({rows * ((F + BN - 1) / BN), rows * ((3 * D + BN - 1) / BN),
                               B * H * ((Lq + QR - 1) / QR), (M + WARPS - 1) / WARPS});
  return persistent::launch_cooperative(sa_encoder_kernel, p, D / H, useful, max_blocks, info,
                                        static_cast<cudaStream_t>(stream));
}
