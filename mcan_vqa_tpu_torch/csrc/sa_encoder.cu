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
// operations (~0.034 ms). At 14 tokens a sample every product has one
// 64-row tile at B = 1 and a few at B = 64 (M 896), so the stack is bound
// by how many SMs read each weight and by its 42 barriers. The design
// (persistent_stages.cuh): gemm_sm90.cu's TMA + wgmma mainloop with the
// tiles and K splits of kernels.stack_plan (at B = 1 every product split
// in two), the attention on masked_attention.cu's mma.sync items, eight a
// block, the LayerNorms from registers, the layer's 7 stages through one
// loop. On an H100 80GB HBM3 at 700 W (PERF.md §6): 0.58 ms at B = 64
// against the WMMA design's 1.12, 0.42 at B = 1 against 0.61.
#include "persistent_stages.cuh"

namespace {

using namespace persistent;

enum Weight { W_QKV, B_QKV, W_M, B_M, LN1_S, LN1_B, W_1, B_1, W_2, B_2, LN2_S, LN2_B, N_WEIGHTS };
enum Scratch { X32, XB, QKV, ATT, Y, X1, X1B, HB, N_SCRATCH };
enum Map { A_XB, A_ATT, A_X1B, A_HB, M_QKV, M_M, M_1, M_2, N_MAPS };
// the products, in the order of the plan's fields
enum Job { J_QKV, J_M, J_1, J_2, N_JOBS };
constexpr int STEPS = 7;   // the stages of a layer

struct Params {
  CUtensorMap maps[N_MAPS];
  GemmJob jobs[N_JOBS];
  Args att;
  AttPlan att_plan;
  LnJob ln[2];         // LN1, LN2 (bias, gamma, beta of layer 0)
  const void* x;       // [B, Lq, D] bf16 or f32
  float* x32;
  bf16* xb;
  void* out;           // [B, Lq, D]
  float* ws;
  int* counters;
  int x_f32, out_f32, M, D, L;
};

__device__ __forceinline__ int job_of(int s) {
  return s == 0 ? J_QKV : s == 2 ? J_M : s == 4 ? J_1 : J_2;
}

__global__ void __launch_bounds__(THREADS, 1) sa_encoder_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int* last_flag;
  Ring ring = ring_init(smem, &last_flag);
  unsigned char* staging = ring_bytes(smem, ring);
  const int D = p.D;

  convert_stage(p.x, p.x_f32, (long long)p.M * D, p.x32, p.xb);
  grid_barrier();

  for (int l = 0; l < p.L; ++l) {
    const bool last = l == p.L - 1;
    for (int s = 0; s < STEPS; ++s) {
      if (s == 1) {
        // 2. self-attention over the tokens
        att_stage(p.att, p.att_plan, staging);
      } else if (s == 3 || s == 6) {
        // 4. LN1, 7. LN2: the f32 stream, or after the last layer the output
        LnJob j = p.ln[s == 6];
        if (j.bias != nullptr) j.bias += (size_t)l * D;
        j.gamma += (size_t)l * D;
        j.beta += (size_t)l * D;
        if (s == 6 && last) {
          j.o32 = p.out_f32 ? static_cast<float*>(p.out) : nullptr;
          j.o16 = p.out_f32 ? nullptr : static_cast<bf16*>(p.out);
        }
        ln_stage(j);
      } else {
        // 1. qkv, 3. merge, 5. FFN up, 6. FFN down
        gemm_stage(p.maps, p.jobs[job_of(s)], nullptr, l, ring, p.ws, p.counters, last_flag);
      }
      if (!(last && s == STEPS - 1)) grid_barrier();
    }
  }
}

}  // namespace

// x: [B, Lq, D] question stream, bf16 (x_f32 == 0) or f32; pad: uint8 [B,
// Lq], 1 = PAD. w: host array of the 12 stacked weights in the order wqkv
// [L, D, 3D], bqkv [L, 3D], wm [L, D, D], bm, ln1_s, ln1_b [L, D], w1 [L,
// D, F], b1 [L, F], w2 [L, F, D], b2, ln2_s, ln2_b [L, D]; matrices bf16,
// vectors f32, all contiguous, the matrices 16-byte aligned. scratch: host
// array of the 8 device buffers x32, xb, qkv, att, y, x1, x1b, h (f32: x32,
// y, x1; else bf16; [M, D] but qkv [M, 3D] and h [M, F]), each 16-byte
// aligned. out: [B, Lq, D], f32 when out_f32, else bf16. plan:
// kernels.stack_plan's fields (per product qkv, m, w1, w2: bm, bn, splits,
// workspace and counter offsets; the attention's instance, dhp, kc, rows;
// the largest stage's work items); workspace (f32) and counters (int32,
// zero, left zero) where a product splits. Requires D and F multiples of 8,
// D / H <= 256. info: see launch_cooperative. Returns the CUDA error of the
// launch, or cudaErrorInvalidValue for a shape or plan it does not take or
// a tensor map that cuTensorMapEncodeTiled refuses.
MCAN_API int mcan_sa_encoder(const void* x, int x_f32, const void* pad, const void* const* w,
                             void* const* scratch, void* out, int out_f32, int B, int Lq, int D,
                             int F, int H, int L, float scale, float eps, const int* plan,
                             void* workspace, void* counters, int max_blocks, int* info,
                             void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Lq < 1 || L < 1 || H < 1 || D % H != 0 || D / H > MAX_DH || D % 8 != 0 ||
      F % 8 != 0 || plan == nullptr)
    return invalid;
  const int M = B * Lq, Dh = D / H;
  Params p;
  memset(&p, 0, sizeof p);
  auto b16 = [&](int i) { return static_cast<bf16*>(scratch[i]); };
  auto f32 = [&](int i) { return static_cast<float*>(scratch[i]); };
  auto fw = [&](int i) { return static_cast<const float*>(w[i]); };
  bool ok = act_map(&p.maps[A_XB], scratch[XB], M, D) &&
            act_map(&p.maps[A_ATT], scratch[ATT], M, D) &&
            act_map(&p.maps[A_X1B], scratch[X1B], M, D) && act_map(&p.maps[A_HB], scratch[HB], M, F) &&
            weight_map(&p.maps[M_QKV], w[W_QKV], L, D, 3 * D) &&
            weight_map(&p.maps[M_M], w[W_M], L, D, D) && weight_map(&p.maps[M_1], w[W_1], L, D, F) &&
            weight_map(&p.maps[M_2], w[W_2], L, F, D);
  p.jobs[J_QKV] = GemmJob{A_XB, M_QKV, M, 3 * D, D, 0, 0, 0, 0, 0, fw(B_QKV), 0, nullptr, b16(QKV)};
  p.jobs[J_M] = GemmJob{A_ATT, M_M, M, D, D, 0, 0, 0, 0, 0, nullptr, 0, f32(Y), nullptr};
  p.jobs[J_1] = GemmJob{A_X1B, M_1, M, F, D, 0, 0, 0, 0, 0, fw(B_1), 1, nullptr, b16(HB)};
  p.jobs[J_2] = GemmJob{A_HB, M_2, M, D, F, 0, 0, 0, 0, 0, fw(B_2), 0, f32(Y), nullptr};
  for (int j = 0; j < N_JOBS; ++j)
    ok = ok && take_job(p.jobs[j], plan + JOB_FIELDS * j, workspace && counters);
  bf16* qkv = b16(QKV);
  p.att = Args{qkv, 0, (long long)Lq * 3 * D, Dh, 3 * D, qkv + D, qkv + 2 * D,
               (long long)Lq * 3 * D, Dh, 3 * D, 0, static_cast<const unsigned char*>(pad),
               nullptr, Philox{0, 0u, 0u, 0u, 0}, 1.0f, scratch[ATT], 0, (long long)Lq * D, D, B,
               H, Lq, Lq, Dh, scale, 0};
  const int* att_fields = plan + JOB_FIELDS * N_JOBS;
  ok = ok && take_att(p.att, p.att_plan, att_fields);
  const int useful = att_fields[ATT_FIELDS];
  if (!ok || useful < 1) return invalid;
  p.ln[0] = LnJob{f32(X32), f32(Y), fw(B_M), fw(LN1_S), fw(LN1_B), f32(X1), b16(X1B), M, D, eps};
  p.ln[1] = LnJob{f32(X1), f32(Y), nullptr, fw(LN2_S), fw(LN2_B),
                  f32(X32), b16(XB), M, D, eps};
  p.x = x;
  p.x32 = f32(X32);
  p.xb = b16(XB);
  p.out = out;
  p.ws = static_cast<float*>(workspace);
  p.counters = static_cast<int*>(counters);
  p.x_f32 = x_f32;
  p.out_f32 = out_f32;
  p.M = M;
  p.D = D;
  p.L = L;
  return launch_cooperative(sa_encoder_kernel, p, useful, max_blocks, info,
                            static_cast<cudaStream_t>(stream));
}
