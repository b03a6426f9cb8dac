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
// GFLOP per sample at 989 TFLOP/s, ~0.18 ms. What keeps it above them: at
// B = 1 the 66 grid barriers (2.3 us each) and the few SMs a 60-row stream
// gives each product (N 512 / 128 = 4 tiles for a merge); at B = 64 the
// products' rate. The design (persistent_stages.cuh): the products on
// gemm_sm90.cu's TMA + wgmma mainloop, tiles and K splits from
// kernels.stack_plan (at B = 1 every product split in two, so twice the
// SMs read each weight); the attention on masked_attention.cu's mma.sync
// items, several a block; the LayerNorms from registers. The steps run
// through one loop over the layer's 11 stages, so each stage's code is in
// the kernel once. On an H100 80GB HBM3 at 700 W (PERF.md §6): 1.66 ms at B =
// 64 against the WMMA design's 6.59, 0.73 at B = 1 against 1.27.
#include "persistent_stages.cuh"

namespace {

using namespace persistent;

enum Weight {
  W_QKV1, B_QKV1, W_M1, B_M1, LN1_S, LN1_B, W_KV2, B_KV2, W_Q2, B_Q2, W_M2, B_M2, LN2_S, LN2_B,
  W_1, B_1, W_2, B_2, LN3_S, LN3_B, N_WEIGHTS
};
enum Scratch { X32, XB, QKV, ATT, Y, V1, V1B, QX, V2, V2B, HB, QB, KV, N_SCRATCH };
// the tensor maps: the products' A operands, then the stacked weights
enum Map { A_XB, A_ATT, A_V1B, A_QB, A_V2B, A_HB, M_QKV1, M_M1, M_KV2, M_Q2, M_M2, M_1, M_2, N_MAPS };
// the products, in the order of the plan's fields
enum Job { J_QKV1, J_M1, J_Q2, J_KV2, J_M2, J_1, J_2, N_JOBS };
constexpr int STEPS = 11;   // the stages of a layer

struct Params {
  CUtensorMap maps[N_MAPS];
  GemmJob jobs[N_JOBS];
  Args att[2];         // self- and cross-attention (external k/v: layer 0's)
  AttPlan att_plan[2];
  LnJob ln[3];         // LN1, LN2, LN3 (bias, gamma, beta of layer 0)
  const void* v;       // [B, Lv, D] bf16 or f32
  const void* q;       // [B, Lq, D] bf16 or f32: in-kernel k/v; null: external
  long long kv_layer;  // external k/v: the bytes from one layer's keys to the next's
  float* x32;
  bf16* xb;
  bf16* qb;
  void* out;           // [B, Lv, D]
  float* ws;
  int* counters;
  int v_f32, q_f32, out_f32, M, Mq, D, L;
};

// the product of GEMM step s
__device__ __forceinline__ int job_of(int s) {
  return s == 0 ? J_QKV1 : s == 2 ? J_M1 : s == 4 ? J_Q2 : s == 6 ? J_M2 : s == 8 ? J_1 : J_2;
}

__global__ void __launch_bounds__(THREADS, 1) sga_decoder_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int* last_flag;
  Ring ring = ring_init(smem, &last_flag);
  unsigned char* staging = ring_bytes(smem, ring);
  const int D = p.D;

  convert_stage(p.v, p.v_f32, (long long)p.M * D, p.x32, p.xb);
  if (p.q != nullptr) convert_stage(p.q, p.q_f32, (long long)p.Mq * D, nullptr, p.qb);
  grid_barrier();

  for (int l = 0; l < p.L; ++l) {
    const bool last = l == p.L - 1;
    for (int s = 0; s < STEPS; ++s) {
      if (s == 1 || s == 5) {
        // 2. self-attention over the regions, 6. cross-attention
        const int c = s == 5;
        Args a = p.att[c];
        if (c && p.q == nullptr) {
          a.k = static_cast<const char*>(a.k) + l * p.kv_layer;
          a.v = static_cast<const char*>(a.v) + l * p.kv_layer;
        }
        att_stage(a, p.att_plan[c], staging);
      } else if (s == 3 || s == 7 || s == 10) {
        // 4. LN1, 8. LN2, 11. LN3: the f32 stream, or after the last layer
        // the output
        const int i = s == 3 ? 0 : s == 7 ? 1 : 2;
        LnJob j = p.ln[i];
        if (j.bias != nullptr) j.bias += (size_t)l * D;
        j.gamma += (size_t)l * D;
        j.beta += (size_t)l * D;
        if (i == 2 && last) {
          j.o32 = p.out_f32 ? static_cast<float*>(p.out) : nullptr;
          j.o16 = p.out_f32 ? nullptr : static_cast<bf16*>(p.out);
        }
        ln_stage(j);
      } else {
        // 1. qkv, 3. merge, 5. the cross query (in-kernel: and the cross
        // keys / values), 7. merge, 9. FFN up, 10. FFN down
        gemm_stage(p.maps, p.jobs[job_of(s)], s == 4 && p.q != nullptr ? &p.jobs[J_KV2] : nullptr,
                   l, ring, p.ws, p.counters, last_flag);
      }
      if (!(last && s == STEPS - 1)) grid_barrier();
    }
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
// matrices bf16, vectors f32, all contiguous, the matrices 16-byte aligned.
// scratch: host array of the 13 device buffers x32, xb, qkv, att, y, v1,
// v1b, qx, v2, v2b, h, qb, kv (f32 where named 32 or y / v1 / v2, else
// bf16; [M, D] but qkv [M, 3D], h [M, F], qb [B*Lq, D], kv [B*Lq, 2D]; the
// last two only for the in-kernel k/v), each 16-byte aligned. out: [B, Lv,
// D], f32 when out_f32, else bf16. plan: kernels.stack_plan's fields (per
// product qkv1, m1, q2, kv2, m2, w1, w2: bm, bn, splits, workspace and
// counter offsets; per attention, self then cross: instance, dhp, kc, rows;
// then the largest stage's work items); workspace (f32) and counters
// (int32, zero, left zero) where a product splits. Requires D and F
// multiples of 8, D / H <= 256. info: see launch_cooperative. Returns the
// CUDA error of the launch, or cudaErrorInvalidValue for a shape or plan it
// does not take or a tensor map that cuTensorMapEncodeTiled refuses.
MCAN_API int mcan_sga_decoder(const void* v, int v_f32, const void* q, int q_f32, const void* kq,
                              const void* vq, int kv_f32, long long kv_bs, long long kv_ls,
                              long long kv_hs, long long kv_rs, const void* vpad,
                              const void* qpad, const void* const* w, void* const* scratch,
                              void* out, int out_f32, int B, int Lv, int Lq, int D, int F, int H,
                              int L, float scale, float eps, const int* plan, void* workspace,
                              void* counters, int max_blocks, int* info, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Lv < 1 || Lq < 1 || L < 1 || H < 1 || D % H != 0 || D / H > MAX_DH || D % 8 != 0 ||
      F % 8 != 0 || plan == nullptr)
    return invalid;
  const bool in_kv = q != nullptr;
  const int M = B * Lv, Mq = B * Lq, Dh = D / H;
  Params p;
  memset(&p, 0, sizeof p);
  auto S = [&](int i) { return scratch[i]; };
  auto b16 = [&](int i) { return static_cast<bf16*>(scratch[i]); };
  auto f32 = [&](int i) { return static_cast<float*>(scratch[i]); };
  auto fw = [&](int i) { return static_cast<const float*>(w[i]); };
  bool ok = act_map(&p.maps[A_XB], S(XB), M, D) && act_map(&p.maps[A_ATT], S(ATT), M, D) &&
            act_map(&p.maps[A_V1B], S(V1B), M, D) && act_map(&p.maps[A_V2B], S(V2B), M, D) &&
            act_map(&p.maps[A_HB], S(HB), M, F) &&
            (!in_kv || act_map(&p.maps[A_QB], S(QB), Mq, D)) &&
            weight_map(&p.maps[M_QKV1], w[W_QKV1], L, D, 3 * D) &&
            weight_map(&p.maps[M_M1], w[W_M1], L, D, D) &&
            (!in_kv || weight_map(&p.maps[M_KV2], w[W_KV2], L, D, 2 * D)) &&
            weight_map(&p.maps[M_Q2], w[W_Q2], L, D, D) &&
            weight_map(&p.maps[M_M2], w[W_M2], L, D, D) &&
            weight_map(&p.maps[M_1], w[W_1], L, D, F) && weight_map(&p.maps[M_2], w[W_2], L, F, D);
  p.jobs[J_QKV1] = GemmJob{A_XB, M_QKV1, M, 3 * D, D, 0, 0, 0, 0, 0, fw(B_QKV1), 0, nullptr, b16(QKV)};
  p.jobs[J_M1] = GemmJob{A_ATT, M_M1, M, D, D, 0, 0, 0, 0, 0, nullptr, 0, f32(Y), nullptr};
  p.jobs[J_Q2] = GemmJob{A_V1B, M_Q2, M, D, D, 0, 0, 0, 0, 0, fw(B_Q2), 0, nullptr, b16(QX)};
  p.jobs[J_KV2] = GemmJob{A_QB, M_KV2, Mq, 2 * D, D, 0, 0, 0, 0, 0, fw(B_KV2), 0, nullptr, b16(KV)};
  p.jobs[J_M2] = GemmJob{A_ATT, M_M2, M, D, D, 0, 0, 0, 0, 0, nullptr, 0, f32(Y), nullptr};
  p.jobs[J_1] = GemmJob{A_V2B, M_1, M, F, D, 0, 0, 0, 0, 0, fw(B_1), 1, nullptr, b16(HB)};
  p.jobs[J_2] = GemmJob{A_HB, M_2, M, D, F, 0, 0, 0, 0, 0, fw(B_2), 0, f32(Y), nullptr};
  for (int j = 0; j < N_JOBS; ++j)
    if (j != J_KV2 || in_kv) ok = ok && take_job(p.jobs[j], plan + JOB_FIELDS * j, workspace && counters);
  const Philox none{0, 0u, 0u, 0u, 0};
  const auto* vp = static_cast<const unsigned char*>(vpad);
  const auto* qp = static_cast<const unsigned char*>(qpad);
  bf16* qkv = b16(QKV);
  p.att[0] = Args{qkv, 0, (long long)Lv * 3 * D, Dh, 3 * D, qkv + D, qkv + 2 * D,
                  (long long)Lv * 3 * D, Dh, 3 * D, 0, vp, nullptr, none, 1.0f, S(ATT), 0,
                  (long long)Lv * D, D, B, H, Lv, Lv, Dh, scale, 0};
  if (in_kv)
    p.att[1] = Args{b16(QX), 0, (long long)Lv * D, Dh, D, b16(KV), b16(KV) + D,
                    (long long)Lq * 2 * D, Dh, 2 * D, 0, qp, nullptr, none, 1.0f, S(ATT), 0,
                    (long long)Lv * D, D, B, H, Lv, Lq, Dh, scale, 0};
  else
    p.att[1] = Args{b16(QX), 0, (long long)Lv * D, Dh, D, kq, vq, kv_bs, kv_hs, kv_rs, kv_f32,
                    qp, nullptr, none, 1.0f, S(ATT), 0, (long long)Lv * D, D, B, H, Lv, Lq, Dh,
                    scale, 0};
  const int* att_fields = plan + JOB_FIELDS * N_JOBS;
  ok = ok && take_att(p.att[0], p.att_plan[0], att_fields) &&
       take_att(p.att[1], p.att_plan[1], att_fields + ATT_FIELDS);
  const int useful = att_fields[2 * ATT_FIELDS];
  if (!ok || useful < 1) return invalid;
  p.ln[0] = LnJob{f32(X32), f32(Y), fw(B_M1), fw(LN1_S), fw(LN1_B), f32(V1), b16(V1B), M, D, eps};
  p.ln[1] = LnJob{f32(V1), f32(Y), fw(B_M2), fw(LN2_S), fw(LN2_B), f32(V2), b16(V2B), M, D, eps};
  p.ln[2] = LnJob{f32(V2), f32(Y), nullptr, fw(LN3_S), fw(LN3_B), f32(X32), b16(XB), M, D, eps};
  p.v = v;
  p.q = q;
  p.kv_layer = kv_ls * (kv_f32 ? 4 : 2);
  p.x32 = f32(X32);
  p.xb = b16(XB);
  p.qb = b16(QB);
  p.out = out;
  p.ws = static_cast<float*>(workspace);
  p.counters = static_cast<int*>(counters);
  p.v_f32 = v_f32;
  p.q_f32 = q_f32;
  p.out_f32 = out_f32;
  p.M = M;
  p.Mq = Mq;
  p.D = D;
  p.L = L;
  return launch_cooperative(sga_decoder_kernel, p, useful, max_blocks, info,
                            static_cast<cudaStream_t>(stream));
}
