// ffn_ln_wstationary: out[M, D] = StdLayerNorm(x + relu(x . W1 + b1) . W2 +
// b2), f32 out, with every weight byte fetched from device memory once.
//
// Replaces: mcan_vqa_tpu/ops/fused_ffn.py::_ffn_ln_wstationary_kernel
//   (:201, called by fused_ffn_ln_weight_stationary at :263). The TPU kernel
//   walks a grid (F / TF, M / TM), F outer: each weight tile W1[:, f],
//   W2[f, :] is fetched once and reused across every row tile, the partial
//   products h . W2[f, :] are summed into the output block in F order, and
//   the residual + LN run on the last F step.
//   Here the F axis is cut into slices of TS hidden units. A block holds
//   one slice's W1[:, s] and W2[s, :] in shared memory while it walks every
//   row tile (128 KB at D 1024), then moves to its next slice (slices s, s
//   + grid, s + 2 grid, ...), so each weight byte is read from device
//   memory once. The output is the running sum: for row tile i, slice s
//   waits until slice s - 1 has added its part (a per-row-tile flag, an
//   acquire / release pair at gpu scope), reads the sum, adds its own part
//   and writes it back, then raises the flag to s + 1. The last slice adds
//   the residual and b2 and takes the LN in place. The slices' parts are
//   therefore summed in F order, as the TPU kernel sums them, whatever the
//   grid, with no float atomics: two runs and any grid give equal bits. A
//   slice waits only on a lower slice, and the launch is cooperative (every
//   block co-resident), so the chain always moves.
//
// Numerics, as the TPU kernel: x read as f32 (an f32 or a bf16 x), rounded
//   to bf16 for the first product; W1, W2 bf16; products summed in f32; h =
//   relu(. + b1) rounded to bf16; the parts summed in slice order in f32;
//   r = (x + sum) + b2; the reference LayerNorm (Bessel std, eps on the
//   std, divided), written f32.
//
// Shapes taken: D a multiple of 128 up to 2048; the row tile TM =
//   ffn::tile_m(D) (64 for D <= 512, 32 for D <= 1024, else 16); the slice
//   TS = ffn::slice(TM) (32, 16 past D 1024) and F a multiple of TS; any M.
//   The grid is the co-resident blocks (one per SM at D 512-2048), at most
//   the F / TS slices and at most max_blocks > 0.
// Workspace: one int32 flag per row tile (480 bytes at MCAN-large B=64: M
//   3840, TM 32), allocated by the caller; the running sums live in the
//   output.
//
// Bounds on an H100: the same function as ffn_ln_blocked.cu, so the same
//   bound (MCAN-large B=64: 64.4 GFLOP, 0.065 ms at the bf16 peak). What
//   this design pays on top: each slice step re-reads the row tile of x and
//   reads and writes the running sum of the tile (through L2: 15.7 MB of f32
//   sums at M 3840), F / TS = 128 times at MCAN-large, the TPU's
//   read-modify-write of the output block per F step at the card's small
//   slices; and a row tile passes the 128 slices one after another, so the
//   pipeline needs F / TS + M / TM steps to drain.
// Design (simple first): 8 warps, WMMA 16x16x16 bf16 fragments with f32
//   accumulation. Per (slice, row tile): x's tile into shared memory as
//   bf16 (a bf16 x by cp.async, an f32 x rounded on the way); h [TM, TS]
//   from x and W1's slice, K split across the warps that the TM x TS
//   fragments leave idle, the parts summed in order, + b1, ReLU, bf16; then
//   the running sums in two halves of D / 2 columns, staged in the x tile's
//   shared memory (cp.async at L2, every load of a half in flight at once),
//   h . W2's slice added fragment by fragment, the half written back at L2.
//   The last slice takes the LN with each row in one warp's registers
//   (ln::centre_regs). Every row tile passes the last slice, so its
//   per-tile time bounds the pipeline: the stage and the LN keep it to a
//   few L2 round trips.
#include <mma.h>

#include "ffn_ln.cuh"
#include "residual_layernorm.cuh"

using namespace nvcuda;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int SKEW = 8, FSKEW = 4;

// the slice width and W1's row padding (none for a 16-wide slice: its rows
// are whole 32-byte fragment rows)
using ffn::slice;
__host__ __device__ constexpr int w1_ld(int tm) { return slice(tm) + (tm == 16 ? 0 : SKEW); }

// dynamic shared memory: W1's slice [D][ld1], W2's slice [TS][D + SKEW], x's
// tile [TM][D + SKEW] (bf16; in phase 2 the f32 stage of half the running
// sums, [TM][D / 2 + FSKEW], the same bytes), h [TM][TS + SKEW] (bf16), h's
// split-K parts (one 16 x 16 f32 fragment per warp)
__host__ __device__ constexpr int smem_bytes(int tm, int D) {
  return D * w1_ld(tm) * 2 + slice(tm) * (D + SKEW) * 2 + tm * (D + SKEW) * 2 +
         tm * (slice(tm) + SKEW) * 2 + WARPS * 256 * 4;
}

struct Params {
  const void* x;    // f32 or bf16
  int x_f32;
  const bf16 *W1, *W2;
  const float *b1, *b2, *gamma, *beta;
  float* out;
  int* flags;
  int M, D, F;
  float eps;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until flag >= want. A chain that stops moving is a fault in the
// kernel: after SPIN_LIMIT_NS the launch traps (an error the wrapper
// raises) rather than holding the card.
constexpr unsigned long long SPIN_LIMIT_NS = 20ull * 1000 * 1000 * 1000;
__device__ __forceinline__ void wait_for(const int* flag, int want) {
  const unsigned long long t0 = global_ns();
  while (load_acquire(flag) < want) {
    __nanosleep(32);
    if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
  }
}

template <int TM>
__global__ void __launch_bounds__(THREADS) ffn_ln_wstationary_kernel(Params p) {
  constexpr int TS = slice(TM), LD1 = w1_ld(TM), LDH = TS + SKEW;
  constexpr int NFRAG = (TM / 16) * (TS / 16), KP = WARPS / NFRAG;  // h: split-K parts
  constexpr int MAXV = 1024 / TM;  // a row's values per lane at the widest D of this TM
  static_assert(NFRAG * KP == WARPS, "h's fragments x K parts = the warps");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int D = p.D, M = p.M, ldd = D + SKEW, half = D / 2, ldc = half + FSKEW;
  bf16* W1s = reinterpret_cast<bf16*>(smem_raw);   // [D][LD1]
  bf16* W2s = W1s + D * LD1;                       // [TS][ldd]
  bf16* Xs = W2s + TS * ldd;                       // [TM][ldd]
  float* Cs = reinterpret_cast<float*>(Xs);        // [TM][ldc], phase 2
  bf16* Hs = Xs + TM * ldd;                        // [TM][LDH]
  float* Ps = reinterpret_cast<float*>(Hs + TM * LDH);  // [WARPS][256]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_slices = p.F / TS, n_tiles = (M + TM - 1) / TM;

  for (int s = blockIdx.x; s < n_slices; s += gridDim.x) {
    const int f0 = s * TS;
    __syncthreads();  // the last slice's reads of W1s / W2s are done
    for (int c = tid; c < D * TS / 8; c += THREADS) {
      const int r = c / (TS / 8), cc = (c % (TS / 8)) * 8;
      cp_async16(&W1s[r * LD1 + cc], p.W1 + (size_t)r * p.F + f0 + cc, true);
    }
    for (int c = tid; c < TS * D / 8; c += THREADS) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      cp_async16(&W2s[r * ldd + cc], p.W2 + (size_t)(f0 + r) * D + cc, true);
    }
    cp_async_commit();

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int m0 = tile * TM;
      __syncthreads();  // the last tile's stage and LN reads are done
      // x's tile as bf16, rows past M zero: a bf16 x by cp.async, an f32 x
      // rounded on the way
      if (p.x_f32) {
#pragma unroll 4
        for (int c = tid; c < TM * D / 8; c += THREADS) {
          const int r = c / (D / 8), cc = (c % (D / 8)) * 8, gm = m0 + r;
          *reinterpret_cast<uint4*>(&Xs[r * ldd + cc]) =
              gm < M ? ffn::x8_bf16(p.x, 1, (size_t)gm * D + cc) : make_uint4(0, 0, 0, 0);
        }
      } else {
        const bf16* xb = static_cast<const bf16*>(p.x);
        for (int c = tid; c < TM * D / 8; c += THREADS) {
          const int r = c / (D / 8), cc = (c % (D / 8)) * 8, gm = m0 + r;
          cp_async16(&Xs[r * ldd + cc], xb + (size_t)(gm < M ? gm : 0) * D + cc, gm < M);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();  // x's tile (and, first, the slice's weights)
      __syncthreads();

      // h = relu(x . W1s + b1): warp -> fragment warp % NFRAG, K part warp / NFRAG
      {
        const int fid = warp % NFRAG, part = warp / NFRAG;
        const int fr = fid / (TS / 16), fc = fid % (TS / 16);
        const int kspan = D / KP, k0 = part * kspan;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
        wmma::fill_fragment(h, 0.0f);
        for (int k = k0; k < k0 + kspan; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, &Xs[fr * 16 * ldd + k], ldd);
          wmma::load_matrix_sync(b, &W1s[k * LD1 + fc * 16], LD1);
          wmma::mma_sync(h, a, b, h);
        }
        wmma::store_matrix_sync(&Ps[(part * NFRAG + fid) * 256], h, 16, wmma::mem_row_major);
      }
      __syncthreads();
      for (int e = tid; e < TM * TS; e += THREADS) {
        const int r = e / TS, c = e % TS;
        const int fid = (r / 16) * (TS / 16) + c / 16, o = (r % 16) * 16 + c % 16;
        float v = Ps[fid * 256 + o];
#pragma unroll
        for (int q = 1; q < KP; ++q) v += Ps[(q * NFRAG + fid) * 256 + o];
        Hs[r * LDH + c] = to_bf16(fmaxf(v + p.b1[f0 + c], 0.0f));
      }

      // wait until slice s - 1 has added its part to this row tile
      if (tid == 0 && s > 0) wait_for(p.flags + tile, s);
      __syncthreads();

      // sum += h . W2s, in two halves of D / 2 columns staged in x's tile
      // (free now): the sums loaded by cp.async at L2 (zeros for slice 0),
      // then each warp adds the product to its fragment columns, then the
      // half is written back at L2
      for (int n0 = 0; n0 < D; n0 += half) {
        for (int c = tid; c < TM * half / 4; c += THREADS) {
          const int r = c / (half / 4), cc = (c % (half / 4)) * 4, gm = m0 + r;
          const bool ok = s > 0 && gm < M;
          cp_async16(&Cs[r * ldc + cc], p.out + (size_t)(ok ? gm : 0) * D + n0 + cc, ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int cf = warp; cf < half / 16; cf += WARPS) {
#pragma unroll
          for (int i = 0; i < TM / 16; ++i) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            float* cblk = &Cs[i * 16 * ldc + cf * 16];
            wmma::load_matrix_sync(acc, cblk, ldc, wmma::mem_row_major);
#pragma unroll
            for (int k = 0; k < TS; k += 16) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
              wmma::load_matrix_sync(a, &Hs[i * 16 * LDH + k], LDH);
              wmma::load_matrix_sync(b, &W2s[k * ldd + n0 + cf * 16], ldd);
              wmma::mma_sync(acc, a, b, acc);
            }
            wmma::store_matrix_sync(cblk, acc, ldc, wmma::mem_row_major);
          }
        }
        __syncthreads();
        for (int c = tid; c < TM * half / 4; c += THREADS) {
          const int r = c / (half / 4), cc = (c % (half / 4)) * 4, gm = m0 + r;
          if (gm < M)
            __stcg(reinterpret_cast<float4*>(p.out + (size_t)gm * D + n0 + cc),
                   *reinterpret_cast<const float4*>(&Cs[r * ldc + cc]));
        }
        __syncthreads();  // the stage is written back (the next half, the LN)
      }

      if (s == n_slices - 1) {
        // the residual and the LN in place, one warp per row, the row in
        // registers: lane holds columns t * 128 + 4 lane + (0..3)
        for (int r = warp; r < TM; r += WARPS) {
          const int gm = m0 + r;
          if (gm >= M) break;
          float* o = p.out + (size_t)gm * D;
          float v[MAXV];
          float sum = 0.0f;
#pragma unroll
          for (int t = 0; t < MAXV / 4; ++t) {
            const int c = t * 128 + lane * 4;
            if (c < D) {
              const float4 a = __ldcg(reinterpret_cast<const float4*>(o + c));
              const float4 xx = ffn::x4_f32(p.x, p.x_f32, (size_t)gm * D + c);
              const float4 bb = *reinterpret_cast<const float4*>(p.b2 + c);
              v[4 * t] = (xx.x + a.x) + bb.x;
              v[4 * t + 1] = (xx.y + a.y) + bb.y;
              v[4 * t + 2] = (xx.z + a.z) + bb.z;
              v[4 * t + 3] = (xx.w + a.w) + bb.w;
              sum += (v[4 * t] + v[4 * t + 1]) + (v[4 * t + 2] + v[4 * t + 3]);
            }
          }
          // D a multiple of 128: the lane's first D / 32 values are the row's
          const float denom = ln::centre_regs(v, D / 32, D, sum, p.eps);
#pragma unroll
          for (int t = 0; t < MAXV / 4; ++t) {
            const int c = t * 128 + lane * 4;
            if (c < D) {
              const float4 g = *reinterpret_cast<const float4*>(p.gamma + c);
              const float4 b = *reinterpret_cast<const float4*>(p.beta + c);
              __stcg(reinterpret_cast<float4*>(o + c),
                     make_float4(g.x * v[4 * t] / denom + b.x, g.y * v[4 * t + 1] / denom + b.y,
                                 g.z * v[4 * t + 2] / denom + b.z,
                                 g.w * v[4 * t + 3] / denom + b.w));
            }
          }
        }
      } else if (tid == 0) {
        __threadfence();
        store_release(p.flags + tile, s + 1);
      }
    }
  }
}

template <int TM>
int launch(const Params& params, int max_blocks, int* info, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int smem = smem_bytes(TM, params.D);
  e = cudaFuncSetAttribute(ffn_ln_wstationary_kernel<TM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ffn_ln_wstationary_kernel<TM>,
                                                      THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = per_sm * sms;
  const int n_slices = params.F / slice(TM);
  if (n_slices < grid) grid = n_slices;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  if (info != nullptr) {
    info[0] = grid;
    info[1] = per_sm;
    info[2] = sms;
    info[3] = smem;
  }
  Params p = params;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ffn_ln_wstationary_kernel<TM>),
                                  dim3(grid), dim3(THREADS), args, static_cast<size_t>(smem),
                                  stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, D] f32 (x_f32 == 1) or bf16, contiguous, 16-byte aligned; W1 [D,
// F] and W2 [F, D] bf16, contiguous, 16-byte aligned; b1 [F], b2, gamma,
// beta [D] f32; out [M, D] f32, 16-byte aligned (written and read as the
// running sum); flags: one int32 per row tile of ffn::tile_m(D) rows,
// zeroed. D a multiple of 128 up to 2048, F a multiple of the slice, M > 0.
// info (host, may be null) <- grid, blocks per SM, SMs, shared memory
// bytes. Returns the CUDA error: cudaErrorInvalidValue for a shape the
// kernel does not take, cudaErrorCooperativeLaunchTooLarge where not one
// block fits an SM.
MCAN_API int mcan_ffn_ln_wstationary(const void* x, int x_f32, const void* W1, const void* b1,
                                     const void* W2, const void* b2, const void* gamma,
                                     const void* beta, void* out, void* flags, int M, int D,
                                     int F, float eps, int max_blocks, int* info, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tm = ffn::tile_m(D);
  if (tm == 0 || F <= 0 || F % slice(tm) != 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x,
                 x_f32,
                 static_cast<const bf16*>(W1),
                 static_cast<const bf16*>(W2),
                 static_cast<const float*>(b1),
                 static_cast<const float*>(b2),
                 static_cast<const float*>(gamma),
                 static_cast<const float*>(beta),
                 static_cast<float*>(out),
                 static_cast<int*>(flags),
                 M,
                 D,
                 F,
                 eps};
  if (tm == 64) return launch<64>(p, max_blocks, info, s);
  if (tm == 32) return launch<32>(p, max_blocks, info, s);
  return launch<16>(p, max_blocks, info, s);
}
