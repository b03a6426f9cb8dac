// The reference LayerNorm of rows whose columns are spread over the CTAs of
// one thread-block cluster, from the accumulator registers of a wgmma
// m64nBNk16 warpgroup: gemm_ln.cu's epilogue, which the streaming FFN
// kernels (ffn_ln_blocked.cu, ffn_ln_wstationary.cu) share. A thread holds
// rows rl, rl + 8 of its warpgroup's 64 (rl = 16 warp + lane / 4) and the
// column pairs c0 + 8 j, + 1 (c0 = the CTA's first column + 2 (lane % 4)):
// accumulator j is row rl + 8 ((j / 2) % 2), column c0 + 8 (j / 4) + j % 2.
//
// The caller forms r (0 past D) in the accumulators and each row's sum over
// the thread's columns, then
//   1. row_stats: the row's sum over the CTA's columns (the quad's four
//      lanes by two xor shuffles: every lane the same bits), its mean over
//      those columns and the sum of squares about that mean (M2), into this
//      CTA's shared memory, 16 bytes a row;
//   2. (the caller makes them visible to the cluster: a cluster barrier, or
//      an mbarrier each peer arrives on)
//   3. combine: every CTA reads the C ranks' (sum, M2, mean) of its rows
//      through distributed shared memory (one 16-byte load a rank, all in
//      flight at once) and combines them in rank order 0 .. C-1 by Chan et
//      al.'s pairwise update, M2 = sum_c M2_c + n_c (mean_c - mean)^2, the
//      two-pass variance without a second exchange: every CTA, and every
//      run, gets the same bits;
//   4. normalise_store: gamma (r - mean) / (std + eps) + beta from the
//      registers, the quotient from the correctly rounded reciprocal of std
//      + eps and one Markstein correction by the exact residual (div_by:
//      branch-free, so the quotients interleave; the compiler's division
//      checks each one for its slow path, a branch that serialised them),
//      stored bf16 as 16-byte pieces after a quad transpose, or f32 as pairs.
#pragma once

#include "sm90_mainloop.cuh"

namespace cln {

using sm90::quad_transpose;

constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// x reduced over the 4 lanes of a quad (every lane the same bits)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

// x / y from r = y's correctly rounded reciprocal: q = x r, then
// Markstein's correction by the residual x - q y, exact in an FMA. The
// correction brings q to div.rn.f32's quotient but for rare last-place
// cases.
__device__ __forceinline__ float div_by(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// A quad's 16-byte pieces of a bf16 row (lane t: columns 8 (g4 + t) .. + 7)
// as the thread's pairs: v[2 s], v[2 s + 1] = columns c0 + 8 (g4 + s), + 1,
// by a quad transpose
__device__ __forceinline__ void unpack_res(float (&v)[8], uint4 x, int lane) {
  unsigned a[4] = {x.x, x.y, x.z, x.w};
  quad_transpose(a, lane);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&a[s]);
    v[2 * s] = __low2float(p);
    v[2 * s + 1] = __high2float(p);
  }
}

// The residual of the thread's pairs g4 .. g4 + 3 of one row: v[2 s], v[2 s +
// 1] = columns c0 + 8 (g4 + s), + 1 (0 past D or M). bf16: each lane reads
// the 8 columns 8 (g4 + t) .. of the row (16 bytes) and a quad transpose
// hands each lane its pairs; f32: the pairs themselves.
__device__ __forceinline__ void load_res(float (&v)[8], const void* res, int res_bf16, long long ldr,
                                         int row, int M, int c0, int g4, int lane, int D) {
  const int t = lane & 3;
  if (res_bf16) {
    const int col = c0 - 2 * t + 8 * (g4 + t);
    unpack_res(v, row < M && col < D   // D % 8 == 0: all 8 columns or none
                      ? *reinterpret_cast<const uint4*>(static_cast<const bf16*>(res) +
                                                        static_cast<size_t>(row) * ldr + col)
                      : make_uint4(0u, 0u, 0u, 0u),
               lane);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int col = c0 + 8 * (g4 + s);
      float2 x = make_float2(0.0f, 0.0f);
      if (row < M && col < D)
        x = *reinterpret_cast<const float2*>(static_cast<const float*>(res) +
                                             static_cast<size_t>(row) * ldr + col);
      v[2 * s] = x.x;
      v[2 * s + 1] = x.y;
    }
  }
}

// 1. From r in the accumulators (0 past D) and s[hi], the thread's sum of
// row rl + 8 hi: the CTA's sum, mean and M2 of each row into stats[4 (rl +
// 8 hi)] (sum, M2, mean); inv_nc = 1 / the CTA's columns
template <int ACC>
__device__ __forceinline__ void row_stats(const float (&acc)[ACC], float (&s)[2], float inv_nc, int c0,
                                          int D, int t, float* stats, int rl) {
  float lm[2], m2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    s[hi] = quad_sum(s[hi]);
    lm[hi] = s[hi] * inv_nc;
  }
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int hi = (j >> 1) & 1;
    const float d = acc[j] - lm[hi];
    if (c0 + 8 * (j >> 2) < D) m2[hi] += d * d;
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) m2[hi] = quad_sum(m2[hi]);
  if (t == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float* st = stats + 4 * (rl + 8 * hi);
      st[0] = s[hi];
      st[1] = m2[hi];
      st[2] = lm[hi];
    }
  }
}

// 3. Row rl + 8 hi's mean, std + eps and its reciprocal from the `ranks`
// CTAs' stats (rank c owns columns [c bn, min(D, (c + 1) bn))), in rank
// order; inv_d = 1 / D, inv_d1 = 1 / (D - 1)
__device__ __forceinline__ void combine(const float* stats, int rl, int ranks, int D, int bn,
                                        float inv_d, float inv_d1, float eps, float (&mean)[2],
                                        float (&denom)[2], float (&inv)[2]) {
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float* st = stats + 4 * (rl + 8 * hi);
    float4 p[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      p[c] = c < ranks ? sm90::peer_f32x4(st, c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      if (c < ranks) sum += p[c].x;
    mean[hi] = sum * inv_d;
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < ranks) {
        const float dm = p[c].z - mean[hi];
        ss += p[c].y + (min(D, (c + 1) * bn) - c * bn) * (dm * dm);
      }
    }
    denom[hi] = sqrtf(ss * inv_d1) + eps;
    inv[hi] = __frcp_rn(denom[hi]);
  }
}

// 4. gamma (r - mean) / (std + eps) + beta of the thread's values, stored
// at rows r0 (+ 8), columns c0 + 8 j (vg, vbe: gamma and beta by column;
// GUARD: read only below D, as vectors of D in device memory must be)
template <int ACC, bool GUARD = false>
__device__ __forceinline__ void normalise_store(const float (&acc)[ACC], const float (&mean)[2],
                                                const float (&denom)[2], const float (&inv)[2],
                                                const float* vg, const float* vbe, void* out,
                                                int out_bf16, long long ldo, int r0, int c0, int M,
                                                int D, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int g4 = 0; g4 < ACC / 4; g4 += 4) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = r0 + 8 * hi;
      float v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c0 + 8 * (g4 + q), j = 4 * (g4 + q) + 2 * hi;
        const bool in = !GUARD || col < D;   // D % 8 == 0: col + 1 < D too
        const float g0 = in ? vg[col] : 0.0f, g1 = in ? vg[col + 1] : 0.0f;
        const float b0 = in ? vbe[col] : 0.0f, b1 = in ? vbe[col + 1] : 0.0f;
        v[2 * q] = div_by(g0 * (acc[j] - mean[hi]), denom[hi], inv[hi]) + b0;
        v[2 * q + 1] = div_by(g1 * (acc[j + 1] - mean[hi]), denom[hi], inv[hi]) + b1;
      }
      if (out_bf16) {
        unsigned a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
          a[q] = *reinterpret_cast<const unsigned*>(&p);
        }
        quad_transpose(a, lane);   // a: columns 8 (g4 + t) .. + 7 of the row
        const int col = c0 - 2 * t + 8 * (g4 + t);
        if (row < M && col < D)
          *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + static_cast<size_t>(row) * ldo + col) =
              make_uint4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = c0 + 8 * (g4 + q);
          if (row < M && col < D)
            *reinterpret_cast<float2*>(static_cast<float*>(out) + static_cast<size_t>(row) * ldo + col) =
                make_float2(v[2 * q], v[2 * q + 1]);
        }
      }
    }
  }
}

}  // namespace cln
