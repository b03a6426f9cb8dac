// What ffn_ln_blocked.cu and ffn_ln_wstationary.cu share: the tiles, chosen
// by width (ops/kernels.py::ffn_tiles holds the same rule for the wrappers'
// checks), and the loads of x, which either kernel reads as f32 whatever
// its dtype.
#pragma once

#include "common.cuh"

namespace ffn {

// The row tile at width D: 64 rows for D <= 512, 32 for D <= 1024, 16 up to
// 2048, so that the f32 row sums (tile_m x D) stay within 128 KB of shared
// memory; 0 for a width the kernels do not take (not a multiple of 128, or
// past 2048).
__host__ __device__ constexpr int tile_m(int D) {
  return D < 128 || D > 2048 || D % 128 != 0 ? 0 : D <= 512 ? 64 : D <= 1024 ? 32 : 16;
}
// ffn_ln_blocked's F tile: h [tm, tile_f] is 4096 values (16 fragments)
__host__ __device__ constexpr int tile_f(int tm) { return 4096 / tm; }
// ffn_ln_wstationary's F slice: 32 hidden units, 16 past D 1024 (W1's and
// W2's slices then fit shared memory beside the x tile)
__host__ __device__ constexpr int slice(int tm) { return tm == 16 ? 16 : 32; }

// x[e] as f32, x f32 (x_f32 == 1) or bf16
__device__ __forceinline__ float x_at(const void* x, int x_f32, size_t e) {
  return x_f32 ? static_cast<const float*>(x)[e] : to_f32(static_cast<const bf16*>(x)[e]);
}

// x[e : e + 4] as f32 (e a multiple of 4; x 16-byte aligned)
__device__ __forceinline__ float4 x4_f32(const void* x, int x_f32, size_t e) {
  if (x_f32) return *reinterpret_cast<const float4*>(static_cast<const float*>(x) + e);
  const uint2 w = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(x) + e);
  const bf16* h = reinterpret_cast<const bf16*>(&w);
  return make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3]));
}

// x[e : e + 8] rounded to bf16, as one 16-byte word (e a multiple of 8; x
// 16-byte aligned)
__device__ __forceinline__ uint4 x8_bf16(const void* x, int x_f32, size_t e) {
  if (!x_f32) return *reinterpret_cast<const uint4*>(static_cast<const bf16*>(x) + e);
  const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(x) + e);
  const float4 a = src[0], b = src[1];
  __align__(16) bf16 v[8] = {to_bf16(a.x), to_bf16(a.y), to_bf16(a.z), to_bf16(a.w),
                             to_bf16(b.x), to_bf16(b.y), to_bf16(b.z), to_bf16(b.w)};
  return *reinterpret_cast<const uint4*>(v);
}

}  // namespace ffn
