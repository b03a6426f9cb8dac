// prng_masks: the uint8 keep-masks that the seeded train kernels draw for
// one block, written out in the external-mask layout; philox_words: the raw
// Philox4x32-10 words behind them.
//
// Replaces: mcan_vqa_tpu/ops/sga_train.py::dump_prng_masks ->
//   _mask_dump_kernel (:1530, called at :1581), which writes the keep-masks
//   the TPU's hardware PRNG draws inside the _prng train kernels, so that
//   the in-kernel dropout can be held against the external-mask kernels fed
//   the same masks (tools/validate_prng_dropout.py). Here it serves both
//   blocks: the SGA block's six sites and the SA block's four.
//
// Each mask is keep iff word < thresh at the same (seed, site + head,
// sample, element) as the kernels' philox_keep (common.cuh), in the layout
// of sga_train.mask_shapes / sa_train.mask_shapes: per sample, per head
// (attention sites), a row of n elements; element e takes word e & 3 of
// counter (e >> 2, b). philox_words writes the words themselves, uint32
// [B, n] under one key.
//
// Bound on an H100: the integer work. Per counter, ten rounds of two
// 32 x 32 -> 64-bit products and two three-input XORs, and for the masks
// four compares: 44 operations for 4 keep bytes (40 for 16 bytes of
// words), at 64 INT32 lanes an SM; the bytes written take about half that
// time at 3.35 TB/s (chip_smoke.py's bound_parts).
//
// Design. kernels.prng_plan fixes every number of a launch from the shapes
// and the SM count; mcan_prng_masks / mcan_philox_words check the plan
// against the call and derive nothing it fixes.
// - A thread's work item is a chunk, 16 bytes of one row (site, sample,
//   head): the keep bytes of 4 consecutive counters, or the 4 words of one.
//   It runs the 4 counters' rounds interleaved, stepping the row's key
//   once a round for all 4 (in philox4x32_10 every counter steps its own),
//   and writes the chunk with the widest store that the site's rows align
//   to: one 16-byte store where a row is a multiple of 16 bytes, else 8-,
//   4-, 2- or 1-byte stores, the plan's width (att2's n = 840 at
//   MCAN-small: 8). So a warp's store is 512 contiguous bytes. (Words
//   drawn 4 counters a thread, 4 stores 64 bytes apart a lane, ran slower
//   on an H100 than one counter a thread.)
// - One wave of CTAs (4 of 256 threads an SM, none without a chunk)
//   strides over the chunks laid end to end sample by sample: sample b
//   holds its sites' chunks one after the other (the plan's prefixes), so
//   every CTA does the same share ± one chunk a thread, whatever the sites'
//   sizes. Sample-major rather than site-major so that a thread's index
//   within a sample stays a 32-bit number whatever B is: a thread divides
//   its first index once, then steps by the plan's (samples, chunks)
//   stride with one compare. A chunk finds its site by comparing with at
//   most 6 prefixes, and its head and place in the row by one division by
//   the site's chunks a row, a multiply-high by the plan's magic number.
//   No 64-bit division is left, and B may pass 65,535 (it was grid y).
//   The 64-bit arithmetic left is the output address.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256, BLOCKS_PER_SM = 4, MAX_SITES = 6, CHUNK_BYTES = 16;
constexpr int HEAD_FIELDS = 7, SITE_FIELDS = 6;  // kernels.PrngPlan.fields
constexpr unsigned NO_SITE = 0xFFFFFFFFu;         // the prefix of an absent site

// q / d for every 32-bit q, from the plan's (m, s1, s2) for d
// (kernels._magic: Granlund and Montgomery's round-up method, as libdivide
// writes it branch-free)
__host__ __device__ __forceinline__ unsigned fast_div(unsigned q, unsigned m, unsigned s1,
                                                      unsigned s2) {
#ifdef __CUDA_ARCH__
  const unsigned t = __umulhi(q, m);
#else
  const unsigned t = static_cast<unsigned>((static_cast<unsigned long long>(q) * m) >> 32);
#endif
  return (t + ((q - t) >> s1)) >> s2;
}

struct Site {
  unsigned char* out;  // [B, heads, n] elements
  unsigned first;      // the site's first chunk in a sample's
  unsigned per_row;    // chunks a row: ceil(n / elements a chunk)
  unsigned mul, s1, s2;  // q / per_row = fast_div(q, mul, s1, s2)
  unsigned code;       // the key's second word for head 0
  unsigned heads, n;   // rows a sample, elements a row
  unsigned width;      // bytes a store
};

struct Plan {
  Site s[MAX_SITES];
  unsigned B, per_sample;  // samples, chunks a sample
  unsigned step_b, step_j;  // the grid's stride: step_b samples + step_j chunks
  unsigned seed, thresh;
};

// one round of Philox4x32-10 (common.cuh's philox4x32_10)
__device__ __forceinline__ uint4 philox_round(uint4 c, unsigned k0, unsigned k1) {
  const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
  const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
  return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

// w[i] = philox4x32_10((c + i, b, 0, 0), (seed, site)), i < C
template <int C>
__device__ __forceinline__ void philox_n(uint4 (&w)[C], unsigned c, unsigned b, unsigned seed,
                                         unsigned site) {
#pragma unroll
  for (int i = 0; i < C; ++i) w[i] = make_uint4(c + i, b, 0u, 0u);
  unsigned k0 = seed, k1 = site;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int i = 0; i < C; ++i) w[i] = philox_round(w[i], k0, k1);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// the four keep bytes of one counter's words, element e & 3 in byte e & 3
__device__ __forceinline__ unsigned keep4(uint4 w, unsigned t) {
  return (w.x < t ? 1u : 0u) | (w.y < t ? 0x100u : 0u) | (w.z < t ? 0x10000u : 0u) |
         (w.w < t ? 0x1000000u : 0u);
}

// the first `bytes` of v (a multiple of W, at most 16) to o (W-aligned), W
// bytes a store
template <int W>
__device__ __forceinline__ void store_w(unsigned char* o, uint4 v, unsigned bytes) {
  if constexpr (W == 16) {
    if (bytes == 16) *reinterpret_cast<uint4*>(o) = v;
  } else {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; k += W) {
      if (k >= static_cast<int>(bytes)) break;
      if constexpr (W == 8)
        *reinterpret_cast<uint2*>(o + k) = make_uint2(u[k / 4], u[k / 4 + 1]);
      else if constexpr (W == 4)
        *reinterpret_cast<unsigned*>(o + k) = u[k / 4];
      else if constexpr (W == 2)
        *reinterpret_cast<unsigned short*>(o + k) =
            static_cast<unsigned short>(u[k / 4] >> (8 * (k % 4)));
      else
        o[k] = static_cast<unsigned char>(u[k / 4] >> (8 * (k % 4)));
    }
  }
}

__device__ __forceinline__ void store(unsigned char* o, uint4 v, unsigned bytes, unsigned width) {
  switch (width) {
    case 16: store_w<16>(o, v, bytes); break;
    case 8: store_w<8>(o, v, bytes); break;
    case 4: store_w<4>(o, v, bytes); break;
    case 2: store_w<2>(o, v, bytes); break;
    default: store_w<1>(o, v, bytes);
  }
}

// WORDS: philox_words (uint32 elements, the words, one counter a chunk);
// else the keep bytes (4 counters a chunk)
template <bool WORDS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) prng_kernel(const __grid_constant__ Plan p) {
  constexpr unsigned CTRS = WORDS ? 1 : 4, ELEMS = 4 * CTRS;  // a chunk's
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  unsigned b = t / p.per_sample, j = t - b * p.per_sample;
  const unsigned wrap = p.per_sample - p.step_j;  // j past it carries a sample
  while (b < p.B) {
    int s = 0;
#pragma unroll
    for (int i = 1; i < MAX_SITES; ++i) s += j >= p.s[i].first ? 1 : 0;
    const Site& st = p.s[s];
    const unsigned q = j - st.first;
    const unsigned h = fast_div(q, st.mul, st.s1, st.s2), c = q - h * st.per_row;
    uint4 w[CTRS];
    philox_n<CTRS>(w, CTRS * c, b, p.seed, st.code + h);
    const unsigned len = min(ELEMS, st.n - ELEMS * c);  // the chunk's elements
    const size_t at = (static_cast<size_t>(b) * st.heads + h) * st.n + static_cast<size_t>(ELEMS) * c;
    if constexpr (WORDS) {
      store(st.out + 4 * at, w[0], 4 * len, st.width);
    } else {
      store(st.out + at,
            make_uint4(keep4(w[0], p.thresh), keep4(w[1], p.thresh), keep4(w[2], p.thresh),
                       keep4(w[3], p.thresh)),
            len, st.width);
    }
    if (j >= wrap) {
      j -= wrap;
      b += p.step_b + 1;
    } else {
      j += p.step_j;
      b += p.step_b;
    }
  }
}

// The plan's fields (kernels.PrngPlan.fields: n_sites, B, per_sample,
// grid, threads, step_b, step_j, then per site first, per_row, mul, s1, s2,
// width) checked against the call's shapes (esize: bytes an element) into
// p; -> the grid, or 0 where the plan does not fit the call.
unsigned take_plan(Plan& p, int n_sites, unsigned char* const* outs, const unsigned* codes,
                   const int* heads, const int* n, int B, unsigned esize, const unsigned* f,
                   int n_fields) {
  if (n_sites < 1 || n_sites > MAX_SITES || n_fields != HEAD_FIELDS + SITE_FIELDS * n_sites ||
      f[0] != static_cast<unsigned>(n_sites) || B < 1 || f[1] != static_cast<unsigned>(B) ||
      f[4] != static_cast<unsigned>(THREADS))
    return 0;
  p = Plan{};
  unsigned long long first = 0;
  for (int i = 0; i < MAX_SITES; ++i) p.s[i].first = NO_SITE;
  for (int i = 0; i < n_sites; ++i) {
    const unsigned* g = f + HEAD_FIELDS + SITE_FIELDS * i;
    Site& st = p.s[i];
    if (heads[i] < 0 || n[i] < 0) return 0;
    st = Site{outs[i], g[0], g[1], g[2], g[3], g[4], codes[i], static_cast<unsigned>(heads[i]),
              static_cast<unsigned>(n[i]), g[5]};
    const unsigned w = st.width;
    const unsigned elems = CHUNK_BYTES / esize;
    if (st.first != first || st.per_row != (st.n + elems - 1) / elems || w > CHUNK_BYTES ||
        w < 1 || (w & (w - 1)) != 0 || (static_cast<unsigned long long>(st.n) * esize) % w != 0 ||
        reinterpret_cast<uintptr_t>(st.out) % w != 0 || st.s1 > 1 || st.s2 > 31)
      return 0;
    const unsigned long long chunks = static_cast<unsigned long long>(st.heads) * st.per_row;
    // the magic number at the edges of the site's chunk indices
    const unsigned long long edges[5] = {0ull, st.per_row - 1ull, st.per_row, st.per_row + 1ull,
                                         chunks - 1};
    for (const unsigned long long q : edges)
      if (q < chunks && fast_div(static_cast<unsigned>(q), st.mul, st.s1, st.s2) != q / st.per_row)
        return 0;
    first += chunks;
  }
  const unsigned long long per_sample = first, grid = f[3];
  const unsigned long long stride = grid * THREADS;
  if (per_sample != f[2] || per_sample == 0 || per_sample > 0xFFFFFFFFull || grid < 1 ||
      (grid - 1) * THREADS >= per_sample * static_cast<unsigned long long>(B) ||
      stride > 0x7FFFFFFFull || f[6] >= per_sample ||
      static_cast<unsigned long long>(f[5]) * per_sample + f[6] != stride)
    return 0;
  p.B = static_cast<unsigned>(B);
  p.per_sample = static_cast<unsigned>(per_sample);
  p.step_b = f[5];
  p.step_j = f[6];
  return static_cast<unsigned>(grid);
}

}  // namespace

// n_sites (1..6) masks of one block, each uint8 [B, heads[i], n[i]]
// contiguous at outs[i], head h keyed by the site code sites[i] + h: keep
// iff the Philox word of key (seed, site) at counter (e >> 2, b) is below
// thresh. plan: the n_fields fields of kernels.prng_plan. The arrays are
// host arrays. Returns cudaGetLastError(), or cudaErrorInvalidValue where
// the plan does not fit the call.
MCAN_API int mcan_prng_masks(int n_sites, const void* outs, const void* sites, const void* heads,
                             const void* n, int B, unsigned seed, unsigned thresh,
                             const void* plan, int n_fields, void* stream) {
  Plan p;
  const unsigned grid = take_plan(p, n_sites, static_cast<unsigned char* const*>(outs),
                                  static_cast<const unsigned*>(sites), static_cast<const int*>(heads),
                                  static_cast<const int*>(n), B, 1, static_cast<const unsigned*>(plan),
                                  n_fields);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.seed = seed;
  p.thresh = thresh;
  prng_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// out uint32 [B, n]: out[b, e] = word e & 3 of Philox4x32-10 with key
// (seed, site) at counter (e >> 2, b, 0, 0). plan: kernels.prng_plan's
// fields for the one site (1 head, n words of 4 bytes).
MCAN_API int mcan_philox_words(unsigned seed, unsigned site, int B, int n, void* out,
                               const void* plan, int n_fields, void* stream) {
  Plan p;
  unsigned char* outs[1] = {static_cast<unsigned char*>(out)};
  const int heads = 1;
  const unsigned grid = take_plan(p, 1, outs, &site, &heads, &n, B, 4,
                                  static_cast<const unsigned*>(plan), n_fields);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.seed = seed;
  prng_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// info[0..2] = the registers a thread, the local (spilled) bytes a thread
// and the most threads a CTA of prng_kernel<words>, as compiled
MCAN_API int mcan_prng_kernel_attrs(int words, void* info) {
  cudaFuncAttributes a{};
  const cudaError_t e = words ? cudaFuncGetAttributes(&a, prng_kernel<true>)
                              : cudaFuncGetAttributes(&a, prng_kernel<false>);
  int* out = static_cast<int*>(info);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  return static_cast<int>(e);
}
