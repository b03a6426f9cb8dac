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
// (attention sites), a slab of n elements; element e takes word e & 3 of
// counter (e >> 2, b).
//
// Bounds on an H100: memory -- one byte written per element, ~60 integer
// instructions per 4 elements (ten rounds, two 32-bit products each).
// Design: one thread per (site, sample, head, counter): it runs Philox once
// and writes the 4 elements of that counter; the sites of one block in one
// launch (grid z), samples in grid y.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, MAX_SITES = 6, MAX_X = 1024;

struct Site {
  unsigned char* out;  // [B, heads, n]
  unsigned site;       // the code of head 0
  int heads;
  int n;               // elements per (sample, head)
};

struct Sites {
  Site s[MAX_SITES];
};

__global__ void __launch_bounds__(THREADS)
prng_masks_kernel(Sites sites, unsigned seed, unsigned thresh) {
  const Site st = sites.s[blockIdx.z];
  const unsigned b = blockIdx.y;
  const int n4 = (st.n + 3) / 4;
  const long long per_sample = (long long)st.heads * n4;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < per_sample;
       t += (long long)gridDim.x * THREADS) {
    const int h = static_cast<int>(t / n4), c = static_cast<int>(t % n4);
    const uint4 w = philox4x32_10(make_uint4(c, b, 0u, 0u), make_uint2(seed, st.site + h));
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    unsigned char* o = st.out + ((size_t)b * st.heads + h) * st.n + 4 * (size_t)c;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * c + k < st.n) o[k] = words[k] < thresh ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
philox_words_kernel(unsigned seed, unsigned site, int n, unsigned* out) {
  const unsigned b = blockIdx.y;
  const int n4 = (n + 3) / 4;
  for (int c = blockIdx.x * THREADS + threadIdx.x; c < n4; c += gridDim.x * THREADS) {
    const uint4 w = philox4x32_10(make_uint4(c, b, 0u, 0u), make_uint2(seed, site));
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    unsigned* o = out + (size_t)b * n + 4 * (size_t)c;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * c + k < n) o[k] = words[k];
  }
}

int blocks_for(long long work) {
  const long long x = (work + THREADS - 1) / THREADS;
  return static_cast<int>(x < 1 ? 1 : x > MAX_X ? MAX_X : x);
}

}  // namespace

// n_sites (1..6) masks of one block, each uint8 [B, heads[i], n[i]]
// contiguous at outs[i], head h keyed by the site code sites[i] + h: keep
// iff the Philox word of key (seed, site) at counter (e >> 2, b) is below
// thresh. The four arrays are host arrays. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a bad count.
MCAN_API int mcan_prng_masks(int n_sites, const void* outs, const void* sites, const void* heads,
                             const void* n, int B, unsigned seed, unsigned thresh, void* stream) {
  if (n_sites < 1 || n_sites > MAX_SITES) return static_cast<int>(cudaErrorInvalidValue);
  Sites ss{};
  long long most = 0;
  for (int i = 0; i < n_sites; ++i) {
    Site& st = ss.s[i];
    st.out = static_cast<unsigned char* const*>(outs)[i];
    st.site = static_cast<const unsigned*>(sites)[i];
    st.heads = static_cast<const int*>(heads)[i];
    st.n = static_cast<const int*>(n)[i];
    const long long w = (long long)st.heads * ((st.n + 3) / 4);
    if (w > most) most = w;
  }
  if (B > 0 && most > 0) {
    dim3 grid(blocks_for(most), B, n_sites);
    prng_masks_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(ss, seed, thresh);
  }
  return static_cast<int>(cudaGetLastError());
}

// out uint32 [B, n]: out[b, e] = word e & 3 of Philox4x32-10 with key
// (seed, site) at counter (e >> 2, b, 0, 0).
MCAN_API int mcan_philox_words(unsigned seed, unsigned site, int B, int n, void* out,
                               void* stream) {
  if (B > 0 && n > 0) {
    dim3 grid(blocks_for((n + 3) / 4), B);
    philox_words_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        seed, site, n, static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
