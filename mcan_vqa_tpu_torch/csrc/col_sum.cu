// col_sum: out[c] = sum over rows r of x[r, c], f32 sums of f32 or bf16
// matrices, for up to four matrices with the same number of rows in one
// launch.
//
// Replaces: the row-sum partials of the TPU train kernels' weight
//   gradients, mcan_vqa_tpu/ops/sga_train.py::_rsum (:406) accumulated by
//   _acc (:390) -- the bias gradients db1, db2 (:526, :528), dbqkv, dbm1,
//   dbq2, dbm2 (:785-793) and the LayerNorm gradients dln*_s = sum(g * u),
//   dln*_b = sum(g) (:529-530, :788-795), summed over all B * Lv rows; and
//   the same twelve sums of mcan_vqa_tpu/ops/sa_train.py::_bwd_body
//   (:273-284). Under bf16_saves the upstream gradient gv2 is bf16
//   (sga_train.py:1032), and dln2_b sums it as it is.
//
// Bounds on an H100: memory -- each input element is read once for one
// add (7.9 MB per [3840, 512] f32 matrix, 2.3 us at 3.35 TB/s); a call of
// the MCAN-small step sums 2048-3584 columns of 3840 rows, 31-55 MB.
//
// Design: a split reduction over the whole card, in a fixed order. The
// columns of every matrix are cut into chunks of CHUNK = 128 and the rows
// into `slabs` slabs (split s: rows [s R / S, (s + 1) R / S)), both from
// the shapes alone (ops/kernels.py::col_sum_plan: as many chunks x slabs
// as the SMs hold at four blocks each, one wave); one block per work item
// (chunk, slab). In a block, thread (g, t) sums the rows g, g + G, ... of its slab
// in order over VEC columns with 16-byte loads (4 f32 or 8 bf16; G = 8 or
// 16 row groups), four rows in flight, and the G partials are added in
// order g = 0 .. G-1 through shared memory. With one slab the block writes
// the sums; else it writes its partial to a workspace the wrapper
// allocates and bumps the chunk's counter (the only atomic): the last
// block to arrive adds the S partials in slab order 0 .. S-1, writes the
// sums and puts the counter back to 0 for the next launch (gemm_sm90.cu's
// split-K protocol). Every sum's order is fixed by the plan, so the same
// inputs give the same bits on every run. A matrix whose rows are not
// 16-byte aligned (a width that is not a multiple of VEC, an odd row
// stride, an offset view) is read one element at a time in the same order.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int CHUNK = 128, THREADS = 256, MAX_SUMS = 4, UNROLL = 4, LAST_BATCH = 32;

struct Sums {
  const void* src[MAX_SUMS];
  int bf16_src[MAX_SUMS];       // 1: src is bf16, else f32
  int vec[MAX_SUMS];            // 1: rows read in 16-byte pieces
  long long ld[MAX_SUMS];
  int cols[MAX_SUMS];
  float* dst[MAX_SUMS];
  int chunk0[MAX_SUMS + 1];     // matrix i's chunks are chunk0[i] .. chunk0[i + 1] - 1
};

// VEC columns of one row into acc, in f32
template <bool BF16, int VEC>
__device__ __forceinline__ void load_row(float (&v)[VEC], const void* src, long long ld, int row,
                                         int col, int cols, bool vec) {
  if (BF16) {
    const bf16* p = static_cast<const bf16*>(src) + static_cast<size_t>(row) * ld + col;
    if (vec) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = col + i < cols ? to_f32(p[i]) : 0.0f;
    }
  } else {
    const float* p = static_cast<const float*>(src) + static_cast<size_t>(row) * ld + col;
    if (vec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = col + i < cols ? p[i] : 0.0f;
    }
  }
}

// this thread's partial sums of rows r0 + g, r0 + g + G, ... < r1 over its
// VEC columns, in row order, UNROLL rows in flight
template <bool BF16>
__device__ __forceinline__ void slab_sums(float* part, const Sums& s, int which, int chunk, int r0,
                                          int r1) {
  constexpr int VEC = BF16 ? 8 : 4, COL_THREADS = CHUNK / VEC, G = THREADS / COL_THREADS;
  const int t = threadIdx.x % COL_THREADS, g = threadIdx.x / COL_THREADS;
  const int col = chunk * CHUNK + t * VEC, cols = s.cols[which];
  const void* src = s.src[which];
  const long long ld = s.ld[which];
  const bool vec = s.vec[which] != 0;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  if (col < cols) {
    int r = r0 + g;
    for (; r + (UNROLL - 1) * G < r1; r += UNROLL * G) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load_row<BF16, VEC>(v[u], src, ld, r + u * G, col, cols, vec);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];
    }
    for (; r < r1; r += G) {
      float v[VEC];
      load_row<BF16, VEC>(v, src, ld, r, col, cols, vec);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += v[i];
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) part[g * CHUNK + t * VEC + i] = acc[i];
}

// four blocks an SM (64 registers a thread at most): the plan's grid is
// one wave
__global__ void __launch_bounds__(THREADS, 4)
col_sum_kernel(Sums s, int rows, int slabs, int chunks, float* __restrict__ ws,
               int* __restrict__ counters) {
  __shared__ float part[THREADS / (CHUNK / 8) * CHUNK];   // G x CHUNK, G <= 16
  __shared__ int last;
  const int chunk = blockIdx.x % chunks, slab = blockIdx.x / chunks;
  int which = 0;
  while (chunk >= s.chunk0[which + 1]) ++which;
  const int c = chunk - s.chunk0[which];   // the chunk within its matrix
  const int r0 = static_cast<int>(static_cast<long long>(slab) * rows / slabs);
  const int r1 = static_cast<int>(static_cast<long long>(slab + 1) * rows / slabs);
  const bool bf = s.bf16_src[which] != 0;
  if (bf)
    slab_sums<true>(part, s, which, c, r0, r1);
  else
    slab_sums<false>(part, s, which, c, r0, r1);
  __syncthreads();
  // the G row groups' partials of column j, in order
  const int j = threadIdx.x, col = c * CHUNK + j, cols = s.cols[which];
  const int G = bf ? THREADS / (CHUNK / 8) : THREADS / (CHUNK / 4);
  float tot = 0.0f;
  if (j < CHUNK) {
    for (int k = 0; k < G; ++k) tot += part[k * CHUNK + j];
  }
  if (slabs == 1) {
    if (j < CHUNK && col < cols) s.dst[which][col] = tot;
    return;
  }
  float* slots = ws + static_cast<size_t>(chunk) * slabs * CHUNK;
  if (j < CHUNK) slots[static_cast<size_t>(slab) * CHUNK + j] = tot;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(&counters[chunk], 1) == slabs - 1;
    if (done) counters[chunk] = 0;   // ready for the next launch
    last = done;
  }
  __syncthreads();
  if (!last || j >= CHUNK) return;
  __threadfence();
  // the last block: every slab's partial (its own too, as written), in
  // slab order, LAST_BATCH loads in flight at a time
  float sum = 0.0f;
  for (int s0 = 0; s0 < slabs; s0 += LAST_BATCH) {
    float v[LAST_BATCH];
#pragma unroll
    for (int k = 0; k < LAST_BATCH; ++k)
      v[k] = s0 + k < slabs ? __ldcg(slots + static_cast<size_t>(s0 + k) * CHUNK + j) : 0.0f;
#pragma unroll
    for (int k = 0; k < LAST_BATCH; ++k)
      if (s0 + k < slabs) sum = s0 + k == 0 ? v[k] : sum + v[k];
  }
  if (col < cols) s.dst[which][col] = sum;
}

}  // namespace

// n (1..4) column sums over `rows` rows: srcs[i] [rows, cols[i]], bf16
// where bf16s[i] != 0 else f32, with row stride lds[i] (elements), dsts[i]
// f32 [cols[i]]. The plan of ops/kernels.py::col_sum_plan: `slabs` (1 ..
// rows) row slabs of every 128-column chunk; slabs > 1 needs `workspace`
// (f32, the chunks x slabs x 128) and `counters` (an int per chunk, 0
// before the launch and left 0). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for n outside 1..4 or a plan it does not take.
MCAN_API int mcan_col_sum(int n, const void* const* srcs, const int* bf16s, const long long* lds,
                          const int* cols, void* const* dsts, int rows, int slabs, void* workspace,
                          void* counters, void* stream) {
  if (n < 1 || n > MAX_SUMS || rows < 0 || slabs < 1 || (rows > 0 && slabs > rows) ||
      (slabs > 1 && (workspace == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Sums s{};
  int chunks = 0;
  for (int i = 0; i < n; ++i) {
    if (cols[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int vec = bf16s[i] ? 8 : 4;
    s.src[i] = srcs[i];
    s.bf16_src[i] = bf16s[i];
    s.vec[i] = reinterpret_cast<uintptr_t>(srcs[i]) % 16 == 0 && lds[i] % vec == 0 &&
               cols[i] % vec == 0;
    s.ld[i] = lds[i];
    s.cols[i] = cols[i];
    s.dst[i] = static_cast<float*>(dsts[i]);
    s.chunk0[i] = chunks;
    chunks += (cols[i] + CHUNK - 1) / CHUNK;
  }
  for (int i = n; i <= MAX_SUMS; ++i) s.chunk0[i] = chunks;
  if (rows > 0 && chunks > 0) {
    col_sum_kernel<<<chunks * slabs, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        s, rows, slabs, chunks, static_cast<float*>(workspace), static_cast<int*>(counters));
  }
  return static_cast<int>(cudaGetLastError());
}
