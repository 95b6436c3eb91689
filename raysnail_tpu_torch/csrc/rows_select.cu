// Per-ray row selects for Hopper (sm_90a): K7, the gather of a small table's
// rows by per-ray indices, and K7b, its transpose summed in one fixed order.
//
// Replaces XLA's one-hot select of the JAX package, which has no Pallas
// kernel: on any backend but the CPU, every small-table row fetch of a
// material or texture is sum(where(onehot(idx), table, 0), axis=1)
// (raysnail_tpu/geometry/hit.py:88-104 `onehot_of`, `select_row`,
// `select_table`, called from materials.py:94 `gather`, :220 `gather_absorb`
// and textures.py:75 `_take`), and its transpose reduces the rays' cotangents
// into the rows in XLA's fixed order, with no atomics. Here the gather is a
// copy and the transpose a deterministic segmented sum: the card gives the
// same bits for the same inputs on every run.
//
// The table is K <= 8 float columns of R entries, each passed by its own
// pointer and element stride (the port keeps a table's fields as separate
// (R,) tensors), so nothing stacks them into one (R, K) array first.
//
// K7 (`rows_select_launch`): out[k][i] = column[k][idx[i]] into a (K, N)
// buffer, one launch for the K columns where K index_select calls were;
// each out[k] a contiguous (N,) row. An index outside [0, R) stops the
// kernel with a device-side assert, as index_select's does.
//
// K7b (`rows_select_bwd_launch`): grad[k][r] = the sum of g[k][i] over the
// rays i with idx[i] == r, in this order, which depends only on N:
//   (1) a segment is 32 consecutive rays (a warp): each row's cotangents
//       summed from +0.0 in ascending ray order;
//   (2) a run is kRunSegments = 8 consecutive segments (256 rays, one
//       warp's share): its segments' sums from +0.0 in ascending order;
//   (3) a chunk is kWarps = 8 consecutive runs (2,048 rays, one block): its
//       runs' sums from +0.0 in ascending order;
//   (4) the grad: the chunks' sums from +0.0 in ascending order.
// Each level equals the sequential sum of where(idx == r, g, 0) over its
// parts: a sum begun at +0.0 is never -0.0, so adding the +0.0 of a ray or
// a part without row r changes no bit. So a NaN cotangent stays in its own
// row. A null cotangent column reads as zeros (autograd's unused output).
// `ops.rows_select.rows_select_bwd_plain` sums in the same order; the two
// agree bit for bit.
//
// What bounds them on the card: bytes. K7 reads the index (8 bytes a ray)
// and writes K floats a ray; K7b reads the index and K floats a ray and
// writes R x K floats. At the train cell's 400,000 rays, materials (K = 4)
// move 9.6 MB: 2.87 us at 3.35 TB/s.
//
// K7b's design, against that bound and for any R:
// - Launch 1, one block a chunk (and a row tile, below): each of its 8 warps
//   walks its run a segment at a time. __match_any_sync groups the lanes of
//   a segment by row; the group's lowest lane (its leader) receives the
//   members' cotangents by shuffles in ascending lane order and sums them,
//   then adds the segment's sum to its warp's row sum in shared memory. The
//   rounds of shuffles are the largest group's size, whatever R is: a
//   dense sweep over the rows would cost R rounds. The leaders of a
//   segment hold distinct rows, so no two lanes touch one row.
// - The block adds its 8 warps' row sums in order and writes the chunk's
//   (R, K) sums to a buffer. No atomics: nothing depends on which block
//   runs first.
// - Launch 2 adds the chunks' sums in ascending order, a thread an entry,
//   into a (K, R) buffer: each column's gradient a contiguous (R,) row.
// - The warps' row sums live in shared memory, 8 x rows x K floats. Where R
//   x K is too large for kSmemBudget, the grid's second dimension tiles the
//   rows: a block sums only the rays of its tile's rows and skips a segment
//   none of whose rays is in its tile.
//
// Built with -fmad=false like the port's other kernels (there is nothing
// here for it to contract). The C entry points launch on the caller's
// stream, do not synchronise, allocate nothing (the wrapper passes the
// chunks' buffer), and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kThreads = 256;              // K7 and K7b launch 2: threads a block
constexpr int kSegment = 32;               // rays a segment: one warp's lanes
constexpr int kRunSegments = 8;            // segments a warp sums in turn
constexpr int kWarps = 8;                  // runs a chunk: a K7b block's warps
constexpr int kSmemBudget = 96 * 1024;     // bytes of warp row sums a K7b block may hold
constexpr int kMaxColumns = 8;
constexpr unsigned kFull = 0xffffffffu;

// K float columns, each with its element stride (a kernel argument)
struct Columns {
  const float* p[kMaxColumns];
  long long s[kMaxColumns];
};

template <int K>
__global__ void __launch_bounds__(kThreads)
rows_select_kernel(Columns table, const int64_t* __restrict__ idx, int n, int r,
                   float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t q = idx[i];
  assert(q >= 0 && q < r);
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[static_cast<int64_t>(k) * n + i] = __ldg(table.p[k] + q * table.s[k]);
}

// launch 1: grid (chunks, row tiles), kWarps warps a block; `rt_max` rows a
// tile; writes each chunk's sums of its tile's rows to part[chunk][row][k]
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
rows_select_bwd_kernel(Columns g, const int64_t* __restrict__ idx, int n, int r, int rt_max,
                       float* __restrict__ part) {
  extern __shared__ float sums[];  // [kWarps][rt][K]: each warp's row sums
  const int r0 = blockIdx.y * rt_max;
  const int rt = min(rt_max, r - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < kWarps * rt * K; e += kWarps * 32) sums[e] = 0.0f;
  __syncthreads();

  float* mine = sums + warp * rt * K;
  const int64_t run0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * (kRunSegments * kSegment);
  for (int seg = 0; seg < kRunSegments; ++seg) {
    const int64_t i = run0 + seg * kSegment + lane;
    int row = -1;  // -1: past N, or a row of another tile
    if (i < n) {
      const int64_t q = idx[i];
      assert(q >= 0 && q < r);
      if (q >= r0 && q < r0 + rt) row = static_cast<int>(q - r0);
    }
    if (__ballot_sync(kFull, row >= 0) == 0u) continue;  // uniform across the warp
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = row >= 0 && g.p[k] != nullptr ? g.p[k][i * g.s[k]] : 0.0f;
    const unsigned same = __match_any_sync(kFull, row);
    const bool lead = row >= 0 && __ffs(same) - 1 == lane;
    const int rounds = __reduce_max_sync(kFull, row >= 0 ? __popc(same) : 0);
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = 0.0f;
    unsigned rest = same;  // the members not yet received, lowest first
    for (int t = 0; t < rounds; ++t) {
      const bool has = rest != 0u;
      const int src = has ? __ffs(rest) - 1 : lane;
      rest &= rest - 1u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float w = __shfl_sync(kFull, v[k], src);
        if (lead && has) s[k] = s[k] + w;
      }
    }
    if (lead) {
#pragma unroll
      for (int k = 0; k < K; ++k) mine[row * K + k] = mine[row * K + k] + s[k];
    }
    __syncwarp();  // the next segment's leaders read these sums
  }
  __syncthreads();

  // the chunk's sums: its warps' (runs') sums from +0.0 in ascending order
  float* dst = part + (static_cast<int64_t>(blockIdx.x) * r + r0) * K;
  for (int e = threadIdx.x; e < rt * K; e += kWarps * 32) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc = acc + sums[w * rt * K + e];
    dst[e] = acc;
  }
}

// launch 2: out[k][row] = the chunks' sums of entry (row, k) from +0.0 in
// ascending order
template <int K>
__global__ void __launch_bounds__(kThreads)
rows_select_bwd_combine_kernel(const float* __restrict__ part, int chunks, int r,
                               float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= r * K) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) acc = acc + part[static_cast<int64_t>(c) * r * K + e];
  out[(e % K) * r + e / K] = acc;
}

int rows_tile(int r, int k) {
  return min(r, kSmemBudget / (kWarps * k * static_cast<int>(sizeof(float))));
}

Columns columns_of(int k, const void* const* ptrs, const long long* strides) {
  Columns c{};
  for (int j = 0; j < k; ++j) {
    c.p[j] = static_cast<const float*>(ptrs[j]);
    c.s[j] = strides[j];
  }
  return c;
}

template <int K>
cudaError_t launch_fwd(const Columns& table, const void* idx, int n, int r, void* out,
                       cudaStream_t st) {
  rows_select_kernel<K><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      table, static_cast<const int64_t*>(idx), n, r, static_cast<float*>(out));
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_bwd(const Columns& g, const void* idx, int n, int r, void* part,
                       void* out, cudaStream_t st) {
  const int rt = rows_tile(r, K);
  const int smem = kWarps * rt * K * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_select_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int chunks = (n + kWarps * kRunSegments * kSegment - 1) /
                     (kWarps * kRunSegments * kSegment);
  const dim3 grid(chunks, (r + rt - 1) / rt);
  rows_select_bwd_kernel<K><<<grid, kWarps * 32, smem, st>>>(
      g, static_cast<const int64_t*>(idx), n, r, rt, static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_select_bwd_combine_kernel<K><<<(r * K + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(part), chunks, r, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// K7: k columns cols[j] (R entries, element stride strides[j]) f32, idx (N,)
// int64, out (k, N) f32 row-major; N, R >= 1
extern "C" int rows_select_launch(const void* const* cols, const long long* strides,
                                  const void* idx, int n, int r, int k, void* out,
                                  void* stream) {
  if (n <= 0 || r <= 0 || k < 1 || k > kMaxColumns)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const Columns table = columns_of(k, cols, strides);
  switch (k) {
#define RS_FWD(KK) \
  case KK: return static_cast<int>(launch_fwd<KK>(table, idx, n, r, out, st));
    RS_FWD(1) RS_FWD(2) RS_FWD(3) RS_FWD(4) RS_FWD(5) RS_FWD(6) RS_FWD(7) RS_FWD(8)
#undef RS_FWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7b: k cotangent columns gs[j] (N entries, element stride strides[j]; null
// for zeros) f32, idx (N,) int64, part (chunks, R, k) f32 scratch, out
// (k, R) f32 row-major; N, R >= 1
extern "C" int rows_select_bwd_launch(const void* const* gs, const long long* strides,
                                      const void* idx, int n, int r, int k, void* part,
                                      void* out, void* stream) {
  if (n <= 0 || r <= 0 || k < 1 || k > kMaxColumns)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const Columns g = columns_of(k, gs, strides);
  switch (k) {
#define RS_BWD(KK) \
  case KK: return static_cast<int>(launch_bwd<KK>(g, idx, n, r, part, out, st));
    RS_BWD(1) RS_BWD(2) RS_BWD(3) RS_BWD(4) RS_BWD(5) RS_BWD(6) RS_BWD(7) RS_BWD(8)
#undef RS_BWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
