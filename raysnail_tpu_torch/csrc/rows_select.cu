// Per-ray row selects for Hopper (sm_90a): K7, the gather of a small table's
// rows by per-ray indices, and K7b, its transpose summed in one fixed order.
//
// Replaces XLA's one-hot select of the JAX package, which has no Pallas
// kernel: on any backend but the CPU, every small-table row fetch of a
// material or texture is sum(where(onehot(idx), table, 0), axis=1)
// (raysnail_tpu/geometry/hit.py:88-104 `onehot_of`, `select_row`,
// `select_table`, called from materials.py:94 `gather`, :220 `gather_absorb`
// and textures.py:75 `_take`), and its transpose reduces the rays' cotangents
// into the rows in XLA's fixed order. Here the gather is a copy and the
// transpose a deterministic segmented sum: the card gives the same bits for
// the same inputs on every run.
//
// The table is K <= 8 float columns of R entries, each passed by its own
// pointer and element stride (the port keeps a table's fields as separate
// (R,) tensors), so nothing stacks them into one (R, K) array first. Each
// entry point takes its arguments as one array of int64 and the stream
// (the wrapper packs them in one call: its host time is K7's call).
//
// K7 (`rows_select_launch`): out[k][i] = column[k][idx[i]] into a (K, N)
// buffer, one launch for the K columns where K index_select calls were;
// each out[k] a contiguous (N,) row. An index outside [0, R) stops the
// kernel with a device-side assert, as index_select's does.
//
// K7b (`rows_select_bwd_launch`): grad[k][r] = the sum of g[k][i] over the
// rays i with idx[i] == r, in this order, which depends only on N:
//   (1) a segment is kSegment = 32 consecutive rays: each row's cotangents
//       summed from +0.0 in ascending ray order;
//   (2) a run is kRunSegments = 8 consecutive segments (256 rays): its
//       segments' sums from +0.0 in ascending order;
//   (3) a chunk is kChunkRuns = 8 consecutive runs (2,048 rays, one block):
//       its runs' sums from +0.0 in ascending order;
//   (4) the grad: the chunks' sums from +0.0 in ascending order.
// Each level equals the sequential sum of where(idx == r, g, 0) over its
// parts: a sum begun at +0.0 is never -0.0, so adding the +0.0 of a ray or
// a part without row r changes no bit, and a part without row r may be
// skipped. So a NaN cotangent stays in its own row. A null cotangent column
// reads as zeros (autograd's unused output).
// `ops.rows_select.rows_select_bwd_plain` sums in the same order; the two
// agree bit for bit.
//
// What bounds them on the card: bytes. K7 reads the index (8 bytes a ray)
// and writes K floats a ray; K7b reads the index and K floats a ray and
// writes R x K floats. At the train cell's 400,000 rays, materials (K = 4)
// move 9.6 MB: 2.87 us at 3.35 TB/s.
//
// K7b's design. A segment's row sums are serial chains by definition, and a
// frame's hits come in long runs of one row, so a design that sums a
// segment across its lanes (a group leader pulling its members by shuffles)
// takes as many rounds as the segment's longest group, up to 32, while the
// other lanes idle. Instead, for a table of at most kMaxEntries entries
// (R x K), a block (a chunk, kChunkRuns warps) works in four phases over
// shared memory:
//   (A) staging: warp w reads run w's 8 segments, a lane a ray, coalesced,
//       all loads issued before the first is used; __match_any_sync groups
//       each segment's lanes by row, and five ballots of the groups' first
//       lanes (none for a segment of one row) rank each ray in the walk's
//       order (the groups by their first lane, each group's members by
//       lane). Rows, that order and the cotangents go to shared memory at a
//       stride of 33 words a segment (no bank conflicts).
//   (B) the walk: a thread a (segment, column) loads its segment's 32
//       cotangents in that order into registers, then adds them from +0.0,
//       leaving each group's sum in its first ray's slot, with no branch.
//       Every segment takes 32 steps whatever its rows, a warp's 32
//       segments side by side: 32 chains in flight instead of 1.
//   (C) the runs: warp w adds its run's 8 segments' sums in ascending order
//       into the run's row sums (R x K floats), a lane a group; the groups
//       of one segment hold distinct rows, so no two lanes touch one row.
//   (D) the chunk: its runs' sums in order, written to the (chunks, R, K)
//       partials (a chunk's padded to 16 bytes).
// Then, for a table of at most kOneLaunchEntries entries, one launch: each
// block takes a ticket (__threadfence, then one atomicAdd on a counter that
// the wrapper keeps per device and stream), and the block that takes the
// last one adds the chunks' partials in ascending chunk order, staged
// through its shared memory by 16-byte loads, and sets the counter back
// to 0. The ticket decides which block sums, never the order, so the bits
// depend on N only. A larger table takes a second launch for that sum,
// kFoldEntries entries a block, launched early (programmatic dependent
// launch): it waits in the kernel for the first to end, so no launch gap
// comes between them. Above kMaxEntries the run sums would not fit: PR 12's
// kernel tiles the rows over the grid's second dimension (a block sums only
// its tile's rows, a segment's group leaders pulling their members by
// shuffles), and the second launch adds the partials.
//
// Built with -fmad=false like the port's other kernels (there is nothing
// here for it to contract). The C entry points launch on the caller's
// stream, do not synchronise, allocate nothing (the wrapper passes the
// partials and the counter), and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int kThreads = 256;              // K7: threads a block
constexpr int kSegment = 32;               // rays a segment: one warp's lanes
constexpr int kRunSegments = 8;            // segments a run
constexpr int kChunkRuns = 8;              // runs a chunk: a K7b block's warps, one a run
constexpr int kChunkSegments = kChunkRuns * kRunSegments;  // segments a K7b block walks
constexpr int kChunk = kChunkSegments * kSegment;          // rays a K7b block
constexpr int kPad = kSegment + 1;         // words a segment in shared memory
constexpr int kSmemBudget = 96 * 1024;     // bytes of run row sums a K7b block may hold
constexpr int kMaxEntries = kSmemBudget / (kChunkRuns * 4);  // R x K without row tiles
constexpr int kOneLaunchEntries = 64;      // R x K up to which the last block adds the chunks
constexpr int kEnd = 1 << 5;               // a walk entry: its lane, kEnd if last of its
constexpr int kHeadShift = 6;              // group, and the group's first lane
constexpr int kPadEntry = kSegment << kHeadShift | kEnd;  // a step past the rays: the pad
constexpr int kFoldEntries = 32;           // entries a block of the second launch adds
constexpr int kFoldTile = 8192;            // floats of partials it stages at a time
constexpr int kFoldLoads = 16;             // 16-byte loads a thread has in flight
constexpr int kFoldLanes = 16;             // threads that load one chunk's (up to 64) entries
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

// out[k][row] for the entries e = row * k + col in [e0, e0 + ew) of the
// partials, a chunk every `stride` floats: the chunks' sums from +0.0 in
// ascending order, staged through `tile` (cap floats) a piece of chunks at
// a time, 16 bytes a load, every load of a thread in flight at once; thread
// t < ew (<= 4 x kFoldLanes) sums entry e0 + t. e0 and stride are
// multiples of 4. The partials are read past L1: other blocks wrote them
// during this launch.
__device__ void fold_chunks(const float* part, int chunks, int stride, int r, int k, int e0,
                            int ew, float* tile, int cap, float* __restrict__ out) {
  const int q = (ew + 3) / 4;                       // 16-byte loads a chunk
  const int lane = threadIdx.x % kFoldLanes;        // a load of a chunk
  const int rows = blockDim.x / kFoldLanes;         // chunks a pass of the block
  const int piece = min(cap / (4 * q), rows * kFoldLoads);
  const float4* src = reinterpret_cast<const float4*>(part + e0) + lane;
  float4* tile4 = reinterpret_cast<float4*>(tile);
  float acc = 0.0f;
  for (int c0 = 0; c0 < chunks; c0 += piece) {
    const int pc = min(piece, chunks - c0);
    float4 v[kFoldLoads];
#pragma unroll
    for (int u = 0; u < kFoldLoads; ++u) {
      const int c = threadIdx.x / kFoldLanes + u * rows;
      if (lane < q && c < pc) v[u] = __ldcg(src + static_cast<int64_t>(c0 + c) * (stride / 4));
    }
#pragma unroll
    for (int u = 0; u < kFoldLoads; ++u) {
      const int c = threadIdx.x / kFoldLanes + u * rows;
      if (lane < q && c < pc) tile4[c * q + lane] = v[u];
    }
    __syncthreads();
    if (threadIdx.x < ew) {
      const float* mine = tile + threadIdx.x;
#pragma unroll 16
      for (int c = 0; c < pc; ++c) acc = acc + mine[c * 4 * q];
    }
    __syncthreads();
  }
  if (threadIdx.x < ew) {
    const int e = e0 + threadIdx.x;
    out[static_cast<int64_t>(e % k) * r + e / k] = acc;
  }
}

// floats a chunk's partials take: R x K rounded up to 16 bytes
__host__ __device__ constexpr int padded(int entries) { return (entries + 3) / 4 * 4; }

// K7b's shared memory, in 4-byte words: each ray's row (-1 for none); the
// walk's order; the cotangents by column; each segment's group heads (first
// lanes) and rays; each run's row sums
__host__ __device__ constexpr int staged_words(int k) {
  return (2 + k) * kChunkSegments * kPad + 2 * kChunkSegments;
}

int smem_bytes(int r, int k) {
  return (staged_words(k) + kChunkRuns * r * k) * static_cast<int>(sizeof(float));
}

// Grid (chunks), kChunkRuns warps a block, R x K <= kMaxEntries. Writes each
// chunk's sums to part[chunk][row][k]; with a ticket counter the last block
// also writes out (K, R).
template <int K>
__global__ void __launch_bounds__(kChunkRuns * 32)
rows_select_bwd_kernel(Columns g, const int64_t* __restrict__ idx, int n, int r,
                       int smem_floats, float* __restrict__ part, unsigned* ticket,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  asm volatile("griddepcontrol.launch_dependents;");  // the second launch may start now
  int* row_s = reinterpret_cast<int*>(smem);
  int* walk_s = row_s + kChunkSegments * kPad;
  float* g_s = smem + 2 * kChunkSegments * kPad;
  unsigned* heads_s = reinterpret_cast<unsigned*>(g_s + K * kChunkSegments * kPad);
  int* count_s = reinterpret_cast<int*>(heads_s + kChunkSegments);
  float* run_s = smem + staged_words(K);
  __shared__ bool last;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // (A) staging: run `warp`'s segments, every load issued before the first
  // is used (the run sums are zeroed while they are in flight)
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kChunkRuns + warp) * (kRunSegments * kSegment) + lane;
  int64_t q[kRunSegments];
  float v[kRunSegments][K];
#pragma unroll
  for (int j = 0; j < kRunSegments; ++j) {
    const int64_t i = first + j * kSegment;
    q[j] = i < n ? idx[i] : -1;
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[j][k] = i < n && g.p[k] != nullptr ? g.p[k][i * g.s[k]] : 0.0f;
  }
  for (int e = threadIdx.x; e < kChunkRuns * r * K; e += blockDim.x) run_s[e] = 0.0f;
#pragma unroll
  for (int j = 0; j < kRunSegments; ++j) {
    const int s = warp * kRunSegments + j;
    assert(q[j] >= -1 && q[j] < r && (q[j] >= 0 || first + j * kSegment >= n));
    const int row = static_cast<int>(q[j]);
    const unsigned same = __match_any_sync(kFull, row);
    const int head = __ffs(same) - 1;
    const bool is_head = row >= 0 && head == lane;
    const unsigned heads = __ballot_sync(kFull, is_head);
    const unsigned rays = __ballot_sync(kFull, row >= 0);
    // the walk's order: the rays whose head is below this ray's head (their
    // groups come first; the heads' bit planes compared from the top bit),
    // then this group's rays below this lane
    unsigned lower = 0u, equal = kFull;
    if (__popc(heads) > 1) {  // uniform across the warp: a frame's segments mostly hold one
#pragma unroll
      for (int b = 4; b >= 0; --b) {
        const unsigned plane = __ballot_sync(kFull, (head >> b) & 1);
        if ((head >> b) & 1) {
          lower |= equal & ~plane;
          equal &= plane;
        } else {
          equal &= ~plane;
        }
      }
    }
    const int rank = __popc(lower & rays) + __popc(same & ((1u << lane) - 1u));
    row_s[s * kPad + lane] = row;
    if (row >= 0)
      walk_s[s * kPad + rank] = lane | ((same >> lane) == 1u ? kEnd : 0) | (head << kHeadShift);
#pragma unroll
    for (int k = 0; k < K; ++k) g_s[(k * kChunkSegments + s) * kPad + lane] = v[j][k];
    if (lane == 0) {
      heads_s[s] = heads;
      count_s[s] = __popc(rays);
    }
  }
  __syncthreads();

  // (B) the walk: a thread a (segment, column); each group's sum from +0.0
  // in ascending ray order, left in its head's slot. Every load comes before
  // the first store, so the loads are in flight together; each step stores
  // its running sum to its group's head slot, so a group's last step leaves
  // its sum there, and a step past the segment's rays writes the pad word.
  for (int task = threadIdx.x; task < K * kChunkSegments; task += blockDim.x) {
    const int s = task % kChunkSegments;
    float* gs = g_s + task * kPad;  // column task / kChunkSegments, segment s
    const int* walk = walk_s + s * kPad;
    const int steps = count_s[s];
    int e[kSegment];
    float x[kSegment];
#pragma unroll
    for (int p = 0; p < kSegment; ++p) e[p] = p < steps ? walk[p] : kPadEntry;
#pragma unroll
    for (int p = 0; p < kSegment; ++p) x[p] = gs[e[p] & (kSegment - 1)];
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < kSegment; ++p) {
      acc = acc + x[p];
      gs[e[p] >> kHeadShift] = acc;
      acc = e[p] & kEnd ? 0.0f : acc;
    }
  }
  __syncthreads();

  // (C) the run's row sums: its segments' sums in ascending order, a lane a
  // head (a segment's heads hold distinct rows); the heads, rows and sums
  // of the run's 8 segments loaded first
  {
    float* mine = run_s + warp * r * K;
    unsigned hs[kRunSegments];
    int rw[kRunSegments];
    float gv[kRunSegments][K];
#pragma unroll
    for (int j = 0; j < kRunSegments; ++j) {
      const int s = warp * kRunSegments + j;
      hs[j] = heads_s[s];
      rw[j] = row_s[s * kPad + lane];
#pragma unroll
      for (int k = 0; k < K; ++k) gv[j][k] = g_s[(k * kChunkSegments + s) * kPad + lane];
    }
#pragma unroll
    for (int j = 0; j < kRunSegments; ++j) {
      if ((hs[j] >> lane) & 1u) {
#pragma unroll
        for (int k = 0; k < K; ++k) mine[rw[j] * K + k] = mine[rw[j] * K + k] + gv[j][k];
      }
      __syncwarp();  // the next segment's heads may add to these rows
    }
  }
  __syncthreads();

  // (D) the chunk's sums: its runs' sums from +0.0 in ascending order
  float* dst = part + static_cast<int64_t>(blockIdx.x) * padded(r * K);
  for (int e = threadIdx.x; e < r * K; e += blockDim.x) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kChunkRuns; ++w) acc = acc + run_s[w * r * K + e];
    dst[e] = acc;
  }
  if (ticket == nullptr) return;  // a second launch adds the chunks

  // one launch: the block that takes the last ticket adds the chunks
  if (threadIdx.x < r * K) __threadfence();  // the partials are visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __threadfence();  // and the other blocks' partials visible to this block's reads
  }
  __syncthreads();
  if (!last) return;
  fold_chunks(part, gridDim.x, padded(r * K), r, K, 0, r * K, smem, smem_floats, out);
  if (threadIdx.x == 0) *ticket = 0u;  // every block has taken its ticket
}

// Above kMaxEntries (PR 12's kernel): grid (chunks, row tiles), kChunkRuns
// warps a block, `rt_max` rows a tile; writes each chunk's sums of its
// tile's rows to part[chunk][row][k] (padded). A warp walks its run a segment at a
// time: __match_any_sync groups the lanes by row, and each group's lowest
// lane (its leader) receives the members' cotangents by shuffles in lane
// order and adds their sum to the warp's row sums.
template <int K>
__global__ void __launch_bounds__(kChunkRuns * 32)
rows_select_bwd_tiles_kernel(Columns g, const int64_t* __restrict__ idx, int n, int r,
                             int rt_max, float* __restrict__ part) {
  extern __shared__ float sums[];  // [kChunkRuns][rt][K]: each warp's row sums
  asm volatile("griddepcontrol.launch_dependents;");  // the second launch may start now
  const int r0 = blockIdx.y * rt_max;
  const int rt = min(rt_max, r - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = threadIdx.x; e < kChunkRuns * rt * K; e += kChunkRuns * 32) sums[e] = 0.0f;
  __syncthreads();

  float* mine = sums + warp * rt * K;
  const int64_t run0 =
      (static_cast<int64_t>(blockIdx.x) * kChunkRuns + warp) * (kRunSegments * kSegment);
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
  float* dst = part + static_cast<int64_t>(blockIdx.x) * padded(r * K) + r0 * K;
  for (int e = threadIdx.x; e < rt * K; e += kChunkRuns * 32) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kChunkRuns; ++w) acc = acc + sums[w * rt * K + e];
    dst[e] = acc;
  }
}

// the second launch: out[k][row] for kFoldEntries entries a block
__global__ void __launch_bounds__(kThreads)
rows_select_bwd_fold_kernel(const float* __restrict__ part, int chunks, int r, int k,
                            float* __restrict__ out) {
  __shared__ __align__(16) float tile[kFoldTile];
  // launched early (programmatic dependent launch): wait until the first
  // launch has ended and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int e0 = blockIdx.x * kFoldEntries;
  fold_chunks(part, chunks, padded(r * k), r, k, e0, min(kFoldEntries, r * k - e0), tile,
              kFoldTile, out);
}

// `a`: the k pointers, then the k element strides
Columns columns_of(int k, const long long* a) {
  Columns c{};
  for (int j = 0; j < k; ++j) {
    c.p[j] = reinterpret_cast<const float*>(static_cast<intptr_t>(a[j]));
    c.s[j] = a[k + j];
  }
  return c;
}

template <typename T>
T* pointer(long long a) {
  return reinterpret_cast<T*>(static_cast<intptr_t>(a));
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
                       void* ticket, void* out, cudaStream_t st) {
  const int chunks = (n + kChunk - 1) / kChunk;
  const auto* q = static_cast<const int64_t*>(idx);
  auto* p = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  const bool one = r * K <= kOneLaunchEntries;
  if (r * K <= kMaxEntries) {
    const int smem = smem_bytes(r, K);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          rows_select_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    rows_select_bwd_kernel<K><<<chunks, kChunkRuns * 32, smem, st>>>(
        g, q, n, r, smem / static_cast<int>(sizeof(float)), p,
        one ? static_cast<unsigned*>(ticket) : nullptr, o);
  } else {
    const int rt = kMaxEntries / K;
    const int smem = kChunkRuns * rt * K * static_cast<int>(sizeof(float));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          rows_select_bwd_tiles_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    rows_select_bwd_tiles_kernel<K><<<dim3(chunks, (r + rt - 1) / rt), kChunkRuns * 32, smem,
                                      st>>>(g, q, n, r, rt, p);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || one) return err;
  // the second launch starts while the first runs and waits in its kernel
  // (griddepcontrol.wait): no launch gap between the two
  cudaLaunchAttribute early{};
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t fold{};
  fold.gridDim = dim3((r * K + kFoldEntries - 1) / kFoldEntries);
  fold.blockDim = dim3(kThreads);
  fold.stream = st;
  fold.attrs = &early;
  fold.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &fold, rows_select_bwd_fold_kernel, static_cast<const float*>(p), chunks, r, K, o);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace

// K7: a = {N, R, k, idx, out, the k column pointers, their k element
// strides}: k columns of R f32 entries, idx (N,) int64, out (k, N) f32
// row-major; N, R >= 1
extern "C" int rows_select_launch(const long long* a, void* stream) {
  const int n = static_cast<int>(a[0]), r = static_cast<int>(a[1]), k = static_cast<int>(a[2]);
  if (n <= 0 || r <= 0 || k < 1 || k > kMaxColumns)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const Columns table = columns_of(k, a + 5);
  const auto* idx = pointer<const void>(a[3]);
  auto* out = pointer<void>(a[4]);
  switch (k) {
#define RS_FWD(KK) \
  case KK: return static_cast<int>(launch_fwd<KK>(table, idx, n, r, out, st));
    RS_FWD(1) RS_FWD(2) RS_FWD(3) RS_FWD(4) RS_FWD(5) RS_FWD(6) RS_FWD(7) RS_FWD(8)
#undef RS_FWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7b: a = {N, R, k, idx, part, ticket, out, the k cotangent pointers (null
// for zeros), their k element strides}: k columns of N f32 entries, idx
// (N,) int64, part chunks x padded(R k) f32 scratch, ticket one uint32 that is 0
// and that no other launch uses meanwhile (left 0), out (k, R) f32
// row-major; N, R >= 1
extern "C" int rows_select_bwd_launch(const long long* a, void* stream) {
  const int n = static_cast<int>(a[0]), r = static_cast<int>(a[1]), k = static_cast<int>(a[2]);
  if (n <= 0 || r <= 0 || k < 1 || k > kMaxColumns)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const Columns g = columns_of(k, a + 7);
  const auto* idx = pointer<const void>(a[3]);
  auto* part = pointer<void>(a[4]);
  auto* ticket = pointer<void>(a[5]);
  auto* out = pointer<void>(a[6]);
  switch (k) {
#define RS_BWD(KK) \
  case KK: return static_cast<int>(launch_bwd<KK>(g, idx, n, r, part, ticket, out, st));
    RS_BWD(1) RS_BWD(2) RS_BWD(3) RS_BWD(4) RS_BWD(5) RS_BWD(6) RS_BWD(7) RS_BWD(8)
#undef RS_BWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
