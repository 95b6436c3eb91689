// Packet traversal of a fat-leaf skip-link BVH for Hopper (sm_90a): closest
// hit with the winner's shading attributes. One source, four leaf kinds
// (triangles by Cramer's rule "tri", triangles by the feature product
// "tri_mxu", axis-aligned boxes "box", spheres "sphere") and two orthogonal
// switches, `stream` and `two_level`.
//
// Replaces the remaining modes of the TPU kernel raysnail_tpu/ops/
// bvh_pallas.py (`_kernel`, wrapped by `bvh_traverse`): its kind "tri_mxu"
// (:62-71, :181-189, :235-249, :359-366), stream=True (:115-120, :519-535)
// and two_level=True (:122-136, :413-471), and gives the kinds "tri", "box"
// and "sphere" a packet counterpart of the per-ray kernel bvh_traverse.cu.
// It reads the same packed arrays (scene._pack_leaf_blocks,
// scene._pack_mxu_blocks, scene._leaf_tree):
//   bb      (K, M, 8) f32    node bounds, K = 8 octant DFS orders or 1
//   links   (K, M, 4) i32    [leaf_block, count, miss, pad]
//   prim    (B, NF, 128) f32 leaf blocks, or (B, 16, 640) for "tri_mxu":
//                            lanes 0:512 the solve table F, 512:640 the
//                            attribute table
//   cbb     (K, 64, 8) f32   bounds of the coarse cut's subtree roots
//   crange  (K, 64, 4) i32   [start, end) DFS node range of each cut entry;
//                            a padding entry starts at M
//
// The packet. A thread block of 128 threads owns 128 consecutive rays, one
// ray per thread: the TPU kernel's PACKET, and one 16x8 image tile of the
// tile-ordered render path. The block picks ONE node order, the octant of
// the sign of the packet's summed directions (:164-169), and holds that
// octant's coarse cut in shared memory. A node order is shared, a walk
// position is not: inside the packet each of the four WARPS walks on its
// own, with its own node, range end, cut entry and deferred leaves. A warp
// enters a node when any of its 32 rays admits it (__any_sync; no block
// barrier after the set-up), with the per-ray cap (:214-224) and admission
// rule (:486), so the rays of an incoherent packet pay for the union of 32
// rays' nodes and not of 128. Admitted leaves are deferred, up to kDepth (8;
// lane j keeps the warp's j-th leaf), and then swept front to back. At the
// sweep each ray tests the leaf's bounds again against its own best t,
// which has tightened since the walk, and sweeps the leaf only if it still
// admits it. So a ray sweeps exactly the leaves that a walk of its own, in
// the packet's order and with an always fresh best t, would sweep: the
// outputs do not depend on the depth, on `stream` or on `two_level`, and
// equal the plain PyTorch version's (ops/bvh_traverse.py, packet=True) bit
// for bit. Inside a leaf the lowest primitive index wins a tie, across
// leaves the first visited (strict <).
//
// The sweep (bvh_sweep.cuh, `sweep_round`): the warp sweeps the leaf for one
// ray that still admits it after the other, primitive-parallel, lane l
// testing primitives 4l..4l+3, with a min-reduction over (t, index).
//
// stream. The sweep rows of a deferred leaf (tri: rows 0-9, 5,120 B; box:
// rows 0-6; sphere: rows 0-4; tri_mxu: rows 0-9 of the solve table and the
// valid row, 20,992 B) are copied from global memory into the warp's own
// ring of shared-memory slots (Shape<KIND>::ring: 2, tri_mxu 1, which is
// then the most it defers) by the bulk copy engine (TMA, 1-D
// cp.async.bulk, bvh_stage.cuh: one lane asks, no lane spends an
// instruction on the copy),
// started the moment the leaf is collected, so that the rest of the walk
// hides it; each slot has an mbarrier, and a sweep waits only for its own
// slot's (:519-535). Without `stream` the sweep reads the same rows
// straight from global memory through the read-only path. The winner's
// attributes are read once, after the walk, from its block and lane.
//
// tri_mxu. For each (ray, triangle) pair the four 10-term dot products of
// the ray's features [d | o | o x d | 1] with the solve table's columns:
// denom, n.o - n.p0 and the beta and gamma numerators, then the epilogue of
// :241-249. The TPU kernel asks its matrix unit for f32-exact products; a
// TF32 tensor-core product is not that (t comes out of a cancellation), so
// these are FP32 multiplies and adds on the CUDA cores, summed term by term
// in row order as the plain version sums them.
//
// two_level. The packet's octant's cut entries sit in shared memory; a warp
// tests the next real entry (padding entries are counted out, never
// tested), enters it when any of its rays admits its bounds, and walks only
// its [start, end) range (:432-471).
//
// What bounds it on this card: latency. The operations and bytes a frame's
// rays need are microseconds of the card's rates; the time goes to the
// dependent loads of the walk (one node per step and warp), to the sweeps
// of rays that diverge, and to the warps that end last. Built with
// -fmad=false and IEEE division and square root, so each product, sum and
// quotient rounds as the plain version's elementwise operations round it.
//
// Probe forms (bvh_sweep.cuh `Form`), the counterparts of the TPU kernel's
// switches _NOSWEEP and _NOATTR (bvh_pallas.py:78-79), for the kinds tri,
// box and sphere with `stream` and `two_level` off: kNoSweep runs the
// warps' walks, the cap, the deferral and the drain rounds with each ray's
// fresh re-test, sweeps nothing, and writes per ray t (BIG), the leaves
// its drain admitted, its warp's node steps and its warp's drain rounds;
// kNoAttr runs all but the epilogue's attribute reads and blend, and
// writes t and the ray's (ray, leaf) sweeps. No render path launches them
// (bvh_packet_form_launch).
//
// The C entry points launch on the caller's stream, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include "bvh_stage.cuh"

namespace {

using namespace bvh;

constexpr int kPacket = 128;     // rays per packet = threads per block
constexpr int kWarps = kPacket / 32;
constexpr int kCoarseMax = 64;   // cut entries per octant, padding included

template <int KIND, bool STREAM, int FORM>
__global__ void __launch_bounds__(kPacket)
bvh_packet_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cap, const float* __restrict__ bb,
                  const int32_t* __restrict__ links, const float* __restrict__ prim,
                  const float* __restrict__ cbb, const int32_t* __restrict__ crange,
                  int n, int m, int k_orders, int two_level, float t_min, float t_max,
                  float* __restrict__ out, int32_t* __restrict__ mat_out,
                  int32_t* __restrict__ counts) {
  // the leaves a warp defers: a ring slot each when they are staged
  constexpr int depth = STREAM ? Shape<KIND>::ring : kDepth;
  extern __shared__ __align__(16) float ring[];  // kWarps rings of depth slots
  __shared__ __align__(8) unsigned long long s_bar[kWarps][depth];
  __shared__ float s_sum[3][kWarps];
  __shared__ __align__(16) float s_cbb[kCoarseMax * 8];
  __shared__ int s_start[kCoarseMax], s_end[kCoarseMax];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i = blockIdx.x * kPacket + tid;
  const bool live = i < n;  // the last packet may be partial
  RayIn r;
  r.ox = live ? ox[i] : 0.f; r.oy = live ? oy[i] : 0.f; r.oz = live ? oz[i] : 0.f;
  r.dx = live ? dx[i] : 0.f; r.dy = live ? dy[i] : 0.f; r.dz = live ? dz[i] : 0.f;
  finish_ray<KIND>(r);
  const float cap_t = live ? t_cap[i] : -1.f;

  // the packet's node order: the octant of the summed directions, summed by
  // halving within each warp and then over the four warps left to right
  int oct = 0;
  if (k_orders == 8) {
    float sx = r.dx, sy = r.dy, sz = r.dz;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx = sx + __shfl_xor_sync(kFull, sx, off);
      sy = sy + __shfl_xor_sync(kFull, sy, off);
      sz = sz + __shfl_xor_sync(kFull, sz, off);
    }
    if (lane == 0) {
      s_sum[0][tid >> 5] = sx; s_sum[1][tid >> 5] = sy; s_sum[2][tid >> 5] = sz;
    }
    __syncthreads();
    const float tx = ((s_sum[0][0] + s_sum[0][1]) + s_sum[0][2]) + s_sum[0][3];
    const float ty = ((s_sum[1][0] + s_sum[1][1]) + s_sum[1][2]) + s_sum[1][3];
    const float tz = ((s_sum[2][0] + s_sum[2][1]) + s_sum[2][2]) + s_sum[2][3];
    oct = (tx < 0.f) * 4 + (ty < 0.f) * 2 + (tz < 0.f);
  }
  const float* bbo = bb + (size_t)oct * m * 8;
  const int4* lko = reinterpret_cast<const int4*>(links) + (size_t)oct * m;

  // the coarse cut of this octant, and the count of its real entries
  int n_cut = 0;
  if (two_level) {
    reinterpret_cast<float4*>(s_cbb)[tid] =
        __ldg(reinterpret_cast<const float4*>(cbb) + (size_t)oct * (kCoarseMax * 2) + tid);
    bool real = false;
    if (tid < kCoarseMax) {
      const int4 cr = __ldg(reinterpret_cast<const int4*>(crange) +
                            (size_t)oct * kCoarseMax + tid);
      s_start[tid] = cr.x; s_end[tid] = cr.y;
      real = cr.x < m;
    }
    n_cut = __syncthreads_count(real);
  }
  // the last block barrier: from here on a warp goes its own way

  // admission cap from the root's slab test (node 0 of every order)
  const float cap = root_cap(bbo, r, cap_t, t_min, t_max);
  const bool any_ray = __any_sync(kFull, cap >= t_min);

  // node, end, cut and nbuf are the same in every lane of the warp: each is
  // set from warp-wide votes and from data that every lane reads
  float* wring = ring + (size_t)(tid >> 5) * depth * Shape<KIND>::staged;
  unsigned long long* wbar = s_bar[tid >> 5];
  unsigned phases = 0;  // bit j: the parity of slot j's next phase
  if (STREAM) {
    if (lane < depth) mbar_init(wbar + lane);
    mbar_fence_init();
    __syncwarp();
  }
  Best best{kBig, 0, 0, 0.f, 0.f};
  int steps = 0, sweeps = 0, drained = 0;  // the probe forms' counters
  int my_node = 0, my_blk = 0;  // lane j keeps the warp's j-th deferred leaf
  int node = 0;
  int end = two_level ? 0 : m;  // two_level starts before the first cut entry
  int cut = 0;
  if (!any_ray) { end = 0; cut = n_cut; }
  while (true) {
    // walk: defer admitted leaves, up to the depth
    int nbuf = 0;
    while (nbuf < depth) {
      if (node >= end) {
        if (cut >= n_cut) break;
        const bool vote = __any_sync(
            kFull, admits<false>(s_cbb + cut * 8, r, t_min, fminf(best.t, cap)));
        if (vote) { node = s_start[cut]; end = s_end[cut]; }
        ++cut;
        continue;
      }
      const int4 lk = __ldg(lko + node);
      if (FORM == kNoSweep) ++steps;
      const bool vote = __any_sync(
          kFull, admits<true>(bbo + (size_t)node * 8, r, t_min, fminf(best.t, cap)));
      if (vote && lk.y > 0) {
        if (lane == nbuf) { my_node = node; my_blk = lk.x; }
        if (STREAM && lane == 0) {  // the copy starts now; the rest of the walk hides it
          stage<KIND>(wring + (size_t)nbuf * Shape<KIND>::staged,
                      prim + (size_t)lk.x * Shape<KIND>::block, wbar + nbuf);
        }
        ++nbuf;
        node = lk.z;
      } else {
        node = vote ? node + 1 : lk.z;
      }
    }
    if (nbuf == 0) break;
    if (FORM == kNoSweep) drained += nbuf;
    for (int j = 0; j < nbuf; ++j) {
      const int nd = __shfl_sync(kFull, my_node, j);
      const int blk = __shfl_sync(kFull, my_blk, j);
      if (STREAM) {  // slot j's bytes have landed
        mbar_wait(wbar + j, (phases >> j) & 1u);
        phases ^= 1u << j;
      }
      // the ray sweeps the leaf only if it admits it with its fresh best t
      const bool adm = admits<true>(bbo + (size_t)nd * 8, r, t_min, fminf(best.t, cap));
      const float* p = STREAM ? wring + (size_t)j * Shape<KIND>::staged
                              : prim + (size_t)blk * Shape<KIND>::block;
      if (FORM != kNoSweep)
        sweep_round<KIND, STREAM, true>(adm, blk, p, prim, r, t_min, t_max, lane, best);
      if (FORM != kFullForm) sweeps += adm;
    }
    if (STREAM) __syncwarp();  // every lane has read the ring: lane 0 may refill it
  }
  if (live) {
    if (FORM == kFullForm) {
      write_hit<KIND>(prim, r, best, i, n, out, mat_out);
    } else {
      write_form<FORM>(best.t, sweeps, steps, drained, i, n, out, counts);
    }
  }
}

template <int KIND, bool STREAM, int FORM>
int launch(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
           const void* dz, const void* t_cap, const void* bb, const void* links,
           const void* prim, const void* cbb, const void* crange, int n, int m,
           int k_orders, int two_level, float t_min, float t_max, void* out, void* mat_out,
           void* counts, cudaStream_t s) {
  constexpr size_t smem =
      STREAM ? (size_t)kWarps * Shape<KIND>::ring * Shape<KIND>::staged * sizeof(float) : 0;
  static_assert(smem <= 227 * 1024, "the rings exceed a block's opt-in shared memory");
  if (smem > 48 * 1024) {  // the large carve-out is opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        bvh_packet_kernel<KIND, STREAM, FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kPacket - 1) / kPacket;
  bvh_packet_kernel<KIND, STREAM, FORM><<<blocks, kPacket, smem, s>>>(
      static_cast<const float*>(ox), static_cast<const float*>(oy),
      static_cast<const float*>(oz), static_cast<const float*>(dx),
      static_cast<const float*>(dy), static_cast<const float*>(dz),
      static_cast<const float*>(t_cap), static_cast<const float*>(bb),
      static_cast<const int32_t*>(links), static_cast<const float*>(prim),
      static_cast<const float*>(cbb), static_cast<const int32_t*>(crange), n, m,
      k_orders, two_level, t_min, t_max, static_cast<float*>(out),
      static_cast<int32_t*>(mat_out), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bvh_packet_launch(int kind, const void* ox, const void* oy, const void* oz,
                                 const void* dx, const void* dy, const void* dz,
                                 const void* t_cap, const void* bb, const void* links,
                                 const void* prim, const void* cbb, const void* crange,
                                 int n, int m, int k_orders, int stream_leaves,
                                 int two_level, float t_min, float t_max, void* out,
                                 void* mat_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (two_level && (!cbb || !crange)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define ARGS ox, oy, oz, dx, dy, dz, t_cap, bb, links, prim, cbb, crange, n, m, k_orders, \
             two_level, t_min, t_max, out, mat_out, nullptr, s
#define LAUNCH(K) \
  return stream_leaves ? launch<K, true, kFullForm>(ARGS) : launch<K, false, kFullForm>(ARGS)
  switch (kind) {
    case kTri: LAUNCH(kTri);
    case kBox: LAUNCH(kBox);
    case kSphere: LAUNCH(kSphere);
    case kTriMxu: LAUNCH(kTriMxu);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
#undef ARGS
}

// A probe form (kNoSweep 1, kNoAttr 2) of the kinds tri, box and sphere,
// `stream` and `two_level` off: t (n,) f32; counts (3, n) i32 for kNoSweep
// (sweeps its drain admitted, its warp's node steps, its warp's drain
// rounds), (n,) for kNoAttr (sweeps)
extern "C" int bvh_packet_form_launch(int form, int kind, const void* ox, const void* oy,
                                      const void* oz, const void* dx, const void* dy,
                                      const void* dz, const void* t_cap, const void* bb,
                                      const void* links, const void* prim, int n, int m,
                                      int k_orders, float t_min, float t_max, void* t_out,
                                      void* counts, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
#define ARGS ox, oy, oz, dx, dy, dz, t_cap, bb, links, prim, nullptr, nullptr, n, m, \
             k_orders, 0, t_min, t_max, t_out, nullptr, counts, s
#define FORMS(K)                                                          \
  switch (form) {                                                         \
    case kNoSweep: return launch<K, false, kNoSweep>(ARGS);               \
    case kNoAttr: return launch<K, false, kNoAttr>(ARGS);                 \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }
  switch (kind) {
    case kTri: FORMS(kTri);
    case kBox: FORMS(kBox);
    case kSphere: FORMS(kSphere);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FORMS
#undef ARGS
}
