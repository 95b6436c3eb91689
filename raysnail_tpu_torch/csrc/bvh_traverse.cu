// Closest hit through a fat-leaf skip-link BVH, with the winner's shading
// attributes, for Hopper (sm_90a). One source, three leaf kinds: triangles
// ("tri"), axis-aligned boxes ("box") and spheres ("sphere").
//
// Replaces the TPU kernel raysnail_tpu/ops/bvh_pallas.py (`_kernel`,
// wrapped by `bvh_traverse`) for its kinds "tri", "box" and "sphere". It
// reads the same packed arrays (scene._pack_leaf_blocks):
//   bb     (K, M, 8) f32   node bounds [min.xyz, max.xyz, pad, pad] in K = 8
//                          direction-octant DFS orders (or K = 1)
//   links  (K, M, 4) i32   [leaf_block, count, miss, pad]; count > 0 marks a
//                          leaf, an admitted interior node goes to node + 1,
//                          anything else to miss
//   prim   (B, NF, 128) f32 leaf blocks: field f of primitive l at [b, f, l]
// and computes, per ray, what that kernel computes per ray:
//   * the per-ray admission cap (bvh_pallas.py:214-224): the root slab test,
//     cap = min(root exit, t_cap, t_max) * 1.0001 + 1e-4 when the ray can
//     hit (t_cap > 0 and the root is hit), else -BIG, which admits nothing;
//   * a node is admitted when near <= far, far >= t_min and near <= min(best
//     t, cap) (:486); inverse directions use the 1e-12 guard (:173-174);
//   * an admitted leaf is swept over its 128 primitives with the TPU
//     kernel's formulas and operation order (:253-318, bvh_sweep.cuh). The
//     sweep compares against the best t only, not against t_cap, so a ray
//     may return a hit beyond its t_cap, as there; the caller's min over
//     groups drops it;
//   * the epilogue (:358-401): tri the barycentric blend of the vertex
//     normals and the material; box the face axis, the entry flag, the face
//     uv rebuilt from the winner's bounds and the material; sphere the
//     winner's center, radius and material. A miss (and a dead lane, t_cap
//     <= 0) is t = BIG with zero attributes.
//
// Design. One thread owns one ray and walks the DFS order of its OWN
// direction octant (the TPU kernel picks one octant per 128-ray packet). The
// walk and the sweeps are taken apart, because a sweep run by the few lanes
// of a warp that happen to stand at a leaf, while the others wait, is what
// this traversal loses its time on:
//   * walk: a thread does not sweep a leaf that it admits. It notes (node,
//     block) in its column of a shared-memory buffer, up to kDepth (8)
//     leaves, and walks on with the best t it had (a stale one admits more, never
//     less). The threads of a warp walk until each has a full buffer or has
//     ended its walk.
//   * drain: the warp converges and goes through the buffers front to back,
//     one round per buffer position. In a round each lane tests its leaf's
//     bounds again against its FRESH best t and drops the leaf if it no
//     longer admits it: by the slab test's monotonicity the ray then sweeps
//     exactly the leaves that a walk with an always fresh best t sweeps, in
//     the same order, so the outputs do not depend on the buffer depth.
//     The round's sweeps run as bvh_sweep.cuh's `sweep_round` sets out:
//     every (ray, leaf) is swept primitive-parallel by the whole warp, one
//     ray after another, lane l testing primitives 4l..4l+3 of coalesced
//     rows, with a min-reduction over (t, index).
// A partial last warp keeps its lanes alive as dead rays (the full-mask
// shuffles need them). Ties: inside a leaf the lowest primitive index wins,
// across leaves the first one visited (strict <), as in the TPU kernel's box
// kind; the TPU kernel's tri/sphere kinds sum the attributes of an exact f32
// tie (measure zero), here one winner is kept. The winner's attributes are
// read once, after the walk, from its block and lane.
//
// What bounds it on this card: latency. The operations and bytes that a
// frame's rays need are microseconds of the card's rates; the time goes to
// dependent loads (48 B per node, one per walk step and thread; the leaf
// rows, which stay in the 50 MB L2 for the 28 MB of a 204,800-triangle
// mesh) and to the warps whose rays need the most leaves, which end last.
//
// Built with -fmad=false and IEEE division and square root: each product,
// sum and quotient rounds as the plain PyTorch version's elementwise
// operations round it, so t and the winner agree bit for bit with it.
//
// Probe forms (bvh_sweep.cuh `Form`), the counterparts of the TPU kernel's
// switches _NOSWEEP and _NOATTR (bvh_pallas.py:78-79): kNoSweep runs the
// walk, the cap, the deferral and the drain rounds with their fresh
// re-test, sweeps nothing, and writes per ray t (BIG), the leaves its
// drain admitted, its node steps and its warp's drain rounds; kNoAttr runs
// all but the epilogue's attribute reads and blend, and writes t and the
// ray's (ray, leaf) sweeps. They measure where the full form's time goes;
// no render path launches them (bvh_traverse_form_launch).
//
// The C entry points launch on the caller's stream, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include "bvh_sweep.cuh"

namespace {

using namespace bvh;

constexpr int kThreads = 128;

template <int KIND, int FORM>
__global__ void __launch_bounds__(kThreads)
bvh_traverse_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t_cap, const float* __restrict__ bb,
                    const int32_t* __restrict__ links, const float* __restrict__ prim,
                    int n, int m, int k_orders, float t_min, float t_max,
                    float* __restrict__ out, int32_t* __restrict__ mat_out,
                    int32_t* __restrict__ counts) {
  // the deferred leaves: a thread reads and writes its own column only
  __shared__ int s_node[kDepth][kThreads], s_blk[kDepth][kThreads];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i = blockIdx.x * kThreads + tid;
  const bool live = i < n;  // the last warp may be partial
  RayIn r;
  r.ox = live ? ox[i] : 0.f; r.oy = live ? oy[i] : 0.f; r.oz = live ? oz[i] : 0.f;
  r.dx = live ? dx[i] : 0.f; r.dy = live ? dy[i] : 0.f; r.dz = live ? dz[i] : 0.f;
  finish_ray<KIND>(r);
  const float cap_t = live ? t_cap[i] : -1.f;

  const int oct = (k_orders == 8)
      ? (r.dx < 0.f) * 4 + (r.dy < 0.f) * 2 + (r.dz < 0.f) : 0;
  const float* bbo = bb + (size_t)oct * m * 8;
  const int4* lko = reinterpret_cast<const int4*>(links) + (size_t)oct * m;

  // admission cap from the root's slab test (node 0 of every order)
  const float cap = root_cap(bbo, r, cap_t, t_min, t_max);

  Best best{kBig, 0, 0, 0.f, 0.f};
  int steps = 0, sweeps = 0, drained = 0;  // the probe forms' counters
  int node = (cap >= t_min) ? 0 : m;
  while (true) {
    // walk: defer admitted leaves until the buffer is full or the walk ends
    int nbuf = 0;
    while (node < m && nbuf < kDepth) {
      const int4 lk = __ldg(lko + node);
      if (FORM == kNoSweep) ++steps;
      const bool admit = admits<true>(bbo + (size_t)node * 8, r, t_min, fminf(best.t, cap));
      if (admit && lk.y > 0) {
        s_node[nbuf][tid] = node;
        s_blk[nbuf][tid] = lk.x;
        ++nbuf;
        node = lk.z;
      } else {
        node = admit ? node + 1 : lk.z;
      }
    }
    // drain: no lane holds a leaf only when every lane's walk has ended
    const int rounds = __reduce_max_sync(kFull, nbuf);
    if (rounds == 0) break;
    if (FORM == kNoSweep) drained += rounds;
    for (int j = 0; j < rounds; ++j) {
      const bool have = j < nbuf;
      const int nd = have ? s_node[j][tid] : 0;
      const int blk = have ? s_blk[j][tid] : 0;
      // the ray sweeps the leaf only if it admits it with its fresh best t
      const bool adm = have && admits<true>(bbo + (size_t)nd * 8, r, t_min,
                                            fminf(best.t, cap));
      const float* p = prim + (size_t)blk * Shape<KIND>::block;
      if (FORM != kNoSweep)
        sweep_round<KIND, false, false>(adm, blk, p, prim, r, t_min, t_max, lane, best);
      if (FORM != kFullForm) sweeps += adm;
    }
  }
  if (live) {
    if (FORM == kFullForm) {
      write_hit<KIND>(prim, r, best, i, n, out, mat_out);
    } else {
      write_form<FORM>(best.t, sweeps, steps, drained, i, n, out, counts);
    }
  }
}

template <int FORM>
int launch(int kind, const void* ox, const void* oy, const void* oz, const void* dx,
           const void* dy, const void* dz, const void* t_cap, const void* bb,
           const void* links, const void* prim, int n, int m, int k_orders, float t_min,
           float t_max, void* out, void* mat_out, void* counts, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n + kThreads - 1) / kThreads;
#define LAUNCH(K)                                                              \
  bvh_traverse_kernel<K, FORM><<<blocks, kThreads, 0, s>>>(                   \
      static_cast<const float*>(ox), static_cast<const float*>(oy),           \
      static_cast<const float*>(oz), static_cast<const float*>(dx),           \
      static_cast<const float*>(dy), static_cast<const float*>(dz),           \
      static_cast<const float*>(t_cap), static_cast<const float*>(bb),        \
      static_cast<const int32_t*>(links), static_cast<const float*>(prim), n, \
      m, k_orders, t_min, t_max, static_cast<float*>(out),                    \
      static_cast<int32_t*>(mat_out), static_cast<int32_t*>(counts))
  switch (kind) {
    case kTri: LAUNCH(kTri); break;
    case kBox: LAUNCH(kBox); break;
    case kSphere: LAUNCH(kSphere); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bvh_traverse_launch(int kind, const void* ox, const void* oy,
                                   const void* oz, const void* dx, const void* dy,
                                   const void* dz, const void* t_cap, const void* bb,
                                   const void* links, const void* prim, int n, int m,
                                   int k_orders, float t_min, float t_max, void* out,
                                   void* mat_out, void* stream) {
  return launch<kFullForm>(kind, ox, oy, oz, dx, dy, dz, t_cap, bb, links, prim, n, m, k_orders,
                       t_min, t_max, out, mat_out, nullptr, static_cast<cudaStream_t>(stream));
}

// A probe form (kNoSweep 1, kNoAttr 2): t (n,) f32; counts (3, n) i32 for
// kNoSweep (sweeps its drain admitted, node steps, its warp's drain
// rounds), (n,) for kNoAttr (sweeps)
extern "C" int bvh_traverse_form_launch(int form, int kind, const void* ox, const void* oy,
                                        const void* oz, const void* dx, const void* dy,
                                        const void* dz, const void* t_cap, const void* bb,
                                        const void* links, const void* prim, int n, int m,
                                        int k_orders, float t_min, float t_max, void* t_out,
                                        void* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kNoSweep:
      return launch<kNoSweep>(kind, ox, oy, oz, dx, dy, dz, t_cap, bb, links, prim, n, m,
                              k_orders, t_min, t_max, t_out, nullptr, counts, s);
    case kNoAttr:
      return launch<kNoAttr>(kind, ox, oy, oz, dx, dy, dz, t_cap, bb, links, prim, n, m,
                             k_orders, t_min, t_max, t_out, nullptr, counts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
