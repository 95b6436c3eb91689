// Probe kernels for the BVH traversal on Hopper (sm_90a): the traversal
// taken apart into ray I/O, walk, sweep, walk shape and a bisect of what each
// added piece of the real kernel costs. They measure; no render path calls
// them.
//
// Replaces the TPU probe kernels of scripts/kern_ab.py (`io_kernel`,
// `walk_kernel`, `sweep_kernel`, `io2`, `io3`, `io4`), scripts/kern_lat.py
// (`walk_narrow`, `walk_wide`, `walk_lane`, `walk_lane_buf`) and scripts/
// kern_walkvar.py (`make_kernel(variant)`, V0-V8), and with V3 and V4 of the
// bisect the probe switches _NOSWEEP and _NOATTR of raysnail_tpu/ops/
// bvh_pallas.py. Each family keeps the TPU probe's function over the same
// packed arrays (bb (K, M, 8) f32, links (K, M, 4) i32, prim (B, 24, 128)
// f32 triangle blocks) and asks it of the walk designs this card has, not of
// the TPU's memory layouts:
//
//   probe_io_kernel<LAYOUT>   the six-field sum ((((ox + dx) + oy) + dy) + oz)
//       + dz per ray, with the rays read as six SoA arrays one word a thread
//       (what bvh_traverse.cu and bvh_packet.cu do), as 16-byte loads of
//       1024-ray rows, through a shared-memory transpose of such rows, and as
//       one packed 8-float record per ray (two 16-byte loads).
//   probe_walk_kernel<W, MODE>   the skip-link walk alone for a packet of W
//       rays: W = 1 one thread with its own octant (bvh_traverse.cu), W = 32
//       one warp voting with __any_sync and no block barrier, W = 128 and
//       W = 1024 one block voting with __syncthreads_or (bvh_packet.cu).
//       MODE bt: admission near <= bt, and a taken leaf lowers bt to
//       min(bt, near) for every ray of the packet (kern_ab.py walk_kernel).
//       MODE plain: admission by the slab alone, each ray summing its near
//       (kern_lat.py A, B). MODE cap: plus the compare against a best-t cap
//       (C). MODE buf: plus the leaf-id buffer and the loop in chunks of at
//       most 8 leaves (D).
//   probe_sweep_kernel<W>   the Cramer sweep of blocks 0..n_blocks-1 for
//       every ray, no walk.
//   probe_variant_kernel<V, W>   the bisect's walk, W = 1 or 128: V0 the
//       plain walk, V1 + take and leaf count, V2 + buffer store, V3 +
//       nested chunk loops; probe_sweep_variant_kernel<V, W> V4 + the Cramer
//       sweep of the buffered blocks, V5 the sweep of blocks 0..nbuf-1
//       instead (no dependent block id), V7 + five attribute carries, V8 +
//       the packet kernel's output record. The walk admits by the slab
//       alone, with no best-t pruning and no cap, so V4 sweeps every leaf a
//       ray's slab admits: V3 and V4 are not the traversal with its sweep or
//       its attributes switched off. Those are the traversal kernels' own
//       probe forms (bvh_sweep.cuh `Form`).
//
// The sweeps (P1c, V4-V8) are the traversal kernels' own, bvh_sweep.cuh's
// `sweep_round`: the warp sweeps each (ray, leaf) primitive-parallel, one
// ray after another, lane l testing primitives 4l..4l+3, with a butterfly
// min over (t, index). The ray shape (W = 1) sweeps as bvh_traverse.cu
// does: each lane its own leaf, read from global memory and L2, in rounds
// of the warp's longest buffer. The packet shape (W = 128) sweeps as
// bvh_packet.cu's `stream` mode does, in uniform rounds from shared memory:
// the packet's leaves are staged by the bulk copy engine (bvh_stage.cuh)
// into a ring of slots that the block's four warps read, each slot's copy
// started when its leaf is taken (P1c: the next block while one is swept).
//
// Every probe writes what decides its work: its float result and exact
// integers (node steps, leaves taken, blocks swept, wins, the last leaf
// taken, which is read back from the buffer where there is one), so a probe
// whose compiler dropped a phase fails its check against the plain PyTorch
// version (ops/bvh_probes.py). The TPU probes add the packet's summed near to
// every lane; here each ray sums its own near in step order: that keeps the
// slab test alive, rounds in one fixed order, and adds no block reduction to
// the node step whose latency is measured.
//
// What bounds them on this card: the I/O probes bytes; the walks latency (a
// dependent 32-byte node load and, for packets, one vote per node); the
// sweeps FP32 operations, three IEEE divisions of each (ray, triangle)
// test among them. Built with -fmad=false and IEEE division, so each
// product, sum and quotient rounds as the plain version's elementwise
// operations round it.
//
// The C entry points launch on the caller's stream, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include "bvh_stage.cuh"
#include "bvh_sweep.cuh"

namespace {

using bvh::kBig;
using bvh::kFull;
using bvh::safe_inv;
using Ray = bvh::RayIn;     // ox..dz and the inverse directions

constexpr int kTriFloats = bvh::Shape<bvh::kTri>::block;  // a triangle block
constexpr int kStaged = bvh::Shape<bvh::kTri>::staged;    // its sweep rows 0-9
constexpr int kChunk = 8;         // leaves per chunk of the buffered walk
constexpr int kRow = 1024;        // rays per row tile of the I/O probes
constexpr int kIoThreads = 256;
constexpr float kTMin = 1e-3f;
constexpr float kAccScale = 1e-20f;

enum Layout { kSoa = 0, kRows = 1, kTranspose = 2, kPacked = 3 };
enum WalkMode { kBt = 0, kPlain = 1, kCap = 2, kBuf = 3 };

__device__ __forceinline__ float six_sum(float ox, float oy, float oz, float dx, float dy,
                                         float dz) {
  return ((((ox + dx) + oy) + dy) + oz) + dz;
}

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy, const float* oz,
                                        const float* dx, const float* dy, const float* dz,
                                        int i, bool live) {
  Ray r;
  r.ox = live ? ox[i] : 0.f; r.oy = live ? oy[i] : 0.f; r.oz = live ? oz[i] : 0.f;
  r.dx = live ? dx[i] : 0.f; r.dy = live ? dy[i] : 0.f; r.dz = live ? dz[i] : 0.f;
  r.ivx = safe_inv(r.dx); r.ivy = safe_inv(r.dy); r.ivz = safe_inv(r.dz);
  return r;
}

// threads of a block that holds packets of W rays
template <int W> struct Block { static constexpr int threads = (W == 1024) ? 1024 : 128; };

// one vote of a packet of W rays: the thread itself, its warp, or its block
template <int W> __device__ __forceinline__ bool vote(bool p) {
  if (W == 1) return p;
  if (W == 32) return __any_sync(kFull, p) != 0;
  return __syncthreads_or(p) != 0;
}

// make the packet's shared-memory buffer writes visible to the packet
template <int W> __device__ __forceinline__ void packet_sync() {
  if (W == 32) __syncwarp();
  if (W > 32) __syncthreads();
}

// the thread that writes the packet's leaf-id buffer
template <int W> __device__ __forceinline__ bool is_writer() {
  if (W == 1) return true;
  if (W == 32) return (threadIdx.x & 31) == 0;
  return threadIdx.x == 0;
}

// the packet's node order: the octant of its rays' summed directions, summed
// by halving within each warp and then over the warps left to right (W = 1:
// the ray's own octant). Dead lanes carry zero directions.
template <int W>
__device__ __forceinline__ int packet_octant(const Ray& r, int k_orders, float (*s_sum)[32]) {
  if (k_orders != 8) return 0;
  if (W == 1) return (r.dx < 0.f) * 4 + (r.dy < 0.f) * 2 + (r.dz < 0.f);
  float sx = r.dx, sy = r.dy, sz = r.dz;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sx = sx + __shfl_xor_sync(kFull, sx, off);
    sy = sy + __shfl_xor_sync(kFull, sy, off);
    sz = sz + __shfl_xor_sync(kFull, sz, off);
  }
  if (W > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) { s_sum[0][warp] = sx; s_sum[1][warp] = sy; s_sum[2][warp] = sz; }
    __syncthreads();
    sx = s_sum[0][0]; sy = s_sum[1][0]; sz = s_sum[2][0];
    for (int w = 1; w < W / 32; ++w) {
      sx = sx + s_sum[0][w]; sy = sy + s_sum[1][w]; sz = sz + s_sum[2][w];
    }
  }
  return (sx < 0.f) * 4 + (sy < 0.f) * 2 + (sz < 0.f);
}

// the bisect's and sweep-all's (ray, leaf) sweep: the Cramer test of the
// traversal kernels for t in [kTMin, kBig]
template <bool STAGED, bool UNIFORM>
__device__ __forceinline__ void sweep(bool adm, int blk, const float* p, const float* prim,
                                      const Ray& r, int lane, bvh::Best& best) {
  bvh::sweep_round<bvh::kTri, STAGED, UNIFORM>(adm, blk, p, prim, r, kTMin, kBig, lane, best);
}

// -- P1: ray I/O ------------------------------------------------------------

template <int LAYOUT>
__global__ void __launch_bounds__(kIoThreads)
probe_io_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                const float* __restrict__ f2, const float* __restrict__ f3,
                const float* __restrict__ f4, const float* __restrict__ f5, int n,
                float* __restrict__ out) {
  // f0..f5 = ox oy oz dx dy dz; kPacked reads (n, 8) records from f0 alone
  __shared__ __align__(16) float s_tile[LAYOUT == kTranspose ? 6 * kRow : 4];
  const int tid = threadIdx.x;
  if (LAYOUT == kSoa) {
    const int i = blockIdx.x * kIoThreads + tid;
    if (i < n) out[i] = six_sum(f0[i], f1[i], f2[i], f3[i], f4[i], f5[i]);
  } else if (LAYOUT == kPacked) {
    const int i = blockIdx.x * kIoThreads + tid;
    if (i < n) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(f0) + 2 * (size_t)i);
      const float4 b = __ldg(reinterpret_cast<const float4*>(f0) + 2 * (size_t)i + 1);
      out[i] = six_sum(a.x, a.y, a.z, a.w, b.x, b.y);
    }
  } else {
    const float* f[6] = {f0, f1, f2, f3, f4, f5};
    const int base = blockIdx.x * kRow + tid * 4;  // this thread's four rays
    float v[6][4];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (base + 3 < n) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(f[c] + base));
        v[c][0] = x.x; v[c][1] = x.y; v[c][2] = x.z; v[c][3] = x.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[c][q] = (base + q < n) ? f[c][base + q] : 0.f;
      }
    }
    if (LAYOUT == kRows) {
      float s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[q] = six_sum(v[0][q], v[1][q], v[2][q], v[3][q], v[4][q], v[5][q]);
      if (base + 3 < n) {
        *reinterpret_cast<float4*>(out + base) = make_float4(s[0], s[1], s[2], s[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (base + q < n) out[base + q] = s[q];
      }
    } else {
      // rows into shared memory four rays a thread, then one ray a thread out
      // of it: the change of ownership that a packet kernel fed by row loads
      // would need
#pragma unroll
      for (int c = 0; c < 6; ++c)
        *reinterpret_cast<float4*>(s_tile + c * kRow + tid * 4) =
            make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = q * kIoThreads + tid;
        const int i = blockIdx.x * kRow + k;
        if (i < n)
          out[i] = six_sum(s_tile[k], s_tile[kRow + k], s_tile[2 * kRow + k],
                           s_tile[3 * kRow + k], s_tile[4 * kRow + k], s_tile[5 * kRow + k]);
      }
    }
  }
}

// -- P1 walk, P2: the walk alone ----------------------------------------------

template <int W, int MODE>
__global__ void __launch_bounds__(Block<W>::threads)
probe_walk_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ bb, const int32_t* __restrict__ links, int n, int m,
                  int k_orders, float cap, float* __restrict__ val_out,
                  int32_t* __restrict__ ints) {
  __shared__ float s_sum[3][32];
  __shared__ int s_buf[Block<W>::threads / 32][kChunk];  // one buffer a warp; a block uses [0]
  const int i = blockIdx.x * Block<W>::threads + threadIdx.x;
  const bool live = i < n;
  if (W == 1 && !live) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i, live);
  const int oct = packet_octant<W>(r, k_orders, s_sum);
  const float* bbo = bb + (size_t)oct * m * 8;
  const int4* lko = reinterpret_cast<const int4*>(links) + (size_t)oct * m;
  int buf_own[kChunk];
  int* buf = (W == 1) ? buf_own : s_buf[W == 32 ? (threadIdx.x >> 5) : 0];
  const bool writer = is_writer<W>();

  // node, steps, leaves, nbuf and last are the same in every thread of a packet
  float val = (MODE == kBt) ? kBig : 0.f;
  int steps = 0, leaves = 0, last = -1, node = 0;
  while (node < m) {
    int nbuf = 0;
    while (node < m && (MODE != kBuf || nbuf < kChunk)) {
      float near, far;
      bvh::slab<true>(bbo + (size_t)node * 8, r, near, far);
      const int4 lk = __ldg(lko + node);
      bool admit = live && (near <= far) && (far >= kTMin);
      if (MODE == kBt) admit = admit && (near <= val);
      if (MODE == kCap || MODE == kBuf) admit = admit && (near <= cap);
      const bool any = vote<W>(admit);
      const bool take = any && lk.y > 0;
      if (MODE == kBt) {
        if (take && live) val = fminf(val, near);
      } else if (live) {
        val = val + near * kAccScale;
      }
      if (take) {
        if (MODE == kBuf) {
          if (writer) buf[nbuf] = lk.x;
        } else {
          last = lk.x;
        }
        ++nbuf;
        ++leaves;
      }
      node = (any && lk.y <= 0) ? node + 1 : lk.z;
      ++steps;
    }
    if (MODE == kBuf && nbuf > 0) {
      packet_sync<W>();
      last = buf[nbuf - 1];
      packet_sync<W>();  // the buffer is free again
    }
  }
  if (!live) return;
  val_out[i] = val;
  ints[i] = steps;
  ints[(size_t)n + i] = leaves;
  ints[2 * (size_t)n + i] = last;
}

// -- P1 sweep: every block for every ray ----------------------------------------

template <int W>
__global__ void __launch_bounds__(128)
probe_sweep_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ prim, int n, int n_blocks,
                   float* __restrict__ bt_out, int32_t* __restrict__ swept_out) {
  // W = 128: two slots, one swept while the next block lands in the other
  __shared__ __align__(16) float s_ring[W == 1 ? 4 : 2 * kStaged];
  __shared__ __align__(8) unsigned long long s_bar[2];
  const int i = blockIdx.x * 128 + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < n;  // a dead lane stays: the sweep's shuffles need all 32
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i, live);
  bvh::Best best{kBig, 0, 0, 0.f, 0.f};
  if (W == 1) {
    for (int b = 0; b < n_blocks; ++b) {
      const float* p = prim + (size_t)b * kTriFloats;
      sweep<false, false>(live, b, p, prim, r, lane, best);
    }
  } else {
    if (threadIdx.x < 2) bvh::mbar_init(s_bar + threadIdx.x);
    bvh::mbar_fence_init();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int b = 0; b < 2 && b < n_blocks; ++b)
        bvh::stage<bvh::kTri>(s_ring + b * kStaged, prim + (size_t)b * kTriFloats, s_bar + b);
    }
    for (int b = 0; b < n_blocks; ++b) {
      const int slot = b & 1;
      bvh::mbar_wait(s_bar + slot, (b >> 1) & 1);
      sweep<true, true>(live, b, s_ring + slot * kStaged, prim, r, lane, best);
      __syncthreads();  // every warp has read the slot: refill it
      if (threadIdx.x == 0 && b + 2 < n_blocks)
        bvh::stage<bvh::kTri>(s_ring + slot * kStaged, prim + (size_t)(b + 2) * kTriFloats,
                              s_bar + slot);
    }
  }
  if (!live) return;
  bt_out[i] = best.t;
  swept_out[i] = n_blocks;
}

// -- P3: the bisect ---------------------------------------------------------------

// V0-V3: the walk and its buffer, no sweep
template <int V, int W>
__global__ void __launch_bounds__(128)
probe_variant_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ bb, const int32_t* __restrict__ links,
                     const float* __restrict__ prim, int n, int m, int k_orders, int n_blocks,
                     float* __restrict__ acc_out, float* __restrict__ bt_out,
                     int32_t* __restrict__ ints, float* __restrict__ rec,
                     int32_t* __restrict__ mat_out) {
  constexpr bool kCount = V >= 1, kStore = V >= 2, kChunked = V >= 3;
  __shared__ float s_sum[3][32];
  __shared__ int s_buf[kChunk];
  const int i = blockIdx.x * 128 + threadIdx.x;
  const bool live = i < n;
  if (W == 1 && !live) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i, live);
  const int oct = packet_octant<W>(r, k_orders, s_sum);
  const float* bbo = bb + (size_t)oct * m * 8;
  const int4* lko = reinterpret_cast<const int4*>(links) + (size_t)oct * m;
  int buf_own[kChunk];
  int* buf = (W == 1) ? buf_own : s_buf;
  const bool writer = is_writer<W>();

  float acc = 0.f;
  int steps = 0, leaves = 0, last = -1, node = 0;
  // W = 128: node, steps, leaves, nbuf and last are the same in every thread
  // of the block; W = 1: a ray buffers the leaves it admits
  while (node < m) {
    int nbuf = 0;
    while (node < m && (!kChunked || nbuf < kChunk)) {
      float near, far;
      bvh::slab<true>(bbo + (size_t)node * 8, r, near, far);
      const int4 lk = __ldg(lko + node);
      const bool admit = live && (near <= far) && (far >= kTMin);
      const bool any = vote<W>(admit);
      if (live) acc = acc + near * kAccScale;
      if (kCount && any && lk.y > 0) {
        if (kStore && writer) buf[kChunked ? nbuf : min(nbuf, kChunk - 1)] = lk.x;
        ++nbuf;
      }
      node = (any && lk.y <= 0) ? node + 1 : lk.z;
      ++steps;
    }
    leaves += nbuf;
    if (kStore && nbuf > 0) {
      packet_sync<W>();
      last = buf[min(nbuf, kChunk) - 1];
      packet_sync<W>();  // the buffer is free again
    }
  }
  if (!live) return;
  acc_out[i] = acc;
  bt_out[i] = kBig;
  ints[i] = steps;
  ints[(size_t)n + i] = leaves;
  ints[2 * (size_t)n + i] = 0;
  ints[3 * (size_t)n + i] = 0;
  ints[4 * (size_t)n + i] = last;
}

// V4-V8: V3's walk, and the sweep of each chunk's buffered blocks (V5:
// blocks 0..nbuf-1 instead) by the traversal kernels' sweep. W = 1: the
// warp drains its lanes' buffers in rounds, as bvh_traverse.cu does; W =
// 128: the packet's leaves are staged into a ring of kChunk slots (40 KB,
// the packet kernel's four tri rings) as they are taken, and each warp
// sweeps each slot for its rays
template <int V, int W>
__global__ void __launch_bounds__(128)
probe_sweep_variant_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                           const float* __restrict__ oz, const float* __restrict__ dx,
                           const float* __restrict__ dy, const float* __restrict__ dz,
                           const float* __restrict__ bb, const int32_t* __restrict__ links,
                           const float* __restrict__ prim, int n, int m, int k_orders,
                           int n_blocks, float* __restrict__ acc_out,
                           float* __restrict__ bt_out, int32_t* __restrict__ ints,
                           float* __restrict__ rec, int32_t* __restrict__ mat_out) {
  constexpr bool kAttr = V >= 7, kStagedRing = W > 1;
  __shared__ float s_sum[3][32];
  __shared__ int s_buf[kChunk];
  __shared__ __align__(16) float s_ring[kStagedRing ? kChunk * kStaged : 4];
  __shared__ __align__(8) unsigned long long s_bar[kChunk];
  const int i = blockIdx.x * 128 + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < n;  // a dead lane stays: the sweep's shuffles need all 32
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i, live);
  const int oct = packet_octant<W>(r, k_orders, s_sum);
  const float* bbo = bb + (size_t)oct * m * 8;
  const int4* lko = reinterpret_cast<const int4*>(links) + (size_t)oct * m;
  int buf_own[kChunk];
  int* buf = (W == 1) ? buf_own : s_buf;
  const bool writer = is_writer<W>();
  if (kStagedRing) {
    if (threadIdx.x < kChunk) bvh::mbar_init(s_bar + threadIdx.x);
    bvh::mbar_fence_init();
    __syncthreads();
  }

  float acc = 0.f;
  bvh::Best best{kBig, 0, 0, 0.f, 0.f};
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;  // wins, block, t, t before, slot
  int steps = 0, leaves = 0, swept = 0, last = -1, node = 0;
  unsigned phases = 0;  // W = 128: bit j, the parity of slot j's next phase
  // W = 128: node, steps, leaves, nbuf, swept, last and phases are the same
  // in every thread of the block; W = 1: a ray buffers the leaves it admits
  while (true) {
    int nbuf = 0;
    while (node < m && nbuf < kChunk) {
      float near, far;
      bvh::slab<true>(bbo + (size_t)node * 8, r, near, far);
      const int4 lk = __ldg(lko + node);
      const bool admit = live && (near <= far) && (far >= kTMin);
      const bool any = vote<W>(admit);
      if (live) acc = acc + near * kAccScale;
      if (any && lk.y > 0) {
        if (writer) {
          buf[nbuf] = lk.x;
          if (kStagedRing) {  // the copy starts now; the rest of the walk hides it
            const int blk = (V == 5) ? nbuf % n_blocks : lk.x;
            bvh::stage<bvh::kTri>(s_ring + nbuf * kStaged, prim + (size_t)blk * kTriFloats,
                                  s_bar + nbuf);
          }
        }
        ++nbuf;
      }
      node = (any && lk.y <= 0) ? node + 1 : lk.z;
      ++steps;
    }
    leaves += nbuf;
    // a round per buffer position: W = 1 the warp's longest buffer
    const int rounds = (W == 1) ? __reduce_max_sync(kFull, nbuf) : nbuf;
    if (rounds == 0) break;
    packet_sync<W>();
    if (nbuf > 0) last = buf[nbuf - 1];
    for (int j = 0; j < rounds; ++j) {
      const bool have = j < nbuf;
      const int blk = (V == 5) ? j % n_blocks : (have ? buf[j] : 0);
      const bool adm = have && live;
      const float before = best.t;
      if (kStagedRing) {
        bvh::mbar_wait(s_bar + j, (phases >> j) & 1u);
        phases ^= 1u << j;
        sweep<true, true>(adm, blk, s_ring + j * kStaged, prim, r, lane, best);
      } else {
        sweep<false, false>(adm, blk, prim + (size_t)blk * kTriFloats, prim, r, lane, best);
      }
      if (kAttr && adm && best.t < before) {
        a0 = a0 + 1.f; a1 = (float)blk; a2 = best.t; a3 = before; a4 = (float)j;
      }
      swept += have;
    }
    packet_sync<W>();  // the buffer and the ring are free again
  }
  if (!live) return;
  acc_out[i] = acc;
  bt_out[i] = best.t;
  ints[i] = steps;
  ints[(size_t)n + i] = leaves;
  ints[2 * (size_t)n + i] = swept;
  ints[3 * (size_t)n + i] = (int32_t)a0;
  ints[4 * (size_t)n + i] = last;
  if (V == 7) rec[i] = ((a1 + a2) + a3) + a4;  // keeps the carries alive
  if (V == 8) {
    // the packet kernel's output record: t, four attributes, an int32
    rec[i] = best.t;
    rec[(size_t)n + i] = a1;
    rec[2 * (size_t)n + i] = a2;
    rec[3 * (size_t)n + i] = a3;
    rec[4 * (size_t)n + i] = a4;
    mat_out[i] = (int32_t)rintf(a0);
  }
}

#define FP(p) static_cast<const float*>(p)
#define I32(p) static_cast<int32_t*>(p)

template <int LAYOUT>
void launch_io(const void* const* f, int n, int reps, void* out, cudaStream_t s) {
  const int per_block = (LAYOUT == kRows || LAYOUT == kTranspose) ? kRow : kIoThreads;
  for (int rep = 0; rep < reps; ++rep)
    probe_io_kernel<LAYOUT><<<(n + per_block - 1) / per_block, kIoThreads, 0, s>>>(
        FP(f[0]), FP(f[1]), FP(f[2]), FP(f[3]), FP(f[4]), FP(f[5]), n, static_cast<float*>(out));
}

template <int W, int MODE>
void launch_walk(const void* const* f, const void* bb, const void* links, int n, int m,
                 int k_orders, float cap, int reps, void* val, void* ints, cudaStream_t s) {
  constexpr int threads = Block<W>::threads;
  for (int rep = 0; rep < reps; ++rep)
    probe_walk_kernel<W, MODE><<<(n + threads - 1) / threads, threads, 0, s>>>(
        FP(f[0]), FP(f[1]), FP(f[2]), FP(f[3]), FP(f[4]), FP(f[5]), FP(bb),
        static_cast<const int32_t*>(links), n, m, k_orders, cap, static_cast<float*>(val),
        I32(ints));
}

template <int W>
void launch_sweep(const void* const* f, const void* prim, int n, int n_blocks, int reps,
                  void* bt, void* swept, cudaStream_t s) {
  for (int rep = 0; rep < reps; ++rep)
    probe_sweep_kernel<W><<<(n + 127) / 128, 128, 0, s>>>(
        FP(f[0]), FP(f[1]), FP(f[2]), FP(f[3]), FP(f[4]), FP(f[5]), FP(prim), n, n_blocks,
        static_cast<float*>(bt), I32(swept));
}

template <int W>
void launch_walk_mode(int mode, const void* const* f, const void* bb, const void* links, int n,
                      int m, int k_orders, float cap, int reps, void* val, void* ints,
                      cudaStream_t s) {
  switch (mode) {
    case kBt: launch_walk<W, kBt>(f, bb, links, n, m, k_orders, cap, reps, val, ints, s); break;
    case kPlain: launch_walk<W, kPlain>(f, bb, links, n, m, k_orders, cap, reps, val, ints, s); break;
    case kCap: launch_walk<W, kCap>(f, bb, links, n, m, k_orders, cap, reps, val, ints, s); break;
    default: launch_walk<W, kBuf>(f, bb, links, n, m, k_orders, cap, reps, val, ints, s); break;
  }
}

// the bisect's kernel of variant V (only that one is instantiated)
template <int V, int W>
auto variant_kernel() {
  if constexpr (V >= 4) {
    return probe_sweep_variant_kernel<V, W>;
  } else {
    return probe_variant_kernel<V, W>;
  }
}

template <int V, int W>
void launch_variant(const void* const* f, const void* bb, const void* links, const void* prim,
                    int n, int m, int k_orders, int n_blocks, int reps, void* acc, void* bt,
                    void* ints, void* rec, void* mat, cudaStream_t s) {
  const auto kernel = variant_kernel<V, W>();
  for (int rep = 0; rep < reps; ++rep)
    kernel<<<(n + 127) / 128, 128, 0, s>>>(
        FP(f[0]), FP(f[1]), FP(f[2]), FP(f[3]), FP(f[4]), FP(f[5]), FP(bb),
        static_cast<const int32_t*>(links), FP(prim), n, m, k_orders, n_blocks,
        static_cast<float*>(acc), static_cast<float*>(bt), I32(ints), static_cast<float*>(rec),
        I32(mat));
}

template <int W>
int launch_variant_v(int v, const void* const* f, const void* bb, const void* links,
                     const void* prim, int n, int m, int k_orders, int n_blocks, int reps,
                     void* acc, void* bt, void* ints, void* rec, void* mat, cudaStream_t s) {
#define CASE(V)                                                                             \
  case V:                                                                                   \
    launch_variant<V, W>(f, bb, links, prim, n, m, k_orders, n_blocks, reps, acc, bt, ints, \
                         rec, mat, s);                                                      \
    break
  switch (v) {
    CASE(0); CASE(1); CASE(2); CASE(3); CASE(4); CASE(5); CASE(7); CASE(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches its kernel `reps` times back to back on the
// stream (the outputs are those of any one launch): the timed window of a
// probe too short for a single launch to be timed from the host.
//
// fields: six pointers ox oy oz dx dy dz (layout 3: fields[0] is the (n, 8)
// packed record array)
extern "C" int probe_io_launch(int layout, const void* const* fields, int n, int reps,
                               void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kSoa: launch_io<kSoa>(fields, n, reps, out, s); break;
    case kRows: launch_io<kRows>(fields, n, reps, out, s); break;
    case kTranspose: launch_io<kTranspose>(fields, n, reps, out, s); break;
    case kPacked: launch_io<kPacked>(fields, n, reps, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// val (n,) f32; ints (3, n) i32: node steps, leaves taken, last leaf taken
extern "C" int probe_walk_launch(int width, int mode, const void* const* fields,
                                 const void* bb, const void* links, int n, int m,
                                 int k_orders, float cap, int reps, void* val, void* ints,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (mode < kBt || mode > kBuf || reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: launch_walk_mode<1>(mode, fields, bb, links, n, m, k_orders, cap, reps, val, ints, s); break;
    case 32: launch_walk_mode<32>(mode, fields, bb, links, n, m, k_orders, cap, reps, val, ints, s); break;
    case 128: launch_walk_mode<128>(mode, fields, bb, links, n, m, k_orders, cap, reps, val, ints, s); break;
    case 1024: launch_walk_mode<1024>(mode, fields, bb, links, n, m, k_orders, cap, reps, val, ints, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// bt (n,) f32, swept (n,) i32
extern "C" int probe_sweep_launch(int width, const void* const* fields, const void* prim, int n,
                                  int n_blocks, int reps, void* bt, void* swept, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (width == 1) {
    launch_sweep<1>(fields, prim, n, n_blocks, reps, bt, swept, s);
  } else if (width == 128) {
    launch_sweep<128>(fields, prim, n, n_blocks, reps, bt, swept, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc, bt (n,) f32; ints (5, n) i32: node steps, leaves taken, blocks swept,
// wins, last leaf taken; rec (5, n) f32 (V7 writes row 0, V8 all); mat (n,) i32
extern "C" int probe_variant_launch(int v, int width, const void* const* fields,
                                    const void* bb, const void* links, const void* prim, int n,
                                    int m, int k_orders, int n_blocks, int reps, void* acc,
                                    void* bt, void* ints, void* rec, void* mat, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n_blocks < 1 || reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (width == 1)
    return launch_variant_v<1>(v, fields, bb, links, prim, n, m, k_orders, n_blocks, reps, acc,
                               bt, ints, rec, mat, s);
  if (width == 128)
    return launch_variant_v<128>(v, fields, bb, links, prim, n, m, k_orders, n_blocks, reps,
                                 acc, bt, ints, rec, mat, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
