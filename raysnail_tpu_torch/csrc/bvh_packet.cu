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
// tile-ordered render path. A block rather than a warp, because the staged
// leaves live in shared memory and four warps share one ring where four
// warp-sized packets would each need their own. The block walks ONE node
// order, the octant of the sign of the packet's summed directions (:164-169),
// and enters a node when any of its rays admits it (__syncthreads_or), with
// the per-ray cap (:214-224) and admission rule (:486). Admitted leaves are
// collected, up to the ring depth, and then swept. At the sweep each ray
// tests the leaf's bounds again against its own best t, which has tightened
// since the walk, and sweeps the leaf only if it still admits it. So a ray
// sweeps exactly the leaves that a walk of its own, in the packet's order
// and with an always fresh best t, would sweep: the outputs do not depend on
// the ring depth, on `stream` or on `two_level`, and equal the plain PyTorch
// version's (ops/bvh_traverse.py, packet=True) bit for bit. Within a leaf a
// thread tests the 128 primitives in lane order, four at a time from one
// 16-byte load that the whole warp shares, and keeps the first winner of a
// tie (strict <), across leaves the first visited.
//
// stream. The sweep rows of the collected leaves (tri: rows 0-9, 5,120 B;
// box: rows 0-6; sphere: rows 0-4; tri_mxu: rows 0-9 of the solve table and
// the valid row, 20,992 B) are copied from global to the shared-memory ring
// with cp.async, one commit group per slot, all started back to back; each
// sweep waits only for its own slot's group (cp.async.wait_group) and a
// block barrier (:519-535). Without `stream` the sweep reads the same rows
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
// two_level. The packet's octant's cut entries sit in shared memory; the
// packet tests the next real entry (padding entries are counted out, never
// tested), enters it when any ray admits its bounds, and walks only its
// [start, end) range (:432-471).
//
// What bounds it on this card: FP32 operations in the sweeps of coherent
// packets, latency in the walk (one block barrier per node). Built with
// -fmad=false and IEEE division and square root, so each product, sum and
// quotient rounds as the plain version's elementwise operations round it.
//
// The C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPacket = 128;     // rays per packet = threads per block
constexpr int kLanes = 128;      // primitives per leaf block
constexpr int kMaxDepth = 8;     // most ring slots
constexpr int kCoarseMax = 64;   // cut entries per octant, padding included
constexpr int kSolveLanes = 512; // lanes of the tri_mxu solve table
constexpr int kMxuLanes = 640;   // lanes of a tri_mxu block
constexpr float kBig = 1e30f;

enum Kind { kTri = 0, kBox = 1, kSphere = 2, kTriMxu = 3 };

// floats of one block in global memory, and of its staged sweep rows
template <int KIND> struct Shape;
template <> struct Shape<kTri> { static constexpr int block = 24 * kLanes, staged = 10 * kLanes; };
template <> struct Shape<kBox> { static constexpr int block = 8 * kLanes, staged = 7 * kLanes; };
template <> struct Shape<kSphere> { static constexpr int block = 8 * kLanes, staged = 5 * kLanes; };
template <> struct Shape<kTriMxu> {
  static constexpr int block = 16 * kMxuLanes, staged = 10 * kSolveLanes + kLanes;
};

struct RayIn {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;
};

// the running winner: block, lane and two per-(ray, primitive) values
// (tri, tri_mxu: beta, gamma; box: face axis, entry flag)
struct Best {
  float t;
  int blk, lane;
  float a, b;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float e = (fabsf(d) < 1e-12f) ? (d < 0.f ? -1e-12f : 1e-12f) : d;
  return 1.0f / e;
}

// slab test of bounds [min.xyz, max.xyz, ..] at `bb` -> (near, far)
__device__ __forceinline__ void slab(const float* bb, const RayIn& r, float& near,
                                     float& far) {
  const float4 p = *reinterpret_cast<const float4*>(bb);
  const float4 q = *(reinterpret_cast<const float4*>(bb) + 1);
  const float ax0 = (p.x - r.ox) * r.ivx;
  const float ax1 = (p.w - r.ox) * r.ivx;
  const float ay0 = (p.y - r.oy) * r.ivy;
  const float ay1 = (q.x - r.oy) * r.ivy;
  const float az0 = (p.z - r.oz) * r.ivz;
  const float az1 = (q.y - r.oz) * r.ivz;
  near = fmaxf(fmaxf(fminf(ax0, ax1), fminf(ay0, ay1)), fminf(az0, az1));
  far = fminf(fminf(fmaxf(ax0, ax1), fmaxf(ay0, ay1)), fmaxf(az0, az1));
}

__device__ __forceinline__ bool admits(const float* bb, const RayIn& r, float t_min,
                                       float limit) {
  float near, far;
  slab(bb, r, near, far);
  return (near <= far) && (far >= t_min) && (near <= limit);
}

// four consecutive floats: from the staged copy, or from global memory
// through the read-only path
template <bool STREAM>
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = STREAM ? *reinterpret_cast<const float4*>(p)
                          : __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` of this thread's commit groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// start the copy of one leaf's sweep rows into a ring slot (whole block)
template <int KIND>
__device__ __forceinline__ void stage(float* dst, const float* src, int tid) {
  if (KIND == kTriMxu) {
    // rows 0-9 of the solve table (640-lane rows in global memory, 512-lane
    // rows in the slot), then the valid row (row 0 of the attribute table)
    for (int c = tid; c < 10 * (kSolveLanes / 4); c += kPacket) {
      const int row = c / (kSolveLanes / 4), col = (c % (kSolveLanes / 4)) * 4;
      cp_async16(dst + row * kSolveLanes + col, src + row * kMxuLanes + col);
    }
    if (tid < kLanes / 4)
      cp_async16(dst + 10 * kSolveLanes + tid * 4, src + kSolveLanes + tid * 4);
  } else {
    for (int c = tid; c < Shape<KIND>::staged / 4; c += kPacket)
      cp_async16(dst + c * 4, src + c * 4);
  }
}

// sweep one leaf's 128 primitives for one ray. p: the staged rows (STREAM)
// or the block in global memory; feat: the ray's nine tri_mxu features.
template <int KIND, bool STREAM>
__device__ __forceinline__ void sweep(const float* p, int blk, const RayIn& r,
                                      const float (&feat)[9], float t_min, float t_max,
                                      Best& best) {
  for (int l0 = 0; l0 < kLanes; l0 += 4) {
    if (KIND == kTriMxu) {
      constexpr int kRow = STREAM ? kSolveLanes : kMxuLanes;
      const float* valid_row = STREAM ? p + 10 * kSolveLanes : p + kSolveLanes;
      float acc[4][4];  // [denom | n.o - n.p0 | beta num | gamma num][lane]
      float f[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        load4<STREAM>(p + g * kLanes + l0, f);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[g][q] = feat[0] * f[q];
      }
#pragma unroll
      for (int k = 1; k < 9; ++k) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          load4<STREAM>(p + k * kRow + g * kLanes + l0, f);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[g][q] = acc[g][q] + feat[k] * f[q];
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {  // the constant feature 1
        load4<STREAM>(p + 9 * kRow + g * kLanes + l0, f);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[g][q] = acc[g][q] + f[q];
      }
      float valid[4];
      load4<STREAM>(valid_row + l0, valid);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float den = acc[0][q];
        if (fabsf(den) < 1e-20f) den = 1e-20f;
        const float inv_den = 1.0f / den;
        const float t = -acc[1][q] * inv_den;
        const float beta = acc[2][q] * inv_den;
        const float gamma = acc[3][q] * inv_den;
        const bool ok = (beta >= 0.f) && (beta < 1.f) && (gamma > 0.f) &&
                        (beta + gamma < 1.f) && (t >= t_min) && (t <= t_max) &&
                        (valid[q] > 0.f);
        if (ok && t < best.t) {
          best.t = t; best.blk = blk; best.lane = l0 + q; best.a = beta; best.b = gamma;
        }
      }
    } else if (KIND == kTri) {
      // Cramer's-rule barycentric solve (bvh_pallas.py:253-271)
      float F[10][4];
#pragma unroll
      for (int i = 0; i < 10; ++i) load4<STREAM>(p + i * kLanes + l0, F[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float j = F[0][q] - r.ox;
        const float k = F[1][q] - r.oy;
        const float ll = F[2][q] - r.oz;
        const float ax = F[3][q], ay = F[4][q], az = F[5][q];
        const float ddx = F[6][q], ddy = F[7][q], ddz = F[8][q];
        const float eihf = ddy * r.dz - r.dy * ddz;
        const float gfdi = r.dx * ddz - ddx * r.dz;
        const float dheg = ddx * r.dy - ddy * r.dx;
        float denom = (ax * eihf + ay * gfdi) + az * dheg;
        if (fabsf(denom) < 1e-20f) denom = 1e-20f;
        const float beta = ((j * eihf + k * gfdi) + ll * dheg) / denom;
        const float akjb = ax * k - j * ay;
        const float jcal = j * az - ax * ll;
        const float blkc = ay * ll - k * az;
        const float gamma = ((r.dz * akjb + r.dy * jcal) + r.dx * blkc) / denom;
        const float t = -((ddz * akjb + ddy * jcal) + ddx * blkc) / denom;
        const bool ok = (beta >= 0.f) && (beta < 1.f) && (gamma > 0.f) &&
                        (beta + gamma < 1.f) && (t >= t_min) && (t <= t_max) &&
                        (F[9][q] > 0.f);
        if (ok && t < best.t) {
          best.t = t; best.blk = blk; best.lane = l0 + q; best.a = beta; best.b = gamma;
        }
      }
    } else if (KIND == kBox) {
      // slab interval; near if in range, else far (bvh_pallas.py:272-302)
      float F[7][4];
#pragma unroll
      for (int i = 0; i < 7; ++i) load4<STREAM>(p + i * kLanes + l0, F[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float tax = (F[0][q] - r.ox) * r.ivx;
        const float tbx = (F[3][q] - r.ox) * r.ivx;
        const float tay = (F[1][q] - r.oy) * r.ivy;
        const float tby = (F[4][q] - r.oy) * r.ivy;
        const float taz = (F[2][q] - r.oz) * r.ivz;
        const float tbz = (F[5][q] - r.oz) * r.ivz;
        const float lox = fminf(tax, tbx), hix = fmaxf(tax, tbx);
        const float loy = fminf(tay, tby), hiy = fmaxf(tay, tby);
        const float loz = fminf(taz, tbz), hiz = fmaxf(taz, tbz);
        const float near = fmaxf(fmaxf(lox, loy), loz);
        const float far = fminf(fminf(hix, hiy), hiz);
        const bool okb = (near < far) && (F[6][q] > 0.f);
        const bool near_in = okb && (t_min < near) && (near < t_max);
        const bool far_in = okb && (t_min < far) && (far < t_max);
        const float t = near_in ? near : far;
        if ((near_in || far_in) && t < best.t) {
          const float axis_near = (lox >= loy) ? ((lox >= loz) ? 0.f : 2.f)
                                               : ((loy >= loz) ? 1.f : 2.f);
          const float axis_far = (hix <= hiy) ? ((hix <= hiz) ? 0.f : 2.f)
                                              : ((hiy <= hiz) ? 1.f : 2.f);
          best.t = t; best.blk = blk; best.lane = l0 + q;
          best.a = near_in ? axis_near : axis_far;
          best.b = near_in ? 1.f : 0.f;
        }
      }
    } else {
      // half-b quadratic, t1-else-t2 in-range rule (bvh_pallas.py:303-318)
      float F[5][4];
#pragma unroll
      for (int i = 0; i < 5; ++i) load4<STREAM>(p + i * kLanes + l0, F[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float lx = r.ox - F[0][q];
        const float ly = r.oy - F[1][q];
        const float lz = r.oz - F[2][q];
        const float half_b = (r.dx * lx + r.dy * ly) + r.dz * lz;
        const float cc = ((lx * lx + ly * ly) + lz * lz) - F[3][q];
        const float delta = half_b * half_b - cc;
        const float sq = sqrtf(fmaxf(delta, 0.f));
        const float t1 = -half_b - sq;
        const float t2 = -half_b + sq;
        const bool okd = (delta > 0.f) && (F[4][q] > 0.f);
        const bool in1 = okd && (t_min < t1) && (t1 < t_max);
        const bool in2 = okd && (t_min < t2) && (t2 < t_max);
        const float t = in1 ? t1 : t2;
        if ((in1 || in2) && t < best.t) {
          best.t = t; best.blk = blk; best.lane = l0 + q;
        }
      }
    }
  }
}

template <int KIND, bool STREAM>
__global__ void __launch_bounds__(kPacket)
bvh_packet_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cap, const float* __restrict__ bb,
                  const int32_t* __restrict__ links, const float* __restrict__ prim,
                  const float* __restrict__ cbb, const int32_t* __restrict__ crange,
                  int n, int m, int k_orders, int two_level, int depth, float t_min,
                  float t_max, float* __restrict__ out, int32_t* __restrict__ mat_out) {
  extern __shared__ __align__(16) float ring[];  // depth slots of staged rows
  __shared__ float s_sum[3][kPacket / 32];
  __shared__ int s_node[kMaxDepth], s_blk[kMaxDepth];
  __shared__ __align__(16) float s_cbb[kCoarseMax * 8];
  __shared__ int s_start[kCoarseMax], s_end[kCoarseMax];

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kPacket + tid;
  const bool live = i < n;  // the last packet may be partial
  RayIn r;
  r.ox = live ? ox[i] : 0.f; r.oy = live ? oy[i] : 0.f; r.oz = live ? oz[i] : 0.f;
  r.dx = live ? dx[i] : 0.f; r.dy = live ? dy[i] : 0.f; r.dz = live ? dz[i] : 0.f;
  r.ivx = safe_inv(r.dx); r.ivy = safe_inv(r.dy); r.ivz = safe_inv(r.dz);
  const float cap_t = live ? t_cap[i] : -1.f;

  // the packet's node order: the octant of the summed directions, summed by
  // halving within each warp and then over the four warps left to right
  int oct = 0;
  if (k_orders == 8) {
    float sx = r.dx, sy = r.dy, sz = r.dz;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx = sx + __shfl_xor_sync(0xffffffffu, sx, off);
      sy = sy + __shfl_xor_sync(0xffffffffu, sy, off);
      sz = sz + __shfl_xor_sync(0xffffffffu, sz, off);
    }
    if ((tid & 31) == 0) {
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

  // admission cap from the root's slab test (node 0 of every order)
  float near0, far0;
  slab(bbo, r, near0, far0);
  const float cap_in = fminf(cap_t, t_max);
  const bool can_hit = (cap_t > 0.f) && (near0 <= far0) && (far0 >= t_min) &&
                       (near0 <= cap_in);
  const float cap = can_hit ? fminf(far0, cap_in) * 1.0001f + 1e-4f : -kBig;
  const bool any_ray = __syncthreads_or(cap >= t_min);

  float feat[9] = {r.dx, r.dy, r.dz, r.ox, r.oy, r.oz, 0.f, 0.f, 0.f};
  if (KIND == kTriMxu) {
    feat[6] = r.oy * r.dz - r.oz * r.dy;
    feat[7] = r.oz * r.dx - r.ox * r.dz;
    feat[8] = r.ox * r.dy - r.oy * r.dx;
  }

  // node, end, cut and nbuf are the same in every thread of the block: each
  // is set from block-wide votes and from data that every thread reads
  Best best{kBig, 0, 0, 0.f, 0.f};
  int node = 0;
  int end = two_level ? 0 : m;  // two_level starts before the first cut entry
  int cut = 0;
  if (!any_ray) { end = 0; cut = n_cut; }
  while (true) {
    // walk: collect admitted leaves, up to the ring depth
    int nbuf = 0;
    while (nbuf < depth) {
      if (node >= end) {
        if (cut >= n_cut) break;
        const bool vote = __syncthreads_or(
            admits(s_cbb + cut * 8, r, t_min, fminf(best.t, cap)));
        if (vote) { node = s_start[cut]; end = s_end[cut]; }
        ++cut;
        continue;
      }
      const int4 lk = __ldg(lko + node);
      const bool vote = __syncthreads_or(
          admits(bbo + (size_t)node * 8, r, t_min, fminf(best.t, cap)));
      if (vote && lk.y > 0) {
        if (tid == 0) { s_node[nbuf] = node; s_blk[nbuf] = lk.x; }
        ++nbuf;
        node = lk.z;
      } else {
        node = vote ? node + 1 : lk.z;
      }
    }
    if (nbuf == 0) break;
    __syncthreads();  // s_node and s_blk are written
    if (STREAM) {
      for (int j = 0; j < nbuf; ++j) {
        stage<KIND>(ring + (size_t)j * Shape<KIND>::staged,
                    prim + (size_t)s_blk[j] * Shape<KIND>::block, tid);
        cp_async_commit();
      }
    }
    for (int j = 0; j < nbuf; ++j) {
      if (STREAM) {
        cp_async_wait(nbuf - 1 - j);  // this thread's copies of slot j
        __syncthreads();              // and every other thread's
      }
      const int blk = s_blk[j];
      // the ray sweeps the leaf only if it admits it with its fresh best t
      if (admits(bbo + (size_t)s_node[j] * 8, r, t_min, fminf(best.t, cap))) {
        const float* p = STREAM ? ring + (size_t)j * Shape<KIND>::staged
                                : prim + (size_t)blk * Shape<KIND>::block;
        sweep<KIND, STREAM>(p, blk, r, feat, t_min, t_max, best);
      }
    }
    __syncthreads();  // the buffer and the ring are free again
  }

  if (!live) return;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, mat = 0.f;
  if (best.t < kBig) {
    if (KIND == kTriMxu) {
      // the winner's column of the attribute table (bvh_pallas.py:359-366)
      const float* f = prim + (size_t)best.blk * Shape<KIND>::block + kSolveLanes + best.lane;
      const float w0 = (1.f - best.a) - best.b;
      a0 = (f[2 * kMxuLanes] * w0 + f[5 * kMxuLanes] * best.a) + f[8 * kMxuLanes] * best.b;
      a1 = (f[3 * kMxuLanes] * w0 + f[6 * kMxuLanes] * best.a) + f[9 * kMxuLanes] * best.b;
      a2 = (f[4 * kMxuLanes] * w0 + f[7 * kMxuLanes] * best.a) + f[10 * kMxuLanes] * best.b;
      mat = f[kMxuLanes];
    } else {
      const float* f = prim + (size_t)best.blk * Shape<KIND>::block + best.lane;
      if (KIND == kTri) {
        // barycentric vertex-normal blend (bvh_pallas.py:367-377)
        const float w0 = (1.f - best.a) - best.b;
        a0 = (f[10 * kLanes] * w0 + f[13 * kLanes] * best.a) + f[16 * kLanes] * best.b;
        a1 = (f[11 * kLanes] * w0 + f[14 * kLanes] * best.a) + f[17 * kLanes] * best.b;
        a2 = (f[12 * kLanes] * w0 + f[15 * kLanes] * best.a) + f[18 * kLanes] * best.b;
        mat = f[19 * kLanes];
      } else if (KIND == kBox) {
        // face uv from the winner's bounds and the hit point (:378-397)
        const float lo[3] = {f[0], f[kLanes], f[2 * kLanes]};
        const float hi[3] = {f[3 * kLanes], f[4 * kLanes], f[5 * kLanes]};
        const float o[3] = {r.ox, r.oy, r.oz};
        const float d[3] = {r.dx, r.dy, r.dz};
        float rel[3];
        for (int c = 0; c < 3; ++c) {
          const float ph = o[c] + d[c] * best.t;
          float den = hi[c] - lo[c];
          if (fabsf(den) < 1e-12f) den = 1.f;
          rel[c] = (ph - lo[c]) / den;
        }
        const int axis = (int)best.a;
        a0 = best.a;
        a1 = best.b;
        a2 = rel[(axis + 1) % 3];
        a3 = rel[(axis + 2) % 3];
        mat = f[7 * kLanes];
      } else {
        // winner's center, radius, material (:398-401)
        a0 = f[0]; a1 = f[kLanes]; a2 = f[2 * kLanes];
        a3 = f[6 * kLanes];
        mat = f[5 * kLanes];
      }
    }
  }
  out[i] = best.t;
  out[(size_t)n + i] = a0;
  out[2 * (size_t)n + i] = a1;
  out[3 * (size_t)n + i] = a2;
  out[4 * (size_t)n + i] = a3;
  mat_out[i] = (int32_t)rintf(mat);
}

template <int KIND, bool STREAM>
int launch(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
           const void* dz, const void* t_cap, const void* bb, const void* links,
           const void* prim, const void* cbb, const void* crange, int n, int m,
           int k_orders, int two_level, int depth, float t_min, float t_max, void* out,
           void* mat_out, cudaStream_t s) {
  const size_t smem = STREAM ? (size_t)depth * Shape<KIND>::staged * sizeof(float) : 0;
  if (smem > 48 * 1024) {  // the large carve-out is opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        bvh_packet_kernel<KIND, STREAM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + kPacket - 1) / kPacket;
  bvh_packet_kernel<KIND, STREAM><<<blocks, kPacket, smem, s>>>(
      static_cast<const float*>(ox), static_cast<const float*>(oy),
      static_cast<const float*>(oz), static_cast<const float*>(dx),
      static_cast<const float*>(dy), static_cast<const float*>(dz),
      static_cast<const float*>(t_cap), static_cast<const float*>(bb),
      static_cast<const int32_t*>(links), static_cast<const float*>(prim),
      static_cast<const float*>(cbb), static_cast<const int32_t*>(crange), n, m,
      k_orders, two_level, depth, t_min, t_max, static_cast<float*>(out),
      static_cast<int32_t*>(mat_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bvh_packet_launch(int kind, const void* ox, const void* oy, const void* oz,
                                 const void* dx, const void* dy, const void* dz,
                                 const void* t_cap, const void* bb, const void* links,
                                 const void* prim, const void* cbb, const void* crange,
                                 int n, int m, int k_orders, int stream_leaves,
                                 int two_level, int depth, float t_min, float t_max,
                                 void* out, void* mat_out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (depth < 1 || depth > kMaxDepth || (two_level && (!cbb || !crange)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K)                                                                    \
  return stream_leaves                                                               \
      ? launch<K, true>(ox, oy, oz, dx, dy, dz, t_cap, bb, links, prim, cbb, crange, \
                        n, m, k_orders, two_level, depth, t_min, t_max, out,         \
                        mat_out, s)                                                  \
      : launch<K, false>(ox, oy, oz, dx, dy, dz, t_cap, bb, links, prim, cbb,        \
                         crange, n, m, k_orders, two_level, depth, t_min, t_max,     \
                         out, mat_out, s)
  switch (kind) {
    case kTri: LAUNCH(kTri);
    case kBox: LAUNCH(kBox);
    case kSphere: LAUNCH(kSphere);
    case kTriMxu: LAUNCH(kTriMxu);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
}
