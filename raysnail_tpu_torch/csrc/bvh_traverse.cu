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
//     kernel's formulas and operation order (:253-318). The sweep compares
//     against the best t only, not against t_cap, so a ray may return a hit
//     beyond its t_cap, as there; the caller's min over groups drops it;
//   * the epilogue (:358-401): tri the barycentric blend of the vertex
//     normals and the material; box the face axis, the entry flag, the face
//     uv rebuilt from the winner's bounds and the material; sphere the
//     winner's center, radius and material. A miss (and a dead lane, t_cap
//     <= 0) is t = BIG with zero attributes.
//
// Design, and where it differs from the TPU kernel. The TPU kernel walks
// 128-ray packets on sublanes with a scalar walk in SMEM, windows of WIN
// nodes and buffered leaf sweeps, all shaped by the TPU's layout. Here one
// thread owns one ray and walks the DFS order of its OWN direction octant
// (the TPU kernel picks one octant per packet), with a best t that tightens
// after every leaf. Ties: inside a leaf the lowest lane wins, across leaves
// the first one visited (strict <), as in the TPU kernel's box kind; the
// TPU kernel's tri/sphere kinds sum the attributes of an exact f32 tie
// (measure zero), here one winner is kept. The winner's attributes are read
// once, after the walk, from its block and lane.
//
// What bounds it on this card: latency. Each thread chases its own node
// and leaf addresses (32 B per node, 128 x NF x 4 B per leaf, the leaves of
// the 204,800-triangle mesh are 28 MB and stay in the 50 MB L2), and
// threads of a warp diverge in their walks. The leaves stay in global
// memory; staging them in shared memory is later work.
//
// Built with -fmad=false and IEEE division and square root: each product,
// sum and quotient rounds as the plain PyTorch version's elementwise
// operations round it, so t and the winner agree bit for bit with it.
//
// The C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 128;  // primitives per leaf block
constexpr float kBig = 1e30f;

enum Kind { kTri = 0, kBox = 1, kSphere = 2 };

struct RayIn {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;
};

// the running winner: block, lane and two per-(ray, primitive) values
// (tri: beta, gamma; box: face axis, entry flag)
struct Best {
  float t;
  int blk, lane;
  float a, b;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float e = (fabsf(d) < 1e-12f) ? (d < 0.f ? -1e-12f : 1e-12f) : d;
  return 1.0f / e;
}

// slab test of one node's bounds -> (near, far)
__device__ __forceinline__ void slab(const float* __restrict__ bb, const RayIn& r,
                                     float& near, float& far) {
  const float4 p = __ldg(reinterpret_cast<const float4*>(bb));
  const float4 q = __ldg(reinterpret_cast<const float4*>(bb) + 1);
  const float ax0 = (p.x - r.ox) * r.ivx;
  const float ax1 = (p.w - r.ox) * r.ivx;
  const float ay0 = (p.y - r.oy) * r.ivy;
  const float ay1 = (q.x - r.oy) * r.ivy;
  const float az0 = (p.z - r.oz) * r.ivz;
  const float az1 = (q.y - r.oz) * r.ivz;
  near = fmaxf(fmaxf(fminf(ax0, ax1), fminf(ay0, ay1)), fminf(az0, az1));
  far = fminf(fminf(fmaxf(ax0, ax1), fmaxf(ay0, ay1)), fmaxf(az0, az1));
}

template <int KIND>
__device__ __forceinline__ void sweep(const float* __restrict__ blk_ptr, int blk,
                                      const RayIn& r, float t_min, float t_max,
                                      Best& best) {
#define FLD(i) __ldg(blk_ptr + (i) * kLanes + l)
  for (int l = 0; l < kLanes; ++l) {
    if (KIND == kTri) {
      // Cramer's-rule barycentric solve (bvh_pallas.py:253-271)
      const float j = FLD(0) - r.ox;
      const float k = FLD(1) - r.oy;
      const float ll = FLD(2) - r.oz;
      const float ax = FLD(3), ay = FLD(4), az = FLD(5);
      const float ddx = FLD(6), ddy = FLD(7), ddz = FLD(8);
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
                      (FLD(9) > 0.f);
      if (ok && t < best.t) {
        best.t = t; best.blk = blk; best.lane = l; best.a = beta; best.b = gamma;
      }
    } else if (KIND == kBox) {
      // slab interval; near if in range, else far (bvh_pallas.py:272-302)
      const float tax = (FLD(0) - r.ox) * r.ivx;
      const float tbx = (FLD(3) - r.ox) * r.ivx;
      const float tay = (FLD(1) - r.oy) * r.ivy;
      const float tby = (FLD(4) - r.oy) * r.ivy;
      const float taz = (FLD(2) - r.oz) * r.ivz;
      const float tbz = (FLD(5) - r.oz) * r.ivz;
      const float lox = fminf(tax, tbx), hix = fmaxf(tax, tbx);
      const float loy = fminf(tay, tby), hiy = fmaxf(tay, tby);
      const float loz = fminf(taz, tbz), hiz = fmaxf(taz, tbz);
      const float near = fmaxf(fmaxf(lox, loy), loz);
      const float far = fminf(fminf(hix, hiy), hiz);
      const bool okb = (near < far) && (FLD(6) > 0.f);
      const bool near_in = okb && (t_min < near) && (near < t_max);
      const bool far_in = okb && (t_min < far) && (far < t_max);
      const float t = near_in ? near : far;
      if ((near_in || far_in) && t < best.t) {
        const float axis_near = (lox >= loy) ? ((lox >= loz) ? 0.f : 2.f)
                                             : ((loy >= loz) ? 1.f : 2.f);
        const float axis_far = (hix <= hiy) ? ((hix <= hiz) ? 0.f : 2.f)
                                            : ((hiy <= hiz) ? 1.f : 2.f);
        best.t = t; best.blk = blk; best.lane = l;
        best.a = near_in ? axis_near : axis_far;
        best.b = near_in ? 1.f : 0.f;
      }
    } else {
      // half-b quadratic, t1-else-t2 in-range rule (bvh_pallas.py:303-318)
      const float lx = r.ox - FLD(0);
      const float ly = r.oy - FLD(1);
      const float lz = r.oz - FLD(2);
      const float half_b = (r.dx * lx + r.dy * ly) + r.dz * lz;
      const float cc = ((lx * lx + ly * ly) + lz * lz) - FLD(3);
      const float delta = half_b * half_b - cc;
      const float sq = sqrtf(fmaxf(delta, 0.f));
      const float t1 = -half_b - sq;
      const float t2 = -half_b + sq;
      const bool okd = (delta > 0.f) && (FLD(4) > 0.f);
      const bool in1 = okd && (t_min < t1) && (t1 < t_max);
      const bool in2 = okd && (t_min < t2) && (t2 < t_max);
      const float t = in1 ? t1 : t2;
      if ((in1 || in2) && t < best.t) {
        best.t = t; best.blk = blk; best.lane = l;
      }
    }
  }
#undef FLD
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
bvh_traverse_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t_cap, const float* __restrict__ bb,
                    const int32_t* __restrict__ links, const float* __restrict__ prim,
                    int n, int m, int k_orders, int nf, float t_min, float t_max,
                    float* __restrict__ out, int32_t* __restrict__ mat_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  RayIn r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ivx = safe_inv(r.dx); r.ivy = safe_inv(r.dy); r.ivz = safe_inv(r.dz);
  const float cap_t = t_cap[i];

  const int oct = (k_orders == 8)
      ? (r.dx < 0.f) * 4 + (r.dy < 0.f) * 2 + (r.dz < 0.f) : 0;
  const float* bbo = bb + (size_t)oct * m * 8;
  const int4* lko = reinterpret_cast<const int4*>(links) + (size_t)oct * m;

  // admission cap from the root's slab test (node 0 of every order)
  float near0, far0;
  slab(bbo, r, near0, far0);
  const float cap_in = fminf(cap_t, t_max);
  const bool can_hit = (cap_t > 0.f) && (near0 <= far0) && (far0 >= t_min) &&
                       (near0 <= cap_in);
  const float cap = can_hit ? fminf(far0, cap_in) * 1.0001f + 1e-4f : -kBig;

  Best best{kBig, 0, 0, 0.f, 0.f};
  int node = (cap >= t_min) ? 0 : m;
  while (node < m) {
    float near, far;
    slab(bbo + (size_t)node * 8, r, near, far);
    const int4 lk = __ldg(lko + node);
    const bool admit = (near <= far) && (far >= t_min) && (near <= fminf(best.t, cap));
    if (admit && lk.y > 0) {
      sweep<KIND>(prim + (size_t)lk.x * nf * kLanes, lk.x, r, t_min, t_max, best);
      node = lk.z;
    } else {
      node = admit ? node + 1 : lk.z;
    }
  }

  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, mat = 0.f;
  const bool hit = best.t < kBig;
  if (hit) {
    const float* f = prim + (size_t)best.blk * nf * kLanes + best.lane;
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
  out[i] = best.t;
  out[(size_t)n + i] = a0;
  out[2 * (size_t)n + i] = a1;
  out[3 * (size_t)n + i] = a2;
  out[4 * (size_t)n + i] = a3;
  mat_out[i] = (int32_t)rintf(mat);
}

}  // namespace

extern "C" int bvh_traverse_launch(int kind, const void* ox, const void* oy,
                                   const void* oz, const void* dx, const void* dy,
                                   const void* dz, const void* t_cap, const void* bb,
                                   const void* links, const void* prim, int n, int m,
                                   int k_orders, int nf, float t_min, float t_max,
                                   void* out, void* mat_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    auto s = static_cast<cudaStream_t>(stream);
#define LAUNCH(K)                                                              \
  bvh_traverse_kernel<K><<<blocks, kThreads, 0, s>>>(                         \
      static_cast<const float*>(ox), static_cast<const float*>(oy),           \
      static_cast<const float*>(oz), static_cast<const float*>(dx),           \
      static_cast<const float*>(dy), static_cast<const float*>(dz),           \
      static_cast<const float*>(t_cap), static_cast<const float*>(bb),        \
      static_cast<const int32_t*>(links), static_cast<const float*>(prim), n, \
      m, k_orders, nf, t_min, t_max, static_cast<float*>(out),                \
      static_cast<int32_t*>(mat_out))
    switch (kind) {
      case kTri: LAUNCH(kTri); break;
      case kBox: LAUNCH(kBox); break;
      case kSphere: LAUNCH(kSphere); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
