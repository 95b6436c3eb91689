// What the two BVH traversal kernels (bvh_traverse.cu, per ray;
// bvh_packet.cu, per packet) share: the slab test, the leaf sweep of the
// four kinds, the round that sweeps one pending leaf per lane, and the
// epilogue. The formulas and their operation order are those of the TPU
// kernel raysnail_tpu/ops/bvh_pallas.py (`_kernel`: sweeps :235-318,
// epilogues :358-401) and of the plain PyTorch version
// (ops/bvh_traverse.py); built with -fmad=false and IEEE division and square
// root, each product, sum and quotient rounds as the plain version's
// elementwise operations round it.
//
// A leaf block holds 128 primitives, field f of primitive l at [f][l]. A
// (ray, leaf) sweep finds the leaf's closest primitive that beats the ray's
// best t; a tie inside the leaf goes to the lowest primitive index and a tie
// with the best t so far changes nothing (strict <). The sweep is
// primitive-parallel (`sweep_coop`): the owner's ray is broadcast by
// shuffles, lane l tests primitives 4l..4l+3 (each row is one coalesced
// 512-byte load of the warp), and a butterfly min-reduction over (t,
// primitive index), the lower index winning a tie, hands the winner to the
// owner. 128 serial tests become 4 and the reduction. `sweep_round` takes
// one pending leaf per lane (or one for the whole warp) and sweeps for one
// ray after another. A ray-parallel form (each ray's own thread testing the
// 128 primitives, lanes at the same block sharing the loads) was measured
// beside it on an H100 and never paid, so there is none.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bvh {

constexpr int kLanes = 128;       // primitives per leaf block
constexpr int kSolveLanes = 512;  // lanes of the tri_mxu solve table
constexpr int kMxuLanes = 640;    // lanes of a tri_mxu block
constexpr int kDepth = 8;         // leaves a ray, or a warp of a packet, defers
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoLane = 0x7fffffff;

enum Kind { kTri = 0, kBox = 1, kSphere = 2, kTriMxu = 3 };

// The forms of the two traversal kernels. kFullForm is the traversal that
// renders. The other two are probes, the counterparts of the TPU kernel's
// switches (bvh_pallas.py:78-79): kNoSweep (`_NOSWEEP`, :231) runs the
// walk, the root cap, the deferral and the drain rounds with their fresh
// re-test, and calls no sweep, so best t stays BIG; kNoAttr (`_NOATTR`,
// :323) runs everything but the epilogue's attribute reads and blend, and
// writes t. Both write counters where the full form writes its record.
enum Form { kFullForm = 0, kNoSweep = 1, kNoAttr = 2 };

// floats of one block in global memory and of its staged sweep rows, and the
// slots of a warp's ring in the packet kernel's `stream` mode (four rings a
// block: tri 40 KB, 5 blocks an SM; tri_mxu 84 KB, 2 blocks an SM)
template <int KIND> struct Shape;
template <> struct Shape<kTri> {
  static constexpr int block = 24 * kLanes, staged = 10 * kLanes, ring = 2;
};
template <> struct Shape<kBox> {
  static constexpr int block = 8 * kLanes, staged = 7 * kLanes, ring = 2;
};
template <> struct Shape<kSphere> {
  static constexpr int block = 8 * kLanes, staged = 5 * kLanes, ring = 2;
};
template <> struct Shape<kTriMxu> {
  static constexpr int block = 16 * kMxuLanes, staged = 10 * kSolveLanes + kLanes, ring = 1;
};

// a ray; f[] holds the nine tri_mxu features [d | o | o x d] (kTriMxu only)
struct RayIn {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;
  float f[9];
};

// the running winner: block, lane and two per-(ray, primitive) values
// (tri, tri_mxu: beta, gamma; box: face axis, entry flag)
struct Best {
  float t;
  int blk, lane;
  float a, b;
};

// the winner inside one leaf
struct Cand {
  float t;
  int lane;
  float a, b;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float e = (fabsf(d) < 1e-12f) ? (d < 0.f ? -1e-12f : 1e-12f) : d;
  return 1.0f / e;
}

template <int KIND>
__device__ __forceinline__ void finish_ray(RayIn& r) {
  r.ivx = safe_inv(r.dx); r.ivy = safe_inv(r.dy); r.ivz = safe_inv(r.dz);
  if (KIND == kTriMxu) {
    r.f[0] = r.dx; r.f[1] = r.dy; r.f[2] = r.dz;
    r.f[3] = r.ox; r.f[4] = r.oy; r.f[5] = r.oz;
    r.f[6] = r.oy * r.dz - r.oz * r.dy;
    r.f[7] = r.oz * r.dx - r.ox * r.dz;
    r.f[8] = r.ox * r.dy - r.oy * r.dx;
  }
}

// slab test of bounds [min.xyz, max.xyz, ..] at `bb` -> (near, far); GLOBAL:
// read through the read-only path
template <bool GLOBAL>
__device__ __forceinline__ void slab(const float* bb, const RayIn& r, float& near,
                                     float& far) {
  const float4* b4 = reinterpret_cast<const float4*>(bb);
  const float4 p = GLOBAL ? __ldg(b4) : b4[0];
  const float4 q = GLOBAL ? __ldg(b4 + 1) : b4[1];
  const float ax0 = (p.x - r.ox) * r.ivx;
  const float ax1 = (p.w - r.ox) * r.ivx;
  const float ay0 = (p.y - r.oy) * r.ivy;
  const float ay1 = (q.x - r.oy) * r.ivy;
  const float az0 = (p.z - r.oz) * r.ivz;
  const float az1 = (q.y - r.oz) * r.ivz;
  near = fmaxf(fmaxf(fminf(ax0, ax1), fminf(ay0, ay1)), fminf(az0, az1));
  far = fminf(fminf(fmaxf(ax0, ax1), fmaxf(ay0, ay1)), fmaxf(az0, az1));
}

template <bool GLOBAL>
__device__ __forceinline__ bool admits(const float* bb, const RayIn& r, float t_min,
                                       float limit) {
  float near, far;
  slab<GLOBAL>(bb, r, near, far);
  return (near <= far) && (far >= t_min) && (near <= limit);
}

// the admission cap from the root's slab test (bvh_pallas.py:214-224): -kBig,
// which admits nothing, for a ray that cannot hit
__device__ __forceinline__ float root_cap(const float* root, const RayIn& r, float cap_t,
                                          float t_min, float t_max) {
  float near0, far0;
  slab<true>(root, r, near0, far0);
  const float cap_in = fminf(cap_t, t_max);
  const bool can_hit = (cap_t > 0.f) && (near0 <= far0) && (far0 >= t_min) &&
                       (near0 <= cap_in);
  return can_hit ? fminf(far0, cap_in) * 1.0001f + 1e-4f : -kBig;
}

// four consecutive floats: from shared memory (STAGED), or from global
// memory through the read-only path
template <bool STAGED>
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = STAGED ? *reinterpret_cast<const float4*>(p)
                          : __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

// primitives l0..l0+3 of one leaf against one ray, in index order; c keeps
// the first primitive with the least t below c.t. p: the staged sweep rows
// (STAGED) or the block in global memory.
template <int KIND, bool STAGED>
__device__ __forceinline__ void test4(const float* p, int l0, const RayIn& r, float t_min,
                                      float t_max, Cand& c) {
  if (KIND == kTriMxu) {
    // the four 10-term dot products of the ray's features [d | o | o x d | 1]
    // with the solve table's columns, summed term by term in row order
    // (bvh_pallas.py:181-189, :235-249)
    constexpr int kRow = STAGED ? kSolveLanes : kMxuLanes;
    const float* valid_row = STAGED ? p + 10 * kSolveLanes : p + kSolveLanes;
    float acc[4][4];  // [denom | n.o - n.p0 | beta num | gamma num][lane]
    float f[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      load4<STAGED>(p + g * kLanes + l0, f);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = r.f[0] * f[q];
    }
#pragma unroll
    for (int k = 1; k < 9; ++k) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        load4<STAGED>(p + k * kRow + g * kLanes + l0, f);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[g][q] = acc[g][q] + r.f[k] * f[q];
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {  // the constant feature 1
      load4<STAGED>(p + 9 * kRow + g * kLanes + l0, f);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = acc[g][q] + f[q];
    }
    float valid[4];
    load4<STAGED>(valid_row + l0, valid);
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
      if (ok && t < c.t) { c.t = t; c.lane = l0 + q; c.a = beta; c.b = gamma; }
    }
  } else if (KIND == kTri) {
    // Cramer's-rule barycentric solve (bvh_pallas.py:253-271)
    float F[10][4];
#pragma unroll
    for (int i = 0; i < 10; ++i) load4<STAGED>(p + i * kLanes + l0, F[i]);
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
      if (ok && t < c.t) { c.t = t; c.lane = l0 + q; c.a = beta; c.b = gamma; }
    }
  } else if (KIND == kBox) {
    // slab interval; near if in range, else far (bvh_pallas.py:272-302)
    float F[7][4];
#pragma unroll
    for (int i = 0; i < 7; ++i) load4<STAGED>(p + i * kLanes + l0, F[i]);
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
      if ((near_in || far_in) && t < c.t) {
        const float axis_near = (lox >= loy) ? ((lox >= loz) ? 0.f : 2.f)
                                             : ((loy >= loz) ? 1.f : 2.f);
        const float axis_far = (hix <= hiy) ? ((hix <= hiz) ? 0.f : 2.f)
                                            : ((hiy <= hiz) ? 1.f : 2.f);
        c.t = t; c.lane = l0 + q;
        c.a = near_in ? axis_near : axis_far;
        c.b = near_in ? 1.f : 0.f;
      }
    }
  } else {
    // half-b quadratic, t1-else-t2 in-range rule (bvh_pallas.py:303-318)
    float F[5][4];
#pragma unroll
    for (int i = 0; i < 5; ++i) load4<STAGED>(p + i * kLanes + l0, F[i]);
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
      if ((in1 || in2) && t < c.t) { c.t = t; c.lane = l0 + q; }
    }
  }
}

__device__ __forceinline__ void take(const Cand& c, int blk, Best& best) {
  if (c.t < best.t) {
    best.t = c.t; best.blk = blk; best.lane = c.lane; best.a = c.a; best.b = c.b;
  }
}

// the fields of lane `src`'s ray that the sweep of KIND reads, in every lane
template <int KIND>
__device__ __forceinline__ void broadcast_ray(const RayIn& r, int src, RayIn& o) {
  if (KIND == kTriMxu) {
#pragma unroll
    for (int k = 0; k < 9; ++k) o.f[k] = __shfl_sync(kFull, r.f[k], src);
    return;
  }
  o.ox = __shfl_sync(kFull, r.ox, src);
  o.oy = __shfl_sync(kFull, r.oy, src);
  o.oz = __shfl_sync(kFull, r.oz, src);
  if (KIND == kBox) {
    o.ivx = __shfl_sync(kFull, r.ivx, src);
    o.ivy = __shfl_sync(kFull, r.ivy, src);
    o.ivz = __shfl_sync(kFull, r.ivz, src);
  } else {
    o.dx = __shfl_sync(kFull, r.dx, src);
    o.dy = __shfl_sync(kFull, r.dy, src);
    o.dz = __shfl_sync(kFull, r.dz, src);
  }
}

// primitive-parallel form, called by the whole warp: the ray `rb` (the same
// in every lane) against the leaf, lane l testing primitives 4l..4l+3; ->
// the leaf's winner below `bt` in every lane (lane kNoLane when there is
// none). The reduction orders by (t, primitive index), so a tie goes to the
// lowest index, as the plain version's argmin gives it; the winner's two
// values come from the lane that tested it.
template <int KIND, bool STAGED>
__device__ __forceinline__ Cand sweep_coop(const float* p, const RayIn& rb, float bt,
                                           float t_min, float t_max, int lane) {
  Cand c{bt, kNoLane, 0.f, 0.f};
  test4<KIND, STAGED>(p, lane * 4, rb, t_min, t_max, c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, c.t, off);
    const int ol = __shfl_xor_sync(kFull, c.lane, off);
    if (ot < c.t || (ot == c.t && ol < c.lane)) { c.t = ot; c.lane = ol; }
  }
  const int winner = (c.lane >> 2) & 31;
  c.a = __shfl_sync(kFull, c.a, winner);
  c.b = __shfl_sync(kFull, c.b, winner);
  return c;
}

// One pending leaf per lane, swept for every lane whose `adm` is set, one
// ray after another, lowest lane first; called by the whole warp, converged.
// UNIFORM: every lane holds the same leaf (blk and p the same in all); else
// each lane its own, p = prim + blk * block. STAGED implies UNIFORM. Every
// ray sweeps at most one leaf here, so the order among rays changes no
// result.
template <int KIND, bool STAGED, bool UNIFORM>
__device__ __forceinline__ void sweep_round(bool adm, int blk, const float* p,
                                            const float* prim, const RayIn& r, float t_min,
                                            float t_max, int lane, Best& best) {
  unsigned todo = __ballot_sync(kFull, adm);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    RayIn rb;
    broadcast_ray<KIND>(r, src, rb);
    const float bt = __shfl_sync(kFull, best.t, src);
    const int blk_s = UNIFORM ? blk : __shfl_sync(kFull, blk, src);
    const float* ps = UNIFORM ? p : prim + (size_t)blk_s * Shape<KIND>::block;
    const Cand c = sweep_coop<KIND, STAGED>(ps, rb, bt, t_min, t_max, lane);
    if (lane == src) take(c, blk_s, best);
  }
}

// the winner's shading attributes and the ray's six outputs
// (bvh_pallas.py:358-401); a miss is t = kBig with zero attributes. The
// kernels' probe forms write what `write_form` writes instead.
template <int KIND>
__device__ __forceinline__ void write_hit(const float* __restrict__ prim, const RayIn& r,
                                          const Best& best, int i, int n,
                                          float* __restrict__ out,
                                          int32_t* __restrict__ mat_out) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, mat = 0.f;
  if (best.t < kBig) {
    if (KIND == kTriMxu) {
      // the winner's column of the attribute table (:359-366)
      const float* f = prim + (size_t)best.blk * Shape<KIND>::block + kSolveLanes + best.lane;
      const float w0 = (1.f - best.a) - best.b;
      a0 = (f[2 * kMxuLanes] * w0 + f[5 * kMxuLanes] * best.a) + f[8 * kMxuLanes] * best.b;
      a1 = (f[3 * kMxuLanes] * w0 + f[6 * kMxuLanes] * best.a) + f[9 * kMxuLanes] * best.b;
      a2 = (f[4 * kMxuLanes] * w0 + f[7 * kMxuLanes] * best.a) + f[10 * kMxuLanes] * best.b;
      mat = f[kMxuLanes];
    } else {
      const float* f = prim + (size_t)best.blk * Shape<KIND>::block + best.lane;
      if (KIND == kTri) {
        // barycentric vertex-normal blend (:367-377)
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

// a probe form's outputs (Form) for ray i of n: its t, then rows of
// `counts`: kNoAttr the (ray, leaf) sweeps the ray ran; kNoSweep the sweeps
// its drain admitted and skipped, its walk's node steps (the packet
// kernel: its warp's) and its warp's drain rounds
template <int FORM>
__device__ __forceinline__ void write_form(float t, int sweeps, int steps, int rounds, int i,
                                           int n, float* __restrict__ out,
                                           int32_t* __restrict__ counts) {
  out[i] = t;
  counts[i] = sweeps;
  if (FORM == kNoSweep) {
    counts[(size_t)n + i] = steps;
    counts[2 * (size_t)n + i] = rounds;
  }
}

}  // namespace bvh
