// Fused ray x sphere intersection with a per-ray min-t and first-index
// argmin, for Hopper (sm_90a).
//
// Replaces the TPU kernel raysnail_tpu/ops/sphere_pallas.py (`_kernel`,
// wrapped by `sphere_min_t`). It computes exactly what that kernel
// computes: the half-b quadratic per (ray, sphere) pair, ok = delta > 0 and
// the sphere active, t = t1 if t_min < t1 < t_max else t2 if t_min < t2 <
// t_max else BIG (1e30), and per ray the smallest t with the index of the
// FIRST sphere that attains it. The TPU kernel takes an argmin inside each
// 128-lane chunk and a strict `<` across chunks; a sequential loop over the
// spheres with a strict `<` gives the same winner.
//
// The moving form (motion blur, sphere.rs:50-52): each sphere also carries
// its speed and each ray its time, and the center of a pair is
// c + speed * time, as geometry/spheres.py pair_t of the JAX package moves
// it. In the JAX package a moving group never takes the TPU kernel (XLA
// fuses its dense sweep); here the dense sweep is this kernel on the card.
//
// What bounds it on the card. With few spheres (example.sdl: S = 4) it is
// the ray I/O: 24 bytes in and 8 bytes out per ray. With many (book 1:
// S = 481) it is the issue of the per-pair arithmetic: built with
// -fmad=false, every product and sum issues on its own (16 operations a
// static pair up to delta, 22 a moving one), so the floor is the
// operations at one per lane per clock, twice the FMA-counted FP32 peak.
//
// Design, against that floor:
// - kRays rays per thread, kThreads threads a block: one sphere read serves
//   kRays pairs, and the rays' chains are independent work for the
//   scheduler. Ray r of a thread is ray tile + r * kThreads + threadIdx.x,
//   so every load and store of the ray arrays is coalesced.
// - The block stages kTile spheres at a time into shared memory, packed as
//   16-byte records (cx, cy, cz, r2) and, moving, (sx, sy, sz, 0): the inner
//   loop reads a sphere with one or two vector broadcasts. An inactive
//   sphere is staged with r2 = -inf, so its c is +inf (or NaN) and its
//   delta never exceeds 0: `delta > 0` alone is the pair's ok.
// - The root only where a pair can hit. A pair with delta <= 0 gives BIG,
//   which never replaces a running best (initialised to BIG, strict <). So
//   the correctly rounded sqrtf, the two roots and their range tests run
//   only when some ray of the thread has delta > 0 (one branch a sphere),
//   and then only for the rays that have it.
// - The grid is one block per kThreads * kRays rays: at the main path's
//   400,000 rays that is 782 blocks, inside one wave of the blocks that
//   132 SMs hold at once (`sphere_min_t_shape` reports the count).
//
// Built with -fmad=false: each product and sum rounds as the plain PyTorch
// version's separate elementwise kernels round it, so t and idx agree bit
// for bit with that version (and with the JAX package's CPU result).
//
// The C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
//
// K1b, the backward of the sweep (`sphere_min_t_bwd_launch`): the gradient
// of each ray's t with respect to its origin and direction, given K1's t
// and idx and the cotangent g_t. Only the winner's pair carries t, so the
// gradient is the winner's: recompute l = o - c (c moved in the moving
// form), half_b = d.l, cc = l.l - r2, delta and sq = sqrt(delta), pick the
// root as the forward picked it (t1 when t_min < t1 < t_max, else t2), and
// apply the chain rule of t = -half_b -/+ sq through half_b and cc:
//   dt/dhalf_b = -1 -/+ half_b / sq,   dt/dcc = +/- 0.5 / sq,
//   g_o = g_hb * d + 2 g_cc * l,       g_d = g_hb * l.
// A ray whose t is BIG (a miss) gets 0. One thread a ray, no atomics: the
// gradient goes to the ray, never to the sphere (geometry is not a
// parameter). The operations and their order are those of
// `ops.sphere_min_t.sphere_min_t_bwd_plain`; with -fmad=false and IEEE
// divisions and square root the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRays = 4;
constexpr int kTile = 256;
constexpr float kBig = 1e30f;

// 8 blocks an SM at once: at most 64 registers a thread
template <bool MOVING>
__global__ void __launch_bounds__(kThreads, 8)
sphere_min_t_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ cx, const float* __restrict__ cy,
                    const float* __restrict__ cz, const float* __restrict__ r2,
                    const uint8_t* __restrict__ active, const float* __restrict__ sx,
                    const float* __restrict__ sy, const float* __restrict__ sz,
                    const float* __restrict__ time, float t_min, float t_max,
                    float* __restrict__ t_out, int32_t* __restrict__ idx_out,
                    int n, int s) {
  __shared__ float4 s_sph[kTile];                  // cx, cy, cz, r2 (-inf: inactive)
  __shared__ float4 s_spd[MOVING ? kTile : 1];     // sx, sy, sz, 0

  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  float o_x[kRays], o_y[kRays], o_z[kRays], d_x[kRays], d_y[kRays], d_z[kRays];
  float tm[kRays], best_t[kRays];
  int32_t best_i[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray = first + r * kThreads;
    const bool live = ray < n;
    o_x[r] = live ? ox[ray] : 0.f;
    o_y[r] = live ? oy[ray] : 0.f;
    o_z[r] = live ? oz[ray] : 0.f;
    d_x[r] = live ? dx[ray] : 0.f;
    d_y[r] = live ? dy[ray] : 0.f;
    d_z[r] = live ? dz[ray] : 0.f;
    tm[r] = (MOVING && live) ? time[ray] : 0.f;
    best_t[r] = kBig;
    best_i[r] = 0;
  }

  for (int base = 0; base < s; base += kTile) {
    const int tile = min(kTile, s - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < tile; j += kThreads) {
      const int k = base + j;
      s_sph[j] = make_float4(cx[k], cy[k], cz[k], active[k] ? r2[k] : -INFINITY);
      if (MOVING) s_spd[j] = make_float4(sx[k], sy[k], sz[k], 0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < tile; ++k) {
      const float4 sph = s_sph[k];
      const float4 spd = MOVING ? s_spd[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      float half_b[kRays], delta[kRays];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        // the plain version's order: the center moves first, then o - c
        const float lx = o_x[r] - (MOVING ? sph.x + spd.x * tm[r] : sph.x);
        const float ly = o_y[r] - (MOVING ? sph.y + spd.y * tm[r] : sph.y);
        const float lz = o_z[r] - (MOVING ? sph.z + spd.z * tm[r] : sph.z);
        half_b[r] = (d_x[r] * lx + d_y[r] * ly) + d_z[r] * lz;
        const float c = ((lx * lx + ly * ly) + lz * lz) - sph.w;
        delta[r] = half_b[r] * half_b[r] - c;
        any |= delta[r] > 0.f;
      }
      if (any) {
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          if (delta[r] > 0.f) {
            const float sq = sqrtf(delta[r]);
            const float t1 = -half_b[r] - sq;
            const float t2 = -half_b[r] + sq;
            const bool in1 = (t_min < t1) && (t1 < t_max);
            const bool in2 = (t_min < t2) && (t2 < t_max);
            const float t = in1 ? t1 : (in2 ? t2 : kBig);
            if (t < best_t[r]) {
              best_t[r] = t;
              best_i[r] = base + k;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray = first + r * kThreads;
    if (ray < n) {
      t_out[ray] = best_t[r];
      idx_out[ray] = best_i[r];
    }
  }
}

}  // namespace

extern "C" int sphere_min_t_launch(const void* ox, const void* oy, const void* oz,
                                   const void* dx, const void* dy, const void* dz,
                                   const void* cx, const void* cy, const void* cz,
                                   const void* r2, const void* active, const void* sx,
                                   const void* sy, const void* sz, const void* time,
                                   float t_min, float t_max, void* t_out, void* idx_out,
                                   int n, int s, void* stream) {
  // time (N,) selects the moving form, with sx, sy, sz (S,), which are null
  // only when S = 0 (an empty tensor's pointer); all four null: static
  if (n > 0) {
    const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
    auto st = static_cast<cudaStream_t>(stream);
#define ARGS                                                                   \
  static_cast<const float*>(ox), static_cast<const float*>(oy),               \
      static_cast<const float*>(oz), static_cast<const float*>(dx),           \
      static_cast<const float*>(dy), static_cast<const float*>(dz),           \
      static_cast<const float*>(cx), static_cast<const float*>(cy),           \
      static_cast<const float*>(cz), static_cast<const float*>(r2),           \
      static_cast<const uint8_t*>(active), static_cast<const float*>(sx),     \
      static_cast<const float*>(sy), static_cast<const float*>(sz),           \
      static_cast<const float*>(time), t_min, t_max, static_cast<float*>(t_out), \
      static_cast<int32_t*>(idx_out), n, s
    if (time && (s == 0 || (sx && sy && sz))) {
      sphere_min_t_kernel<true><<<blocks, kThreads, 0, st>>>(ARGS);
    } else if (!sx && !sy && !sz && !time) {
      sphere_min_t_kernel<false><<<blocks, kThreads, 0, st>>>(ARGS);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#undef ARGS
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of one form, for a run's record: threads a block, rays a
// thread, spheres a shared-memory tile, and the blocks that one SM of the
// current device holds at once (the occupancy calculator's count).
extern "C" int sphere_min_t_shape(int moving, int* threads, int* rays, int* tile,
                                  int* blocks_per_sm) {
  *threads = kThreads;
  *rays = kRays;
  *tile = kTile;
  const cudaError_t err =
      moving ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, sphere_min_t_kernel<true>, kThreads, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, sphere_min_t_kernel<false>, kThreads, 0);
  return static_cast<int>(err);
}

namespace {

constexpr int kBwdThreads = 256;

template <bool MOVING>
__global__ void __launch_bounds__(kBwdThreads)
sphere_min_t_bwd_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                        const float* __restrict__ oz, const float* __restrict__ dx,
                        const float* __restrict__ dy, const float* __restrict__ dz,
                        const float* __restrict__ t, const int32_t* __restrict__ idx,
                        const float* __restrict__ g_t, const float* __restrict__ cx,
                        const float* __restrict__ cy, const float* __restrict__ cz,
                        const float* __restrict__ r2, const float* __restrict__ sx,
                        const float* __restrict__ sy, const float* __restrict__ sz,
                        const float* __restrict__ time, float t_min, float t_max,
                        float* __restrict__ go_x, float* __restrict__ go_y,
                        float* __restrict__ go_z, float* __restrict__ gd_x,
                        float* __restrict__ gd_y, float* __restrict__ gd_z, int n) {
  const int ray = blockIdx.x * kBwdThreads + threadIdx.x;
  if (ray >= n) return;
  float gox = 0.f, goy = 0.f, goz = 0.f, gdx = 0.f, gdy = 0.f, gdz = 0.f;
  if (t[ray] < kBig) {
    const int k = idx[ray];
    const float d_x = dx[ray], d_y = dy[ray], d_z = dz[ray];
    float c_x = cx[k], c_y = cy[k], c_z = cz[k];
    if (MOVING) {
      const float tm = time[ray];
      c_x = c_x + sx[k] * tm;
      c_y = c_y + sy[k] * tm;
      c_z = c_z + sz[k] * tm;
    }
    const float lx = ox[ray] - c_x;
    const float ly = oy[ray] - c_y;
    const float lz = oz[ray] - c_z;
    const float half_b = (d_x * lx + d_y * ly) + d_z * lz;
    const float cc = ((lx * lx + ly * ly) + lz * lz) - r2[k];
    const float sq = sqrtf(half_b * half_b - cc);  // delta > 0 for every winner
    const float t1 = -half_b - sq;
    const bool in1 = (t_min < t1) && (t1 < t_max);
    const float q = half_b / sq;
    const float h = 0.5f / sq;
    const float g = g_t[ray];
    const float g_hb = g * ((in1 ? -q : q) - 1.0f);
    const float g_cc2 = (g * (in1 ? h : -h)) * 2.0f;
    gox = g_hb * d_x + g_cc2 * lx;
    goy = g_hb * d_y + g_cc2 * ly;
    goz = g_hb * d_z + g_cc2 * lz;
    gdx = g_hb * lx;
    gdy = g_hb * ly;
    gdz = g_hb * lz;
  }
  go_x[ray] = gox;
  go_y[ray] = goy;
  go_z[ray] = goz;
  gd_x[ray] = gdx;
  gd_y[ray] = gdy;
  gd_z[ray] = gdz;
}

}  // namespace

extern "C" int sphere_min_t_bwd_launch(const void* ox, const void* oy, const void* oz,
                                       const void* dx, const void* dy, const void* dz,
                                       const void* t, const void* idx, const void* g_t,
                                       const void* cx, const void* cy, const void* cz,
                                       const void* r2, const void* sx, const void* sy,
                                       const void* sz, const void* time, float t_min,
                                       float t_max, void* go_x, void* go_y, void* go_z,
                                       void* gd_x, void* gd_y, void* gd_z, int n, int s,
                                       void* stream) {
  // time (N,) selects the moving form, with sx, sy, sz (S,), which are null
  // only when S = 0; all four null: static. A ray's idx names a sphere only
  // where its t is below BIG.
  if (n > 0) {
    const int blocks = (n + kBwdThreads - 1) / kBwdThreads;
    auto st = static_cast<cudaStream_t>(stream);
#define ARGS                                                                     \
  static_cast<const float*>(ox), static_cast<const float*>(oy),                 \
      static_cast<const float*>(oz), static_cast<const float*>(dx),             \
      static_cast<const float*>(dy), static_cast<const float*>(dz),             \
      static_cast<const float*>(t), static_cast<const int32_t*>(idx),           \
      static_cast<const float*>(g_t), static_cast<const float*>(cx),            \
      static_cast<const float*>(cy), static_cast<const float*>(cz),             \
      static_cast<const float*>(r2), static_cast<const float*>(sx),             \
      static_cast<const float*>(sy), static_cast<const float*>(sz),             \
      static_cast<const float*>(time), t_min, t_max, static_cast<float*>(go_x), \
      static_cast<float*>(go_y), static_cast<float*>(go_z),                     \
      static_cast<float*>(gd_x), static_cast<float*>(gd_y),                     \
      static_cast<float*>(gd_z), n
    if (time && (s == 0 || (sx && sy && sz))) {
      sphere_min_t_bwd_kernel<true><<<blocks, kBwdThreads, 0, st>>>(ARGS);
    } else if (!sx && !sy && !sz && !time) {
      sphere_min_t_bwd_kernel<false><<<blocks, kBwdThreads, 0, st>>>(ARGS);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#undef ARGS
  }
  return static_cast<int>(cudaGetLastError());
}
