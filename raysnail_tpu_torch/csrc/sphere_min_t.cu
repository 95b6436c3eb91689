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
// Design. One thread owns one ray and keeps its six ray components and its
// running (t, idx) in registers. The block stages the sphere parameters
// (cx, cy, cz, r2, active) through shared memory, one tile of blockDim.x
// spheres at a time, so a block reads each sphere once from device memory
// however many rays it holds. The kernel masks the ragged ray edge itself:
// no padding of rays or spheres to the TPU's (512, 128) tiling.
//
// What bounds it on the card. With few spheres (example.sdl: S = 4) it is
// the ray I/O: 24 bytes in and 8 bytes out per ray, at device-memory
// bandwidth. With many (book1: S = 478) it is about 20 float operations per
// (ray, sphere) pair, in registers, with the sphere tile read from shared
// memory as a broadcast (every thread of a warp reads the same word).
//
// Built with -fmad=false: each product and sum rounds as the plain PyTorch
// version's separate elementwise kernels round it, so t and idx agree bit
// for bit with that version (and with the JAX package's CPU result).
//
// The C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
sphere_min_t_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ cx, const float* __restrict__ cy,
                    const float* __restrict__ cz, const float* __restrict__ r2,
                    const uint8_t* __restrict__ active, float t_min, float t_max,
                    float* __restrict__ t_out, int32_t* __restrict__ idx_out,
                    int n, int s) {
  __shared__ float s_cx[kThreads];
  __shared__ float s_cy[kThreads];
  __shared__ float s_cz[kThreads];
  __shared__ float s_r2[kThreads];
  __shared__ uint8_t s_act[kThreads];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  float o_x = 0.f, o_y = 0.f, o_z = 0.f, d_x = 0.f, d_y = 0.f, d_z = 0.f;
  if (live) {
    o_x = ox[ray]; o_y = oy[ray]; o_z = oz[ray];
    d_x = dx[ray]; d_y = dy[ray]; d_z = dz[ray];
  }
  float best_t = kBig;
  int32_t best_i = 0;

  for (int base = 0; base < s; base += kThreads) {
    const int j = base + threadIdx.x;
    __syncthreads();  // the previous tile is no longer read
    if (j < s) {
      s_cx[threadIdx.x] = cx[j];
      s_cy[threadIdx.x] = cy[j];
      s_cz[threadIdx.x] = cz[j];
      s_r2[threadIdx.x] = r2[j];
      s_act[threadIdx.x] = active[j];
    }
    __syncthreads();
    const int tile = min(kThreads, s - base);
    for (int k = 0; k < tile; ++k) {
      const float lx = o_x - s_cx[k];
      const float ly = o_y - s_cy[k];
      const float lz = o_z - s_cz[k];
      const float half_b = (d_x * lx + d_y * ly) + d_z * lz;
      const float c = ((lx * lx + ly * ly) + lz * lz) - s_r2[k];
      const float delta = half_b * half_b - c;
      const float sq = sqrtf(fmaxf(delta, 0.f));
      const float t1 = -half_b - sq;
      const float t2 = -half_b + sq;
      const bool ok = (delta > 0.f) && (s_act[k] != 0);
      const bool in1 = ok && (t_min < t1) && (t1 < t_max);
      const bool in2 = ok && (t_min < t2) && (t2 < t_max);
      const float t = in1 ? t1 : (in2 ? t2 : kBig);
      if (t < best_t) {
        best_t = t;
        best_i = base + k;
      }
    }
  }
  if (live) {
    t_out[ray] = best_t;
    idx_out[ray] = best_i;
  }
}

}  // namespace

extern "C" int sphere_min_t_launch(const void* ox, const void* oy, const void* oz,
                                   const void* dx, const void* dy, const void* dz,
                                   const void* cx, const void* cy, const void* cz,
                                   const void* r2, const void* active, float t_min,
                                   float t_max, void* t_out, void* idx_out, int n,
                                   int s, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    sphere_min_t_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ox), static_cast<const float*>(oy),
        static_cast<const float*>(oz), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dz),
        static_cast<const float*>(cx), static_cast<const float*>(cy),
        static_cast<const float*>(cz), static_cast<const float*>(r2),
        static_cast<const uint8_t*>(active), t_min, t_max,
        static_cast<float*>(t_out), static_cast<int32_t*>(idx_out), n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
