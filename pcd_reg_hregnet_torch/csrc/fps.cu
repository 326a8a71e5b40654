// Farthest-point sampling (FPS) and weighted FPS for Hopper (sm_90a).
//
// Replaces: pcd_reg_hregnet_tpu/ops/pallas/fps.py::_fps_kernel (weighted=False
// is kernel K1, weighted=True is K2).
//
// Computes, per batch row: idx[0] = 0; a running min squared distance
// `temp` (init 1e10) is folded with the (weighted) squared distance to the
// last selected point; the next index is the argmax of `temp`, ties going
// to the smallest index.  Weighted FPS multiplies each candidate's distance
// by its own weight before the fold.
//
// What bounds it on this card: latency.  The M-1 selection steps are
// strictly sequential and each ends in a block-wide argmax, so the kernel
// is bound by M-1 rounds of (distance update + reduction + two barriers),
// not by bytes (the cloud is read once) or by FLOPs (~10 per point-step).
// At B=1 only one SM works.  argmax_steps_kernel below runs the reduction
// and barriers alone, so its time is this design's latency floor.
//
// Design: one block of 1024 threads per batch row.  Each thread keeps its
// PPT points (strided: point j lives in thread j % 1024), their weights and
// running distances in registers, so a step touches no memory except the
// per-warp argmax candidates and the selected point, which go through
// shared memory.  The squared distance is written with __fmul_rn/__fadd_rn
// so that no FMA contraction changes its rounding: indices must equal the
// plain version's exactly, and an FMA flips near-ties.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kInitDist = 1e10f;

// a beats b: larger value, or equal value and smaller index.  NaN counts
// as the largest value, as in torch.argmax / jnp.argmax.
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  if (isnan(av)) return !isnan(bv) || ai < bi;
  if (isnan(bv)) return false;
  return av > bv || (av == bv && ai < bi);
}

// Argmax of (bv, bi) across the warp; every lane ends with the winner.
__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
  }
}

template <int PPT, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const float* __restrict__ weights,
           int32_t* __restrict__ out, int n, int m) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_pt[3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + (size_t)blockIdx.x * n * 3;
  int32_t* o = out + (size_t)blockIdx.x * m;

  float px[PPT], py[PPT], pz[PPT], pw[PPT], temp[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = tid + i * kThreads;
    const bool ok = j < n;
    px[i] = ok ? p[3 * j + 0] : 0.f;
    py[i] = ok ? p[3 * j + 1] : 0.f;
    pz[i] = ok ? p[3 * j + 2] : 0.f;
    pw[i] = (WEIGHTED && ok) ? weights[(size_t)blockIdx.x * n + j] : 1.f;
    temp[i] = kInitDist;
  }
  if (tid == 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];

  for (int s = 1; s < m; ++s) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int j = tid + i * kThreads;
      if (j < n) {  // padded slots never take part, so they never win
        const float dx = __fsub_rn(px[i], lx);
        const float dy = __fsub_rn(py[i], ly);
        const float dz = __fsub_rn(pz[i], lz);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        if (WEIGHTED) d = __fmul_rn(d, pw[i]);
        // minimum that propagates NaN, as torch.minimum / jnp.minimum do
        const float t = temp[i];
        temp[i] = (d < t || isnan(d)) ? d : t;
        if (beats(temp[i], j, bv, bi)) { bv = temp[i]; bi = j; }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) { s_val[warp] = bv; s_idx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = s_val[lane];
      bi = s_idx[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        o[s] = bi;
        s_pt[0] = p[3 * bi + 0];
        s_pt[1] = p[3 * bi + 1];
        s_pt[2] = p[3 * bi + 2];
      }
    }
    __syncthreads();
    lx = s_pt[0];
    ly = s_pt[1];
    lz = s_pt[2];
  }
}

// Latency probe, not a path kernel: m-1 steps of exactly fps_kernel's
// block-wide argmax and broadcast (two shuffle trees, two barriers), with
// each thread's candidate a cheap function of the last winner in place of
// the distance update and the selected point's fetch.  Its time over m-1
// is the floor a step of this one-block-per-row design cannot go below.
__global__ void __launch_bounds__(kThreads)
argmax_steps_kernel(int32_t* __restrict__ out, int m) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_win;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int32_t* o = out + (size_t)blockIdx.x * m;
  if (tid == 0) o[0] = 0;
  int last = 0;

  for (int s = 1; s < m; ++s) {
    float bv = (float)((tid * 37 + last) & 1023);
    int bi = tid;
    warp_argmax(bv, bi);
    if (lane == 0) { s_val[warp] = bv; s_idx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = s_val[lane];
      bi = s_idx[lane];
      warp_argmax(bv, bi);
      if (lane == 0) { o[s] = bi; s_win = bi; }
    }
    __syncthreads();
    last = s_win;
  }
}

template <bool WEIGHTED>
cudaError_t launch(const float* xyz, const float* w, int32_t* out, int b,
                   int n, int m, cudaStream_t stream) {
  const int ppt = (n + kThreads - 1) / kThreads;
  if (ppt <= 1) fps_kernel<1, WEIGHTED><<<b, kThreads, 0, stream>>>(xyz, w, out, n, m);
  else if (ppt <= 2) fps_kernel<2, WEIGHTED><<<b, kThreads, 0, stream>>>(xyz, w, out, n, m);
  else if (ppt <= 4) fps_kernel<4, WEIGHTED><<<b, kThreads, 0, stream>>>(xyz, w, out, n, m);
  else if (ppt <= 8) fps_kernel<8, WEIGHTED><<<b, kThreads, 0, stream>>>(xyz, w, out, n, m);
  else if (ppt <= 16) fps_kernel<16, WEIGHTED><<<b, kThreads, 0, stream>>>(xyz, w, out, n, m);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// xyz [b, n, 3] f32, weights [b, n] f32 or null, out [b, m] int32; all
// contiguous on the current device.  n <= 16384, 1 <= m <= n.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pcdreg_fps(const void* xyz, const void* weights, void* out,
                          int b, int n, int m, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || m > n) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)xyz;
  int32_t* o = (int32_t*)out;
  if (weights) return (int)launch<true>(x, (const float*)weights, o, b, n, m, s);
  return (int)launch<false>(x, nullptr, o, b, n, m, s);
}

// Runs the latency probe: b blocks of m-1 argmax steps into out [b, m]
// int32 on the current device.  Returns the cudaError_t of the launch.
extern "C" int pcdreg_argmax_steps(void* out, int b, int m, void* stream) {
  if (b <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  argmax_steps_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>((int32_t*)out, m);
  return (int)cudaGetLastError();
}

extern "C" const char* pcdreg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
