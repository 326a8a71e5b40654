// Patch attention forward for Hopper (sm_90a).
//
// Replaces: pcd_reg_hregnet_tpu/ops/pallas/attention.py::_attn_kernel
// (kernel K3).
//
// Computes, for q, k, v of shape [R, H, K, d] (R independent patches, H
// heads, patch length K, head dim d): out = softmax(q*scale . k^T) . v per
// (patch, head), with the softmax in f32 and max subtraction, and the
// output in the input dtype (f32 or bf16).
//
// What bounds it on this card: operations.  Each (patch, head) reads
// 3*K*d values and does 4*K*K*d FLOPs, so at K=256 the kernel does ~170
// FLOPs per f32 byte.  The arithmetic is plain f32 FMA on the CUDA cores
// (no TF32: the f32 path must match to 1e-5), whose peak is 67 TFLOP/s.
//
// Design (simple first): one block per (patch, head, tile of 64 query
// rows).  The block stages the whole K and V of its (patch, head) in
// shared memory as f32 (2*K*d*4 bytes, 64 KB at the production K*d = 8192,
// above the 48 KB default, so the kernel opts in, once per device).
// G = d/DPT threads share one query row, each owning DPT <= 16 dims
// (interleaved, so the G threads hit distinct banks), which keeps q and the
// accumulator in registers at every d from 8 to 128.  Keys stream through
// in chunks of 16 with an online softmax: one rescale per chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRowsPerBlock = 64;
constexpr int kChunk = 16;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may opt in to
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

template <typename T, int D>
__global__ void attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o, int K,
                            float scale) {
  constexpr int DPT = D < 16 ? D : 16;  // dims per thread
  constexpr int G = D / DPT;            // threads per query row
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + (size_t)K * D;

  const size_t base = (size_t)blockIdx.x * K * D;  // (patch, head) slab
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) {
    ks[i] = to_f32(k[base + i]);
    vs[i] = to_f32(v[base + i]);
  }
  __syncthreads();

  const int row = blockIdx.y * kRowsPerBlock + threadIdx.x / G;
  const int part = threadIdx.x % G;
  const bool valid = row < K;
  const int r = valid ? row : K - 1;  // idle rows compute, never store

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = to_f32(q[base + (size_t)r * D + i * G + part]) * scale;
    acc[i] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int j0 = 0; j0 < K; j0 += kChunk) {
    float s[kChunk];
    float m_chunk = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c;
      float dot = 0.f;
      if (j < K) {
        const float* kr = ks + (size_t)j * D + part;
#pragma unroll
        for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], kr[i * G], dot);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[c] = j < K ? dot : -INFINITY;
      m_chunk = fmaxf(m_chunk, s[c]);
    }
    const float m_new = fmaxf(m_run, m_chunk);
    const float corr = expf(m_run - m_new);  // 0 on the first chunk
    l_run *= corr;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int j = j0 + c;
      if (j < K) {
        const float p = expf(s[c] - m_new);
        l_run += p;
        const float* vr = vs + (size_t)j * D + part;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vr[i * G], acc[i]);
      }
    }
    m_run = m_new;
  }

  if (valid) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      from_f32(acc[i] * inv, o + base + (size_t)row * D + i * G + part);
  }
}

// Lift attn_kernel<T, D>'s dynamic shared memory cap to the most a block
// may opt in to, once per device: later launches make no host API call
// for it.  Setting it twice from racing threads is harmless.
template <typename T, int D>
cudaError_t opt_in_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(attn_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return e;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int rh, int K, float scale, cudaStream_t stream) {
  constexpr int G = D / (D < 16 ? D : 16);
  const size_t smem = 2 * (size_t)K * D * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_smem<T, D>();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(rh, (K + kRowsPerBlock - 1) / kRowsPerBlock);
  attn_kernel<T, D><<<grid, kRowsPerBlock * G, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, K, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int rh, int K, int d, float scale, cudaStream_t s) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, o, rh, K, scale, s);
    case 16: return launch<T, 16>(q, k, v, o, rh, K, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, rh, K, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, rh, K, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, rh, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [r, h, K, d] contiguous on the current device, f32
// (dtype 0) or bf16 (dtype 1); d in {8, 16, 32, 64, 128}; 2*K*d*4 bytes
// must fit in 227 KB of shared memory.  Returns the cudaError_t (0 = ok).
extern "C" int pcdreg_patch_attention(const void* q, const void* k,
                                      const void* v, void* out, int r, int h,
                                      int K, int d, float scale, int dtype,
                                      void* stream) {
  if (r <= 0 || h <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(q, k, v, out, r * h, K, d, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(q, k, v, out, r * h, K, d, scale, s);
  return (int)cudaErrorInvalidValue;
}
