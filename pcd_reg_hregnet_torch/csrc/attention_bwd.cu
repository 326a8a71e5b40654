// Patch attention backward for Hopper (sm_90a): kernel K3b.
//
// Replaces: pcd_reg_hregnet_tpu/ops/pallas/attention.py::_bwd, the
// custom_vjp backward of patch_attention (dense XLA in the JAX package; the
// JAX model's dense path below K = 512 has the same gradient by autodiff).
//
// For q, k, v, the forward output o and its gradient g, all [R, H, K, d] f32
// (R patches, H heads, patch length K, head dim d), per (patch, head):
//   s = q.k^T * scale, p = softmax(s), dp = g.v^T, D = rowsum(g * o)
//   dv = p^T.g, ds = p * (dp - D), dq = ds.k * scale, dk = ds^T.q * scale
// (D = rowsum(dp * p), since o = p.v).  Softmax and every sum in f32; any
// K >= 1 and d >= 1; each tensor with its own strides (last dim contiguous),
// so dq, dk and dv can be views of one [R, K, 3, H, d] gradient buffer.
//
// What bounds it on this card: operations.  A (patch, head) reads 5 K*d
// values, writes 3 and does 14 K*K*d FLOPs (s twice, dp twice, dq, dk, dv);
// at the production K = 64..256 that is 3.5-112 FLOPs per byte, above the
// f32 ridge of the CUDA cores (67 TFLOP/s over 3.35 TB/s = 20) for K >= 128.
// This first version is simple, deterministic (no atomics) and runs its
// products as f32 FMA on the CUDA cores, out of shared memory:
// - pass 1, one block per (patch, head, 32 query rows): streams the keys in
//   tiles of 32, keeps an online softmax (running max and sum) per row and
//   accumulates dq, rescaled as the max rises, with D taken from o; writes
//   dq, the log-sum-exp and D;
// - pass 2, one block per (patch, head, 32 key rows): streams the queries in
//   tiles of 32, recomputes p = exp(s - lse) exactly and accumulates dk and
//   dv.
// A block's 256 threads each hold 4 entries of the 32x32 score tiles and
// 1-16 columns of its rows' gradients.  The head dim is padded to DC in {8,
// 16, 32, 64, 128} with zero-filled tiles; d > 128 runs in chunks of 128 for
// the scores and in blocks along d (grid.y) for the gradients, each block
// recomputing the scores.  Tensor cores, a ring of asynchronous copies and
// one launch for both passes are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kWide = 128;        // the widest head slice a block holds
constexpr int kRows = 32;         // rows a block owns
constexpr int kCols = 32;         // rows of the other side per streamed tile
constexpr int kThreads = 256;     // 8 threads per owned row
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt in to
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long r, h, k;   // elements; the last dim is contiguous
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* g;
  float* dq;
  float* dk;
  float* dv;
  float* lse;     // [R * H * K] scratch: log-sum-exp of each query row
  float* delta;   // [R * H * K] scratch: rowsum(g * o)
  Strides sq, sk, sv, so, sg, sdq, sdk, sdv;
  int heads, K, d, tiles;   // tiles: blocks of kRows rows per (patch, head)
  float scale;
};

int padded_width(int d) {
  int w = 8;
  while (w < kWide && d > w) w *= 2;
  return w;
}

// Bytes of dynamic shared memory of a block at padded width dc: four tiles
// of 32 rows, two 32x32 score tiles and per-row scalars.
int smem_bytes(int dc) {
  return (4 * kRows * (dc + 1) + 2 * kRows * (kCols + 1) + 4 * kCols) * 4;
}

__device__ __forceinline__ const float* at(const float* base, const Strides& s, int r, int h) {
  return base + (long long)r * s.r + (long long)h * s.h;
}

__device__ __forceinline__ float* at(float* base, const Strides& s, int r, int h) {
  return base + (long long)r * s.r + (long long)h * s.h;
}

// Rows [row0, row0 + N) and columns [c0, c0 + DC) of one (patch, head) into
// tile[row][col] (row stride DC + 1, odd, so the 8 rows a warp reads at one
// column fall in distinct banks); zero past K and past d.
template <int N, int DC>
__device__ __forceinline__ void load_tile(float* __restrict__ tile, const float* __restrict__ p,
                                          long long stride, int row0, int c0, int K, int d) {
  for (int i = threadIdx.x; i < N * DC; i += kThreads) {
    const int row = i / DC, c = i % DC;
    const int kr = row0 + row, gc = c0 + c;
    tile[row * (DC + 1) + c] = (kr < K && gc < d) ? p[kr * stride + gc] : 0.f;
  }
}

// acc[e] += A[a] . B[b0 + 8e] over DC columns, with a = tid / 8 and
// b0 = tid % 8: thread tid's 4 entries of the 32x32 product A.B^T.
template <int DC>
__device__ __forceinline__ void dot4(const float* __restrict__ A, const float* __restrict__ B,
                                     float (&acc)[4]) {
  const int a = threadIdx.x >> 3, b0 = threadIdx.x & 7;
#pragma unroll 8
  for (int c = 0; c < DC; ++c) {
    const float x = A[a * (DC + 1) + c];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(x, B[(b0 + 8 * e) * (DC + 1) + c], acc[e]);
  }
}

// Reductions over the 8 lanes that share a row (lanes 8i .. 8i + 7).
__device__ __forceinline__ float max8(float x) {
#pragma unroll
  for (int o = 4; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float sum8(float x) {
#pragma unroll
  for (int o = 4; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float sum32(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Pass 1: dq, lse and D for kRows query rows of one (patch, head); blockIdx.y
// is the block's DC-wide slice of dq (d > 128).
template <int DC>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr int L = DC + 1, W = kCols + 1, E = DC / 8;
  float* sQ = smem;                  // [kRows][L] query rows
  float* sG = sQ + kRows * L;        // [kRows][L] their output gradient
  float* sK = sG + kRows * L;        // [kCols][L] key tile
  float* sV = sK + kCols * L;        // [kCols][L] value tile
  float* sW = sV + kCols * L;        // [kRows][W] exp(s - m) * (dp - D)
  float* sD = sW + 2 * kRows * W;    // [kRows] D

  const int rh = blockIdx.x / a.tiles, i0 = (blockIdx.x % a.tiles) * kRows;
  const int r = rh / a.heads, h = rh % a.heads, slice = blockIdx.y;
  const int K = a.K, d = a.d, chunks = (d + DC - 1) / DC;
  const float* q = at(a.q, a.sq, r, h);
  const float* k = at(a.k, a.sk, r, h);
  const float* v = at(a.v, a.sv, r, h);
  const float* g = at(a.g, a.sg, r, h);
  const float* o = at(a.o, a.so, r, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = threadIdx.x >> 3, b0 = threadIdx.x & 7;

  for (int i = warp; i < kRows; i += kThreads / 32) {   // D = rowsum(g * o)
    float s = 0.f;
    if (i0 + i < K) {
      const long long gi = (long long)(i0 + i) * a.sg.k, oi = (long long)(i0 + i) * a.so.k;
      for (int c = lane; c < d; c += 32) s = fmaf(g[gi + c], o[oi + c], s);
    }
    s = sum32(s);
    if (lane == 0) sD[i] = s;
  }
  if (chunks == 1) {
    load_tile<kRows, DC>(sQ, q, a.sq.k, i0, 0, K, d);
    load_tile<kRows, DC>(sG, g, a.sg.k, i0, 0, K, d);
  }
  float m = -INFINITY, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int j0 = 0; j0 < K; j0 += kCols) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < chunks; ++ch) {
      __syncthreads();   // the tiles' last readers are done
      if (chunks > 1) {
        load_tile<kRows, DC>(sQ, q, a.sq.k, i0, ch * DC, K, d);
        load_tile<kRows, DC>(sG, g, a.sg.k, i0, ch * DC, K, d);
      }
      load_tile<kCols, DC>(sK, k, a.sk.k, j0, ch * DC, K, d);
      load_tile<kCols, DC>(sV, v, a.sv.k, j0, ch * DC, K, d);
      __syncthreads();
      dot4<DC>(sQ, sK, s);
      dot4<DC>(sG, sV, dp);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = j0 + b0 + 8 * e < K ? s[e] * a.scale : -INFINITY;
      tmax = fmaxf(tmax, s[e]);
    }
    const float mnew = fmaxf(m, max8(tmax));
    const float f = expf(m - mnew);   // 0 on the first tile
    const float D = sD[row];
    float psum = 0.f;
    __syncthreads();   // sK is read no more for the scores
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[e] - mnew);
      psum += p;
      sW[row * W + b0 + 8 * e] = p * (dp[e] - D);
    }
    l = l * f + sum8(psum);
    m = mnew;
    if (chunks > 1) load_tile<kCols, DC>(sK, k, a.sk.k, j0, slice * DC, K, d);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= f;
    for (int j = 0; j < kCols; ++j) {
      const float w = sW[row * W + j];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(w, sK[j * L + b0 + 8 * e], acc[e]);
    }
  }
  const int i = i0 + row;
  if (i >= K) return;
  float* dq = at(a.dq, a.sdq, r, h) + (long long)i * a.sdq.k;
  const float norm = a.scale / l;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = slice * DC + b0 + 8 * e;
    if (c < d) dq[c] = acc[e] * norm;
  }
  if (slice == 0 && b0 == 0) {
    a.lse[(long long)rh * K + i] = m + logf(l);
    a.delta[(long long)rh * K + i] = sD[row];
  }
}

// Pass 2: dk and dv for kRows key rows of one (patch, head); blockIdx.y is
// the block's DC-wide slice of dk and dv (d > 128).
template <int DC>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr int L = DC + 1, W = kCols + 1, E = DC / 8;
  float* sK = smem;                  // [kRows][L] key rows
  float* sV = sK + kRows * L;        // [kRows][L] value rows
  float* sQ = sV + kRows * L;        // [kCols][L] query tile
  float* sG = sQ + kCols * L;        // [kCols][L] its output gradient
  float* sP = sG + kCols * L;        // [kRows][W] p
  float* sS = sP + kRows * W;        // [kRows][W] ds
  float* sLse = sS + kRows * W;      // [kCols]
  float* sD = sLse + kCols;          // [kCols]

  const int rh = blockIdx.x / a.tiles, j0 = (blockIdx.x % a.tiles) * kRows;
  const int r = rh / a.heads, h = rh % a.heads, slice = blockIdx.y;
  const int K = a.K, d = a.d, chunks = (d + DC - 1) / DC;
  const float* q = at(a.q, a.sq, r, h);
  const float* k = at(a.k, a.sk, r, h);
  const float* v = at(a.v, a.sv, r, h);
  const float* g = at(a.g, a.sg, r, h);
  const float* lse = a.lse + (long long)rh * K;
  const float* delta = a.delta + (long long)rh * K;
  const int row = threadIdx.x >> 3, b0 = threadIdx.x & 7;

  if (chunks == 1) {
    load_tile<kRows, DC>(sK, k, a.sk.k, j0, 0, K, d);
    load_tile<kRows, DC>(sV, v, a.sv.k, j0, 0, K, d);
  }
  float dk[E], dv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dk[e] = dv[e] = 0.f;

  for (int i0 = 0; i0 < K; i0 += kCols) {
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < chunks; ++ch) {
      __syncthreads();   // the tiles' last readers are done
      if (chunks > 1) {
        load_tile<kRows, DC>(sK, k, a.sk.k, j0, ch * DC, K, d);
        load_tile<kRows, DC>(sV, v, a.sv.k, j0, ch * DC, K, d);
      }
      load_tile<kCols, DC>(sQ, q, a.sq.k, i0, ch * DC, K, d);
      load_tile<kCols, DC>(sG, g, a.sg.k, i0, ch * DC, K, d);
      if (ch == 0 && threadIdx.x < kCols) {
        const int i = i0 + threadIdx.x;
        sLse[threadIdx.x] = i < K ? lse[i] : 0.f;
        sD[threadIdx.x] = i < K ? delta[i] : 0.f;
      }
      __syncthreads();
      dot4<DC>(sK, sQ, s);
      dot4<DC>(sV, sG, dp);
    }
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = b0 + 8 * e;
      p[e] = i0 + c < K ? expf(s[e] * a.scale - sLse[c]) : 0.f;
      ds[e] = p[e] * (dp[e] - sD[c]);
    }
    __syncthreads();   // sQ and sG are read no more for the scores
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sP[row * W + b0 + 8 * e] = p[e];
      sS[row * W + b0 + 8 * e] = ds[e];
    }
    if (chunks > 1) {
      load_tile<kCols, DC>(sQ, q, a.sq.k, i0, slice * DC, K, d);
      load_tile<kCols, DC>(sG, g, a.sg.k, i0, slice * DC, K, d);
    }
    __syncthreads();
    for (int i = 0; i < kCols; ++i) {
      const float pi = sP[row * W + i], dsi = sS[row * W + i];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dv[e] = fmaf(pi, sG[i * L + b0 + 8 * e], dv[e]);
        dk[e] = fmaf(dsi, sQ[i * L + b0 + 8 * e], dk[e]);
      }
    }
  }
  const int j = j0 + row;
  if (j >= K) return;
  float* dkp = at(a.dk, a.sdk, r, h) + (long long)j * a.sdk.k;
  float* dvp = at(a.dv, a.sdv, r, h) + (long long)j * a.sdv.k;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = slice * DC + b0 + 8 * e;
    if (c < d) {
      dkp[c] = dk[e] * a.scale;
      dvp[c] = dv[e];
    }
  }
}

// Raise a kernel's dynamic shared memory cap to the most a block may opt in
// to, once per device and kernel.
template <typename Kern>
cudaError_t opt_in_smem(Kern kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return e;
}

template <int DC>
cudaError_t launch(const Args& a, int rh, cudaStream_t stream) {
  static std::atomic<bool> done_dq[kMaxDevices], done_dkv[kMaxDevices];
  const int smem = smem_bytes(DC);
  if (smem > 48 * 1024) {
    cudaError_t e = opt_in_smem(bwd_dq_kernel<DC>, done_dq);
    if (e == cudaSuccess) e = opt_in_smem(bwd_dkv_kernel<DC>, done_dkv);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(rh * a.tiles, (a.d + DC - 1) / DC);
  bwd_dq_kernel<DC><<<grid, kThreads, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkv_kernel<DC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o (the forward output), g (its gradient), dq, dk, dv: f32
// [r, h, K, d] on the current device, each with its last dim contiguous;
// lse and delta: f32 scratch of r * h * K values.  p holds, as 64-bit
// integers, the strides (elements) of dims r, h, K in the order q, k, v, o,
// g, dq, dk, dv (p[0..23]), then r, h, K, d (p[24..27]).  Any K >= 1 and
// d >= 1.  Launches pass 1 then pass 2 on `stream`; returns the cudaError_t
// of the launches (0 = ok).
extern "C" int pcdreg_patch_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* g, void* dq, void* dk,
                                          void* dv, void* lse, void* delta,
                                          const long long* p, float scale, void* stream) {
  const long long r = p[24], h = p[25], K = p[26], d = p[27];
  if (r <= 0 || h <= 0 || K <= 0 || d <= 0 || K > 0x7fffffffLL || d > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (K + kRows - 1) / kRows;
  if (r * h * tiles > 0x7fffffffLL || (d + kWide - 1) / kWide > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.o = (const float*)o;
  a.g = (const float*)g;
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.lse = (float*)lse;
  a.delta = (float*)delta;
  Strides* s[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sg, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
  a.heads = (int)h;
  a.K = (int)K;
  a.d = (int)d;
  a.tiles = (int)tiles;
  a.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rh = (int)(r * h);
  switch (d > kWide ? kWide : padded_width((int)d)) {
    case 8: return (int)launch<8>(a, rh, st);
    case 16: return (int)launch<16>(a, rh, st);
    case 32: return (int)launch<32>(a, rh, st);
    case 64: return (int)launch<64>(a, rh, st);
    default: return (int)launch<128>(a, rh, st);
  }
}
