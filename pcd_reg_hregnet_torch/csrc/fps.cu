// Farthest-point sampling (FPS) and weighted FPS for Hopper (sm_90a).
//
// Replaces: pcd_reg_hregnet_tpu/ops/pallas/fps.py::_fps_kernel (weighted=False
// is kernel K1, weighted=True is K2).
//
// Computes, per batch row: idx[0] = 0; a running min squared distance
// `temp` (init 1e10) is folded with the (weighted) squared distance to the
// last selected point; the next index is the argmax of `temp`, ties going
// to the smallest index.  Weighted FPS multiplies each candidate's distance
// by its own weight before the fold.  NaN follows torch.minimum (a NaN
// distance or running distance stays NaN) and torch.argmax (NaN is the
// largest value, the first NaN wins).
//
// What bounds it on this card: step latency, not bytes or FLOPs.  The M-1
// selection steps are strictly sequential; the cloud is read once (0.24 us
// at B=8 x 8096) and the arithmetic is ~10 FLOPs per point-step.  A step is
// (distance update over the row) + (argmax over the row) + (synchronisation
// that hands the winner to every thread).  What the design does about each:
//
// - Update: a row is split over C CTAs of a thread-block cluster (C in
//   {1, 2, 4, 8}, neighbouring SMs), so one SM updates N/C points a step.
//   Each thread keeps its PPT points, weights and running distances in
//   registers.  Rank r holds the contiguous index chunk [r*chunk,
//   (r+1)*chunk), and inside a CTA point j lives in thread j % T, slot
//   j / T, so rank order and slot order are index order.
// - Argmax: a thread keeps its best with a strict `>` over its slots in
//   increasing index (the smallest index wins ties for free; a NaN, rare,
//   is found afterwards), then maps it once to a 32-bit key whose
//   unsigned order is the float order (one XOR with a sign-derived mask;
//   NaN -> the largest key; -0 -> +0).  A warp reduces with two
//   redux.sync: max of the key, then min of the index over the lanes that
//   hold it.  No shuffle tree.
// - Synchronisation: one wait per step.  Each warp's winner record (key,
//   index, x, y, z; the coordinates come from a copy of the CTA's points
//   in shared memory) goes into a record array double-buffered by step
//   parity.  With C = 1 the warp stores it in its own CTA and all warps
//   meet at one __syncthreads().  With C > 1 it sends it to every rank
//   with st.async, which counts its bytes down on that rank's mbarrier
//   for the buffer, and every thread waits on its own CTA's mbarrier: no
//   cluster-wide barrier in the loop (a cluster.sync() per step measured
//   slower on the H100; PERF.md).  After the wait every warp reduces all records itself (up to
//   kFewRecords by plain compares in every thread, more lane by lane and
//   then across the warp), so the winner's index and coordinates reach
//   every thread with no second barrier and no global load.  A single
//   warp per row (T = 32, C = 1) needs no barrier at all.
//
// The squared distance is written with __fsub_rn/__fmul_rn/__fadd_rn in
// the plain version's order so that no FMA contraction changes its
// rounding: indices must equal the plain version's exactly, and an FMA
// flips near-ties.  Padded slots (beyond the row) hold a running distance
// of -inf and a thread without a real point offers key 0, below every
// real key, so padding never wins.
//
// Rows above the largest configuration (65536 points) take the
// global-memory variant (GLOBAL): kGlobal threads per CTA and kGlobalCluster
// CTAs per row, whose points and running distances stay in device memory
// (a 1M-point row is 16 MB, resident in the 50 MB L2) and are re-read every
// step, any number of them per thread; its argmax, records and
// synchronisation are the kernel's own.
//
// The configurations (T threads per CTA, PPT points per thread, C CTAs
// per row) are the table kConfigs below; the wrapper (ops/kernels/fps.py)
// mirrors it and picks one per N from a sweep on the card.  The latency
// probe (pcdreg_fps_probe) runs the same kernel with the distance update
// replaced by a cheap function of the last winner: its time over M-1 is
// the floor of a step of this design in that configuration.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr float kInitDist = 1e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kFewRecords = 8;   // up to this many, each thread reduces them alone

struct Config {
  int threads, ppt, cluster;
};

// Keep in step with CONFIGS in ops/kernels/fps.py (ids are positions).
constexpr Config kConfigs[] = {
    {1024, 8, 1},  // 0: one 1024-thread CTA per row, 8192 points
    {1024, 1, 1},  // 1: one 1024-thread CTA per row, 1024 points
    {512, 16, 1},  // 2: one CTA, 8192 points
    {512, 8, 2},   // 3: clusters of 2, 4 and 8 over 8192 points
    {256, 8, 4},   // 4
    {128, 8, 8},   // 5
    {128, 4, 4},   // 6: 2048 points
    {128, 8, 4},   // 7: 4096 points
    {256, 8, 8},   // 8: 16384 points
    {256, 16, 8},  // 9: 32768 points
    {512, 16, 8},  // 10: 65536 points
    {32, 32, 1},   // 11: one warp, 1024 points
    {32, 16, 1},   // 12: one warp, 512 points
    {64, 8, 1},    // 13
    {128, 8, 1},   // 14
    {128, 4, 1},   // 15
    {256, 4, 1},   // 16
    {256, 8, 1},   // 17: 2048 points
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);
// The global-memory variant: configuration id kNumConfigs, any N.
constexpr int kGlobal = 1024;
constexpr int kGlobalCluster = 8;

// Minimum and maximum that propagate NaN, as torch.minimum / jnp.minimum
// and torch.argmax's "NaN is the largest" do.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Unsigned key in float order: flips the sign bit of a non-negative value
// and every bit of a negative one.  -0 compares equal to +0 and NaN above
// everything, as in torch.argmax.  Real values map to keys >= 0x007fffff
// (-inf), so key 0 marks "no candidate".
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));  // -0 -> +0
  const unsigned k = u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
  return isnan(v) ? kFull : k;
}

// --- distributed shared memory signalling (C > 1) -----------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address `addr` of this CTA's shared memory, in cluster rank `rank`.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Store into another CTA's shared memory; the bytes count down the
// transaction count of that CTA's mbarrier `bar` when they land.
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, int v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` more bytes in this phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that never
// ends is a fault: trap (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

template <int T, int PPT, int C, bool WEIGHTED, bool PROBE, bool GLOBAL>
__global__ void __launch_bounds__(T)
fps_kernel(const float* __restrict__ xyz, const float* __restrict__ weights,
           float* __restrict__ dist, int32_t* __restrict__ out, int n, int m,
           int chunk) {
  constexpr int W = T / 32;   // warps per CTA
  constexpr int R = W * C;    // records per step
  constexpr bool kRecords = R > 1;
  constexpr int RB = kRecords ? R : 1;
  // record q of a step: (x, y, z, key) and the index; two buffers by parity
  __shared__ float4 s_rec[2][RB];
  __shared__ int s_idx[2][RB];
  __shared__ uint64_t s_bar[2];       // C > 1: one mbarrier per buffer
  extern __shared__ float s_pts[];    // x[chunk], y[chunk], z[chunk]
  float* s_x = s_pts;
  float* s_y = s_pts + chunk;
  float* s_z = s_pts + 2 * chunk;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int row = blockIdx.x / C;
  const int base = rank * chunk;
  const int cn = max(0, min(chunk, n - base));   // real points of this CTA
  const float* p = xyz + (size_t)row * n * 3;
  int32_t* o = out + (size_t)row * m;

  float px[PPT], py[PPT], pz[PPT], pw[PPT], temp[PPT];
  // GLOBAL: this CTA's running distances, in device memory
  float* dr = GLOBAL ? dist + (size_t)row * n + base : nullptr;
  if constexpr (GLOBAL) {
    for (int j = tid; j < cn; j += T) dr[j] = kInitDist;
  }
#pragma unroll
  for (int i = 0; i < (GLOBAL ? 0 : PPT); ++i) {
    const int j = tid + i * T;
    const bool ok = j < cn;
    const float x = ok ? p[3 * (base + j) + 0] : 0.f;
    const float y = ok ? p[3 * (base + j) + 1] : 0.f;
    const float z = ok ? p[3 * (base + j) + 2] : 0.f;
    if (ok) { s_x[j] = x; s_y[j] = y; s_z[j] = z; }
    px[i] = x;
    py[i] = y;
    pz[i] = z;
    pw[i] = (WEIGHTED && ok) ? weights[(size_t)row * n + base + j] : 1.f;
    temp[i] = ok ? kInitDist : -INFINITY;
  }
  if (rank == 0 && tid == 0) o[0] = 0;
  float lx = p[0], ly = p[1], lz = p[2];
  int last = 0;
  // the point copy is visible, and with C > 1 the mbarriers are set up in
  // every rank before any rank signals one
  if constexpr (C > 1) {
    if (tid == 0) {
      mbar_init(smem_addr(&s_bar[0]), 1);
      mbar_init(smem_addr(&s_bar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cg::this_cluster().sync();
  } else if constexpr (W > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }

  for (int s = 1; s < m; ++s) {
    const int buf = (s - 1) & 1;
    if constexpr (C > 1) {   // this phase: one arrival and R records
      if (tid == 0) mbar_expect(smem_addr(&s_bar[buf]), R * (sizeof(float4) + sizeof(int)));
    }
    float bv = -INFINITY;
    int slot = 0;
    if constexpr (PROBE) {
      bv = (float)((tid * 37 + rank * 101 + last) & 1023);
    } else if constexpr (GLOBAL) {   // slot i is point tid + i * T of the CTA
      const float* pb = p + 3 * (size_t)base;
      const float* wb = WEIGHTED ? weights + (size_t)row * n + base : nullptr;
      int i = 0;
      for (int j = tid; j < cn; j += T, ++i) {
        const float dx = __fsub_rn(pb[3 * j + 0], lx);
        const float dy = __fsub_rn(pb[3 * j + 1], ly);
        const float dz = __fsub_rn(pb[3 * j + 2], lz);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        if (WEIGHTED) d = __fmul_rn(d, wb[j]);
        const float t = nan_min(dr[j], d);
        dr[j] = t;
        if (t > bv) slot = i;
        bv = nan_max(bv, t);
      }
      if (isnan(bv)) {   // rare: the first NaN slot wins
        i = 0;
        for (int j = tid; j < cn; j += T, ++i)
          if (isnan(dr[j])) {
            slot = i;
            break;
          }
      }
    } else {
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = __fsub_rn(px[i], lx);
        const float dy = __fsub_rn(py[i], ly);
        const float dz = __fsub_rn(pz[i], lz);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        if (WEIGHTED) d = __fmul_rn(d, pw[i]);
        const float t = nan_min(temp[i], d);
        temp[i] = t;
        // strictly greater: earlier slots keep ties
        if (t > bv) slot = i;
        bv = nan_max(bv, t);
      }
      if (isnan(bv)) {   // rare: the first NaN slot wins
        slot = PPT - 1;
#pragma unroll
        for (int i = PPT - 1; i >= 0; --i)
          if (isnan(temp[i])) slot = i;
      }
    }
    // warp argmax: max key, then the smallest index holding it
    const unsigned key = tid < cn ? order_key(bv) : 0u;
    const unsigned wk = __reduce_max_sync(kFull, key);
    const unsigned cand = key == wk ? (unsigned)(base + tid + slot * T) : (unsigned)INT_MAX;
    const int wi = (int)__reduce_min_sync(kFull, cand);
    const int wl = wi - base;
    const bool real = wk != 0u;   // the warp holds a real point
    float wx = real ? (GLOBAL ? p[3 * (size_t)(base + wl) + 0] : s_x[wl]) : 0.f;
    float wy = real ? (GLOBAL ? p[3 * (size_t)(base + wl) + 1] : s_y[wl]) : 0.f;
    float wz = real ? (GLOBAL ? p[3 * (size_t)(base + wl) + 2] : s_z[wl]) : 0.f;
    int wins = wi;

    if constexpr (kRecords) {
      const int q = rank * W + warp;
      const float4 rec = make_float4(wx, wy, wz, __uint_as_float(wk));
      if constexpr (C > 1) {   // lane r sends the record to rank r
        if (lane < C) {
          const uint32_t bar = at_rank(smem_addr(&s_bar[buf]), lane);
          st_async(at_rank(smem_addr(&s_rec[buf][q]), lane), rec, bar);
          st_async(at_rank(smem_addr(&s_idx[buf][q]), lane), wi, bar);
        }
        mbar_wait(smem_addr(&s_bar[buf]), ((s - 1) >> 1) & 1);
      } else {
        if (lane == 0) {
          s_rec[buf][q] = rec;
          s_idx[buf][q] = wi;
        }
        __syncthreads();
      }
      // every warp reduces all R records itself: a few records each
      // thread compares in turn, many records lane by lane and then
      // across the warp
      unsigned k2 = 0u;
      int i2 = INT_MAX;
      float x2 = 0.f, y2 = 0.f, z2 = 0.f;
      constexpr bool kFew = R <= kFewRecords;
#pragma unroll
      for (int r = kFew ? 0 : lane; r < R; r += kFew ? 1 : 32) {
        const float4 a = s_rec[buf][r];
        const int ir = s_idx[buf][r];
        const unsigned kr = __float_as_uint(a.w);
        if (kr > k2 || (kr == k2 && ir < i2)) {
          k2 = kr; i2 = ir; x2 = a.x; y2 = a.y; z2 = a.z;
        }
      }
      int gi = i2;
      if constexpr (kFew) {
        wx = x2;
        wy = y2;
        wz = z2;
      } else {
        const unsigned gk = __reduce_max_sync(kFull, k2);
        gi = (int)__reduce_min_sync(kFull, k2 == gk ? (unsigned)i2 : (unsigned)INT_MAX);
        const int src = __ffs(__ballot_sync(kFull, k2 == gk && i2 == gi)) - 1;
        wx = __shfl_sync(kFull, x2, src);
        wy = __shfl_sync(kFull, y2, src);
        wz = __shfl_sync(kFull, z2, src);
      }
      wins = gi;
    }
    lx = wx;
    ly = wy;
    lz = wz;
    last = wins;
    if (rank == 0 && tid == 0) o[s] = wins;
  }
  // no rank leaves while another may still address its shared memory
  if constexpr (C > 1) cg::this_cluster().sync();
}

// Raise a kernel's dynamic shared memory cap to `bytes` where it is above
// what this device already granted it (static plus dynamic shared memory
// may pass the 48 KB default only after an opt-in), so that launches of
// an N seen before make no host API call for it.
template <typename K>
cudaError_t opt_in_smem(K kernel, std::atomic<int>* granted, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted[dev].store(bytes, std::memory_order_release);
  return e;
}

template <int T, int PPT, int C, bool WEIGHTED, bool PROBE, bool GLOBAL = false>
cudaError_t launch(const float* xyz, const float* w, float* dist, int32_t* out,
                   int b, int n, int m, cudaStream_t stream) {
  static std::atomic<int> granted[kMaxDevices];
  const int chunk = (n + C - 1) / C;
  if (!GLOBAL && chunk > T * PPT) return cudaErrorInvalidValue;
  if (GLOBAL && dist == nullptr) return cudaErrorInvalidValue;
  const int smem = GLOBAL ? 0 : 3 * (int)sizeof(float) * chunk;
  auto kernel = fps_kernel<T, PPT, C, WEIGHTED, PROBE, GLOBAL>;
  cudaError_t e = opt_in_smem(kernel, granted, smem);
  if (e != cudaSuccess) return e;
  if constexpr (C == 1) {
    kernel<<<b, T, smem, stream>>>(xyz, w, dist, out, n, m, chunk);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(b * C);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, xyz, w, dist, out, n, m, chunk);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// Launch configuration `id` of kConfigs, resolved at compile time; id
// kNumConfigs is the global-memory variant (not probed).
template <bool WEIGHTED, bool PROBE, int I = 0>
cudaError_t dispatch(int id, const float* xyz, const float* w, float* dist,
                     int32_t* out, int b, int n, int m, cudaStream_t s) {
  if constexpr (I == kNumConfigs) {
    if (PROBE || id != kNumConfigs) return cudaErrorInvalidValue;
    return launch<kGlobal, 1, kGlobalCluster, WEIGHTED, false, true>(xyz, w, dist, out,
                                                                     b, n, m, s);
  } else {
    if (id == I) {
      constexpr Config c = kConfigs[I];
      return launch<c.threads, c.ppt, c.cluster, WEIGHTED, PROBE>(xyz, w, dist, out,
                                                                  b, n, m, s);
    }
    return dispatch<WEIGHTED, PROBE, I + 1>(id, xyz, w, dist, out, b, n, m, s);
  }
}

}  // namespace

// xyz [b, n, 3] f32, weights [b, n] f32 or null, out [b, m] int32; all
// contiguous on the current device.  1 <= m <= n, and n must fit
// configuration `config` (threads * ppt * cluster points), or config is
// kNumConfigs (the global-memory variant, any n), which keeps its running
// distances in `dist` [b, n] f32 (scratch; null for the other configs).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pcdreg_fps(const void* xyz, const void* weights, void* dist, void* out,
                          int b, int n, int m, int config, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || m > n) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)xyz;
  float* dd = (float*)dist;
  int32_t* o = (int32_t*)out;
  if (weights)
    return (int)dispatch<true, false>(config, x, (const float*)weights, dd, o, b, n, m, s);
  return (int)dispatch<false, false>(config, x, nullptr, dd, o, b, n, m, s);
}

// The latency probe of configuration `config`: the kernel above with the
// distance update replaced by a cheap function of the last winner, m-1
// steps on b rows of n points (xyz as for pcdreg_fps; out [b, m] int32
// receives the probe's winners).  Returns the cudaError_t of the launch.
extern "C" int pcdreg_fps_probe(const void* xyz, void* out, int b, int n, int m,
                                int config, void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || m > n) return (int)cudaErrorInvalidValue;
  return (int)dispatch<false, true>(config, (const float*)xyz, nullptr, nullptr,
                                    (int32_t*)out, b, n, m, (cudaStream_t)stream);
}

// Configuration `config` of the table as (threads, ppt, cluster); returns
// the number of configurations, or -1 for an id out of range.
extern "C" int pcdreg_fps_config(int config, int* threads, int* ppt, int* cluster) {
  if (config < 0 || config >= kNumConfigs) return -1;
  *threads = kConfigs[config].threads;
  *ppt = kConfigs[config].ppt;
  *cluster = kConfigs[config].cluster;
  return kNumConfigs;
}

extern "C" const char* pcdreg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
