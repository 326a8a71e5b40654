// Patch attention backward for Hopper (sm_90a): kernel K3b.
//
// Replaces: pcd_reg_hregnet_tpu/ops/pallas/attention.py::_bwd, the
// custom_vjp backward of patch_attention (dense XLA in the JAX package; the
// JAX model's dense path below K = 512 has the same gradient by autodiff).
//
// For q, k, v, the forward output o, its gradient g, all [R, H, K, d] f32
// or all bf16 (R patches, H heads, patch length K, head dim d), and the log-sum-exp of
// each query row that the forward (attention.cu, K3) wrote, per (patch,
// head):
//   s = q.k^T * scale, p = exp(s - lse), dp = g.v^T, D = rowsum(g * o)
//   dv = p^T.g, ds = p * (dp - D), dq = ds.k * scale, dk = ds^T.q * scale
// (D = rowsum(dp * p), since o = p.v).  Softmax and every sum in f32; any
// K >= 1 and d >= 1; each tensor with its own strides (last dim contiguous),
// so dq, dk and dv can be views of one [R, K, 3, H, d] gradient buffer,
// written in the inputs' dtype.  Deterministic: every sum is taken in a
// fixed order, with no atomics on values.
//
// bf16 (the JAX `_bwd` on bf16 inputs: f32 inside, the results cast back):
// attention_bwd_bf16.cu, a kernel designed for Hopper's wgmma and TMA, takes
// the shapes it can (d a multiple of 8 up to 128, K up to 512, where its
// shared memory fits: every shape of the train step;
// ops/kernels/attention.py::backward_route).  This file's bf16
// instantiations take the rest: the same kernel, templated on the element
// type, with every product one mma.sync.m16n8k16.bf16 accumulating in f32
// in place of the three tf32 ones.  P and dS are rounded to bf16 only as the operands of the products
// that take them (FlashAttention-2's rounding); the scores, p, dS, D =
// rowsum(g * o) from the bf16 g and o, and every sum stay f32.  Tiles and
// the staged dS^T hold bf16 (rows padded by 16 bytes), so a block needs
// less shared memory than in f32; the padded width starts at 16 (one mma
// depth), and a warp's query share of a tile is a multiple of 16 (query
// rows per tile: max(f32's, 16 * QS)), so that two of its 8-query C tiles
// form one A operand.  The fragment reads that do not follow a row (B
// operands over queries or keys) pack two 16-bit loads.
//
// What bounds it on this card: five K*K*d products (s, dp, dv, dk, dq) of
// 2 K*K*d FLOPs each against 8 K*d values moved.  On the tensor cores at
// 3xTF32 (495/3 TFLOP/s) that is operations at K = 256 and bytes at the
// production K = 128 and 64.  The design:
// - Products on mma.sync.m16n8k8.tf32, each operand split as hi + lo and
//   lo*hi, hi*lo, hi*hi accumulated in f32, as K3 runs them
//   (tf32_tiles.cuh).  In f32, mma.sync and not wgmma: a warp's tiles here are 16
//   rows by 8-64 columns at depths of 8-128, below wgmma's 64-row tile and
//   the depth at which its asynchronous issue pays for the shared-memory
//   operand layout it needs; the three split products triple the work
//   either way.  (In bf16 each product is one mma, and wgmma pays:
//   attention_bwd_bf16.cu.)
// - Five products, not seven: the forward's log-sum-exp gives p = exp2(s
//   * scale * log2 e - lse * log2 e) directly, with no online rescale and
//   no second pass over the keys.
// - One launch, FlashAttention-2 order: a block owns BN keys (64, 32 or
//   16) of one (patch, head) and keeps their dK and dV in registers while
//   the queries stream past in tiles of BM (64; 32 at d > 64, for
//   registers) through a ring of two cp.async stages, as K3's tiles do.
//   Each warp holds 16 keys; QS warps (1, 2 or 4) share each 16 keys and
//   each takes 1/QS of every query tile, so that a block has 4 or 8 warps
//   (latency, not throughput, bounds a warp here: one block of ~100-200
//   KB of shared memory fits an SM, and 8 warps hide twice the latency of
//   4); the QS partials of dK and dV meet once, at the end, in shared
//   memory, in a fixed order.  Smaller BN gives small batches more blocks.
// - Every product reads its operands the way the fragments lie, with no
//   transpose: the warp computes S^T = K.Q^T and dP^T = V.G^T (keys as
//   rows, K and V as the A operand from the block's tile), so that P^T and
//   dS^T are already the A operands of dV = P^T.G and dK = dS^T.Q (the
//   columns relabelled, tf32_tiles.cuh), whose B operands are the staged G
//   and Q tiles read at rows 2t, 2t + 1.  Only dQ = dS.K needs dS with
//   queries as rows: dS^T goes through shared memory once per tile (one
//   8-byte store per value, read back once, both tiles padded by 16 bytes
//   so the fragment reads fall in distinct banks), and the block's 4 warps
//   then share the tile's dQ rows.  At d = 8 and 16 this staging is as
//   large as the products; it costs one barrier per tile and no extra
//   pass.
// - dQ is the one sum that crosses blocks.  Where the key tiles of a
//   (patch, head) number at most 8 and their dQ fits in shared memory (every
//   production shape), they form one thread-block cluster: each keeps its
//   dQ partial of every query in shared memory, and at the end each rank
//   sums a share of the rows over all ranks' partials through distributed
//   shared memory, in rank order.  The ranks also split D = rowsum(g * o)
//   and the log-sum-exp loads between them at the start and share them the
//   same way.  Any other shape (K > 8 * BN, d > 128) writes its partials
//   to device memory (wrapper scratch); the last block of the (patch, head)
//   to arrive, counted by an integer ticket, sums them in key-tile order.
// - d > 128 runs 128-wide slices along grid.y: the scores read q, k, v and
//   g over all of d from device memory (L2), the staged tiles hold the
//   slice.
// The wrapper (ops/kernels/attention.py::plan_backward) picks QS per shape;
// pcdreg_attention_bwd_plan reports what the kernel uses.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tf32_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDevices = 64;
constexpr int kWide = 128;        // the widest head slice a block holds
constexpr int kMaxCluster = 8;    // key tiles of a (patch, head) in one cluster
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt in to
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long r, h, k;   // elements; the last dim is contiguous
};

struct Args {
  const void* q;      // f32 or bf16, as o, g, dq, dk, dv
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  const float* lse;   // [R * H * K] each query row's log-sum-exp (K3's)
  void* dq;
  void* dk;
  void* dv;
  float* part;        // null (cluster path) or [ntk][R * H][K][d] dQ partials
  int* ticket;        // [R * H * slices] arrivals, zero before the launch
  Strides sq, sk, sv, so, sg, sdq, sdk, sdv;
  int heads, K, d, rh;   // rh = R * H
  int ntk, ntq;          // key tiles (blocks) and query tiles per (patch, head)
  float scale, scale_log2;
  int vec;               // q, k, v, g rows may be copied 16 bytes at a time
  int ovec;              // dq, dk, dv rows may be written 16 bytes at a time
  int dvec;              // g and o rows may be read 16 bytes at a time, d % 4 == 0
};

// The block shapes the kernel is built with: BN keys a block holds, and QS
// warps that share each 16 of them (BN / 16 * QS warps).  Query rows per
// streamed tile, and tiles in the ring: two, one computed while the next
// lands (a tile's products outlast a load), which keeps a block's shared
// memory low enough for two of them to share an SM at the production
// shapes where 4 warps a block are best.  Keep in step with
// ops/kernels/attention.py (BWD_TILES, plan_backward).
struct Tiling {
  int bn, qs;
};
constexpr Tiling kTilings[] = {{64, 1}, {64, 2}, {32, 2}, {32, 4}, {16, 4}};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);
constexpr int kStages = 2;
__host__ __device__ constexpr int max_of(int x, int y) { return x > y ? x : y; }
// query rows per streamed tile: 64, 32 at d > 64 (registers); in bf16 at
// least 16 per warp that shares a tile
__host__ __device__ constexpr int query_rows(int dp, int qs, int esize) {
  return max_of(dp == kWide ? 32 : 64, esize == 2 ? 16 * qs : 0);
}
// elements of a shared-memory row of width w: padded by 16 bytes
__host__ __device__ constexpr int padded_row(int w, int esize) { return w + 16 / esize; }
// bytes of the ring, which the f32 QS partials of dK and dV reuse at the end
__host__ __device__ constexpr int ring_bytes(int dp, int bn, int qs, int esize) {
  return max_of(kStages * 2 * query_rows(dp, qs, esize) * padded_row(dp, esize) * esize,
                2 * qs * bn * (dp + 4) * 4);
}

int padded_width(int d, int esize) {
  int w = esize == 2 ? 16 : 8;
  while (w < kWide && d > w) w *= 2;
  return w;
}

// Dynamic shared memory of a block: its K and V rows, the ring of Q and G
// tiles, dS^T (in the element type), the log-sum-exp and D of the query
// rows (all rows on the cluster path, one tile's otherwise) and, on the
// cluster path, the f32 dQ partial of every query row.
long long smem_bytes(int dp, int bn, int qs, int K, bool cluster, int esize) {
  const long long bm = query_rows(dp, qs, esize), ld = padded_row(dp, esize);
  const long long kp = (K + bm - 1) / bm * bm;
  const long long rows = cluster ? kp : bm;
  return 2 * bn * ld * esize + ring_bytes(dp, bn, qs, esize) +
         bn * padded_row((int)bm, esize) * esize + 4 * 2 * rows +
         (cluster ? 4 * kp * (dp + 4) : 0);
}

bool cluster_path(int dp, int bn, int qs, int K, int d, int esize) {
  return d <= kWide && (K + bn - 1) / bn <= kMaxCluster &&
         smem_bytes(dp, bn, qs, K, true, esize) <= kMaxSmem;
}

template <typename T, int DP, int BN, int QS, bool WIDE>
__global__ void __launch_bounds__(BN / 16 * QS * 32) attn_bwd_kernel(const Args a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int ES = (int)sizeof(T);
  constexpr int W = BN / 16 * QS;       // warps
  constexpr int NTHR = 32 * W;
  constexpr int BM = query_rows(DP, QS, ES);   // query rows per streamed tile
  constexpr int BMW = BM / QS;          // of them, each warp's
  constexpr int NJ = BMW / 8;           // 8-query column tiles of a warp's S^T
  constexpr int NT = DP / 8;            // 8-wide column tiles of dK and dV
  constexpr int LD = padded_row(DP, ES);   // rows of K, V, Q and G (elements)
  constexpr int LDP = DP + 4;           // rows of the f32 dQ partial and dK/dV partials
  constexpr int LDS = padded_row(BM, ES);  // rows of dS^T (elements)
  constexpr int RG = BM / 16;           // dQ: 16-row groups of a tile ...
  constexpr int CP = W / RG < NT ? W / RG : NT;   // ... each shared by CP warps ...
  constexpr int NTQ = NT / CP;          // ... taking NTQ column tiles each
  // independent accumulators, so that no mma waits on the one before it
  constexpr int SC = WIDE || NJ >= 4 ? 1 : 4 / NJ;   // of S^T and dP^T
  constexpr int DA = NT >= 4 ? 1 : 4 / NT;            // of dK and dV
  constexpr int QA = NTQ >= 4 ? 1 : 4 / NTQ;          // of dQ
  constexpr int NC = NT < 4 ? NT : 4;   // column tiles whose G and Q one step splits
  static_assert(NJ >= 1 && BMW * QS == BM && CP >= 1 && NTQ * CP == NT && RG * CP <= W,
                "tiling");
  static_assert(F32 || (NJ % 2 == 0 && DP % 16 == 0), "bf16: 16-query and 16-dim steps");
  static_assert(!WIDE || DP == kWide, "d > 128 runs in 128-wide slices");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool cl = a.part == nullptr;   // dQ partials meet in the cluster
  const int ntq = a.ntq, Kp = ntq * BM;
  T* ks = reinterpret_cast<T*>(smem_raw);   // [BN][LD] the block's keys
  T* vs = ks + BN * LD;                      // [BN][LD] their values (not when WIDE)
  T* stg = vs + BN * LD;                     // [kStages][Q, G][BM][LD]
  T* ss = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(stg) +
                               ring_bytes(DP, BN, QS, ES));   // [BN][LDS] dS^T of the tile
  float* lse2 = reinterpret_cast<float*>(ss + BN * LDS);   // [Kp or BM] lse * log2 e
  float* dd = lse2 + (cl ? Kp : BM);         // [Kp or BM] D
  float* dqp = dd + (cl ? Kp : BM);          // [Kp][LDP] dQ partial (cluster path)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rh = blockIdx.x / a.ntk, kt = blockIdx.x % a.ntk;   // kt: rank in the cluster
  const int r = rh / a.heads, h = rh % a.heads;
  const int K = a.K, d = a.d;
  const int j0 = kt * BN;                    // the block's first key
  const int c0 = WIDE ? blockIdx.y * kWide : 0;
  const int dw = WIDE ? min(DP, d - c0) : d;   // columns of the staged tiles and outputs
  const int kr = warp / QS * 16;             // the warp's keys in the block
  const int q0w = warp % QS * BMW;           // its queries in each tile
  const T* qp = static_cast<const T*>(a.q) + r * a.sq.r + h * a.sq.h;
  const T* kp = static_cast<const T*>(a.k) + r * a.sk.r + h * a.sk.h;
  const T* vp = static_cast<const T*>(a.v) + r * a.sv.r + h * a.sv.h;
  const T* gp = static_cast<const T*>(a.g) + r * a.sg.r + h * a.sg.h;
  const T* op = static_cast<const T*>(a.o) + r * a.so.r + h * a.so.h;
  const bool vec = a.vec != 0;

  // the block's keys (the slice at c0 when WIDE) and values, then the first
  // query tiles, each one commit group
  stage_tile<T, BN, DP, LD>(ks, kp + (long long)j0 * a.sk.k + c0, a.sk.k, K - j0, dw, vec);
  if constexpr (!WIDE)
    stage_tile<T, BN, DP, LD>(vs, vp + (long long)j0 * a.sv.k, a.sv.k, K - j0, d, vec);
  cp_async_commit();
  auto stage = [&](int it) {
    if (it < ntq) {
      T* dst = stg + (it % kStages) * 2 * BM * LD;
      const long long i0 = (long long)it * BM;
      stage_tile<T, BM, DP, LD>(dst, qp + i0 * a.sq.k + c0, a.sq.k, K - (int)i0, dw, vec);
      stage_tile<T, BM, DP, LD>(dst + BM * LD, gp + i0 * a.sg.k + c0, a.sg.k,
                                K - (int)i0, dw, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  // lse (log2 units; +inf past K, so p = 0 there) and D of query rows
  // [lo, hi), at row - base.  With 16-byte rows, DP / 4 lanes share a row
  // (one float4 of g and of o each) and every load of up to 8 passes is in
  // flight at once; else one thread a row.
  const float* lse_in = a.lse + (long long)rh * K;
  auto rows_lse_d = [&](int lo, int hi, int base) {
    if constexpr (!WIDE && F32) if (a.dvec) {
      constexpr int CPR = DP / 4, RPP = NTHR / CPR, U = 8;
      const int sub = threadIdx.x % CPR, c = sub * 4;
      for (int b0 = lo; b0 < hi; b0 += U * RPP) {   // uniform trip count: the lanes shuffle
        const int p0 = b0 + (int)threadIdx.x / CPR;
        float4 gx[U], ox[U];
        float lx[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = p0 + u * RPP;
          const bool in = i < hi && i < K && c < d;
          gx[u] = ox[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in) {
            gx[u] = *reinterpret_cast<const float4*>(gp + (long long)i * a.sg.k + c);
            ox[u] = *reinterpret_cast<const float4*>(op + (long long)i * a.so.k + c);
          }
          lx[u] = i < hi && i < K && sub == 0 ? lse_in[i] * kLog2e : INFINITY;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float s = gx[u].x * ox[u].x + gx[u].y * ox[u].y + gx[u].z * ox[u].z + gx[u].w * ox[u].w;
#pragma unroll
          for (int o = CPR / 2; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o, CPR);
          const int i = p0 + u * RPP;
          if (sub == 0 && i < hi) {
            lse2[i - base] = lx[u];
            dd[i - base] = s;
          }
        }
      }
      return;
    }
    for (int i = lo + (int)threadIdx.x; i < hi; i += NTHR) {
      float s = 0.f, l = INFINITY;
      if (i < K) {
        const T* gr = gp + (long long)i * a.sg.k;
        const T* orow = op + (long long)i * a.so.k;
#pragma unroll 4
        for (int c = 0; c < d; ++c) s = fmaf(to_f32(gr[c]), to_f32(orow[c]), s);
        l = lse_in[i] * kLog2e;
      }
      lse2[i - base] = l;
      dd[i - base] = s;
    }
  };
  cg::cluster_group cluster = cg::this_cluster();
  if (cl) {   // each rank takes a share of the rows, then copies the others'
    const int per = (Kp + a.ntk - 1) / a.ntk;
    rows_lse_d(kt * per, min(Kp, (kt + 1) * per), 0);
    cluster.sync();
    for (int i = threadIdx.x; i < Kp; i += NTHR) {
      const int owner = i / per;
      if (owner != kt) {
        lse2[i] = cluster.map_shared_rank(lse2, owner)[i];
        dd[i] = cluster.map_shared_rank(dd, owner)[i];
      }
    }
  }

  auto ldg = [&](const T* base, long long ld, int row, int col) -> float {
    return row < K && col < d ? to_f32(base[row * ld + col]) : 0.f;
  };
  // bf16: elements (row, col) and (row, col + 1) as one operand register,
  // from device memory (WIDE) or from a staged tile (row stride LD)
  auto ldg2 = [&](const T* base, long long ld, int row, int col) -> uint32_t {
    return pack(ldg(base, ld, row, col), ldg(base, ld, row, col + 1));
  };
  auto lds2 = [](const T* tile, int row, int col) -> uint32_t {
    return *reinterpret_cast<const uint32_t*>(tile + row * LD + col);
  };
  const bool key0 = j0 + kr + g < K, key1 = j0 + kr + g + 8 < K;   // the lane's key rows
  float dka[DA][NT][4], dva[DA][NT][4];
#pragma unroll
  for (int c = 0; c < DA; ++c)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dka[c][n][i] = dva[c][n][i] = 0.f;

  for (int it = 0; it < ntq; ++it) {
    // the slot of tile it - 1, free since the mid-tile barrier of it - 1
    stage(it + kStages - 1);
    cp_async_wait<kStages - 1>();   // tile it (and the keys) have landed
    const int i0 = it * BM;
    if (!cl) rows_lse_d(i0, i0 + BM, i0);
    __syncthreads();
    const T* qt = stg + (it % kStages) * 2 * BM * LD;
    const T* gt = qt + BM * LD;
    const float* lt = lse2 + (cl ? i0 : 0);
    const float* dt = dd + (cl ? i0 : 0);

    // ---- S^T = K.Q^T and dP^T = V.G^T: the warp's 16 keys x BMW queries --
    float sa[SC][NJ][4], pa[SC][NJ][4];
#pragma unroll
    for (int c = 0; c < SC; ++c)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[c][j][i] = pa[c][j][i] = 0.f;
    if constexpr (!F32) {   // one bf16 mma per 16 dims
      const int nk = WIDE ? (d + 15) / 16 : DP / 16;
#pragma unroll
      for (int kk = 0; kk < nk; ++kk) {
        const int c = kk * 16 + 2 * t, ra = kr + g;
        uint32_t kf[4], vf[4];
        if constexpr (WIDE) {
          kf[0] = ldg2(kp, a.sk.k, j0 + ra, c);
          kf[1] = ldg2(kp, a.sk.k, j0 + ra + 8, c);
          kf[2] = ldg2(kp, a.sk.k, j0 + ra, c + 8);
          kf[3] = ldg2(kp, a.sk.k, j0 + ra + 8, c + 8);
          vf[0] = ldg2(vp, a.sv.k, j0 + ra, c);
          vf[1] = ldg2(vp, a.sv.k, j0 + ra + 8, c);
          vf[2] = ldg2(vp, a.sv.k, j0 + ra, c + 8);
          vf[3] = ldg2(vp, a.sv.k, j0 + ra + 8, c + 8);
        } else {
          kf[0] = lds2(ks, ra, c);
          kf[1] = lds2(ks, ra + 8, c);
          kf[2] = lds2(ks, ra, c + 8);
          kf[3] = lds2(ks, ra + 8, c + 8);
          vf[0] = lds2(vs, ra, c);
          vf[1] = lds2(vs, ra + 8, c);
          vf[2] = lds2(vs, ra, c + 8);
          vf[3] = lds2(vs, ra + 8, c + 8);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {   // B = Q^T, G^T: [dims][query j*8 + g]
          const int row = q0w + j * 8 + g;
          uint32_t q0, q1, g0, g1;
          if constexpr (WIDE) {
            q0 = ldg2(qp, a.sq.k, i0 + row, c);
            q1 = ldg2(qp, a.sq.k, i0 + row, c + 8);
            g0 = ldg2(gp, a.sg.k, i0 + row, c);
            g1 = ldg2(gp, a.sg.k, i0 + row, c + 8);
          } else {
            q0 = lds2(qt, row, c);
            q1 = lds2(qt, row, c + 8);
            g0 = lds2(gt, row, c);
            g1 = lds2(gt, row, c + 8);
          }
          mma_bf16(sa[kk % SC][j], kf, q0, q1);
          mma_bf16(pa[kk % SC][j], vf, g0, g1);
        }
      }
    } else {
    const int nk = WIDE ? (d + 7) / 8 : DP / 8;
#pragma unroll
    for (int kk = 0; kk < nk; ++kk) {
      float kf[4], vf[4];
      if constexpr (WIDE) {
        const int ra = j0 + kr + g, c = kk * 8 + t;
        kf[0] = ldg(kp, a.sk.k, ra, c);
        kf[1] = ldg(kp, a.sk.k, ra + 8, c);
        kf[2] = ldg(kp, a.sk.k, ra, c + 4);
        kf[3] = ldg(kp, a.sk.k, ra + 8, c + 4);
        vf[0] = ldg(vp, a.sv.k, ra, c);
        vf[1] = ldg(vp, a.sv.k, ra + 8, c);
        vf[2] = ldg(vp, a.sv.k, ra, c + 4);
        vf[3] = ldg(vp, a.sv.k, ra + 8, c + 4);
      } else {
        const float* kx = ks + (kr + g) * LD + kk * 8 + t;
        const float* vx = vs + (kr + g) * LD + kk * 8 + t;
        kf[0] = kx[0];
        kf[1] = kx[8 * LD];
        kf[2] = kx[4];
        kf[3] = kx[8 * LD + 4];
        vf[0] = vx[0];
        vf[1] = vx[8 * LD];
        vf[2] = vx[4];
        vf[3] = vx[8 * LD + 4];
      }
      uint32_t kh[4], kl[4], vh[4], vl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(kf[i], kh[i], kl[i]);
        split(vf[i], vh[i], vl[i]);
      }
      uint32_t qh[NJ][2], ql[NJ][2], gh[NJ][2], gl[NJ][2];   // Q, G[query j*8 + g][dims kk*8 + t, +4]
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float b[4];
        if constexpr (WIDE) {
          const int row = i0 + q0w + j * 8 + g, c = kk * 8 + t;
          b[0] = ldg(qp, a.sq.k, row, c);
          b[1] = ldg(qp, a.sq.k, row, c + 4);
          b[2] = ldg(gp, a.sg.k, row, c);
          b[3] = ldg(gp, a.sg.k, row, c + 4);
        } else {
          const float* qx = qt + (q0w + j * 8 + g) * LD + kk * 8 + t;
          const float* gx = gt + (q0w + j * 8 + g) * LD + kk * 8 + t;
          b[0] = qx[0];
          b[1] = qx[4];
          b[2] = gx[0];
          b[3] = gx[4];
        }
        split(b[0], qh[j][0], ql[j][0]);
        split(b[1], qh[j][1], ql[j][1]);
        split(b[2], gh[j][0], gl[j][0]);
        split(b[3], gh[j][1], gl[j][1]);
      }
      // 3xTF32: lo.hi and hi.lo first, then hi.hi
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const int c = (3 * kk + term) % SC;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma_tf32(sa[c][j], term == 0 ? kl : kh, term == 1 ? ql[j][0] : qh[j][0],
                   term == 1 ? ql[j][1] : qh[j][1]);
          mma_tf32(pa[c][j], term == 0 ? vl : vh, term == 1 ? gl[j][0] : gh[j][0],
                   term == 1 ? gl[j][1] : gh[j][1]);
        }
      }
    }
    }

    // ---- P^T and dS^T: lane holds keys kr + g, + 8 of queries 2t, 2t + 1 --
    float p[NJ][4], ds[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float s[4], dp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = sa[0][j][i];
        dp[i] = pa[0][j][i];
#pragma unroll
        for (int c = 1; c < SC; ++c) {
          s[i] += sa[c][j][i];
          dp[i] += pa[c][j][i];
        }
      }
      const int qa = q0w + j * 8 + 2 * t;
      const float l0 = lt[qa], l1 = lt[qa + 1], D0 = dt[qa], D1 = dt[qa + 1];
      p[j][0] = key0 ? ex2(fmaf(s[0], a.scale_log2, -l0)) : 0.f;
      p[j][1] = key0 ? ex2(fmaf(s[1], a.scale_log2, -l1)) : 0.f;
      p[j][2] = key1 ? ex2(fmaf(s[2], a.scale_log2, -l0)) : 0.f;
      p[j][3] = key1 ? ex2(fmaf(s[3], a.scale_log2, -l1)) : 0.f;
      ds[j][0] = p[j][0] * (dp[0] - D0);
      ds[j][1] = p[j][1] * (dp[1] - D1);
      ds[j][2] = p[j][2] * (dp[2] - D0);
      ds[j][3] = p[j][3] * (dp[3] - D1);
      if (K == 1) {   // a softmax over one key is 1: ds = 0 exactly, as in f32
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[j][i] = p[j][i] > 0.f ? 1.f : 0.f;
          ds[j][i] = 0.f;
        }
      }
    }

    // ---- dV += P^T.G and dK += dS^T.Q over the warp's queries -------------
    if constexpr (!F32) {   // 16 queries a step: the C tiles j = 2m, 2m + 1 as A
#pragma unroll
      for (int m = 0; m < NJ / 2; ++m) {
        const uint32_t pf[4] = {pack(p[2 * m][0], p[2 * m][1]), pack(p[2 * m][2], p[2 * m][3]),
                                pack(p[2 * m + 1][0], p[2 * m + 1][1]),
                                pack(p[2 * m + 1][2], p[2 * m + 1][3])};
        const uint32_t sf[4] = {pack(ds[2 * m][0], ds[2 * m][1]),
                                pack(ds[2 * m][2], ds[2 * m][3]),
                                pack(ds[2 * m + 1][0], ds[2 * m + 1][1]),
                                pack(ds[2 * m + 1][2], ds[2 * m + 1][3])};
        // B = G, Q [queries 2t, 2t + 1 (+ 8)][dim n*8 + g]
        const T* gr = gt + (q0w + m * 16 + 2 * t) * LD + g;
        const T* qr = qt + (q0w + m * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const T* gc = gr + n * 8;
          const T* qc = qr + n * 8;
          mma_bf16(dva[m % DA][n], pf, pack(gc[0], gc[LD]), pack(gc[8 * LD], gc[9 * LD]));
          mma_bf16(dka[m % DA][n], sf, pack(qc[0], qc[LD]), pack(qc[8 * LD], qc[9 * LD]));
        }
      }
    } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      // A column t is query 2t, column t + 4 is query 2t + 1 (relabelled)
      const float pf[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
      const float sf[4] = {ds[j][0], ds[j][2], ds[j][1], ds[j][3]};
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(pf[i], ph[i], pl[i]);
        split(sf[i], sh[i], sl[i]);
      }
      const float* gr = gt + (q0w + j * 8 + 2 * t) * LD + g;
      const float* qr = qt + (q0w + j * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NC) {
        uint32_t gbh[NC][2], gbl[NC][2], qbh[NC][2], qbl[NC][2];   // [queries 2t, 2t+1][dim n*8 + g]
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          split(gr[(n0 + n) * 8], gbh[n][0], gbl[n][0]);
          split(gr[(n0 + n) * 8 + LD], gbh[n][1], gbl[n][1]);
          split(qr[(n0 + n) * 8], qbh[n][0], qbl[n][0]);
          split(qr[(n0 + n) * 8 + LD], qbh[n][1], qbl[n][1]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const int c = (3 * j + term) % DA;
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            mma_tf32(dva[c][n0 + n], term == 0 ? pl : ph, term == 1 ? gbl[n][0] : gbh[n][0],
                     term == 1 ? gbl[n][1] : gbh[n][1]);
            mma_tf32(dka[c][n0 + n], term == 0 ? sl : sh, term == 1 ? qbl[n][0] : qbh[n][0],
                     term == 1 ? qbl[n][1] : qbh[n][1]);
          }
        }
      }
    }
    }

    // ---- dS^T into shared memory, then dQ = dS.K over the block's keys ----
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      T* sp = ss + (kr + g) * LDS + q0w + j * 8 + 2 * t;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(sp) = make_float2(ds[j][0], ds[j][1]);
        *reinterpret_cast<float2*>(sp + 8 * LDS) = make_float2(ds[j][2], ds[j][3]);
      } else {   // rounded to bf16 as the operand of dQ = dS.K
        *reinterpret_cast<uint32_t*>(sp) = pack(ds[j][0], ds[j][1]);
        *reinterpret_cast<uint32_t*>(sp + 8 * LDS) = pack(ds[j][2], ds[j][3]);
      }
    }
    __syncthreads();   // dS^T is whole; the ring slot of tile it is read no more
    if (warp < RG * CP) {
      const int rg = warp / CP, cpart = warp % CP;
      constexpr int NCQ = NTQ < 8 ? NTQ : 8;
      float qa[QA][NTQ][4];
#pragma unroll
      for (int c = 0; c < QA; ++c)
#pragma unroll
        for (int n = 0; n < NTQ; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[c][n][i] = 0.f;
      if constexpr (!F32) {   // 16 keys a step
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          // A = dS[query rg*16 + g (+ 8)][keys kk*16 + 2t, 2t + 1 (+ 8)] from dS^T
          const T* sr = ss + (kk * 16 + 2 * t) * LDS + rg * 16 + g;
          const uint32_t af[4] = {pack(sr[0], sr[LDS]), pack(sr[8], sr[LDS + 8]),
                                  pack(sr[8 * LDS], sr[9 * LDS]),
                                  pack(sr[8 * LDS + 8], sr[9 * LDS + 8])};
          // B = K[keys kk*16 + 2t, 2t + 1 (+ 8)][dim n*8 + g]
          const T* kb = ks + (kk * 16 + 2 * t) * LD + cpart * NTQ * 8 + g;
#pragma unroll
          for (int n = 0; n < NTQ; ++n) {
            const T* kc = kb + n * 8;
            mma_bf16(qa[kk % QA][n], af, pack(kc[0], kc[LD]), pack(kc[8 * LD], kc[9 * LD]));
          }
        }
      } else {
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        // A = dS[query rg*16 + g, + 8][keys kk*8 + 2t, 2t + 1] (relabelled)
        const float* sr = ss + (kk * 8 + 2 * t) * LDS + rg * 16 + g;
        const float af[4] = {sr[0], sr[8], sr[LDS], sr[LDS + 8]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(af[i], ah[i], al[i]);
        const float* kb = ks + (kk * 8 + 2 * t) * LD + cpart * NTQ * 8 + g;
#pragma unroll
        for (int n0 = 0; n0 < NTQ; n0 += NCQ) {
          uint32_t bh[NCQ][2], bl[NCQ][2];   // K[keys 2t, 2t+1][dim n*8 + g]
#pragma unroll
          for (int n = 0; n < NCQ; ++n) {
            split(kb[(n0 + n) * 8], bh[n][0], bl[n][0]);
            split(kb[(n0 + n) * 8 + LD], bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            const int c = (3 * kk + term) % QA;
#pragma unroll
            for (int n = 0; n < NCQ; ++n)
              mma_tf32(qa[c][n0 + n], term == 0 ? al : ah, term == 1 ? bl[n][0] : bh[n][0],
                       term == 1 ? bl[n][1] : bh[n][1]);
          }
        }
      }
      }
      const int ra = i0 + rg * 16 + g, rb = ra + 8;
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = qa[0][n][i];
#pragma unroll
          for (int c = 1; c < QA; ++c) x[i] += qa[c][n][i];
        }
        const int col = (cpart * NTQ + n) * 8 + 2 * t;
        if (cl) {
          *reinterpret_cast<float2*>(dqp + ra * LDP + col) = make_float2(x[0], x[1]);
          *reinterpret_cast<float2*>(dqp + rb * LDP + col) = make_float2(x[2], x[3]);
        } else {
          float* pr = a.part + ((long long)kt * a.rh + rh) * K * d + c0 + col;
          if (ra < K && col < dw) pr[(long long)ra * d] = x[0];
          if (ra < K && col + 1 < dw) pr[(long long)ra * d + 1] = x[1];
          if (rb < K && col < dw) pr[(long long)rb * d] = x[2];
          if (rb < K && col + 1 < dw) pr[(long long)rb * d + 1] = x[3];
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- dK and dV: the QS partials of each key meet in shared memory (the
  // ring's space, read no more since the last mid-tile barrier) and are
  // summed in a fixed order, whole rows at a time ---------------------------
  float* epk = reinterpret_cast<float*>(stg);   // [QS][BN][LDP]
  float* epv = epk + QS * BN * LDP;              // [QS][BN][LDP]
  {
    float* ek = epk + (warp % QS * BN + kr + g) * LDP + 2 * t;
    float* ev = epv + (warp % QS * BN + kr + g) * LDP + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float xk[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xk[i] = dka[0][n][i];
        xv[i] = dva[0][n][i];
#pragma unroll
        for (int c = 1; c < DA; ++c) {
          xk[i] += dka[c][n][i];
          xv[i] += dva[c][n][i];
        }
      }
      *reinterpret_cast<float2*>(ek + n * 8) = make_float2(xk[0], xk[1]);
      *reinterpret_cast<float2*>(ek + n * 8 + 8 * LDP) = make_float2(xk[2], xk[3]);
      *reinterpret_cast<float2*>(ev + n * 8) = make_float2(xv[0], xv[1]);
      *reinterpret_cast<float2*>(ev + n * 8 + 8 * LDP) = make_float2(xv[2], xv[3]);
    }
  }
  __syncthreads();
  {
    T* dkp = static_cast<T*>(a.dk) + r * a.sdk.r + h * a.sdk.h + (long long)j0 * a.sdk.k + c0;
    T* dvp = static_cast<T*>(a.dv) + r * a.sdv.r + h * a.sdv.h + (long long)j0 * a.sdv.k + c0;
    const int rows = min(BN, K - j0);
    if (F32 && a.ovec && dw % 4 == 0) {   // 16-byte stores
      const int q4 = dw / 4;
      for (int i = threadIdx.x; i < rows * q4; i += NTHR) {
        const int row = i / q4, c = (i % q4) * 4;
        float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
#pragma unroll
        for (int w = 0; w < QS; ++w) {
          const float4 xk = *reinterpret_cast<const float4*>(epk + (w * BN + row) * LDP + c);
          const float4 xv = *reinterpret_cast<const float4*>(epv + (w * BN + row) * LDP + c);
          sk.x += xk.x; sk.y += xk.y; sk.z += xk.z; sk.w += xk.w;
          sv.x += xv.x; sv.y += xv.y; sv.z += xv.z; sv.w += xv.w;
        }
        *reinterpret_cast<float4*>(dkp + row * a.sdk.k + c) =
            make_float4(sk.x * a.scale, sk.y * a.scale, sk.z * a.scale, sk.w * a.scale);
        *reinterpret_cast<float4*>(dvp + row * a.sdv.k + c) = sv;
      }
    } else {
      for (int i = threadIdx.x; i < rows * dw; i += NTHR) {
        const int row = i / dw, c = i % dw;
        float sk = 0.f, sv = 0.f;
#pragma unroll
        for (int w = 0; w < QS; ++w) {
          sk += epk[(w * BN + row) * LDP + c];
          sv += epv[(w * BN + row) * LDP + c];
        }
        dkp[row * a.sdk.k + c] = sk * a.scale;
        dvp[row * a.sdv.k + c] = sv;
      }
    }
  }

  // ---- dQ: the key tiles' partials summed in rank (key-tile) order --------
  T* dqg = static_cast<T*>(a.dq) + r * a.sdq.r + h * a.sdq.h + c0;
  if (cl) {
    cluster.sync();   // every rank's partial is whole
    const int per = (K + a.ntk - 1) / a.ntk, lo = kt * per, hi = min(K, lo + per);
    constexpr int Q4 = DP / 4;
    const bool v4 = F32 && a.ovec && d % 4 == 0;
    for (int i = threadIdx.x; i < (hi - lo) * Q4; i += NTHR) {
      const int row = lo + i / Q4, c = (i % Q4) * 4;
      if (c >= d) continue;
      float4 x[kMaxCluster];   // every rank's load in flight at once
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk)
        if (rk < a.ntk)
          x[rk] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(dqp, rk) +
                                                   row * LDP + c);
      float4 s = x[0];
#pragma unroll
      for (int rk = 1; rk < kMaxCluster; ++rk)
        if (rk < a.ntk) {
          s.x += x[rk].x; s.y += x[rk].y; s.z += x[rk].z; s.w += x[rk].w;
        }
      const float y[4] = {s.x * a.scale, s.y * a.scale, s.z * a.scale, s.w * a.scale};
      T* dst = dqg + (long long)row * a.sdq.k + c;
      if (v4) {
        *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) dst[e] = y[e];
      }
    }
    cluster.sync();   // no rank leaves while another reads its shared memory
  } else {
    // the last block of this (patch, head, slice) to arrive sums the partials
    int* last = reinterpret_cast<int*>(ss);   // dS^T is read no more
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      *last = atomicAdd(a.ticket + rh * gridDim.y + blockIdx.y, 1) == a.ntk - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    const float* pr = a.part + (long long)rh * K * d + c0;
    const long long tile = (long long)a.rh * K * d;   // between key tiles' partials
    for (long long i = threadIdx.x; i < (long long)K * dw; i += NTHR) {
      const int row = (int)(i / dw), c = (int)(i % dw);
      float s = 0.f;
      for (int x = 0; x < a.ntk; ++x) s += __ldcg(pr + x * tile + (long long)row * d + c);
      dqg[row * a.sdq.k + c] = s * a.scale;
    }
  }
}

// Raise a kernel's dynamic shared memory cap to `bytes` where it is above
// what this device already granted it, so that launches of a shape seen
// before make no host API call for it.
template <typename Kern>
cudaError_t opt_in_smem(Kern kernel, std::atomic<int>* granted, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || granted[dev].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) granted[dev].store(bytes, std::memory_order_release);
  return e;
}

template <typename T, int DP, int BN, int QS, bool WIDE>
cudaError_t launch(const Args& a, int slices, bool cl, int smem, cudaStream_t stream) {
  static std::atomic<int> granted[kMaxDevices];
  auto kernel = attn_bwd_kernel<T, DP, BN, QS, WIDE>;
  cudaError_t e = opt_in_smem(kernel, granted, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.rh * a.ntk, slices);
  cfg.blockDim = dim3(BN / 16 * QS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl ? a.ntk : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Tiling `id` of kTilings, resolved at compile time.
template <typename T, int DP, bool WIDE, int I = 0>
cudaError_t by_tiling(const Args& a, int id, int slices, bool cl, int smem, cudaStream_t s) {
  if constexpr (I == kNumTilings) {
    return cudaErrorInvalidValue;
  } else {
    if (id == I)
      return launch<T, DP, kTilings[I].bn, kTilings[I].qs, WIDE>(a, slices, cl, smem, s);
    return by_tiling<T, DP, WIDE, I + 1>(a, id, slices, cl, smem, s);
  }
}

// The kernel of element type T for padded width dp (128 and WIDE past it).
template <typename T>
cudaError_t by_width(const Args& a, int dp, int id, int slices, bool cl, int smem,
                     cudaStream_t st) {
  if (a.d > kWide) return by_tiling<T, kWide, true>(a, id, slices, false, smem, st);
  switch (dp) {
    case 8:
      if constexpr (std::is_same<T, float>::value)
        return by_tiling<T, 8, false>(a, id, slices, cl, smem, st);
      return cudaErrorInvalidValue;   // bf16 pads to 16
    case 16: return by_tiling<T, 16, false>(a, id, slices, cl, smem, st);
    case 32: return by_tiling<T, 32, false>(a, id, slices, cl, smem, st);
    case 64: return by_tiling<T, 64, false>(a, id, slices, cl, smem, st);
    default: return by_tiling<T, 128, false>(a, id, slices, cl, smem, st);
  }
}

int tiling_id(long long bn, long long qs) {
  for (int i = 0; i < kNumTilings; ++i)
    if (kTilings[i].bn == bn && kTilings[i].qs == qs) return i;
  return -1;
}

bool aligned16(const void* p, const Strides& s, int esize) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 && (s.r * esize) % 16 == 0 &&
         (s.h * esize) % 16 == 0 && (s.k * esize) % 16 == 0;
}

}  // namespace

// q, k, v, o (the forward output), g (its gradient), dq, dk, dv: all f32
// (dtype 0) or all bf16 (dtype 1), [r, h, K, d] on the current device,
// each with its last dim contiguous; lse: f32 [r, h, K] contiguous, each
// query row's log-sum-exp of the scaled scores (K3 writes it).  p holds,
// as 64-bit integers, the strides (elements) of dims r, h, K in the order
// q, k, v, o, g, dq, dk, dv (p[0..23]), then r, h, K, d, the block's
// tiling, one of kTilings: bn keys and qs warps per 16 of them
// (p[24..29]), and the dtype (p[30]).  part and ticket: null where
// pcdreg_attention_bwd_plan reports a cluster, else f32 scratch of
// ceil(K / bn) * r * h * K * d values and int32 [r * h * ceil(d / 128)]
// zeros.  Any K >= 1 and d >= 1.  One launch on `stream`; returns its
// cudaError_t (0 = ok).
extern "C" int pcdreg_patch_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* g, const void* lse,
                                          void* dq, void* dk, void* dv, void* part,
                                          void* ticket, const long long* p, float scale,
                                          void* stream) {
  const long long r = p[24], h = p[25], K = p[26], d = p[27], bn = p[28], qs = p[29];
  const long long dtype = p[30];
  if (r <= 0 || h <= 0 || K <= 0 || d <= 0 || K > 0x7fffffffLL || d > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int id = tiling_id(bn, qs);
  if (id < 0) return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const long long ntk = (K + bn - 1) / bn, slices = d > kWide ? (d + kWide - 1) / kWide : 1;
  const int dp = d > kWide ? kWide : padded_width((int)d, es);
  if (r * h * ntk > 0x7fffffffLL || slices > 65535) return (int)cudaErrorInvalidValue;
  const bool cl = cluster_path(dp, (int)bn, (int)qs, (int)K, (int)d, es);
  if (!cl && (part == nullptr || ticket == nullptr)) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(dp, (int)bn, (int)qs, (int)K, cl, es);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.g = g;
  a.lse = (const float*)lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.part = cl ? nullptr : (float*)part;
  a.ticket = (int*)ticket;
  Strides* s[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sg, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
  a.heads = (int)h;
  a.K = (int)K;
  a.d = (int)d;
  a.rh = (int)(r * h);
  a.ntk = (int)ntk;
  const int bm = query_rows(dp, (int)qs, es);
  a.ntq = (int)((K + bm - 1) / bm);
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.vec = aligned16(q, a.sq, es) && aligned16(k, a.sk, es) && aligned16(v, a.sv, es) &&
          aligned16(g, a.sg, es);
  a.ovec = aligned16(dq, a.sdq, es) && aligned16(dk, a.sdk, es) && aligned16(dv, a.sdv, es);
  a.dvec = aligned16(g, a.sg, es) && aligned16(o, a.so, es) && d % 4 == 0;
  const int sl = (int)slices, sm = (int)smem;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return (int)by_width<__nv_bfloat16>(a, dp, id, sl, cl, sm, st);
  return (int)by_width<float>(a, dp, id, sl, cl, sm, st);
}

// The tiling of K3b in dtype (0 f32, 1 bf16) for patch length K, head dim
// d, bn keys a block and qs warps per 16 keys: padded width dp, query rows
// per tile bm, ring stages, and the cluster size (the key tiles of a
// (patch, head); 0 where the dQ partials go through device memory
// instead).  Returns the dynamic shared memory bytes, or -1 for a tiling
// or dtype the kernel is not built with.
// ops/kernels/attention.py::plan_backward mirrors it.
extern "C" int pcdreg_attention_bwd_plan(int K, int d, int bn, int qs, int dtype, int* dp,
                                         int* bm, int* stages, int* cluster) {
  if (K <= 0 || d <= 0 || tiling_id(bn, qs) < 0 || (dtype != 0 && dtype != 1)) return -1;
  const int es = dtype == 0 ? 4 : 2;
  *dp = d > kWide ? kWide : padded_width(d, es);
  *bm = query_rows(*dp, qs, es);
  *stages = kStages;
  const bool cl = cluster_path(*dp, bn, qs, K, d, es);
  *cluster = cl ? (K + bn - 1) / bn : 0;
  const long long smem = smem_bytes(*dp, bn, qs, K, cl, es);
  return smem > 0x7fffffff ? -1 : (int)smem;
}

// Tiling `id` of the table as (bn, qs); returns the number of tilings, or
// -1 for an id out of range.
extern "C" int pcdreg_attention_bwd_tiling(int id, int* bn, int* qs) {
  if (id < 0 || id >= kNumTilings) return -1;
  *bn = kTilings[id].bn;
  *qs = kTilings[id].qs;
  return kNumTilings;
}
