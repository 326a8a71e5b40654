// Patch attention forward for Hopper (sm_90a).
//
// Replaces: pcd_reg_hregnet_tpu/ops/pallas/attention.py::_attn_kernel
// (kernel K3).
//
// Computes, for q, k, v of shape [R, H, K, d] (R independent patches, H
// heads, patch length K, head dim d): out = softmax(q*scale . k^T) . v per
// (patch, head), with the softmax in f32 and max subtraction, and the
// output in the input dtype (f32 or bf16).  Any K >= 1 and d >= 1; each
// tensor comes with its own strides (the last dim contiguous), so the
// caller can hand in views of a fused qkv projection and an output buffer
// in its own layout.
// Given an lse buffer (the train step's forward), the kernel also writes
// each query row's log-sum-exp of the scaled scores, m + log(l) from the
// softmax's running max and sum, so that the backward (attention_bwd.cu,
// K3b) forms the probabilities with no second pass over the keys.
//
// What bounds it on this card: operations at the production K = 256 and
// 128 (each (patch, head) reads 3*K*d values and does 4*K*K*d FLOPs), bytes
// at K = 64.  So the products go to the tensor cores:
//
// - f32 (the model's path, held to 1e-5 of the full-f32 reference): error
//   compensated 3xTF32 on mma.sync.m16n8k8.tf32.  Each operand is split as
//   x = hi + lo (hi rounded to tf32 by integer ops, lo the exact rest) and
//   lo*hi, hi*lo, hi*hi are accumulated in f32; the dropped lo*lo is below
//   f32 round-off.  Q is split once, into registers (d <= 64) or shared
//   memory (d = 128, which frees the registers of O's accumulators); K
//   and V are split as their fragments leave shared memory, P as it
//   leaves the softmax.  The bound of this path is FLOPs / (495/3 TFLOP/s)
//   against the bytes.
// - bf16: one mma.sync.m16n8k16 (bf16 in, f32 accumulate) per product.
//
// At these sizes (a (patch, head) is at most 256 x 128) the time goes to
// latency, not to throughput, and the design is about that:
// - Tiles: a block holds BM query rows of one (patch, head), 16 rows a
//   warp.  K and V stream through shared memory in tiles of 64 keys, a
//   ring of 2-4 tiles in flight with cp.async (zero-filled past K and past
//   d), issued before Q is read, so that a whole production patch arrives
//   in one round trip.
// - Split: with few (patch, head) pairs (a batch of one pair), SPLIT = 4
//   warps share 16 rows, each taking a quarter of every key tile with its
//   own running max, sum and O; they meet once, at the end, in shared
//   memory.  The wrapper's `plan` picks BM and the split per shape.
// - Independent accumulators: S and O are held in as many copies as keep
//   8 products in flight (one mma never waits on the one before it); the
//   copies are summed at the end.
// - Softmax online, in registers: a running max and sum per row, two quad
//   shuffles per tile (not per score), ex2.approx on scores pre-scaled by
//   log2(e).  The S accumulator becomes P.V's A operand in registers: for
//   bf16 as in FlashAttention-2; for tf32, whose m16n8k8 C fragment holds
//   keys 2t and 2t+1 where A wants t and t+4, the keys of each 8-key step
//   are relabelled (V's B fragment rows are read as 2t and 2t+1), which
//   leaves the sum over keys unchanged and needs no shuffle.
// - Any shape: d is padded inside the kernel to the next width DP in {8,
//   16, 32, 64, 128} (bf16 from 16), with zero-filled tiles and unstored
//   columns; d > 128 is split over blocks, each recomputing S from q and k
//   in device memory (L2) and accumulating one 128-wide slice of V and O;
//   keys past K get -inf before the max.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tf32_tiles.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr int kWide = 128;         // the widest head slice a block holds
constexpr int kSplit = 4;          // warps that share 16 rows (f32, d <= 128)
constexpr int kMaxSmem = 232448;   // 227 KB a block may opt in to
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long r, h, k;   // elements; the last dim is contiguous
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;               // [R * H * K] or null: each query row's log-sum-exp
  Strides sq, sk, sv, so;
  int heads, K, d, tiles;   // tiles: query tiles of BM rows per (patch, head)
  float scale_log2;         // scale * log2(e)
  int vec;                  // k and v rows may be copied 16 bytes at a time
  int ovec;                 // out rows may be written 16 bytes at a time
};

// Keys per K/V tile; tiles in the ring of shared-memory buffers (all in
// flight at once: a whole patch of the forward, 256 keys at DP <= 32, 128
// at DP = 64, 64 at DP = 128); and the shared-memory row stride for head
// width DP, whose 16-byte pad puts the 8 rows that a fragment load touches
// in distinct banks.  Keep in step with ops/kernels/attention.py::plan.
constexpr int kTileKeys = 64;
constexpr int tile_stages(int dp) { return dp <= 32 ? 4 : dp == 64 ? 3 : 2; }

template <typename T, int DP>
struct Tile {
  static constexpr int BN = kTileKeys;
  static constexpr int STAGES = tile_stages(DP);
  static constexpr int LD = DP + 16 / (int)sizeof(T);
};

template <typename T, int DP, bool WIDE, int SPLIT>
__global__ void __launch_bounds__(256)
attn_kernel(const Args a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int BN = Tile<T, DP>::BN;
  constexpr int LD = Tile<T, DP>::LD;
  constexpr int STAGES = Tile<T, DP>::STAGES;
  constexpr int KS = F32 ? 8 : 16;       // depth of one mma
  constexpr int NT = DP / 8;             // 8-wide column tiles of O
  constexpr int NJ = BN / 8 / SPLIT;     // 8-key tiles of S a warp takes per tile
  static_assert(NJ >= (F32 ? 1 : 2) && NJ * 8 * SPLIT == BN, "SPLIT must divide the tile");
  constexpr int NQ = WIDE ? 1 : DP / KS;     // k-steps of Q held in registers
  constexpr bool QSPLIT = F32 && DP <= 64;   // Q held as hi and lo
  // f32 at DP = 128: Q's hi and lo wait in shared memory after the tiles,
  // [row group][k-step][hi, lo][lane] (one 16-byte load a fragment), which
  // frees the registers that O's 64 accumulators need
  constexpr bool QSMEM = F32 && !WIDE && DP == kWide;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);      // [STAGES][BN][LD], none when WIDE
  T* vs = ks + (WIDE ? 0 : STAGES * BN * LD);  // [STAGES][BN][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rh = blockIdx.x / a.tiles;
  const int r = rh / a.heads, h = rh % a.heads;
  // SPLIT warps share 16 rows, each taking 1/SPLIT of every key tile
  const int part = warp % SPLIT;
  const int bm = blockDim.x / (2 * SPLIT);
  const int tile_row0 = (blockIdx.x % a.tiles) * bm;
  const int row0 = tile_row0 + warp / SPLIT * 16;
  const int jw = part * NJ;                    // this warp's first 8-key group
  const int K = a.K, d = a.d;
  const int c0 = blockIdx.y * kWide;           // this block's slice of V and O
  const int dv = min(DP, d - c0);
  const T* qp = static_cast<const T*>(a.q) + r * a.sq.r + h * a.sq.h;
  const T* kp = static_cast<const T*>(a.k) + r * a.sk.r + h * a.sk.h;
  const T* vp = static_cast<const T*>(a.v) + r * a.sv.r + h * a.sv.h + c0;
  T* op = static_cast<T*>(a.o) + r * a.so.r + h * a.so.h + c0;

  // q (f32: times scale * log2 e) and k, zero outside [K, d)
  auto ldq = [&](int row, int col) -> float {
    const float x = row < K && col < d ? to_f32(qp[row * a.sq.k + col]) : 0.f;
    return F32 ? x * a.scale_log2 : x;
  };
  auto ldk = [&](int row, int col) -> float {
    return row < K && col < d ? to_f32(kp[row * a.sk.k + col]) : 0.f;
  };
  // the A fragment of Q for k-step kk: f32 raw values, or bf16 pairs
  auto q_frag = [&](int kk, uint32_t (&f)[4]) {
    const int ra = row0 + g, rb = ra + 8;
    if constexpr (F32) {
      const int c = kk * 8 + t;
      f[0] = __float_as_uint(ldq(ra, c));
      f[1] = __float_as_uint(ldq(rb, c));
      f[2] = __float_as_uint(ldq(ra, c + 4));
      f[3] = __float_as_uint(ldq(rb, c + 4));
    } else {
      const int c = kk * 16 + 2 * t;
      f[0] = pack(ldq(ra, c), ldq(ra, c + 1));
      f[1] = pack(ldq(rb, c), ldq(rb, c + 1));
      f[2] = pack(ldq(ra, c + 8), ldq(ra, c + 9));
      f[3] = pack(ldq(rb, c + 8), ldq(rb, c + 9));
    }
  };
  auto split4 = [](const uint32_t (&f)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(f[i]), hi[i], lo[i]);
  };

  // tile `it` of K and V into ring slot it % STAGES, as one commit group
  // (empty past the last tile, so that every iteration commits one)
  const bool vec = a.vec != 0;
  const int ntiles = (K + BN - 1) / BN;
  auto stage = [&](int it) {
    if (it < ntiles) {
      const int j0 = it * BN, slot = it % STAGES;
      if constexpr (!WIDE)
        stage_tile<T, BN, DP, LD>(ks + slot * BN * LD, kp + j0 * a.sk.k, a.sk.k, K - j0, d, vec);
      stage_tile<T, BN, DP, LD>(vs + slot * BN * LD, vp + j0 * a.sv.k, a.sv.k, K - j0, dv, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) stage(i);   // in flight while Q loads

  uint4* qsm = reinterpret_cast<uint4*>(smem_raw + 2 * STAGES * BN * LD * sizeof(T)) +
               (warp / SPLIT) * NQ * 2 * 32 + lane;
  uint32_t qa[QSMEM ? 1 : NQ][4];   // f32: hi (QSPLIT) or raw; bf16: pairs
  uint32_t ql[QSPLIT ? NQ : 1][4];  // f32 lo (QSPLIT)
  if constexpr (QSMEM) {
    if (part == 0) {   // one warp of the SPLIT that share the rows
      uint32_t raw[NQ][4];   // every load in flight at once
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) q_frag(kk, raw[kk]);
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t hi[4], lo[4];
        split4(raw[kk], hi, lo);
        qsm[kk * 64] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        qsm[kk * 64 + 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }   // read after the loop's first barrier
  } else if constexpr (!WIDE) {
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      q_frag(kk, qa[kk]);
      if constexpr (QSPLIT) {
        uint32_t raw[4] = {qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]};
        split4(raw, qa[kk], ql[kk]);
      }
    }
  }

  // Independent accumulators, so that no mma waits on the one before it:
  // SA copies of S and OA of O, each taking every SA-th (OA-th) product in
  // turn, keep at least 8 products in flight; they are summed at the end.
  constexpr int SA = WIDE ? 1 : (8 + NJ - 1) / NJ;
  constexpr int OA = NT >= 8 ? 1 : 8 / NT;
  constexpr int NC = NT < 8 ? NT : 8;   // O column tiles whose V a step splits at once
  float oa[OA][NT][4];
#pragma unroll
  for (int c = 0; c < OA; ++c)
#pragma unroll
    for (int n = 0; n < NT; ++n) oa[c][n][0] = oa[c][n][1] = oa[c][n][2] = oa[c][n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // rows g, g + 8

  for (int it = 0; it < ntiles; ++it) {
    // the slot of tile it - 1, free since the barrier that ended it
    stage(it + STAGES - 1);
    cp_async_wait<STAGES - 1>();   // tile it has landed
    __syncthreads();
    const int slot = it % STAGES;
    const T* kb = ks + slot * BN * LD;
    const T* vb = vs + slot * BN * LD;
    const int j0 = it * BN;

    // ---- S = Q K^T (times scale * log2 e) --------------------------------
    float sa[SA][NJ][4];
#pragma unroll
    for (int c = 0; c < SA; ++c)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sa[c][j][0] = sa[c][j][1] = sa[c][j][2] = sa[c][j][3] = 0.f;
    const int nk = WIDE ? (d + KS - 1) / KS : NQ;
#pragma unroll
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t fa[4];
      if constexpr (WIDE) q_frag(kk, fa);
      else if constexpr (!QSMEM) {
#pragma unroll
        for (int i = 0; i < 4; ++i) fa[i] = qa[kk][i];
      }
      if constexpr (F32) {
        uint32_t ah[4], al[4];
        if constexpr (QSPLIT) {
#pragma unroll
          for (int i = 0; i < 4; ++i) { ah[i] = fa[i]; al[i] = ql[kk][i]; }
        } else if constexpr (QSMEM) {
          const uint4 h = qsm[kk * 64], l = qsm[kk * 64 + 32];
          ah[0] = h.x; ah[1] = h.y; ah[2] = h.z; ah[3] = h.w;
          al[0] = l.x; al[1] = l.y; al[2] = l.z; al[3] = l.w;
        } else {
          split4(fa, ah, al);
        }
        uint32_t bh[NJ][2], bl[NJ][2];   // K[key j*8 + g][dims kk*8 + t, + 4], split
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float b0, b1;
          if constexpr (WIDE) {
            b0 = ldk(j0 + (jw + j) * 8 + g, kk * 8 + t);
            b1 = ldk(j0 + (jw + j) * 8 + g, kk * 8 + t + 4);
          } else {
            const float* kr =
                reinterpret_cast<const float*>(kb) + ((jw + j) * 8 + g) * LD + kk * 8 + t;
            b0 = kr[0];
            b1 = kr[4];
          }
          split(b0, bh[j][0], bl[j][0]);
          split(b1, bh[j][1], bl[j][1]);
        }
        // 3xTF32: lo.hi and hi.lo first, then hi.hi
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const int c = (3 * kk + term) % SA;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const uint32_t(&b)[2] = term == 1 ? bl[j] : bh[j];
            mma_tf32(sa[c][j], term == 0 ? al : ah, b[0], b[1]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t b0, b1;   // K[key j*8 + g][dims kk*16 + 2t, +1 and +8, +9]
          if constexpr (WIDE) {
            const int row = j0 + (jw + j) * 8 + g, c = kk * 16 + 2 * t;
            b0 = pack(ldk(row, c), ldk(row, c + 1));
            b1 = pack(ldk(row, c + 8), ldk(row, c + 9));
          } else {
            const T* kr = kb + ((jw + j) * 8 + g) * LD + kk * 16 + 2 * t;
            b0 = *reinterpret_cast<const uint32_t*>(kr);
            b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
          }
          mma_bf16(sa[kk % SA][j], fa, b0, b1);
        }
      }
    }
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sa[0][j][i];
#pragma unroll
        for (int c = 1; c < SA; ++c) x += sa[c][j][i];
        s[j][i] = F32 ? x : x * a.scale_log2;
      }

    // ---- online softmax: lane holds keys 2t, 2t+1 of rows g and g + 8 ----
    if (j0 + BN > K) {   // the last tile: keys past K get -inf
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = j0 + (jw + j) * 8 + 2 * t;
        if (key >= K) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= K) s[j][1] = s[j][3] = -INFINITY;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    // with SPLIT > 1 a warp may have had no key yet: subtract 0, not -inf
    const float ms0 = SPLIT > 1 && mx0 == -INFINITY ? 0.f : mx0;
    const float ms1 = SPLIT > 1 && mx1 == -INFINITY ? 0.f : mx1;
    const float cr0 = ex2(m0 - ms0), cr1 = ex2(m1 - ms1);   // 0 on the first tile
    l0 *= cr0;
    l1 *= cr1;
#pragma unroll
    for (int c = 0; c < OA; ++c)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        oa[c][n][0] *= cr0;
        oa[c][n][1] *= cr0;
        oa[c][n][2] *= cr1;
        oa[c][n][3] *= cr1;
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = ex2(s[j][0] - ms0);
      s[j][1] = ex2(s[j][1] - ms0);
      s[j][2] = ex2(s[j][2] - ms1);
      s[j][3] = ex2(s[j][3] - ms1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    m0 = mx0;
    m1 = mx1;

    // ---- O += P V ----------------------------------------------------------
    if constexpr (F32) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // A column t is key 2t, column t + 4 is key 2t + 1 (relabelled)
        const uint32_t pf[4] = {__float_as_uint(s[j][0]), __float_as_uint(s[j][2]),
                                __float_as_uint(s[j][1]), __float_as_uint(s[j][3])};
        uint32_t ph[4], pl[4];
        split4(pf, ph, pl);
        const float* vr = reinterpret_cast<const float*>(vb) + ((jw + j) * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += NC) {
          uint32_t vh[NC][2], vl[NC][2];   // V[keys 2t, 2t+1][dim n*8 + g], split
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            split(vr[(n0 + n) * 8], vh[n][0], vl[n][0]);
            split(vr[(n0 + n) * 8 + LD], vh[n][1], vl[n][1]);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            const int c = (3 * j + term) % OA;
#pragma unroll
            for (int n = 0; n < NC; ++n) {
              const uint32_t(&b)[2] = term == 1 ? vl[n] : vh[n];
              mma_tf32(oa[c][n0 + n], term == 0 ? pl : ph, b[0], b[1]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NJ / 2; ++i) {
        const uint32_t pf[4] = {pack(s[2 * i][0], s[2 * i][1]), pack(s[2 * i][2], s[2 * i][3]),
                                pack(s[2 * i + 1][0], s[2 * i + 1][1]),
                                pack(s[2 * i + 1][2], s[2 * i + 1][3])};
        const T* vr = vb + (jw * 8 + i * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const T* c = vr + n * 8;
          mma_bf16(oa[i % OA][n], pf, pack(c[0], c[LD]), pack(c[8 * LD], c[9 * LD]));
        }
      }
    }
    __syncthreads();   // the slot is free for tile it + STAGES
  }

  // ---- O / l, rows g and g + 8, columns 2t and 2t + 1 of each tile ---------
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = oa[0][n][i];
#pragma unroll
      for (int c = 1; c < OA; ++c) x += oa[c][n][i];
      o[n][i] = x;
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  if constexpr (SPLIT > 1) {
    // the SPLIT partial (max, sum, O) of each row meet in shared memory
    // (the tiles' space, free after the loop's last barrier); every thread
    // then combines and stores some (row, column) of the block's output
    constexpr int LDO = DP + 1;
    float* pm = reinterpret_cast<float*>(smem_raw);   // [SPLIT][bm]
    float* pl = pm + SPLIT * bm;                      // [SPLIT][bm]
    float* po = pl + SPLIT * bm;                      // [SPLIT][bm][LDO]
    const int la = warp / SPLIT * 16 + g, lb = la + 8;
    if (t == 0) {
      pm[part * bm + la] = m0;
      pm[part * bm + lb] = m1;
      pl[part * bm + la] = l0;
      pl[part * bm + lb] = l1;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* oa = po + (part * bm + la) * LDO + n * 8 + 2 * t;
      float* ob = po + (part * bm + lb) * LDO + n * 8 + 2 * t;
      oa[0] = o[n][0];
      oa[1] = o[n][1];
      ob[0] = o[n][2];
      ob[1] = o[n][3];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < bm * dv; i += blockDim.x) {
      const int row = i / dv, c = i % dv;
      if (tile_row0 + row >= K) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < SPLIT; ++p) mx = fmaxf(mx, pm[p * bm + row]);
      float l = 0.f, acc = 0.f;
#pragma unroll
      for (int p = 0; p < SPLIT; ++p) {
        const float w = ex2(pm[p * bm + row] - mx);   // 0 for a part with no key
        l += w * pl[p * bm + row];
        acc += w * po[(p * bm + row) * LDO + c];
      }
      store(acc / l, op + (tile_row0 + row) * a.so.k + c);
      if (a.lse && c == 0) a.lse[(long long)rh * K + tile_row0 + row] = (mx + log2f(l)) * kLn2;
    }
    return;
  }
  // O / l goes through shared memory (the tiles' space, free since the
  // loop's last barrier), so that the block writes whole rows: a warp's
  // own fragments would store 8-byte pieces of 8 rows at a time
  constexpr int LDO = (DP + 31) / 32 * 32 + 8;   // 4 rows of 8 floats: 32 banks
  float* ob = reinterpret_cast<float*>(smem_raw);   // [bm][LDO]
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int la = warp * 16 + g, lb = la + 8;
  if (a.lse && t == 0 && blockIdx.y == 0) {   // the scores in log2 units: back to natural
    float* lse = a.lse + (long long)rh * K + tile_row0;
    if (tile_row0 + la < K) lse[la] = (m0 + log2f(l0)) * kLn2;
    if (tile_row0 + lb < K) lse[lb] = (m1 + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(ob + la * LDO + c) = make_float2(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<float2*>(ob + lb * LDO + c) = make_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncthreads();
  const int rows = min(bm, K - tile_row0);
  if (F32 && a.ovec && dv % 4 == 0) {   // 16-byte stores
    const int q4 = dv / 4;
    for (int i = threadIdx.x; i < rows * q4; i += blockDim.x) {
      const int row = i / q4, c = (i % q4) * 4;
      *reinterpret_cast<float4*>(op + (tile_row0 + row) * a.so.k + c) =
          *reinterpret_cast<const float4*>(ob + row * LDO + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * dv; i += blockDim.x) {
      const int row = i / dv, c = i % dv;
      store(ob[row * LDO + c], op + (tile_row0 + row) * a.so.k + c);
    }
  }
}

// The padded width DP of a block for head dim d (bf16 from 16), and the
// dynamic shared memory of its launch.
int padded_width(int d, bool f32) {
  const int lo = f32 ? 8 : 16;
  for (int w = lo; w < kWide; w *= 2)
    if (d <= w) return w;
  return kWide;
}

// Dynamic shared memory of a launch: the ring of K and V tiles (V alone
// when WIDE; with Q's hi and lo at f32 DP = 128), or the output's rows
// (with SPLIT > 1 the partial results) if larger.
int smem_bytes(int dp, bool wide, bool f32, int bm, int split) {
  const int esize = f32 ? 4 : 2;
  const int tiles = (wide ? 1 : 2) * tile_stages(dp) * kTileKeys * (dp + 16 / esize) * esize +
                    (f32 && !wide && dp == kWide ? bm * 1024 : 0);   // Q's hi and lo
  const int parts = split > 1 ? split * bm * (dp + 3) * 4 : bm * ((dp + 31) / 32 * 32 + 8) * 4;
  return tiles > parts ? tiles : parts;
}

// Raise attn_kernel<T, DP, WIDE, SPLIT>'s dynamic shared memory cap to the
// most a block may opt in to, once per device: later launches make no host
// API call for it.  Setting it twice from racing threads is harmless.
template <typename T, int DP, bool WIDE, int SPLIT>
cudaError_t opt_in_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(attn_kernel<T, DP, WIDE, SPLIT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return e;
}

template <typename T, int DP, bool WIDE, int SPLIT = 1>
cudaError_t launch(const Args& a, int rh, int bm, cudaStream_t stream) {
  const int smem = smem_bytes(DP, WIDE, std::is_same<T, float>::value, bm, SPLIT);
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_smem<T, DP, WIDE, SPLIT>();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(rh * a.tiles, WIDE ? (a.d + kWide - 1) / kWide : 1);
  attn_kernel<T, DP, WIDE, SPLIT><<<grid, 2 * bm * SPLIT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_split(const Args& a, int rh, int bm, int split, cudaStream_t s) {
  if (split == 1) return launch<T, DP, false>(a, rh, bm, s);
  if constexpr (std::is_same<T, float>::value) {
    if (split == kSplit) return launch<T, DP, false, kSplit>(a, rh, bm, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const Args& a, int rh, int bm, int split, cudaStream_t s) {
  if (a.d > kWide) {
    if (split != 1) return cudaErrorInvalidValue;
    return launch<T, kWide, true>(a, rh, bm, s);
  }
  switch (padded_width(a.d, std::is_same<T, float>::value)) {
    case 8:
      if constexpr (std::is_same<T, float>::value) return launch_split<T, 8>(a, rh, bm, split, s);
      return cudaErrorInvalidValue;
    case 16: return launch_split<T, 16>(a, rh, bm, split, s);
    case 32: return launch_split<T, 32>(a, rh, bm, split, s);
    case 64: return launch_split<T, 64>(a, rh, bm, split, s);
    default: return launch_split<T, 128>(a, rh, bm, split, s);
  }
}

bool aligned16(const void* p, const Strides& s, int elem) {
  return (reinterpret_cast<uintptr_t>(p) % 16) == 0 && (s.r * elem) % 16 == 0 &&
         (s.h * elem) % 16 == 0 && (s.k * elem) % 16 == 0;
}

}  // namespace

// q, k, v, out: [r, h, K, d] on the current device, f32 (dtype 0) or bf16
// (dtype 1), each with its last dim contiguous; lse: null, or f32 [r, h, K]
// contiguous, which receives each query row's log-sum-exp of the scaled
// scores (what the backward, K3b, needs of the softmax).  p holds, as 64-bit
// integers, the strides (elements) of dims r, h, K in the order q, k, v,
// out (p[0..11]), then r, h, K, d, bm, split and dtype (p[12..18]): the
// wrapper caches it per layout, so a launch passes 7 arguments.  bm: query
// rows per block, in {16, 32, 64, 128}; split: warps that share 16 rows and
// split each key tile, 1 or (f32, d <= 128) 4; at most 8 warps a block
// (bm * split <= 128).  Any K >= 1, d >= 1.  Returns the cudaError_t of the
// launch (0 = ok).
extern "C" int pcdreg_patch_attention(const void* q, const void* k, const void* v,
                                      void* out, void* lse, const long long* p, float scale,
                                      void* stream) {
  const long long r = p[12], h = p[13], K = p[14], d = p[15], bm = p[16], split = p[17],
                  dtype = p[18];
  if (r <= 0 || h <= 0 || K <= 0 || d <= 0 || K > 0x7fffffffLL || d > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (bm != 16 && bm != 32 && bm != 64 && bm != 128) return (int)cudaErrorInvalidValue;
  if (bm * split > 128) return (int)cudaErrorInvalidValue;
  const long long tiles = (K + bm - 1) / bm;
  if (r * h * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = (float*)lse;
  Strides* s[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) *s[i] = Strides{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
  a.heads = (int)h;
  a.K = (int)K;
  a.d = (int)d;
  a.tiles = (int)tiles;
  a.scale_log2 = scale * kLog2e;
  const int elem = dtype == 0 ? 4 : 2;
  a.vec = aligned16(k, a.sk, elem) && aligned16(v, a.sv, elem);
  a.ovec = aligned16(out, a.so, elem);
  const cudaStream_t st = (cudaStream_t)stream;
  const int rh = (int)(r * h), bmi = (int)bm, spl = (int)split;
  if (dtype == 0) return (int)dispatch<float>(a, rh, bmi, spl, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, rh, bmi, spl, st);
  return (int)cudaErrorInvalidValue;
}

// The tiling the kernel uses for head dim d with bm rows and split warps
// per 16 rows: padded width DP, keys per tile BN, blocks along d, and
// dynamic shared memory bytes (returned).  ops/kernels/attention.py::plan
// mirrors it.
extern "C" int pcdreg_attention_plan(int d, int dtype, int bm, int split, int* dp,
                                     int* bn, int* slices) {
  if (d <= 0 || (dtype != 0 && dtype != 1)) return -1;
  const bool f32 = dtype == 0;
  *dp = d > kWide ? kWide : padded_width(d, f32);
  *bn = kTileKeys;
  *slices = d > kWide ? (d + kWide - 1) / kWide : 1;
  return smem_bytes(*dp, d > kWide, f32, bm, split);
}
