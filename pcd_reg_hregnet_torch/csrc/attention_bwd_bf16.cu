// Patch attention backward in bf16 for Hopper (sm_90a): kernel K3b, bf16.
//
// Replaces: pcd_reg_hregnet_tpu/ops/pallas/attention.py::_bwd (the
// custom_vjp backward of patch_attention) on bf16 q, k, v and output
// gradient g: f32 inside, dq, dk and dv cast to bf16.  Per (patch, head),
// with the log-sum-exp lse of each query row that the forward
// (attention.cu, K3) wrote:
//   s = q.k^T * scale, p = exp(s - lse), dp = g.v^T, D = rowsum(g * o)
//   dv = p^T.g, ds = p * (dp - D), dq = ds.k * scale, dk = ds^T.q * scale
// p and ds are rounded to bf16 only as the operands of the products that
// take them (FlashAttention-2's rounding); the scores, p, ds, D (from the
// bf16 g and o) and every sum stay f32.  Deterministic: every sum runs in a
// fixed order, with no atomics on values.  It takes the shapes
// pcdreg_attention_bwd_bf16_plan accepts (d a multiple of 8 up to 128, K up
// to 512, the block's shared memory within 227 KB: every shape of the
// model's train step); attention_bwd.cu's bf16 instantiations take the
// rest.  The inputs' rows must start on 16 bytes (TMA); the wrapper copies a
// view that does not.
//
// What bounds it on this card: at the train step's shapes (K * d = 16384 /
// H) each call moves 8 R H K d bf16 values (~2.5 us at 3.35 TB/s for R =
// 32) against five K * K * d products (~0.7-1.4 us at 989 TFLOP/s): bytes,
// but in blocks so small (64 keys, 64-256 query rows, d = 8-128) that
// latency, not either rate, sets a block's time.  The design keeps every
// instruction a block issues on its critical path to the products and the
// loads, in the shape of FlashAttention-3's backward:
// - One block per 64 keys of a (patch, head): one consumer warpgroup (warps
//   0-3, each 16 keys) and one producer warp (warp 4).  The key tiles of a
//   (patch, head) form one thread-block cluster (at most 8, K <= 512),
//   placed by the load-balancing cluster policy.
// - The producer keeps TMA loads (cp.async.bulk.tensor, 4-d tensor maps of
//   the strided [R, H, K, d] views, encoded on the host per call) of the
//   Q, G and O tiles of 64 query rows in flight through a ring of up to
//   three stages (two at d > 64) on mbarriers; TMA fills rows past K and
//   columns past d with
//   zeros, so a ragged tile needs no masking to load.  When a tile lands,
//   the producer computes its rows' D = rowsum(G * O) in f32 and lse * log2
//   e into the stage and then marks the stage full (the consumers start the
//   tile's scores once it lands, and read lse and D after); they release
//   it when their products have read it.  K and V are loaded once.
// - Every product is one wgmma.mma_async (m64nNk16, bf16 in, f32
//   accumulate), its operands read from shared memory through descriptors
//   in the swizzle TMA wrote them with (32, 64 or 128 bytes: the head
//   width padded to 16, 32, 64 or two panels of 64); no thread loads an
//   operand.  S^T = K.Q^T and dP^T = V.G^T take K and V as A and Q and G as
//   B (both K-major), keys as rows and the 64 queries of the tile as N.
// - P^T and dS^T stay in registers: p and ds, computed from the f32
//   accumulators of S^T and dP^T, are rounded to bf16 as the register A
//   operand of dV += P^T.G and dK += dS^T.Q (the accumulator's fragment of
//   two adjacent 8-column tiles is the A fragment of one 16-deep step), with
//   G and Q read transposed (MN-major B) from the same tiles.  Each tile's
//   products complete within its loop iteration, and no other instruction
//   touches an accumulator of a product in flight: else ptxas serializes
//   the wgmmas.
// - dQ = dS.K: dS^T goes to shared memory once per tile (4-byte stores in
//   the 128-byte swizzle, free of bank conflicts), and one wgmma reads it
//   as a transposed A operand, with K as a transposed B, giving the tile's
//   64 query rows over the block's 64 keys.  As many query tiles as key
//   tiles: rank i of the cluster owns query tile i, and every rank writes
//   its f32 dQ partial of tile i into a slot of rank i's shared memory
//   (distributed shared memory, stores only, during the loop).  After one
//   cluster barrier each rank sums its slots in rank order.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDevices = 64;
constexpr int kKeys = 64;         // keys a block holds: one consumer warpgroup's wgmma rows
constexpr int kRows = 64;         // query rows per streamed tile
constexpr int kStages = 3;        // tiles in the ring (fewer when K has fewer; 2 at d > 64)
constexpr int kMaxCluster = 8;    // key tiles of a (patch, head) in one cluster
constexpr int kWide = 128;        // the widest head a block holds
constexpr int kMaxSmem = 232448;  // 227 KB a block may opt in to
constexpr int kConsumers = 128;   // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long r, h, k;   // elements; the last dim is contiguous
};

struct Args {
  const float* lse;   // [R * H * K] each query row's log-sum-exp (K3's)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides sdq, sdk, sdv;
  int heads, K, d;
  int ntk, ntq, stages;   // key tiles (cluster size), query tiles, ring stages
  float scale, scale_log2;
  int ovec;               // dq, dk, dv rows may be written 4 bytes at a time
};

// Byte offsets into a block's dynamic shared memory (from a 1024-byte
// aligned base, so that every tile starts on its swizzle's period).
struct Smem {
  int tile;    // a 64-row tile of width dp (bf16): K at 0, V at tile
  int ring;    // [stages][Q, G, O] tiles
  int ds;      // dS^T: [2][64 keys][64 queries] bf16, 128-byte swizzle, by tile parity
  int rows;    // [stages][lse * log2 e, D][64] f32
  int dqp;     // [ntk][64][dp + 4] f32: each rank's dQ partial of this rank's query tile
  int bars;    // mbarriers: K/V, then per stage: loaded, full, empty
  int bytes;   // total, with the alignment slack
};

__host__ __device__ constexpr int ring_stages(int K, int dp) {
  const int most = dp > 64 ? 2 : kStages, ntq = (K + kRows - 1) / kRows;
  return ntq < most ? ntq : most;
}

// For K <= 8 * 64 and dp <= 128 (the shapes plan takes).
__host__ __device__ constexpr Smem smem_layout(int dp, int K, int stages) {
  const int tile = kKeys * dp * 2;
  const int ring = 2 * tile;
  const int ds = ring + stages * 3 * tile;
  const int rows = ds + 2 * kKeys * kRows * 2;
  const int dqp = rows + stages * 2 * kRows * 4;
  const int bars = dqp + (K + kRows - 1) / kRows * kRows * (dp + 4) * 4;
  return Smem{tile, ring, ds, rows, dqp, bars, bars + (1 + 3 * stages) * 8 + 1024};
}

int padded_width(int d) {
  int w = 16;
  while (w < kWide && d > w) w *= 2;
  return w;
}

// ---- PTX: shared-memory addresses, mbarriers, TMA, wgmma ------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 4-d tensor map (d, K, H, R) at {c0, c1, c2, c3} into shared
// memory at dst; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep registers that an asynchronous wgmma reads or writes in place
// across its issue and wait: the compiler may neither read an accumulator
// early nor reuse an operand's register before the wait.
template <int N>
__device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]));
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i]));
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets, and the swizzle of rows `rb` bytes wide (128, 64 or 32).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int rb) {
  const uint64_t layout = rb == 128 ? 1 : rb == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (layout << 62);
}

// Step kk (16 columns) of a tile read K-major: its rows are the M or N
// dimension, its columns the depth.  The tile is NP panels of 64 rows of RB
// bytes; a step within a swizzled row advances the start by 32 bytes.
template <int RB, int PANEL>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  constexpr int SPP = RB / 32;   // steps per panel
  return make_desc(tile + kk / SPP * PANEL + kk % SPP * 32, 16, 8 * RB, RB);
}

// Step kk (16 rows) of a tile read MN-major (transposed): its rows are the
// depth, its columns the M or N dimension, 64 of them per panel (LBO).
template <int RB, int PANEL>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * RB, PANEL, 8 * RB, RB);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16; d holds N / 2 accumulators
// of the thread.  _ss: A and B from shared memory (TA, TB: read transposed,
// MN-major); _rs: A from registers (four of the thread's bf16 pairs).  acc
// = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
}

// S^T = K.Q^T and dP^T = V.G^T of one tile (64 keys x 64 queries, depth
// DP): two wgmma groups, each its own pipeline stage (fence, products,
// commit), so that S^T may be read while dP^T is in flight; the first step
// of each overwrites its accumulators.  No other instruction may write an
// accumulator, or read one of a stage still in flight: ptxas then
// serializes the wgmmas.
template <int RB, int PANEL, int KS>
__device__ __forceinline__ void issue_scores(float (&sa)[32], float (&pa)[32], uint32_t kb,
                                             uint32_t vb, uint32_t qb, uint32_t gb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss<0, 0>(sa, k_major<RB, PANEL>(kb, kk), k_major<RB, PANEL>(qb, kk), kk);
  wgmma_commit();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss<0, 0>(pa, k_major<RB, PANEL>(vb, kk), k_major<RB, PANEL>(gb, kk), kk);
  wgmma_commit();
}

// A tile's dQ rows (the accumulator's rows are its queries) into an f32
// partial at q0 (row kr, column 2 t; rows of LDQ), in this block's shared
// memory or, through distributed shared memory, another rank's.
template <int NA, int LDQ>
__device__ __forceinline__ void store_dq(float (&qa)[NA], float* q0) {
  hold(qa);
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    *reinterpret_cast<float2*>(q0 + 8 * j) = make_float2(qa[4 * j], qa[4 * j + 1]);
    *reinterpret_cast<float2*>(q0 + 8 * LDQ + 8 * j) = make_float2(qa[4 * j + 2], qa[4 * j + 3]);
  }
}

// ---- the kernel -------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads, DP == kWide ? 1 : 2)
    attn_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ CUtensorMap to, const Args a) {
  constexpr int PW = DP < 64 ? DP : 64;   // columns of a panel: a TMA box's width
  constexpr int NP = DP / PW;             // panels (2 at DP = 128)
  constexpr int RB = 2 * PW;              // bytes of a panel row: the swizzle span
  constexpr int PANEL = kRows * RB;
  constexpr int TILE = NP * PANEL;
  constexpr int KS = DP / 16;             // 16-deep steps over the head dim
  constexpr int NA = DP / 2;              // accumulators of an m64 x DP product
  constexpr int LDQ = DP + 4;             // row of the f32 dQ partial
  static_assert(kKeys == kRows && kKeys == 64, "one warpgroup: 64 keys and 64 queries a tile");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (sbase - raw);
  const int S = a.stages, K = a.K;
  const Smem L = smem_layout(DP, K, S);
  const uint32_t kv_bar = sbase + L.bars;
  auto loaded = [&](int s) { return kv_bar + 8 * (1 + s); };
  auto full = [&](int s) { return kv_bar + 8 * (1 + S + s); };
  auto empty = [&](int s) { return kv_bar + 8 * (1 + 2 * S + s); };
  float* dqp = reinterpret_cast<float*>(sm + L.dqp);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rh = blockIdx.x / a.ntk, kt = blockIdx.x % a.ntk;   // kt: rank in the cluster
  const int r = rh / a.heads, h = rh % a.heads;
  const int j0 = kt * kKeys;   // the block's first key

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(loaded(s), 1);
      mbar_init(full(s), 32);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // every rank of the cluster is running before any writes to another's
  // shared memory: arrive now, wait before the first such write
  const bool clustered = a.ntk > 1;
  if (clustered) asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");

  if (warp == kConsumers / 32) {
    // ---- producer: K and V once, then the ring of Q, G and O tiles -------
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * TILE);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(&tk, sbase + p * PANEL, kv_bar, p * PW, j0, h, r);
        tma_load(&tv, sbase + L.tile + p * PANEL, kv_bar, p * PW, j0, h, r);
      }
    }
    const float* lse_in = a.lse + (long long)rh * K;
    // tile j has landed: its rows' lse * log2 e (0 past K, where q and g are
    // zero, so that p stays finite) and D = rowsum(G * O) in f32, summed
    // over the row's 16-byte chunks in the order they lie (a swizzle only
    // permutes the chunks of a row); then the stage is full
    auto finish = [&](int j) {
      const int s = j % S;
      float lx[kRows / 32];   // in flight while the tile lands
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u) {
        const int row = j * kRows + lane + 32 * u;
        lx[u] = row < K ? lse_in[row] * kLog2e : 0.f;
      }
      mbar_wait(loaded(s), (j / S) & 1);
      const unsigned char* gt = sm + L.ring + s * 3 * TILE + TILE;
      const unsigned char* ot = gt + TILE;
      float* lt = reinterpret_cast<float*>(sm + L.rows + s * 2 * kRows * 4);
#pragma unroll
      for (int u = 0; u < kRows / 32; ++u) {
        const int i = lane + 32 * u;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < TILE / kRows / 16; ++c) {
          const int off = c / (RB / 16) * PANEL + i * RB + c % (RB / 16) * 16;
          const uint4 gx = *reinterpret_cast<const uint4*>(gt + off);
          const uint4 ox = *reinterpret_cast<const uint4*>(ot + off);
          const uint32_t gw[4] = {gx.x, gx.y, gx.z, gx.w}, ow[4] = {ox.x, ox.y, ox.z, ox.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[e]));
            const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
            acc = fmaf(gf.x, of.x, acc);
            acc = fmaf(gf.y, of.y, acc);
          }
        }
        lt[i] = lx[u];
        lt[kRows + i] = acc;
      }
      mbar_arrive(full(s));
    };
    auto issue = [&](int it) {   // tile it into its stage
      if (lane == 0) {
        const uint32_t dst = sbase + L.ring + it % S * 3 * TILE, bar = loaded(it % S);
        mbar_expect_tx(bar, 3 * TILE);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load(&tq, dst + p * PANEL, bar, p * PW, it * kRows, h, r);
          tma_load(&tg, dst + TILE + p * PANEL, bar, p * PW, it * kRows, h, r);
          tma_load(&to, dst + 2 * TILE + p * PANEL, bar, p * PW, it * kRows, h, r);
        }
      }
      __syncwarp();
    };
    for (int it = 0; it < S; ++it) issue(it);
    // finish each tile as soon as it lands, then refill the stage the
    // consumers free next (the tile before's) with the tile S ahead of it
    for (int j = 0; j < a.ntq; ++j) {
      finish(j);
      if (j >= 1 && j - 1 + S < a.ntq) {
        mbar_wait(empty((j - 1) % S), ((j - 1) / S) & 1);
        issue(j - 1 + S);
      }
    }
    if (clustered) {   // the producer's share of both cluster barriers
      asm volatile("barrier.cluster.wait;" ::: "memory");
      asm volatile("barrier.cluster.arrive.release;" ::: "memory");
    }
  } else {
    // ---- consumers: warp w holds keys j0 + 16 w .. + 15 ------------------
    const int g = lane >> 2, t = lane & 3;
    const int kr = warp * 16 + g;   // the lane's key rows kr and kr + 8 (accumulator rows)
    const bool kin0 = j0 + kr < K, kin1 = j0 + kr + 8 < K;
    const float scale_log2 = a.scale_log2;
    const int ntq = a.ntq;
    const uint32_t kb = sbase, vb = sbase + L.tile;
    float dka[NA], dva[NA], sa[32], pa[32], qa[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
    auto stage_of = [&](int it) { return sbase + L.ring + it % S * 3 * TILE; };
    // tile it's dQ partial goes to the rank that owns its rows (rank it: as
    // many query tiles as key tiles), in the slot of this rank (kt)
    auto dq_dst = [&](int it) {
      float* base = clustered ? cg::this_cluster().map_shared_rank(dqp, it) : dqp;
      return base + (kt * kRows + kr) * LDQ + 2 * t;
    };
    mbar_wait(kv_bar, 0);
    if (clustered) asm volatile("barrier.cluster.wait;" ::: "memory");
    // No wgmma is in flight across the loop's back edge: an accumulator
    // carried over it in flight makes ptxas serialize the wgmmas.
    for (int it = 0; it < ntq; ++it) {
      const int s = it % S;
      mbar_wait(loaded(s), (it / S) & 1);   // the scores need the tiles, not lse and D
      issue_scores<RB, PANEL, KS>(sa, pa, kb, vb, stage_of(it), stage_of(it) + TILE);
      const uint32_t qb = sbase + L.ring + s * 3 * TILE, gb = qb + TILE;
      const uint32_t dsb = sbase + L.ds + (it & 1) * kKeys * kRows * 2;   // double-buffered
      const float* lt = reinterpret_cast<const float*>(sm + L.rows + s * 2 * kRows * 4);
      const float* dt = lt + kRows;

      // S^T is in: P^T.  Accumulator v is key kr + 8 (v / 2 % 2), query 8 (v / 4) + 2 t + v
      // % 2; two adjacent 8-query tiles are one A step.  P and dS go to new
      // registers: an instruction that writes an accumulator while a wgmma
      // is in flight makes ptxas serialize the wgmmas.
      mbar_wait(full(s), (it / S) & 1);   // the rows' lse and D (the scores run meanwhile)
      wgmma_wait<1>();
      hold(sa);
      uint32_t pf[16], sf[16];
      float pv[32], dv[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
        pv[4 * j + 0] = kin0 ? ex2(fmaf(sa[4 * j + 0], scale_log2, -l.x)) : 0.f;
        pv[4 * j + 1] = kin0 ? ex2(fmaf(sa[4 * j + 1], scale_log2, -l.y)) : 0.f;
        pv[4 * j + 2] = kin1 ? ex2(fmaf(sa[4 * j + 2], scale_log2, -l.x)) : 0.f;
        pv[4 * j + 3] = kin1 ? ex2(fmaf(sa[4 * j + 3], scale_log2, -l.y)) : 0.f;
      }
      if (K == 1) {   // a softmax over one key is 1: ds = 0 exactly, as in f32
#pragma unroll
        for (int i = 0; i < 32; ++i) pv[i] = pv[i] > 0.f ? 1.f : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) pf[i] = pack(pv[2 * i], pv[2 * i + 1]);
      wgmma_wait<0>();
      hold(pa);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(dt + 8 * j + 2 * t);
        dv[4 * j + 0] = K == 1 ? 0.f : pv[4 * j + 0] * (pa[4 * j + 0] - dd.x);
        dv[4 * j + 1] = K == 1 ? 0.f : pv[4 * j + 1] * (pa[4 * j + 1] - dd.y);
        dv[4 * j + 2] = K == 1 ? 0.f : pv[4 * j + 2] * (pa[4 * j + 2] - dd.x);
        dv[4 * j + 3] = K == 1 ? 0.f : pv[4 * j + 3] * (pa[4 * j + 3] - dd.y);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) sf[i] = pack(dv[2 * i], dv[2 * i + 1]);

      // dV += P^T.G and dK += dS^T.Q over the tile's 64 queries (G and Q
      // transposed: queries are the depth)
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < 4; ++m) wgmma_rs<1>(dva, pf + 4 * m, mn_major<RB, PANEL>(gb, m), 1);
#pragma unroll
      for (int m = 0; m < 4; ++m) wgmma_rs<1>(dka, sf + 4 * m, mn_major<RB, PANEL>(qb, m), 1);
      wgmma_commit();

      // dS^T into shared memory: key row, query column, 128-byte swizzle.
      // Its buffer alternates by tile: the dQ of tile it - 2 read it last,
      // and every warp waited for that before the barrier of tile it - 1.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t c = 8 * j + 2 * t;
        const uint32_t a0 = dsb + ((kr * 128 + c * 2) ^ ((kr & 7) << 4));
        const uint32_t a1 = dsb + (((kr + 8) * 128 + c * 2) ^ ((kr & 7) << 4));
        asm volatile("st.shared.b32 [%0], %1;" :: "r"(a0), "r"(sf[2 * j]) : "memory");
        asm volatile("st.shared.b32 [%0], %1;" :: "r"(a1), "r"(sf[2 * j + 1]) : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");

      // dQ = dS.K for the tile's 64 queries over the block's keys: dS^T and
      // K read transposed (keys are the depth)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(qa, mn_major<128, 8192>(dsb, kk), mn_major<RB, PANEL>(kb, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();   // dV and dK of the tile are in
      hold(dka);
      hold(dva);
      hold(pf);
      hold(sf);
      mbar_arrive(empty(s));   // Q, G, O and the rows of stage s are read no more
      wgmma_wait<0>();
      store_dq<NA, LDQ>(qa, dq_dst(it));
    }
    // every dQ partial this rank writes is out: arrive, and wait only after
    // the dK and dV stores
    if (clustered) asm volatile("barrier.cluster.arrive.release;" ::: "memory");

    // ---- dK (scaled) and dV of the lane's keys, straight from registers --
    __nv_bfloat16* dkp = a.dk + r * a.sdk.r + h * a.sdk.h;
    __nv_bfloat16* dvp = a.dv + r * a.sdv.r + h * a.sdv.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = j0 + kr + 8 * half;
      if (key >= K) continue;
      __nv_bfloat16* kp = dkp + key * a.sdk.k;
      __nv_bfloat16* vp = dvp + key * a.sdv.k;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c >= a.d) continue;
        const float k0 = dka[4 * j + 2 * half] * a.scale, k1 = dka[4 * j + 2 * half + 1] * a.scale;
        const float v0 = dva[4 * j + 2 * half], v1 = dva[4 * j + 2 * half + 1];
        if (a.ovec) {   // d is even here, so c + 1 < d
          *reinterpret_cast<uint32_t*>(kp + c) = pack(k0, k1);
          *reinterpret_cast<uint32_t*>(vp + c) = pack(v0, v1);
        } else {
          kp[c] = __float2bfloat16(k0);
          vp[c] = __float2bfloat16(v0);
          if (c + 1 < a.d) {
            kp[c + 1] = __float2bfloat16(k1);
            vp[c + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }

  // ---- dQ of the rows this rank owns (query tile kt): the key tiles'
  // partials, which every rank wrote into this rank's slots, summed in rank
  // (key-tile) order ----------------------------------------------------------
  if (clustered)   // every rank's partials of this rank's rows are in
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  else
    __syncthreads();
  {
    __nv_bfloat16* dqg = a.dq + r * a.sdq.r + h * a.sdq.h;
    constexpr int Q4 = DP / 4;
    const int rows = min(kRows, K - kt * kRows);
    for (int i = threadIdx.x; i < rows * Q4; i += kThreads) {
      const int row = i / Q4, c = i % Q4 * 4;
      if (c >= a.d) continue;
      float4 x = *reinterpret_cast<const float4*>(dqp + row * LDQ + c);
      for (int rk = 1; rk < a.ntk; ++rk) {
        const float4 y = *reinterpret_cast<const float4*>(dqp + (rk * kRows + row) * LDQ + c);
        x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
      }
      const float z[4] = {x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale};
      __nv_bfloat16* dst = dqg + (long long)(kt * kRows + row) * a.sdq.k + c;
      if (a.ovec) {   // d is a multiple of 8 here, so c + 3 < d
        *reinterpret_cast<uint32_t*>(dst) = pack(z[0], z[1]);
        *reinterpret_cast<uint32_t*>(dst + 2) = pack(z[2], z[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < a.d) dst[e] = __float2bfloat16(z[e]);
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

// Raise a kernel's dynamic shared memory cap to `bytes` where it is above
// what this device already granted it.
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (no link
// to libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// The tensor map of an [R, H, K, d] bf16 view with strides `s`: boxes of
// pw columns by 64 rows of one (patch, head), swizzled as wide as a row of
// the box.  A dim of size 1 is never stepped; it gets a packed stride.
bool encode(CUtensorMap* map, const void* ptr, const Strides& s, long long R, long long H,
            long long K, long long d, int pw) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)K, (cuuint64_t)H, (cuuint64_t)R};
  cuuint64_t strides[3] = {(cuuint64_t)s.k * 2, (cuuint64_t)s.h * 2, (cuuint64_t)s.r * 2};
  if (K == 1) strides[0] = (cuuint64_t)((d * 2 + 15) / 16 * 16);
  for (int i = 1; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = strides[i - 1] * dims[i];
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 16 != 0 || strides[i] >= (1ull << 40)) return false;
  cuuint32_t box[4] = {(cuuint32_t)pw, (cuuint32_t)kRows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = pw == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                : pw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_128B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const CUtensorMap (&m)[5], const Args& a, int rh, int smem,
                   cudaStream_t stream) {
  static std::atomic<int> granted[kMaxDevices];
  auto kernel = attn_bwd_bf16_kernel<DP>;
  cudaError_t e = opt_in_smem(kernel, granted, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rh * a.ntk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ntk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // the default placement left ~10% of 64 clusters of 4 blocks (two an SM)
  // to a second wave at K = 256, d = 32 on an H100; load balancing fits
  // them in one (PERF.md)
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  void* args[] = {(void*)&m[0], (void*)&m[1], (void*)&m[2], (void*)&m[3], (void*)&m[4],
                  (void*)&a};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool aligned(const void* p, const Strides& s, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0 && (s.r * 2) % bytes == 0 &&
         (s.h * 2) % bytes == 0 && (s.k * 2) % bytes == 0;
}

// The plan of a shape: padded width, ring stages, cluster size and shared
// memory bytes; -1 where this kernel does not take (K, d).
int plan(long long K, long long d, int* dp, int* stages, int* cluster) {
  if (K <= 0 || d <= 0 || d % 8 != 0 || d > kWide || (K + kKeys - 1) / kKeys > kMaxCluster)
    return -1;
  *dp = padded_width((int)d);
  *stages = ring_stages((int)K, *dp);
  *cluster = (int)((K + kKeys - 1) / kKeys);
  const int bytes = smem_layout(*dp, (int)K, *stages).bytes;
  return bytes > kMaxSmem ? -1 : bytes;
}

}  // namespace

// q, k, v, o (the forward output), g (its gradient), dq, dk, dv: bf16
// [r, h, K, d] on the current device, each with its last dim contiguous;
// q, k, v, o and g start on 16 bytes with strides of whole 16 bytes (the
// tensor maps' rule, dims of size 1 aside); lse: f32 [r, h, K] contiguous,
// each query row's log-sum-exp of the scaled scores (K3 writes it).  p
// holds, as 64-bit integers, the strides (elements) of dims r, h, K in the
// order q, k, v, o, g, dq, dk, dv (p[0..23]), then r, h, K, d (p[24..27]).
// (K, d) must be a shape pcdreg_attention_bwd_bf16_plan accepts.  One
// launch on `stream`; returns its cudaError_t (0 = ok).
extern "C" int pcdreg_patch_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                               const void* o, const void* g, const void* lse,
                                               void* dq, void* dk, void* dv, const long long* p,
                                               float scale, void* stream) {
  const long long R = p[24], H = p[25], K = p[26], d = p[27];
  if (R <= 0 || H <= 0 || K <= 0 || K > 0x7fffffffLL || R * H > 0x7fffffffLL / kMaxCluster)
    return (int)cudaErrorInvalidValue;
  int dp = 0, stages = 0, ntk = 0;
  const int smem = plan(K, d, &dp, &stages, &ntk);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
  const void* in[5] = {q, k, v, o, g};
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || reinterpret_cast<uintptr_t>(o) % 16 ||
      reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorMisalignedAddress;
  // maps in the kernel's order: q, k, v, g, o
  const int order[5] = {0, 1, 2, 4, 3};
  CUtensorMap maps[5];
  const int pw = dp < 64 ? dp : 64;
  for (int i = 0; i < 5; ++i)
    if (!encode(&maps[i], in[order[i]], st[order[i]], R, H, K, d, pw))
      return (int)cudaErrorInvalidValue;
  Args a;
  a.lse = (const float*)lse;
  a.dq = (__nv_bfloat16*)dq;
  a.dk = (__nv_bfloat16*)dk;
  a.dv = (__nv_bfloat16*)dv;
  a.sdq = st[5];
  a.sdk = st[6];
  a.sdv = st[7];
  a.heads = (int)H;
  a.K = (int)K;
  a.d = (int)d;
  a.ntk = ntk;
  a.ntq = (int)((K + kRows - 1) / kRows);
  a.stages = stages;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.ovec = aligned(dq, st[5], 4) && aligned(dk, st[6], 4) && aligned(dv, st[7], 4);
  const int rh = (int)(R * H);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dp) {
    case 16: return (int)launch<16>(maps, a, rh, smem, s);
    case 32: return (int)launch<32>(maps, a, rh, smem, s);
    case 64: return (int)launch<64>(maps, a, rh, smem, s);
    default: return (int)launch<128>(maps, a, rh, smem, s);
  }
}

// K3b in bf16 on this kernel for patch length K and head dim d: padded
// width dp, query rows per tile bm, ring stages, and the cluster size (the
// key tiles of a (patch, head)).  Returns the dynamic shared memory bytes,
// or -1 where this kernel does not take (K, d) (attention_bwd.cu does).
// ops/kernels/attention.py::plan_backward mirrors it.
extern "C" int pcdreg_attention_bwd_bf16_plan(int K, int d, int* dp, int* bm, int* stages,
                                              int* cluster) {
  *bm = kRows;
  return plan(K, d, dp, stages, cluster);
}
