// K1 at N = 32, 64 and 128, the "fused_otf" blind rotation for the rings
// that K1's 256-byte contraction slices do not divide (sm_90a): all n CMux
// steps of a tile of 16 ciphertexts in one launch, on a thread-block
// cluster, the contraction on int8 tensor cores (mma.sync m16n8k32) with
// the key operand read out of the compact keys in shared memory; and, as
// k1s_kernel_wide, K1's small-tile plan at N = 256 and 512, for launches
// of few tiles that the ring kernel (fused_blind_rotate.cu) would run on a
// dozen SMs (end of this comment).
//
// Replaces _kernel_otf of tfhe_fbs_map_tpu/ops/fused_blind_rotate.py
// (:160-242) at N < 256 (the Pallas kernel takes any N, with its strip
// tile T = min(128, N), :248-252).  Keys: [n, L*(k+1), rows, 2N] int8, the
// anti-periodic limb extensions E = [limbs(-poly), limbs(poly)] of every
// (step, limb, comp, row); step i's negacyclic matrix is
// M[(r, j), t] = E[N + t - j], and
//   ACC[comp] += sum_limb (digits @ M_{limb,comp}) << 8*(limb + drop).
//
// What bounds it on the H100.  A tile is M = 16 ciphertexts, so a step is a
// thin product: 16 x rows*N x L*(k+1)*N int8 MACs (28 M at k=2, N=128, l=3,
// L=4) on operands that live in shared memory, and a launch at the JAX
// package's sizes (8-48 ciphertexts, n = 8-32 steps) is n such steps in
// series: latency, some 1,000x its card-wide bound.  With one CTA a tile
// (the first version of this kernel) a launch kept 1-3 of the 132 SMs busy
// and the products were 76-84% of it (PERF.md, section 5).
// This design spreads a step over a cluster of 8 CTAs; what is left of a
// step at bench --quick (~4.5 us on an H100, PERF.md) is the products
// (~1.4 us: the B windows' shared loads, then the mma.sync), the exchange
// and the cluster barrier (~1 us), the digit pass (~0.64 us: what
// no_digits saves, over 32 steps) and the CTA barriers and the slices'
// reduction.
//
// The design:
// * a cluster of C CTAs a tile (kMaxCluster at most, the portable size):
//   CTA r owns the columns [r*span, (r+1)*span) of the flattened (comp, t)
//   axis, span = (k+1)*N / C, with all L limbs, so the limb shift-add stays
//   inside the CTA.  Its warps form groups of NT n8 output tiles
//   (tile_groups) and each group's warps split the contraction, so every
//   warp keeps 4-16 independent int32 fragments whatever the span, and the
//   slices' limb-shifted sums meet in shared memory (in the key stage the
//   step is done with).  A CTA runs 1/C of the products and reads 1/C of
//   the keys;
// * every CTA keeps the whole tile's ACC [k+1][16][N] in shared memory,
//   double-buffered: step i reads buffer i&1 and writes (i+1)&1.  A CTA
//   computes all the digits itself (at most 6,144 coefficients a step on
//   256 threads, cheaper than any exchange) and stores its span of the new
//   ACC into every CTA's copy (st.shared::cluster).  One cluster barrier a
//   step orders those remote stores and the next step's reads; ACC reaches
//   device memory once, at the end;
// * the keys of the next pass are in flight while this one computes: one
//   warp brings the CTA's own E rows (L x its components x the pass's rows x
//   2N bytes) with cp.async.bulk into the other of two stages, completing on
//   that stage's mbarrier;
// * one digit pass a step (PASSES = 1): the digits of all k+1 components
//   are written at once, then three CTA barriers (digits written; products
//   done; partial sums written) and the cluster barrier.  Where those
//   digit rows and the two key stages do not fit 227 KB (large l), the step
//   runs one pass a component (PASSES = k+1), each with its own digit rows
//   and key stage and two barriers.  k1_small_plan
//   (ops/fused_blind_rotate.py) picks which from this file's layout.
// The digits are written reversed within each row's N block (j' = N-1-j),
// which makes the key operand the Hankel matrix B'[(lev, j'), t] =
// E[t + j' + 1] (as in K1, fused_blind_rotate.cu): a B fragment of
// m16n8k32 is two 4-byte windows of one E row, read as two aligned words
// and a funnel shift; the A fragment is one ldmatrix.  wgmma is not used:
// its M of 64 rows would waste 3/4 of every product on a 16-ciphertext
// tile.
//
// The small-tile plan at N >= 256 (k1s_kernel_wide).  At k=2, N=512 a
// tile's whole ACC is 100 KB, so a CTA keeps only its span of it, computes
// the digits of its span alone (reading each rotated source word from the
// CTA that owns it over distributed shared memory) and stores them into
// every CTA's digits; two cluster barriers a step; one digit pass; tiles
// of 16 ciphertexts on 12 warps, or of 32 (each B window feeds two row
// tiles) on 8.  The B windows' shared loads bound the products (the
// bisect's loads_only): a warp's n8 tiles in one component share them
// (NT + 2 a chunk and limb in place of 2 NT, and the next chunk of a row
// reuses NT - 2 of them), and a third warp a scheduler hides more of
// their latency (12 warps: 20% less time a launch than 8, PERF.md).
//
// Exactness: |digit| <= 2^(b-1) <= 128, |key| <= 128 and
// rows*N*2^(b+6) < 2^31 (unsupported() in ops/fused_blind_rotate.py), so
// every int32 fragment sum is exact.  The limb shifts and the ACC adds are
// uint32_t (mod 2^32).  Rows past the batch have zero digits, stay zero and
// are never stored.
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_blind_rotate.cuh"

namespace fbr {
namespace k1s {

constexpr int kCB = 16;                   // ciphertexts a tile: mma's M
constexpr int kWarps = 8;                 // warps a CTA
constexpr int kThreadsS = 32 * kWarps;
constexpr int kMaxCluster = 8;            // CTAs a tile at N < 256, at most
constexpr int kMaxClusterWide = 16;       // at N >= 256 (non-portable)
constexpr int kMaxNWide = 512;            // the widest ring it serves
constexpr int kMaxKnWide = 1536;          // and the most columns (k+1)*N
constexpr int kSmemMax = 232448;          // shared memory a CTA may have

// Warps of k1s_kernel_wide at a tile of cb: 12 at 16 (three a scheduler,
// more of the windows' load latency hidden; 168 registers), 8 at 32 (its
// two row tiles' accumulators need the registers).
__host__ __device__ constexpr int wide_warps(int cb) {
  return cb == 16 ? 12 : 8;
}

// Its warps' groups of nt n8 tiles: as many as cover the span's tiles,
// exactly (every group busy); they must divide the warps.
__host__ __device__ inline int wide_groups(int tiles, int nt) {
  return (tiles + nt - 1) / nt;
}
constexpr int kAccPad = 8;   // words past each ACC row (epilogue banks)
constexpr int kDigPad = 16;  // bytes past each digit row (fragment banks)
constexpr int kEPad = 16;    // bytes past a key stage (a window's 2nd word)
constexpr int kRedPad = 8;   // words past each partial-sum row (store banks)

// A CTA's warps: groups of nt n8 output tiles, ceil(tiles / nt) rounded up
// to a power of two (so they divide kWarps), each group's warps splitting
// the contraction.
__host__ __device__ inline int tile_groups(int tiles, int nt) {
  int groups = 1;
  while (groups * nt < tiles) groups *= 2;
  return groups;
}

// The most output components the span of any CTA of a cluster of `cluster`
// touches: the E rows a CTA copies are those of its components.
__host__ __device__ inline int comps_a_cta(int n, int k1, int cluster) {
  const int span = k1 * n / cluster;
  int most = 0;
  for (int r = 0; r < cluster; ++r) {
    const int c = (r * span + span - 1) / n - r * span / n + 1;
    most = c > most ? c : most;
  }
  return most;
}

// Dynamic shared memory of a CTA, byte offsets (the launch side asks
// fbr_k1s_layout for the total): ACC 2 x [k1][kCB][n + kAccPad] uint32,
// the digits [kCB][prow*n + kDigPad] int8 (prow = the E rows of a pass),
// two key stages of [L][comps][prow][2n] int8 + kEPad, each also the room
// of the contraction slices' partial sums [kWarps / groups][kCB][span +
// kRedPad] uint32 once the last pass of a step is done with it, the
// rotation amounts 2 x [kCB] int32, the stages' two mbarriers.
struct Layout {
  int dig, es, stage, amt, bar, total;
};

// A key stage: the E rows of a pass, or the room of the partial sums.
__host__ __device__ inline int stage_bytes(int n, int k1, int limbs,
                                           int cluster, int prow, int nt) {
  const int span = k1 * n / cluster;
  const int keys = limbs * comps_a_cta(n, k1, cluster) * prow * 2 * n + kEPad;
  const int red =
      kWarps / tile_groups(span / 8, nt) * kCB * (span + kRedPad) * 4;
  return keys > red ? keys : red;
}

__host__ __device__ inline Layout layout(int n, int k1, int l, int limbs,
                                         int cluster, int passes, int nt) {
  const int prow = k1 * l / passes;
  Layout s;
  s.dig = 2 * 4 * k1 * kCB * (n + kAccPad);
  s.es = s.dig + kCB * (prow * n + kDigPad);
  s.stage = stage_bytes(n, k1, limbs, cluster, prow, nt);
  s.amt = s.es + 2 * s.stage;
  s.bar = s.amt + 2 * kCB * 4;
  s.total = s.bar + 2 * 8;
  return s;
}

// The small-tile kernel's (N >= 256) at tiles of cb ciphertexts: its span
// of the ACC [cb][span + kAccPad] uint32, all the digits [cb][rows*n +
// kDigPad] int8, two key stages of all the step's rows (each also the room
// of the partial sums [slices][cb][span + kRedPad]), the amounts 2 x [cb]
// and the mbarriers.
__host__ __device__ inline Layout layout_wide(int n, int k1, int l,
                                              int limbs, int cluster, int nt,
                                              int cb) {
  const int span = k1 * n / cluster;
  const int red =
      wide_warps(cb) / wide_groups(span / 8, nt) * cb * (span + kRedPad) * 4;
  const int keys = stage_bytes(n, k1, limbs, cluster, k1 * l, nt);
  Layout s;
  s.dig = cb * (span + kAccPad) * 4;
  s.es = s.dig + cb * (k1 * l * n + kDigPad);
  s.stage = keys > red ? keys : red;
  s.amt = s.es + 2 * s.stage;
  s.bar = s.amt + 2 * cb * 4;
  s.total = s.bar + 2 * 8;
  return s;
}

// Bytes row[at .. at+3] as one little-endian word, at >= 0 any offset into
// a 4-aligned row (the second word may lie past the row: kEPad).
__device__ __forceinline__ uint32_t window(const int8_t* row, int at) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (at & ~3));
  return __funnelshift_r(w[0], w[1], 8 * (at & 3));
}

// d += A (16x32 s8, row-major fragment) * B (32x8 s8, column fragment).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The m16n8k32 A fragment of 16 rows x 32 bytes: lane i gives the address
// of row (i & 7) + 8 * ((i >> 3) & 1), byte 16 * (i >> 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// Every thread of every CTA of the cluster: the shared-memory loads and
// stores before it, this CTA's and the remote ones, are done for the
// cluster after.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 16 bytes at the shared-memory address `addr` of this CTA, in CTA
// `rank` of the cluster.
__device__ __forceinline__ uint4 load_from(uint32_t addr, int rank) {
  uint32_t remote;
  uint4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// {v0, v1} to the shared-memory address `addr` of this CTA, in CTA `rank`
// of the cluster.
__device__ __forceinline__ void store_to(uint32_t addr, int rank,
                                         uint32_t v0, uint32_t v1) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(remote),
               "r"(v0), "r"(v1)
               : "memory");
}

// Digits of X^a * ACC[c] - ACC[c] for the components c0 .. c0 + nc - 1 of
// the tile (rotation amounts amt[g]), balanced and biased-added as
// digit_pass in fused_blind_rotate.cuh, into dig [kCB][drow]: coefficient t
// of (component c0 + ci, level lev) at column (ci*l + lev)*n + n-1-t.  Four
// coefficients a thread at a time; rows past the batch (g >= live) get zero
// digits.
__device__ __forceinline__ void write_digits(const uint32_t* acc,
                                             int8_t* dig, const int* amt,
                                             int c0, int nc, int live, int n,
                                             int log_n, int l, int b,
                                             int accw, int drow) {
  const int bl = b * l, half = 1 << (b - 1);
  const uint32_t mask = (1u << b) - 1, rnd = 1u << (31 - bl);
  uint32_t bias = 0;
  for (int j = 0; j < l; ++j) bias += static_cast<uint32_t>(half) << (b * j);
  // kCB * (n / 4) = 4n groups a component
  for (int e = threadIdx.x; e < nc << (log_n + 2); e += kThreadsS) {
    const int ci = e >> (log_n + 2), g = (e >> (log_n - 2)) & (kCB - 1);
    const int t = 4 * (e & (n / 4 - 1));
    uint32_t* dp =
        reinterpret_cast<uint32_t*>(dig + g * drow + ci * l * n + (n - 4 - t));
    if (g >= live) {
      for (int lev = 0; lev < l; ++lev) dp[lev * (n / 4)] = 0;
      continue;
    }
    // rotated_coef(row, t + j, a, n) for j < 4: the words (t + j - a) mod
    // n, from the two aligned 16-byte blocks that hold them
    const int a = amt[g], am = a & (n - 1);
    const bool flip = (a & n) != 0;
    const uint32_t* row = acc + ((c0 + ci) * kCB + g) * accw;
    const int from = (t - am) & (n - 1), sh4 = from & 3, blk = from & ~3;
    const uint4 own = *reinterpret_cast<const uint4*>(row + t);
    const uint4 x0 = *reinterpret_cast<const uint4*>(row + blk);
    const uint4 x1 =
        *reinterpret_cast<const uint4*>(row + ((blk + 4) & (n - 1)));
    const uint32_t o[4] = {own.x, own.y, own.z, own.w};
    const uint32_t x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    uint32_t z[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) z[k] = (sh4 & 2) ? x[k + 2] : x[k];
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t v = (sh4 & 1) ? z[j + 1] : z[j];  // x[sh4 + j]
      const uint32_t rot = ((t + j < am) != flip) ? 0u - v : v;
      w[j] = ((rot - o[j] + rnd) >> (32 - bl)) + bias;
    }
    for (int lev = 0; lev < l; ++lev) {
      const int sh = b * (l - 1 - lev);
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        packed |= ((((w[j] >> sh) & mask) - half) & 0xFFu) << (8 * (3 - j));
      dp[lev * (n / 4)] = packed;
    }
  }
}

// The products of one pass of a step over the warp's chunks [kc_lo,
// kc_hi) of the contraction (r, j'), into d: chunk kc = r * n/32 + j0/32,
// A[g][k] = the digits at byte 32*kc + k of row g (this lane's ldmatrix row
// at a_lane in each of the R row tiles of 16, a_rt bytes apart: every B
// window feeds R products), B'[k][t] = E[limb][comp][r][t + j0 + k + 1]
// (this lane's tiles at bo, limbs lstride bytes apart in the stage at byte
// stage_at of the dynamic shared memory, which this function names itself
// so that every window is a shared load).  The operands of chunk kc + 1
// are loaded while chunk kc's products issue.  The warp's tiles are first
// .. first + NT - 1 of the CTA's `tiles`; `flat`: all of them in the span
// and in one component.
template <int R, int L, int NT>
__device__ __forceinline__ void products(int (&d)[R][L][NT][4],
                                         int stage_at, int lstride,
                                         uint32_t a_lane, int a_rt,
                                         const int (&bo)[NT], bool flat,
                                         int first, int tiles, int kc_lo,
                                         int kc_hi, int cl, int two_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int8_t* stage = reinterpret_cast<const int8_t*>(smem + stage_at);
  if (flat) {
    // the group's NT + 2 windows a limb, at bo[0] + ko + 8m; the next chunk
    // of the same row starts 32 bytes (4 windows) on, so its first NT - 2
    // are this chunk's last (slide) and only 4 are loaded
    auto load = [&](int kc, uint32_t(&a)[R][4], uint32_t(&bw)[L][NT + 2],
                    const uint32_t(&prev)[L][NT + 2], bool slide) {
#pragma unroll
      for (int rt = 0; rt < R; ++rt)
        ldmatrix_x4(a[rt], a_lane + rt * a_rt + 32 * kc);
      const int ko = (kc >> cl) * two_n + ((kc & ((1 << cl) - 1)) << 5);
      if (slide) {
#pragma unroll
        for (int lb = 0; lb < L; ++lb)
#pragma unroll
          for (int m = 0; m < NT + 2; ++m)
            bw[lb][m] = m < NT - 2 ? prev[lb][m + 4]
                                   : window(stage + lb * lstride,
                                            bo[0] + ko + 8 * m);
      } else {
#pragma unroll
        for (int lb = 0; lb < L; ++lb)
#pragma unroll
          for (int m = 0; m < NT + 2; ++m)
            bw[lb][m] = window(stage + lb * lstride, bo[0] + ko + 8 * m);
      }
    };
    auto product = [&](const uint32_t(&a)[R][4],
                       const uint32_t(&bw)[L][NT + 2]) {
#pragma unroll
      for (int lb = 0; lb < L; ++lb)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int rt = 0; rt < R; ++rt)
            mma_s8(d[rt][lb][nt], a[rt], bw[lb][nt], bw[lb][nt + 2]);
    };
    uint32_t a0[R][4], w0[L][NT + 2], a1[R][4], w1[L][NT + 2];
    if (kc_lo < kc_hi) load(kc_lo, a0, w0, w1, false);
    for (int kc = kc_lo; kc < kc_hi; kc += 2) {
      if (kc + 1 < kc_hi)
        load(kc + 1, a1, w1, w0, (kc + 1) >> cl == kc >> cl);
      product(a0, w0);
      if (kc + 1 < kc_hi) {
        if (kc + 2 < kc_hi)
          load(kc + 2, a0, w0, w1, (kc + 2) >> cl == (kc + 1) >> cl);
        product(a1, w1);
      }
    }
  } else {
    // each tile's two windows of its own
    auto load = [&](int kc, uint32_t(&a)[R][4], uint32_t(&bw)[NT][L][2]) {
#pragma unroll
      for (int rt = 0; rt < R; ++rt)
        ldmatrix_x4(a[rt], a_lane + rt * a_rt + 32 * kc);
      const int ko = (kc >> cl) * two_n + ((kc & ((1 << cl) - 1)) << 5);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (first + nt < tiles)
#pragma unroll
          for (int lb = 0; lb < L; ++lb) {
            const int8_t* er = stage + lb * lstride;
            bw[nt][lb][0] = window(er, bo[nt] + ko);
            bw[nt][lb][1] = window(er, bo[nt] + ko + 16);
          }
    };
    auto product = [&](const uint32_t(&a)[R][4],
                       const uint32_t(&bw)[NT][L][2]) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (first + nt < tiles)
#pragma unroll
          for (int lb = 0; lb < L; ++lb)
#pragma unroll
            for (int rt = 0; rt < R; ++rt)
              mma_s8(d[rt][lb][nt], a[rt], bw[nt][lb][0], bw[nt][lb][1]);
    };
    uint32_t a0[R][4], b0[NT][L][2], a1[R][4], b1[NT][L][2];
    if (kc_lo < kc_hi) load(kc_lo, a0, b0);
    for (int kc = kc_lo; kc < kc_hi; kc += 2) {
      if (kc + 1 < kc_hi) load(kc + 1, a1, b1);
      product(a0, b0);
      if (kc + 1 < kc_hi) {
        if (kc + 2 < kc_hi) load(kc + 2, a0, b0);
        product(a1, b1);
      }
    }
  }
}

template <int L, int NT, int PASSES_ALL>
__global__ void __launch_bounds__(kThreadsS)
k1s_kernel(const int32_t* __restrict__ b_init,
           const int32_t* __restrict__ a_t, const int32_t* __restrict__ tv,
           const int8_t* __restrict__ keys, int32_t* __restrict__ out,
           int steps, int batch, int n, int k1, int l, int b, int cluster) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int rank = static_cast<int>(cluster_rank());
  const int g0 = (blockIdx.x / cluster) * kCB;  // first ciphertext of the tile
  const int live = min(kCB, batch - g0);        // its rows inside the batch
  const int log_n = __ffs(n) - 1;
  const int accw = n + kAccPad, rows = k1 * l, two_n = 2 * n;
  // PASSES_ALL: one pass of all k1 components a step; else one a component
  const int passes = PASSES_ALL ? 1 : k1, cpp = k1 / passes;
  const int prow = rows / passes;             // E rows (digit rows) a pass
  const int drow = prow * n + kDigPad;        // bytes a digit row
  const int span = k1 * n / cluster, q_lo = rank * span;
  const int tiles = span / 8;                 // n8 output tiles of the CTA
  const int c_lo = q_lo >> log_n;             // the CTA's first component
  const int nc = ((q_lo + span - 1) >> log_n) - c_lo + 1;
  const int run = prow * two_n;               // bytes a (limb, comp) copy
  // warp = (contraction slice ks, tile group tg): the group's NT tiles over
  // the slice's chunks of every pass
  const int groups = tile_groups(tiles, NT), slices = kWarps / groups;
  const int tg = warp % groups, ks = warp / groups;
  const int rs = span + kRedPad;              // words a partial-sum row
  const Layout lay = layout(n, k1, l, L, cluster, passes, NT);
  constexpr int drop = 4 - L;
  const int acc_words = k1 * kCB * accw;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);  // 2 x [k1][kCB][accw]
  int8_t* dig = reinterpret_cast<int8_t*>(smem + lay.dig);
  int8_t* es = reinterpret_cast<int8_t*>(smem + lay.es);  // 2 stages
  int* amt = reinterpret_cast<int*>(smem + lay.amt);      // 2 x [kCB]
  const uint32_t bar = smem_u32(smem + lay.bar);          // 2 mbarriers

  // the E rows of pass u (step u / passes, pass u % passes) of every limb
  // and of this CTA's components into stage u & 1, by warp 0
  auto fetch = [&](int u) {
    const int i = u / passes, p = u - i * passes;
    const uint32_t full = bar + 8 * (u & 1);
    const uint32_t dst = smem_u32(es + (u & 1) * lay.stage);
    if (lane == 0) mbar_expect_tx(full, L * nc * run);
    __syncwarp();
    for (int j = lane; j < L * nc; j += 32) {
      const int lb = j / nc, c = j - lb * nc;
      bulk_load(dst + j * run,
                keys + ((static_cast<size_t>(i) * L * k1 + lb * k1 + c_lo +
                         c) * rows + p * prow) * two_n,
                run, full);
    }
  };

  // the first pass's keys come while the tile's ACC is set up
  if (warp == 0) {
    if (lane == 0) {
      mbar_init(bar, 1);
      mbar_init(bar + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    fetch(0);
  }
  // ACC = (0, ..., 0, X^{b_init} * tv), the whole tile, in buffer 0
  for (int e = tid; e < k1 * kCB * n; e += kThreadsS) {
    const int c = e >> (log_n + 4), g = (e >> log_n) & (kCB - 1);
    const int t = e & (n - 1);
    uint32_t v = 0;
    if (c == k1 - 1 && g < live)
      v = rotated_coef(reinterpret_cast<const uint32_t*>(tv) +
                           static_cast<size_t>(g0 + g) * n,
                       t, b_init[g0 + g], n);
    acc[(c * kCB + g) * accw + t] = v;
  }
  if (tid < kCB) amt[tid] = tid < live ? a_t[g0 + tid] : 0;
  // every CTA of the cluster runs and has its ACC, and every thread sees
  // the mbarriers: remote stores and waits may start
  cluster_barrier();

  // this lane's ldmatrix row of the digits, and its tiles' columns in a
  // stage plus 4*tig + 1 (B'[k][t] = E[t + j' + 1])
  const uint32_t a_lane = smem_u32(dig) +
                          ((lane & 7) + ((lane >> 3) & 1) * 8) * drow +
                          16 * (lane >> 4);
  int bo[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int q = q_lo + 8 * (tg * NT + nt) + gid;
    bo[nt] = ((q >> log_n) - c_lo) * prow * two_n + (q & (n - 1)) +
             4 * tig + 1;
  }
  const int chunks = prow * (n >> 5), cl = log_n - 5;  // 32-byte chunks
  const int kc_lo = ks * chunks / slices, kc_hi = (ks + 1) * chunks / slices;
  const int lstride = nc * run;  // bytes from one limb's rows to the next

  int d[L][NT][4];
  for (int i = 0, u = 0; i < steps; ++i) {
    const uint32_t* cur = acc + (i & 1) * acc_words;
    uint32_t* nxt = acc + ((i + 1) & 1) * acc_words;
    // the next step's amounts: loaded now, stored after this step's digits
    int next_amt = 0;
    if (tid < live && i + 1 < steps)
      next_amt = __ldg(a_t + static_cast<size_t>(i + 1) * batch + g0 + tid);
#pragma unroll
    for (int lb = 0; lb < L; ++lb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[lb][nt][r] = 0;

    for (int p = 0; p < passes; ++p, ++u) {
      // the previous pass's products are done with the digits and with
      // stage (u + 1) & 1 (at p = 0: the step's cluster barrier)
      if (p > 0) __syncthreads();
      if (warp == 0 && u + 1 < steps * passes) fetch(u + 1);
      write_digits(cur, dig, amt + (i & 1) * kCB, p * cpp, cpp, live, n,
                   log_n, l, b, accw, drow);
      __syncthreads();
      mbar_wait(bar + 8 * (u & 1), (u >> 1) & 1);

      // products over the warp's chunks of the pass's contraction (r, j'):
      // chunk kc = r * n/32 + j0/32, A[g][k] = digits at byte 32*kc + k of
      // row g, B'[k][t] = E[limb][comp][r][t + j0 + k + 1]; the operands of
      // chunk kc + 1 are loaded while chunk kc's products issue
      const int8_t* stage = es + (u & 1) * lay.stage;
      auto load = [&](int kc, uint32_t(&a)[4], uint32_t(&bw)[NT][L][2]) {
        ldmatrix_x4(a, a_lane + 32 * kc);
        const int ko = (kc >> cl) * two_n + ((kc & ((1 << cl) - 1)) << 5);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (tg * NT + nt < tiles)
#pragma unroll
            for (int lb = 0; lb < L; ++lb) {
              const int8_t* er = stage + lb * lstride;
              bw[nt][lb][0] = window(er, bo[nt] + ko);
              bw[nt][lb][1] = window(er, bo[nt] + ko + 16);
            }
      };
      auto product = [&](const uint32_t(&a)[4],
                         const uint32_t(&bw)[NT][L][2]) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (tg * NT + nt < tiles)
#pragma unroll
            for (int lb = 0; lb < L; ++lb)
              mma_s8(d[lb][nt], a, bw[nt][lb][0], bw[nt][lb][1]);
      };
      uint32_t a0[4], b0[NT][L][2], a1[4], b1[NT][L][2];
      if (kc_lo < kc_hi) load(kc_lo, a0, b0);
      for (int kc = kc_lo; kc < kc_hi; kc += 2) {
        if (kc + 1 < kc_hi) load(kc + 1, a1, b1);
        product(a0, b0);
        if (kc + 1 < kc_hi) {
          if (kc + 2 < kc_hi) load(kc + 2, a0, b0);
          product(a1, b1);
        }
      }
    }

    // the slice's partial sums, limbs shifted in (mod 2^32), into red
    // [ks][g][column of the span], in the stage the step's last pass is
    // done with once every warp's products are (its next fill is issued
    // after the cluster barrier)
    uint32_t* red =
        reinterpret_cast<uint32_t*>(es + ((u - 1) & 1) * lay.stage);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int tile = tg * NT + nt;
      if (tile < tiles) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v0 = 0, v1 = 0;
#pragma unroll
          for (int lb = 0; lb < L; ++lb) {
            const uint32_t sh = 8u * static_cast<uint32_t>(lb + drop);
            v0 += static_cast<uint32_t>(d[lb][nt][2 * h]) << sh;
            v1 += static_cast<uint32_t>(d[lb][nt][2 * h + 1]) << sh;
          }
          *reinterpret_cast<uint2*>(
              red + (ks * kCB + gid + 8 * h) * rs + 8 * tile + 2 * tig) =
              make_uint2(v0, v1);
        }
      }
    }
    fence_async_shared();  // before the stage's next cp.async.bulk fill
    __syncthreads();

    // ACC[comp] += the slices' sums on the CTA's span: read from this CTA's
    // copy of buffer i&1, stored into buffer (i+1)&1 of every CTA's copy (no
    // CTA reads buffer (i+1)&1 before the cluster barrier below)
    const uint32_t nxt_s = smem_u32(nxt);
    const int pairs = span / 2;
    for (int e = tid; e < live * pairs; e += kThreadsS) {
      const int g = e / pairs, c = 2 * (e - g * pairs);
      const int q = q_lo + c, co = q >> log_n, t = q & (n - 1);
      const int off = (co * kCB + g) * accw + t;
      uint32_t v0 = cur[off], v1 = cur[off + 1];
      for (int k = 0; k < slices; ++k) {
        const uint2 part =
            *reinterpret_cast<const uint2*>(red + (k * kCB + g) * rs + c);
        v0 += part.x;
        v1 += part.y;
      }
      for (int j = 0; j < cluster; ++j) {
        const int peer = rank + j < cluster ? rank + j : rank + j - cluster;
        store_to(nxt_s + 4 * off, peer, v0, v1);
      }
    }
    if (tid < kCB) amt[((i + 1) & 1) * kCB + tid] = next_amt;
    cluster_barrier();
  }

  // the CTA's span of the final ACC, buffer steps & 1
  const uint32_t* fin = acc + (steps & 1) * acc_words;
  uint32_t* o = reinterpret_cast<uint32_t*>(out);  // [k1][batch][n]
  for (int e = tid; e < live * span; e += kThreadsS) {
    const int g = e / span, q = q_lo + e - g * span;
    const int c = q >> log_n, t = q & (n - 1);
    o[(static_cast<size_t>(c) * batch + g0 + g) * n + t] =
        fin[(c * kCB + g) * accw + t];
  }
}

// K1 at N >= 256 for launches of few tiles: the small-tile plan.  A
// cluster of C CTAs a tile of CB ciphertexts (16 or 32: R = CB/16 row
// tiles of mma.sync), CTA r the columns [r*span, (r+1)*span) of the
// (k+1)*N with all their limbs, its wide_warps(CB) warps in exactly as many
// groups of NT n8 tiles as the span needs, as k1s_kernel does; but
// a CTA keeps only its span of the ACC (a tile's whole ACC, 100 KB at
// k=2, N=512, would leave no room for the digits and two key stages).  A
// step:
// * the digits of the CTA's span, 8 coefficients an item: the rotated
//   source words X^a * ACC[c] needs are read from the CTAs that own them
//   (three aligned 16-byte loads over distributed shared memory, each
//   inside one owner's span), the item's l words of digits stored into
//   every CTA's copy of the digits;
// * a cluster barrier (every CTA's digits everywhere; every read of a span
//   done);
// * the products over all the step's rows, one pass, from the key stage
//   that came in while the previous step ran (products());
// * the slices' sums added into the CTA's span, in place;
// * a cluster barrier (the new spans readable; every CTA done with its
//   digits).
// Rows past the batch keep zero digits (set once) and are never stored.
template <int CB, int L, int NT>
__global__ void __launch_bounds__(32 * wide_warps(CB))
k1s_kernel_wide(const int32_t* __restrict__ b_init,
                const int32_t* __restrict__ a_t,
                const int32_t* __restrict__ tv,
                const int8_t* __restrict__ keys, int32_t* __restrict__ out,
                int steps, int batch, int n, int k1, int l, int b,
                int cluster) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int rank = static_cast<int>(cluster_rank());
  const int g0 = (blockIdx.x / cluster) * CB;  // first ciphertext of the tile
  const int live = min(CB, batch - g0);        // its rows inside the batch
  const int log_n = __ffs(n) - 1;
  const int rows = k1 * l, two_n = 2 * n;
  const int drow = rows * n + kDigPad;        // bytes a digit row
  const int span = k1 * n / cluster, q_lo = rank * span;
  const int accw = span + kAccPad;            // words a row of the span
  const int tiles = span / 8;                 // n8 output tiles of the CTA
  const int c_lo = q_lo >> log_n;             // the CTA's first component
  const int nc = ((q_lo + span - 1) >> log_n) - c_lo + 1;
  const int run = rows * two_n;               // bytes a (limb, comp) copy
  constexpr int kT = 32 * wide_warps(CB);      // threads a CTA
  const int groups = wide_groups(tiles, NT);
  const int slices = wide_warps(CB) / groups;
  const int tg = warp % groups, ks = warp / groups;
  const int rs = span + kRedPad;              // words a partial-sum row
  const Layout lay = layout_wide(n, k1, l, L, cluster, NT, CB);
  constexpr int drop = 4 - L, R = CB / 16;  // R row tiles of 16
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);  // [CB][accw]
  int8_t* dig = reinterpret_cast<int8_t*>(smem + lay.dig);
  int8_t* es = reinterpret_cast<int8_t*>(smem + lay.es);  // 2 stages
  int* amt = reinterpret_cast<int*>(smem + lay.amt);      // 2 x [CB]
  const uint32_t bar = smem_u32(smem + lay.bar);          // 2 mbarriers
  const uint32_t acc_s = smem_u32(acc), dig_s = smem_u32(dig);

  // every row of step i of every limb and of this CTA's components into
  // stage i & 1, by warp 0
  auto fetch = [&](int i) {
    const uint32_t full = bar + 8 * (i & 1);
    const uint32_t dst = smem_u32(es + (i & 1) * lay.stage);
    if (lane == 0) mbar_expect_tx(full, L * nc * run);
    __syncwarp();
    for (int j = lane; j < L * nc; j += 32) {
      const int lb = j / nc, c = j - lb * nc;
      bulk_load(dst + j * run,
                keys + (static_cast<size_t>(i) * L * k1 + lb * k1 + c_lo +
                        c) * rows * two_n,
                run, full);
    }
  };

  if (warp == 0) {
    if (lane == 0) {
      mbar_init(bar, 1);
      mbar_init(bar + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    fetch(0);
  }
  // the span of ACC = (0, ..., 0, X^{b_init} * tv); zero digits
  for (int e = tid; e < CB * span; e += kT) {
    const int g = e / span, j = e - g * span;
    const int q = q_lo + j, c = q >> log_n;
    uint32_t v = 0;
    if (c == k1 - 1 && g < live)
      v = rotated_coef(reinterpret_cast<const uint32_t*>(tv) +
                           static_cast<size_t>(g0 + g) * n,
                       q & (n - 1), b_init[g0 + g], n);
    acc[g * accw + j] = v;
  }
  for (int e = tid; e < CB * drow / 16; e += kT)
    reinterpret_cast<uint4*>(dig)[e] = make_uint4(0, 0, 0, 0);
  if (tid < CB) amt[tid] = tid < live ? a_t[g0 + tid] : 0;
  cluster_barrier();

  const uint32_t a_lane = smem_u32(dig) +
                          ((lane & 7) + ((lane >> 3) & 1) * 8) * drow +
                          16 * (lane >> 4);
  int bo[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int q = q_lo + 8 * (tg * NT + nt) + gid;
    bo[nt] = ((q >> log_n) - c_lo) * rows * two_n + (q & (n - 1)) +
             4 * tig + 1;
  }
  const int q_first = q_lo + 8 * tg * NT;
  const bool flat = (tg + 1) * NT <= tiles &&
                    q_first >> log_n == (q_first + 8 * NT - 1) >> log_n;
  const int chunks = rows * (n >> 5), cl = log_n - 5;  // 32-byte chunks
  const int kc_lo = ks * chunks / slices, kc_hi = (ks + 1) * chunks / slices;
  const int lstride = nc * run;
  const int bl = b * l, half = 1 << (b - 1);
  const uint32_t mask = (1u << b) - 1, rnd = 1u << (31 - bl);
  uint32_t bias = 0;
  for (int j = 0; j < l; ++j) bias += static_cast<uint32_t>(half) << (b * j);
  const int octs = span >> 3;  // 8-coefficient items a row of the span

  int d[R][L][NT][4];
  for (int i = 0; i < steps; ++i) {
    int next_amt = 0;
    if (tid < live && i + 1 < steps)
      next_amt = __ldg(a_t + static_cast<size_t>(i + 1) * batch + g0 + tid);
    if (warp == 0 && i + 1 < steps) fetch(i + 1);

    // the digits of the span, into every CTA's copy: coefficient t of
    // (component c, level lev) at column (c*l + lev)*n + n-1-t
    for (int e = tid; e < live * octs; e += kT) {
      const int g = e / octs, j0 = 8 * (e - g * octs);
      const int q = q_lo + j0, c = q >> log_n, t0 = q & (n - 1);
      const int a = amt[(i & 1) * CB + g], am = a & (n - 1);
      const bool flip = (a & n) != 0;
      // rotated_coef(row, t0 + j, a, n) for j < 8: the words (t0 + j - a)
      // mod n, from the three aligned 16-byte blocks that hold them
      const int from = (t0 - am) & (n - 1), sh4 = from & 3, blk = from & ~3;
      uint32_t x[12];
#pragma unroll
      for (int h = 0; h < 3; ++h) {
        const int src = c * n + ((blk + 4 * h) & (n - 1));
        const int owner = src / span;
        const uint4 v =
            load_from(acc_s + 4 * (g * accw + src - owner * span), owner);
        x[4 * h] = v.x;
        x[4 * h + 1] = v.y;
        x[4 * h + 2] = v.z;
        x[4 * h + 3] = v.w;
      }
      const uint4 o0 = *reinterpret_cast<const uint4*>(acc + g * accw + j0);
      const uint4 o1 =
          *reinterpret_cast<const uint4*>(acc + g * accw + j0 + 4);
      const uint32_t o[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      uint32_t z[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) z[k] = (sh4 & 2) ? x[k + 2] : x[k];
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t v = (sh4 & 1) ? z[j + 1] : z[j];  // x[sh4 + j]
        const uint32_t rot = ((t0 + j < am) != flip) ? 0u - v : v;
        w[j] = ((rot - o[j] + rnd) >> (32 - bl)) + bias;
      }
      for (int lev = 0; lev < l; ++lev) {
        const int sh = b * (l - 1 - lev);
        // bytes n-8-t0 .. n-1-t0: coefficients t0+7 .. t0
        uint32_t p0 = 0, p1 = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p0 |= ((((w[7 - j] >> sh) & mask) - half) & 0xFFu) << (8 * j);
          p1 |= ((((w[3 - j] >> sh) & mask) - half) & 0xFFu) << (8 * j);
        }
        const uint32_t at = dig_s + g * drow + (c * l + lev) * n + n - 8 - t0;
        for (int j = 0; j < cluster; ++j) {
          const int peer = rank + j < cluster ? rank + j : rank + j - cluster;
          store_to(at, peer, p0, p1);
        }
      }
    }
    // every CTA's digits in every copy, every read of a span done
    cluster_barrier();

#pragma unroll
    for (int rt = 0; rt < R; ++rt)
#pragma unroll
      for (int lb = 0; lb < L; ++lb)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) d[rt][lb][nt][r] = 0;
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    products<R, L, NT>(d, lay.es + (i & 1) * lay.stage, lstride, a_lane,
                       16 * drow, bo, flat, tg * NT, tiles, kc_lo, kc_hi, cl,
                       two_n);

    // the slice's partial sums, limbs shifted in, into red [ks][g][column],
    // in the stage the products are done with
    uint32_t* red = reinterpret_cast<uint32_t*>(es + (i & 1) * lay.stage);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int tile = tg * NT + nt;
      if (tile < tiles) {
#pragma unroll
        for (int rt = 0; rt < R; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t v0 = 0, v1 = 0;
#pragma unroll
            for (int lb = 0; lb < L; ++lb) {
              const uint32_t sh = 8u * static_cast<uint32_t>(lb + drop);
              v0 += static_cast<uint32_t>(d[rt][lb][nt][2 * h]) << sh;
              v1 += static_cast<uint32_t>(d[rt][lb][nt][2 * h + 1]) << sh;
            }
            *reinterpret_cast<uint2*>(
                red + (ks * CB + 16 * rt + gid + 8 * h) * rs + 8 * tile +
                2 * tig) = make_uint2(v0, v1);
          }
      }
    }
    fence_async_shared();  // before the stage's next cp.async.bulk fill
    __syncthreads();
    // the span += the slices' sums, four columns at a time
    const int quads = span / 4;
    for (int e = tid; e < live * quads; e += kT) {
      const int g = e / quads, c = 4 * (e - g * quads);
      uint4* at = reinterpret_cast<uint4*>(acc + g * accw + c);
      uint4 v = *at;
      for (int k = 0; k < slices; ++k) {
        const uint4 part =
            *reinterpret_cast<const uint4*>(red + (k * CB + g) * rs + c);
        v.x += part.x;
        v.y += part.y;
        v.z += part.z;
        v.w += part.w;
      }
      *at = v;
    }
    if (tid < CB) amt[((i + 1) & 1) * CB + tid] = next_amt;
    // the new spans readable, every CTA done with its digits
    cluster_barrier();
  }

  uint32_t* o = reinterpret_cast<uint32_t*>(out);  // [k1][batch][n]
  for (int e = tid; e < live * span; e += kT) {
    const int g = e / span, j = e - g * span;
    const int q = q_lo + j, c = q >> log_n, t = q & (n - 1);
    o[(static_cast<size_t>(c) * batch + g0 + g) * n + t] = acc[g * accw + j];
  }
}

// Launches (L, NT, PASSES_ALL) of k1s_kernel, or at N >= 256 (CB > 0) of
// k1s_kernel_wide<CB, L, NT> (one pass a step).
template <int L, int NT, int PASSES_ALL, int CB>
cudaError_t launch(const void* b_init, const void* a_t, const void* tv,
                   const void* keys, void* out, int steps, int batch, int n,
                   int k1, int l, int b, int cluster, cudaStream_t stream) {
  auto kern = k1s_kernel<L, NT, PASSES_ALL>;
  int smem = layout(n, k1, l, L, cluster, PASSES_ALL ? 1 : k1, NT).total;
  int tile = kCB, threads = kThreadsS;
  if constexpr (CB > 0) {
    kern = k1s_kernel_wide<CB, L, NT>;
    smem = layout_wide(n, k1, l, L, cluster, NT, CB).total;
    tile = CB;
    threads = 32 * wide_warps(CB);
  }
  cudaError_t err = prepare_kernel(kern, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config((batch + tile - 1) / tile * cluster, cluster, smem, attr,
                     stream, threads);
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const int32_t*>(b_init),
                           static_cast<const int32_t*>(a_t),
                           static_cast<const int32_t*>(tv),
                           static_cast<const int8_t*>(keys),
                           static_cast<int32_t*>(out), steps, batch, n, k1, l,
                           b, cluster);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of that kernel at this shape the current card runs at once
// (cudaOccupancyMaxActiveClusters).
template <int L, int NT, int PASSES_ALL, int CB>
cudaError_t resident(int n, int k1, int l, int cluster, int* clusters) {
  auto kern = k1s_kernel<L, NT, PASSES_ALL>;
  int smem = layout(n, k1, l, L, cluster, PASSES_ALL ? 1 : k1, NT).total;
  int threads = kThreadsS;
  if constexpr (CB > 0) {
    kern = k1s_kernel_wide<CB, L, NT>;
    smem = layout_wide(n, k1, l, L, cluster, NT, CB).total;
    threads = 32 * wide_warps(CB);
  }
  return max_active_clusters(kern, cluster, smem, clusters, threads);
}

// Shared memory a CTA of the plan takes at the shape.
inline int smem_of(int n, int k1, int l, int limbs, int cb, int cluster,
                   int nt, int passes) {
  return n >= 256 ? layout_wide(n, k1, l, limbs, cluster, nt, cb).total
                  : layout(n, k1, l, limbs, cluster, passes, nt).total;
}

// The shapes the kernel serves: N a power of two in [32, 128] on tiles of
// kCB and clusters of at most kMaxCluster CTAs, one pass a step or one a
// component; or, by k1s_kernel_wide, in [256, kMaxNWide] with (k+1)*N at
// most kMaxKnWide on tiles of 16 or 32 and clusters of at most
// kMaxClusterWide, one pass a step; spans of whole n8 tiles, in groups of
// nt a warp that divide the warps; the layout within the kSmemMax bytes a
// CTA may have.
inline bool serves(int n, int k1, int l, int limbs, int cb, int cluster,
                   int nt, int passes) {
  const bool wide = n >= 256;
  if (n < 32 || (n & (n - 1)) || k1 < 2 || l < 1 || cluster < 1 ||
      (k1 * n) % cluster ||
      (wide ? n > kMaxNWide || k1 * n > kMaxKnWide ||
                  cluster > kMaxClusterWide || passes != 1 ||
                  (cb != 16 && cb != 32)
            : n > 128 || cluster > kMaxCluster || cb != kCB ||
                  (passes != 1 && passes != k1)))
    return false;
  const int span = k1 * n / cluster;
  const int groups =
      wide ? wide_groups(span / 8, nt) : tile_groups(span / 8, nt);
  const int warps = wide ? wide_warps(cb) : kWarps;
  return span % 8 == 0 && groups <= warps && warps % groups == 0 &&
         smem_of(n, k1, l, limbs, cb, cluster, nt, passes) <= kSmemMax;
}

}  // namespace k1s
}  // namespace fbr

// (limbs, n8 output tiles a warp); at N >= 256 the limbs the optimizer
// picks and 4 tiles a warp (3, all warps busy at 12 and 24 tiles, was
// slower: 4 new windows for 3 products a chunk in place of 4)
#define FBR_K1S_CASES(X)                                                   \
  X(1, 1) X(1, 2) X(1, 4) X(2, 1) X(2, 2) X(2, 4) X(3, 1) X(3, 2) X(3, 4) \
  X(4, 1) X(4, 2) X(4, 4)
#define FBR_K1S_WIDE_CASES(X) X(3, 4) X(4, 4)

// C entry: returns the launch's cudaError_t (0 on success).  The plan
// (k1_small_plan, k1_wide_plan): tiles of `cb` ciphertexts (16; at N >= 256
// 16 or 32) on `cluster` CTAs, `nt` n8 output tiles a warp (1, 2 or 4: a
// CTA's warps are groups of them, each group's warps splitting the
// contraction, tile_groups), `passes` digit passes a step
// (1: all k+1 components at once; k+1: one a component, below N = 256).
// N a power of two in [32, 128], or in [256, 512] at (k+1)*N <= 1536.
extern "C" int fbr_k1s_blind_rotate(const void* b_init, const void* a_t,
                                    const void* tv, const void* keys,
                                    void* out, int steps, int batch, int n,
                                    int k1, int l, int b, int n_limbs, int cb,
                                    int cluster, int nt, int passes,
                                    void* stream) {
  using namespace fbr::k1s;
  if (!serves(n, k1, l, n_limbs, cb, cluster, nt, passes))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define FBR_K1S_LAUNCH(L, NT)                                                \
  if (n_limbs == L && nt == NT)                                              \
    return static_cast<int>(                                                 \
        passes == 1 ? launch<L, NT, 1, 0>(b_init, a_t, tv, keys, out, steps, \
                                          batch, n, k1, l, b, cluster, st)   \
                    : launch<L, NT, 0, 0>(b_init, a_t, tv, keys, out, steps, \
                                          batch, n, k1, l, b, cluster, st));
#define FBR_K1S_LAUNCH_WIDE(L, NT)                                           \
  if (n_limbs == L && nt == NT)                                              \
    return static_cast<int>(                                                 \
        cb == 16 ? launch<L, NT, 1, 16>(b_init, a_t, tv, keys, out, steps,   \
                                        batch, n, k1, l, b, cluster, st)     \
                 : launch<L, NT, 1, 32>(b_init, a_t, tv, keys, out, steps,   \
                                        batch, n, k1, l, b, cluster, st));
  if (n >= 256) {
    FBR_K1S_WIDE_CASES(FBR_K1S_LAUNCH_WIDE)
  } else {
    FBR_K1S_CASES(FBR_K1S_LAUNCH)
  }
#undef FBR_K1S_LAUNCH
#undef FBR_K1S_LAUNCH_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a CTA of the plan (cb, cluster, nt, passes)
// launches with at (n, k1, l, n_limbs), into *smem, and the clusters the
// current card runs at once, into *clusters.
extern "C" int fbr_k1s_layout(int n, int k1, int l, int n_limbs, int cb,
                              int cluster, int nt, int passes, int* smem,
                              int* clusters) {
  using namespace fbr::k1s;
  if (!serves(n, k1, l, n_limbs, cb, cluster, nt, passes))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_of(n, k1, l, n_limbs, cb, cluster, nt, passes);
#define FBR_K1S_RESIDENT(L, NT)                                              \
  if (n_limbs == L && nt == NT)                                              \
    return static_cast<int>(                                                 \
        passes == 1 ? resident<L, NT, 1, 0>(n, k1, l, cluster, clusters)     \
                    : resident<L, NT, 0, 0>(n, k1, l, cluster, clusters));
#define FBR_K1S_RESIDENT_WIDE(L, NT)                                         \
  if (n_limbs == L && nt == NT)                                              \
    return static_cast<int>(                                                 \
        cb == 16 ? resident<L, NT, 1, 16>(n, k1, l, cluster, clusters)       \
                 : resident<L, NT, 1, 32>(n, k1, l, cluster, clusters));
  if (n >= 256) {
    FBR_K1S_WIDE_CASES(FBR_K1S_RESIDENT_WIDE)
  } else {
    FBR_K1S_CASES(FBR_K1S_RESIDENT)
  }
#undef FBR_K1S_RESIDENT
#undef FBR_K1S_RESIDENT_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}
