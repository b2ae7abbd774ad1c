// K2, the "fused" blind rotation, for Hopper (sm_90a): all n CMux steps of
// a tile of ciphertexts in one launch, the contraction on int8 tensor cores.
//
// Replaces _kernel of tfhe_fbs_map_tpu/ops/fused_blind_rotate.py (:102-142).
// Keys: [n, ncol, K] int8, K-major, with K = rows*N = (k+1)*l*N contraction
// rows (r, j) and ncol = L*(k+1)*N output columns (limb, comp, t).  Each
// step i is one GEMM and a shift-add per limb:
//   P = digits [B, K] x M_i^T
//   ACC[comp] += sum_limb P[:, limb, comp] << 8*(limb + drop)
//
// What bounds it: a step's key is K*ncol bytes (18.9 MB at the aes128_p4
// preset, 10.9 GB a launch), and each key byte brought into an SM feeds as
// many MACs as there are ciphertexts sharing it.  The TPU kernel ran a VMEM
// slice of hundreds of ciphertexts against each key chunk.  Here:
//
// * A tile of CB (16, 32, 64 or 128) ciphertexts is shared by a thread-block
//   cluster of C CTAs.  CTA r owns coefficients [r*span, (r+1)*span) of the
//   flattened (comp, t) axis, span = (k+1)*N / C, with all L limbs of them:
//   it reads only its L*span key columns, K*L*span bytes a step, and its
//   limb shift-add stays inside the CTA.
// * ACC lives in the output tensor [k+1, B, N] (L2-resident; every CTA
//   updates only its own coefficients).  Each CTA computes the digits of
//   its own coefficients of X^{a_i}*ACC - ACC, reading the rotated source
//   coefficient wherever it lies, into a [tiles*CB, K] int8 scratch.  Two
//   cluster barriers a step order ACC writes before digit reads and digit
//   writes before the GEMM reads them; ACC goes through L2 only (.cg).
// * The GEMM: per column chunk of 64 coefficients (x L limbs) the CTA
//   streams K in 128-byte slices through a ring of `stages` shared-memory
//   stages.  One thread fills a stage with TMA (cp.async.bulk.tensor, 128B
//   swizzle, completion on the stage's mbarrier): 64 or 128 digit rows and
//   the chunk's L*64 key rows.  Two warpgroups, each owning 32 of the
//   chunk's coefficients with all their limbs, run wgmma m64n(32L)k32
//   s8*s8->s32 (once per 64 rows) straight from shared memory with the sums
//   in registers.  One wgmma group stays in flight while the stage of the
//   previous slice is refilled, so the products overlap the loads.
// * On the H100 the ring's loads bound it: a CTA takes in ~50-80 GB/s of
//   digit and key tiles, so a plan's time follows the bytes each CTA
//   streams, (max(CB, 64) + 64 L) * K * span / 64 a step (k2_plan in
//   ops/fused_blind_rotate.py).  The digit pass and the two barriers take
//   about a fifth of a launch.
// * Exactness: |digit| <= 2^(b-1) <= 128, |key| <= 128 and K <= 12,288, so
//   each int32 partial sum stays below 2^28.  The limb shifts and the ACC
//   adds are uint32_t (mod 2^32).  wgmma runs 64-row blocks: rows past the
//   tile or the batch are never stored, and digit rows past the scratch
//   are TMA's zero fill.
//
// Later work: loading the next step's key tiles during the digit pass.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_blind_rotate.cuh"

namespace fbr {
namespace k2 {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kChunk = 64;        // coefficients per column chunk
constexpr int kHalf = kChunk / 2;  // coefficients per warpgroup
constexpr int kKc = 128;          // contraction bytes a stage: a swizzle row
constexpr int kM = 64;            // wgmma's M: digit rows per block
constexpr int kUnroll = 4;  // digit-pass groups of 4 coefficients in flight
constexpr int kSpin = 1 << 24;  // mbarrier polls (seconds) before a trap

// One ring stage: MT blocks of 64 digit rows, then the key rows.
template <int L, int MT>
struct Stage {
  static constexpr int kA = MT * kM * kKc;       // digits [MT*64][128]
  static constexpr int kB = L * kChunk * kKc;    // key [2][L][32][128]
  static constexpr int kBytes = kA + kB;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: what this thread wrote to
// global memory before is visible to the cluster after, TMA reads included.
__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` to complete; trap instead of
// hanging if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kSpin) __trap();
  }
}

// 2-D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128B swizzle, 8-row
// groups 1024 bytes apart; `addr` 1024-aligned plus a K offset.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= A (64x32, K-major, shared) * B (32Lx32, K-major, shared), s32.
template <int L>
__device__ __forceinline__ void wgmma_s8(int (&d)[16 * L], uint64_t da,
                                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<1>(int (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<2>(int (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<3>(int (&d)[48], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<4>(int (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The wgmma sums are written asynchronously: pin every read after the wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int L, int CB>
__global__ void __launch_bounds__(kThreads, 1)
k2_kernel(const __grid_constant__ CUtensorMap key_map,
          const __grid_constant__ CUtensorMap dig_map,
          const int32_t* __restrict__ b_init,
          const int32_t* __restrict__ a_t, const int32_t* __restrict__ tv,
          int32_t* out, int8_t* dig, int steps, int batch, int n, int k1,
          int l, int b, int cluster, int stages) {
  constexpr int MT = CB > kM ? CB / kM : 1;  // 64-row blocks of the tile
  using St = Stage<L, MT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int amt[2][CB];  // the tile's rotation amounts, a step ahead

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;  // warpgroup, its rows
  const int rank = static_cast<int>(cluster_rank());
  const int g0 = (blockIdx.x / cluster) * CB;  // first ciphertext of the tile
  const int kn = k1 * n;
  const int span = kn / cluster;  // coefficients this CTA owns
  const int q_lo = rank * span;
  const int K = k1 * l * n;
  const int nk = K / kKc;
  const int total = (span / kChunk) * nk;  // ring iterations a step
  const int drop = 4 - L;
  const int log_n = __ffs(n) - 1;
  uint32_t* acc = reinterpret_cast<uint32_t*>(out);  // [k1][batch][n]
  // 128B swizzle wants 1024-aligned tiles; the barriers follow the ring
  const uint32_t smem0 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = smem0 + stages * St::kBytes;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // ACC = (0, ..., 0, X^{b_init} * tv) on this CTA's coefficients
  for (int e = tid; e < CB * span; e += kThreads) {
    const int g = g0 + e / span, q = q_lo + e % span;
    if (g >= batch) continue;
    const int c = q >> log_n, t = q & (n - 1);
    uint32_t v = 0;
    if (c == k1 - 1)
      v = rotated_coef(
          reinterpret_cast<const uint32_t*>(tv) + static_cast<size_t>(g) * n,
          t, b_init[g], n);
    __stcg(acc + (static_cast<size_t>(c) * batch + g) * n + t, v);
  }

  // digit pass: thread -> (row, group of 4 coefficients), kThreads groups
  // a round, stepped without divisions; biased-add digits (biased_digits)
  const int span4 = span / 4;
  const int row_step = kThreads / span4, grp_step = kThreads % span4;
  const int bl = b * l, half = 1 << (b - 1);
  const uint32_t mask = (1u << b) - 1, rnd = 1u << (31 - bl);
  uint32_t bias = 0;
  for (int j = 0; j < l; ++j) bias += static_cast<uint32_t>(half) << (b * j);

  auto load_amounts = [&](int i) {
    for (int r = tid; r < CB; r += kThreads)
      amt[i & 1][r] =
          g0 + r < batch ? a_t[static_cast<size_t>(i) * batch + g0 + r] : 0;
  };
  load_amounts(0);

  int it = 0;  // ring iterations consumed so far, over all steps
  for (int i = 0; i < steps; ++i) {
    cluster_sync();  // ACC of the last step is complete; its digits consumed

    // digits of X^{a_i} * ACC - ACC, row (c*l + lev), own coefficients
    for (int row = tid / span4, grp = tid % span4; row < CB;) {
      uint32_t diff[kUnroll][4];
      int rows[kUnroll], grps[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rows[u] = row;
        grps[u] = grp;
        const int g = g0 + row;
#pragma unroll
        for (int j = 0; j < 4; ++j) diff[u][j] = 0;
        if (row < CB && g < batch) {
          const int q = q_lo + 4 * grp, c = q >> log_n, t = q & (n - 1);
          const uint32_t* src =
              acc + (static_cast<size_t>(c) * batch + g) * n;
          const int a = amt[i & 1][row];
          const int am = a & (n - 1);
          const bool flip = (a & n) != 0;
          const uint4 own = __ldcg(reinterpret_cast<const uint4*>(src + t));
          const uint32_t o[4] = {own.x, own.y, own.z, own.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // rotated_coef, read from L2
            const uint32_t v = __ldcg(src + ((t + j - am) & (n - 1)));
            diff[u][j] = (((t + j < am) != flip) ? 0u - v : v) - o[j];
          }
        }
        row += row_step;
        grp += grp_step;
        if (grp >= span4) {
          grp -= span4;
          ++row;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (rows[u] >= CB) break;
        const int g = g0 + rows[u];
        const int q = q_lo + 4 * grps[u], c = q >> log_n, t = q & (n - 1);
        uint32_t* dp = reinterpret_cast<uint32_t*>(
            dig + static_cast<size_t>(g) * K + c * l * n + t);
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = ((diff[u][j] + rnd) >> (32 - bl)) + bias;
        for (int lev = 0; lev < l; ++lev) {
          // rows past the batch: zero digits (a zero ciphertext stays zero)
          const int sh = b * (l - 1 - lev);
          uint32_t packed = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            packed |= ((((w[j] >> sh) & mask) - half) & 0xFFu) << (8 * j);
          dp[lev * (n / 4)] = g < batch ? packed : 0u;
        }
      }
    }
    cluster_sync();  // the tile's digits of step i are complete

    // ring iteration f of this step: column chunk f / nk, K slice f % nk
    auto issue = [&](int f) {
      const int s = (it + f) % stages;
      const uint32_t st = smem0 + s * St::kBytes, bar = bars + 8 * s;
      const int x = (f % nk) * kKc;
      const int row0 = i * L * kn + q_lo + (f / nk) * kChunk;
      mbar_expect_tx(bar, St::kBytes);
      tma_load(st, &dig_map, x, g0, bar);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int lb = 0; lb < L; ++lb)
          tma_load(st + St::kA + (w * L + lb) * kHalf * kKc, &key_map, x,
                   row0 + lb * kn + w * kHalf, bar);
    };
    if (tid == 0)
      for (int f = 0; f < stages && f < total; ++f) issue(f);

    int d[MT][16 * L];
    uint2 old[MT][4][2];  // ACC of the chunk, fetched at its start
    for (int f = 0; f < total; ++f) {
      const int chunk = f / nk;
      const int q_base = q_lo + chunk * kChunk + wg * kHalf + (lane & 3) * 2;
      if (f % nk == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int jc = 0; jc < 4; ++jc)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m * kM + wrow + (lane >> 2) + h * 8;
              const int g = g0 + r, q = q_base + jc * 8;
              const int c = q >> log_n, t = q & (n - 1);
              old[m][jc][h] =
                  r < CB && g < batch
                      ? __ldcg(reinterpret_cast<const uint2*>(
                            acc + (static_cast<size_t>(c) * batch + g) * n +
                            t))
                      : make_uint2(0, 0);
            }
      }

      const int s = (it + f) % stages;
      const uint32_t st = smem0 + s * St::kBytes;
      mbar_wait(bars + 8 * s, ((it + f) / stages) & 1);
      const uint64_t da = sw128_desc(st);
      const uint64_t db = sw128_desc(st + St::kA + wg * L * kHalf * kKc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < kKc / 32; ++k)  // 32 bytes = 2 descriptor units
#pragma unroll
        for (int m = 0; m < MT; ++m)
          wgmma_s8<L>(d[m], da + m * (kM * kKc >> 4) + 2 * k, db + 2 * k,
                      f % nk != 0 || k != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the products of iteration f may still run; those of f - 1 are done
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      __syncthreads();  // every warpgroup is done with the stage of f - 1
      if (tid == 0 && f > 0 && f - 1 + stages < total) issue(f - 1 + stages);

      if (f % nk == nk - 1) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_regs(d[m]);
        // ACC[comp] += sum_limb P << 8*(limb + drop) on the chunk's columns
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int jc = 0; jc < 4; ++jc)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m * kM + wrow + (lane >> 2) + h * 8;
              const int g = g0 + r, q = q_base + jc * 8;
              if (r >= CB || g >= batch) continue;
              const int c = q >> log_n, t = q & (n - 1);
              uint2 v = old[m][jc][h];
#pragma unroll
              for (int lb = 0; lb < L; ++lb) {  // n8 block (lb, jc) of wgmma
                const int e = (lb * 4 + jc) * 4 + 2 * h;
                const uint32_t sh = 8u * static_cast<uint32_t>(lb + drop);
                v.x += static_cast<uint32_t>(d[m][e]) << sh;
                v.y += static_cast<uint32_t>(d[m][e + 1]) << sh;
              }
              __stcg(reinterpret_cast<uint2*>(
                         acc + (static_cast<size_t>(c) * batch + g) * n + t),
                     v);
            }
      }
    }
    it += total;
    if (i + 1 < steps) load_amounts(i + 1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Tensor map of a row-major [rows][cols] int8 matrix, boxes of 128 bytes by
// `box_rows`, 128B swizzle; rows past the end read as zeros.
cudaError_t encode(CUtensorMap* map, const void* base, uint64_t cols,
                   uint64_t rows, uint32_t box_rows) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKc), box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaLaunchConfig_t config(int blocks, int cluster, int smem,
                          cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int L, int CB>
cudaError_t prepare(int cluster, int smem) {
  auto kern = k2_kernel<L, CB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int L, int CB>
cudaError_t launch(const void* b_init, const void* a_t, const void* tv,
                   const void* keys, void* out, void* dig, int steps,
                   int batch, int n, int k1, int l, int b, int cluster,
                   int stages, int smem, cudaStream_t stream) {
  cudaError_t err = prepare<L, CB>(cluster, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (batch + CB - 1) / CB;
  const uint64_t K = static_cast<uint64_t>(k1) * l * n;
  CUtensorMap key_map, dig_map;
  err = encode(&key_map, keys, K, static_cast<uint64_t>(steps) * L * k1 * n,
               kHalf);
  if (err == cudaSuccess)
    err = encode(&dig_map, dig, K, static_cast<uint64_t>(tiles) * CB,
                 CB > kM ? CB : kM);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(tiles * cluster, cluster, smem, attr, stream);
  err = cudaLaunchKernelEx(&cfg, k2_kernel<L, CB>, key_map, dig_map,
                           static_cast<const int32_t*>(b_init),
                           static_cast<const int32_t*>(a_t),
                           static_cast<const int32_t*>(tv),
                           static_cast<int32_t*>(out),
                           static_cast<int8_t*>(dig), steps, batch, n, k1, l,
                           b, cluster, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int L, int CB>
cudaError_t max_clusters(int cluster, int smem, int* count) {
  cudaError_t err = prepare<L, CB>(cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster * 64, cluster, smem, attr, 0);
  return cudaOccupancyMaxActiveClusters(count, k2_kernel<L, CB>, &cfg);
}

}  // namespace k2
}  // namespace fbr

#define FBR_K2_CASES(X)                                                   \
  X(1, 16) X(1, 32) X(1, 64) X(1, 128) X(2, 16) X(2, 32) X(2, 64)      \
  X(2, 128) X(3, 16) X(3, 32) X(3, 64) X(3, 128) X(4, 16) X(4, 32)      \
  X(4, 64) X(4, 128)

// C entry: returns the launch's cudaError_t (0 on success).  `cb` is the
// number of ciphertexts per cluster tile (16, 32, 64 or 128), `cluster` the
// CTAs per tile, `dig` a [ceil(batch/cb)*cb, K] int8 scratch.
extern "C" int fbr_k2_blind_rotate(const void* b_init, const void* a_t,
                                   const void* tv, const void* keys,
                                   void* out, void* dig, int steps,
                                   int batch, int n, int k1, int l, int b,
                                   int n_limbs, int cb, int cluster,
                                   int stages, int smem, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define FBR_K2_LAUNCH(L, CB)                                                 \
  if (n_limbs == L && cb == CB)                                              \
    return static_cast<int>(fbr::k2::launch<L, CB>(                          \
        b_init, a_t, tv, keys, out, dig, steps, batch, n, k1, l, b, cluster, \
        stages, smem, st));
  FBR_K2_CASES(FBR_K2_LAUNCH)
#undef FBR_K2_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `cluster` CTAs with `smem` bytes each the card runs
// at once (cudaOccupancyMaxActiveClusters), into *count.
extern "C" int fbr_k2_max_clusters(int n_limbs, int cb, int cluster,
                                   int smem, int* count) {
#define FBR_K2_OCC(L, CB)                                                 \
  if (n_limbs == L && cb == CB)                                           \
    return static_cast<int>(                                              \
        fbr::k2::max_clusters<L, CB>(cluster, smem, count));
  FBR_K2_CASES(FBR_K2_OCC)
#undef FBR_K2_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
