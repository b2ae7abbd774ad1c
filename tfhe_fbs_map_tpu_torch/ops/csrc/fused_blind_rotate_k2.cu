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
// The helpers it shares with K1 (mbarriers, TMA, wgmma, the ACC init and
// the digit pass) are in fused_blind_rotate.cuh.
//
// Later work: loading the next step's key tiles during the digit pass.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_blind_rotate.cuh"

namespace fbr {
namespace k2 {

constexpr int kChunk = 64;         // coefficients per column chunk
constexpr int kHalf = kChunk / 2;  // coefficients per warpgroup

// One ring stage: MT blocks of 64 digit rows, then the key rows.
template <int L, int MT>
struct Stage {
  static constexpr int kA = MT * kM * kKc;       // digits [MT*64][128]
  static constexpr int kB = L * kChunk * kKc;    // key [2][L][32][128]
  static constexpr int kBytes = kA + kB;
};

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

  init_acc(acc, b_init, tv, g0, CB, q_lo, span, batch, n, k1);

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
    digit_pass<CB, false>(acc, dig, amt[i & 1], g0, q_lo, span, batch, n, l,
                          b, K);
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

template <int L, int CB>
cudaError_t launch(const void* b_init, const void* a_t, const void* tv,
                   const void* keys, void* out, void* dig, int steps,
                   int batch, int n, int k1, int l, int b, int cluster,
                   int stages, int smem, cudaStream_t stream) {
  cudaError_t err = prepare_kernel(k2_kernel<L, CB>, cluster, smem);
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
      cluster_config(tiles * cluster, cluster, smem, attr, stream);
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
        fbr::max_active_clusters(fbr::k2::k2_kernel<L, CB>, cluster, smem, \
                                 count));
  FBR_K2_CASES(FBR_K2_OCC)
#undef FBR_K2_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
