// K1, the "fused_otf" blind rotation, for Hopper (sm_90a): all n CMux steps
// of a tile of ciphertexts in one launch, the contraction on int8 tensor
// cores with the key operand copied from a table built once a key.  K2
// ("fused") is in fused_blind_rotate_k2.cu; the helpers both use are in
// fused_blind_rotate.cuh.
//
// Replaces _kernel_otf of tfhe_fbs_map_tpu/ops/fused_blind_rotate.py
// (:160-242).  Keys: [n, L*(k+1), rows, 2N] int8, the anti-periodic limb
// extensions E = [limbs(-poly), limbs(poly)] of every (step, limb, comp,
// row).  Step i's negacyclic matrix is M[(r, j), t] = E[N + t - j], and
//   ACC[comp] += sum_limb (digits @ M_{limb,comp}) << 8*(limb + drop).
//
// A step's key is only L*(k+1)*rows*2N bytes (73.7 KB at the aes128_p4
// preset, 42.6 MB a launch), so unlike K2 no key matrix is streamed.  The
// design:
//
// * Digits reversed within each row's N block (j' = N-1-j, written so by
//   the digit pass) turn M into a Hankel matrix, B'[t][j'] = E[t + j' + 1]:
//   row t of B' (K-major, as wgmma wants an int8 B) is a contiguous run of
//   E, and the 8-row x 16-byte core matrix of B' at (t0, j0') is the block
//   H[w][i][c] = E[8w + i + 1 + c] with w = (t0 + j0') / 8.  A no-swizzle
//   wgmma descriptor with core matrices 256 bytes apart along K and 128
//   bytes apart along N reads any B tile straight out of consecutive H
//   blocks (they overlap, which reads allow): a ring stage holds, per limb,
//   the CW/8 + 30 blocks that one 256-byte K slice of a chunk of CW
//   coefficients touches, 16x the E bytes they come from.
// * H depends on the key alone, so the launch side builds it once a key
//   (hankel_table in ops/fused_blind_rotate.py): for each (step, limb,
//   comp, row) the 2N/8 blocks at every 8-byte offset o of E, block o/8
//   row i = E[o + i + 1 ..+16), zeros past 2N (16x the key, 682 MB at
//   aes128_p4).  A stage's blocks of one limb are a contiguous run of it,
//   from o0 / 8 with o0 = t_c + j0' (the chunk's first coefficient and the
//   slice's first column), and every tile of a launch reads the same runs,
//   so L2 serves all but the first read.
// * A tile of CB (64 or 128) ciphertexts runs on a thread-block cluster of
//   C CTAs, as in K2: CTA r owns coefficients [r*span, (r+1)*span) of the
//   flattened (comp, t) axis, span = (k+1)*N / C, with all L limbs, so the
//   limb shift-add stays in the CTA.  ACC lives in the output tensor and
//   the digits in a [tiles*CB, K] int8 scratch; two cluster barriers a
//   step order them.
// * Per chunk of CW = 2*NW coefficients, the CTA walks K in 256-byte
//   slices through a ring of 4-6 stages (as many as shared memory holds),
//   each the slice's digit rows and H blocks.  Three warpgroups: the
//   producer's first thread (the warpgroup at 56 registers after
//   setmaxnreg) claims a stage once the consumers release it and issues
//   its copies: the digit rows by TMA (128B swizzle), the H blocks by one
//   bulk copy a limb from the table.  The H blocks do not depend on the
//   digits, so it issues the next step's first stages during the digit
//   pass.  Two consumers (224 registers) each own NW of the chunk's
//   coefficients and run, per limb and 64-row block, m64n(NW)k32 wgmma
//   s8*s8->s32 with A (digits) and B (H) from shared memory, one wgmma
//   group in flight; they compute the digit pass and the ACC epilogue.
//   Stages pass between them by three mbarriers each (digits landed, H
//   landed, stage consumed).
// * What bounds it on the H100: the serial work around the products.  The
//   phase bisect (runtime/bisect.py) at n=578, B=1024 (plan 64 x 6, nw 64)
//   gives 25.8 ms a launch against a least time of 11.29; leaving out the
//   products saves 10.2 ms, the H copies 1.0 and the digit pass 5.3 (at
//   Kreyvium's fam1, B=3200: 248.1 ms; 111.5, 8.1 and 25.9).  The digit
//   pass and the two cluster barriers a step stall the ring; only a second
//   independent tile a CTA could hide them.
// * Exactness: |digit| <= 2^(b-1) <= 128, |key| <= 128 and K*2^(b+6) <
//   2^31 (unsupported() in ops/fused_blind_rotate.py), so each int32 sum
//   is exact.  The limb shifts and the ACC adds are uint32_t (mod 2^32).
//   Rows past the batch have zero digits and are never stored.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_blind_rotate.cuh"

namespace fbr {
namespace k1 {

constexpr int kSlice = 2 * kKc;  // contraction bytes a ring stage
constexpr int kMaxStages = 6;    // ring stages, as many as fit up to this
// dynamic shared memory beside the ring (1024-byte alignment, mbarriers)
// and the static amt[2][CB]
constexpr int kSmemBeside = 2048;
constexpr int kSmemStatic = 1024;
constexpr int kProducer = 128;  // the producer warpgroup's threads
constexpr int kK1Threads = kThreads + kProducer;
// registers a thread after setmaxnreg: 256 * 224 + 128 * 56 = 384 * 168
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;

// One ring stage: the slice's two 128-byte columns of MT blocks of 64
// digit rows (TMA, 128B swizzle, so 1024-aligned), then L limbs of kHB H
// blocks of 128 bytes: those that a chunk of 2*NW coefficients and kSlice
// contraction bytes touch, (2*NW - 8 + kSlice - 16) / 8 + 1.  The ring
// takes as many stages as fit the 227 KB a CTA may have, at most
// kMaxStages; kSmem is the dynamic shared memory a CTA launches with.  The
// launch side asks fbr_k1_layout for both.
template <int L, int MT, int NW>
struct Stage {
  static constexpr int kHB = (2 * NW + kSlice) / 8 - 2;  // H blocks a limb
  static constexpr int kA = 2 * MT * kM * kKc;
  static constexpr int kH = L * kHB * 128;
  static constexpr int kBytes = (kA + kH + 1023) / 1024 * 1024;
  static constexpr int kFit = (232448 - kSmemBeside - kSmemStatic) / kBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kStages * kBytes + kSmemBeside;
  static_assert(kStages >= 4, "a ring of fewer than 4 stages");
  // alignment and 3 mbarriers a stage
  static_assert(1023 + 8 * 3 * kMaxStages <= kSmemBeside,
                "mbarriers overflow the bytes beside the ring");
};

template <int L, int CB, int NW>
__global__ void __launch_bounds__(kK1Threads, 1)
k1_kernel(const __grid_constant__ CUtensorMap dig_map,
          const int32_t* __restrict__ b_init,
          const int32_t* __restrict__ a_t, const int32_t* __restrict__ tv,
          const int8_t* __restrict__ hankel, int32_t* out, int8_t* dig,
          int steps, int batch, int n, int k1, int l, int b, int cluster) {
  constexpr int MT = CB / kM;  // 64-row blocks of the tile
  constexpr int CW = 2 * NW;   // coefficients a chunk (two warpgroups)
  constexpr int R = NW / 32;   // wgmma_s8<R> is m64n(NW)k32
  using St = Stage<L, MT, NW>;
  constexpr int kS = St::kStages;  // ring stages
  extern __shared__ unsigned char smem_raw[];
  __shared__ int amt[2][CB];  // the tile's rotation amounts, a step ahead

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;  // warpgroup, its rows
  const int rank = static_cast<int>(cluster_rank());
  const int g0 = (blockIdx.x / cluster) * CB;  // first ciphertext of the tile
  const int kn = k1 * n;
  const int span = kn / cluster;  // coefficients this CTA owns
  const int q_lo = rank * span;
  const int rows = k1 * l;
  const int K = rows * n;
  const int nk = K / kSlice;
  const int chunks = span / CW;
  const int total = chunks * nk;  // ring iterations a step
  const int pre = total < kS ? total : kS;
  const int log_n = __ffs(n) - 1;
  uint32_t* acc = reinterpret_cast<uint32_t*>(out);  // [k1][batch][n]
  const uint32_t smem0 = (smem_u32(smem_raw) + 1023) & ~1023u;
  // per stage: digits landed (TMA), H landed (bulk copies), stage consumed
  // (one arrival per consumer warp)
  const uint32_t afull = smem0 + kS * St::kBytes;
  const uint32_t hfull = afull + 8 * kS, empty = hfull + 8 * kS;
  bool stuck = false;  // an mbarrier wait gave up: trap once the loops end

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(afull + 8 * s, 1);
      mbar_init(hfull + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Ring iteration G counts over all steps: step G / total, column chunk
  // (G % total) / nk, K slice G % nk.
  if (tid >= kThreads) {
    // ---- producer warpgroup: its first thread issues every copy (the H
    // blocks of a stage from the table, its digit tiles by TMA)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const bool issuer = tid == kThreads;
    // the table's blocks of one (step, limb, comp, row): 2N/8 of 128 bytes
    const size_t row_bytes = static_cast<size_t>(32) * n;
    const size_t limb_stride = static_cast<size_t>(k1) * rows * row_bytes;
    // wait until the consumers are done with the previous iteration of
    // G's stage
    auto claim = [&](int G) {
      if (G >= kS)
        mbar_wait_or_give_up(empty + 8 * (G % kS),
                             ((G / kS) + 1) & 1, stuck);
    };
    // the H blocks of iteration G (step i, its f-th): for limb lb the kHB
    // blocks from o0 / 8 of (step, limb, comp c, row r), o0 = t_c + j0'
    // (the chunk's first coefficient and the slice's first column, both
    // 16-aligned), one bulk copy each, completing on the stage's H barrier
    auto copy_h = [&](int G, int i, int f) {
      const int s = G % kS;
      const int q0 = q_lo + (f / nk) * CW, x = (f % nk) * kSlice;
      const int c = q0 >> log_n, r = x >> log_n;
      const int8_t* h0 =
          hankel + ((static_cast<size_t>(i) * L * k1 + c) * rows + r) *
                       row_bytes +
          static_cast<size_t>((q0 & (n - 1)) + (x & (n - 1))) * 16;
      mbar_expect_tx(hfull + 8 * s, St::kH);
      for (int lb = 0; lb < L; ++lb)
        bulk_load(smem0 + s * St::kBytes + St::kA + lb * St::kHB * 128,
                  h0 + lb * limb_stride, St::kHB * 128, hfull + 8 * s);
    };
    int it = 0;
    for (int i = 0; i < steps; ++i) {
      // H of the step's first stages: it does not depend on the digits
      if (issuer)
        for (int f = 0; f < pre; ++f) {
          claim(it + f);
          copy_h(it + f, i, f);
        }
      cluster_sync();  // the consumers' ACC of the last step is complete
      cluster_sync();  // the tile's digits of step i are complete
      if (issuer)
        for (int f = 0, sl = 0; f < total; ++f) {
          const int G = it + f, s = G % kS;
          if (f >= pre) claim(G);
          mbar_expect_tx(afull + 8 * s, St::kA);  // the digit rows of G
          for (int h = 0; h < 2; ++h)
            tma_load(smem0 + s * St::kBytes + h * (St::kA / 2), &dig_map,
                     sl * kSlice + h * kKc, g0, afull + 8 * s);
          if (f >= pre) copy_h(G, i, f);
          if (++sl == nk) sl = 0;
        }
      it += total;
    }
    if (stuck) __trap();
    return;
  }

  // ---- consumer warpgroups: digits, products, ACC
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int drop = 4 - L;
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
    digit_pass<CB, true>(acc, dig, amt[i & 1], g0, q_lo, span, batch, n, l, b,
                         K);
    cluster_sync();  // the tile's digits of step i are complete

    // column chunks of CW coefficients, each a pipelined loop over the nk
    // K slices with the epilogue after it (accumulators untouched inside)
    int d[MT][L][16 * R];
    for (int ch = 0, f = 0; ch < chunks; ++ch) {
      for (int sl = 0; sl < nk; ++sl, ++f) {
        const int G = it + f, s = G % kS;
        const uint32_t st = smem0 + s * St::kBytes;
        mbar_wait_or_give_up(hfull + 8 * s, (G / kS) & 1, stuck);
        mbar_wait_or_give_up(afull + 8 * s, (G / kS) & 1, stuck);
        const uint64_t da = sw128_desc(st);
        // B of warpgroup wg, limb lb, k step k: H blocks from
        // lb*kHB + wg*NW/8 + 4k, core matrices 256 B apart along K, 128 B
        // along N
        const uint32_t hb = st + St::kA + wg * (NW / 8) * 128;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < kSlice / 32; ++k)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int lb = 0; lb < L; ++lb)
              wgmma_s8<R>(d[m][lb],
                          da + (k / 4) * (St::kA / 2 >> 4) +
                              m * (kM * kKc >> 4) + 2 * (k % 4),
                          plain_desc(hb + (lb * St::kHB + 4 * k) * 128, 256,
                                     128),
                          sl != 0 || k != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the products of iteration G may still run; those of G - 1 are
        // done, and its stage goes back to the producer
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (sl > 0 && lane == 0) mbar_arrive(empty + 8 * ((G - 1) % kS));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty + 8 * ((it + f - 1) % kS));
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int lb = 0; lb < L; ++lb) fence_regs(d[m][lb]);
      // ACC[comp] += sum_limb P << 8*(limb + drop) on the chunk's columns,
      // a 64-row block at a time: its loads first, then adds and stores
      const int q_base = q_lo + ch * CW + wg * NW + (lane & 3) * 2;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint2 old[NW / 8][2];
#pragma unroll
        for (int jc = 0; jc < NW / 8; ++jc)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int g = g0 + m * kM + wrow + (lane >> 2) + h * 8;
            const int q = q_base + jc * 8, c = q >> log_n, t = q & (n - 1);
            old[jc][h] =
                g < batch ? __ldcg(reinterpret_cast<const uint2*>(
                                acc + (static_cast<size_t>(c) * batch + g) *
                                          n +
                                t))
                          : make_uint2(0, 0);
          }
#pragma unroll
        for (int jc = 0; jc < NW / 8; ++jc)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int g = g0 + m * kM + wrow + (lane >> 2) + h * 8;
            if (g >= batch) continue;
            const int q = q_base + jc * 8, c = q >> log_n, t = q & (n - 1);
            uint2 v = old[jc][h];
#pragma unroll
            for (int lb = 0; lb < L; ++lb) {  // n8 block jc of limb lb
              const int e = jc * 4 + 2 * h;
              const uint32_t sh = 8u * static_cast<uint32_t>(lb + drop);
              v.x += static_cast<uint32_t>(d[m][lb][e]) << sh;
              v.y += static_cast<uint32_t>(d[m][lb][e + 1]) << sh;
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
  if (stuck) __trap();
}

template <int L, int CB, int NW>
cudaError_t launch(const void* b_init, const void* a_t, const void* tv,
                   const void* hankel, void* out, void* dig, int steps,
                   int batch, int n, int k1, int l, int b, int cluster,
                   cudaStream_t stream) {
  const int smem = Stage<L, CB / kM, NW>::kSmem;
  auto kern = k1_kernel<L, CB, NW>;
  cudaError_t err = prepare_kernel(kern, cluster, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (batch + CB - 1) / CB;
  const uint64_t K = static_cast<uint64_t>(k1) * l * n;
  CUtensorMap dig_map;
  err = encode(&dig_map, dig, K, static_cast<uint64_t>(tiles) * CB, CB);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      tiles * cluster, cluster, smem, attr, stream, kK1Threads);
  err = cudaLaunchKernelEx(&cfg, kern, dig_map,
                           static_cast<const int32_t*>(b_init),
                           static_cast<const int32_t*>(a_t),
                           static_cast<const int32_t*>(tv),
                           static_cast<const int8_t*>(hankel),
                           static_cast<int32_t*>(out),
                           static_cast<int8_t*>(dig), steps, batch, n, k1, l,
                           b, cluster);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace k1
}  // namespace fbr

// (limbs, ciphertexts a tile, coefficients a warpgroup) with at most 128
// accumulator registers a thread: (CB / 64) * L * NW / 2 <= 128.
#define FBR_K1_CASES(X)                                                     \
  X(1, 64, 32) X(1, 64, 64) X(1, 128, 32) X(1, 128, 64) X(2, 64, 32)       \
  X(2, 64, 64) X(2, 128, 32) X(2, 128, 64) X(3, 64, 32) X(3, 64, 64)       \
  X(3, 128, 32) X(4, 64, 32) X(4, 64, 64) X(4, 128, 32)

// C entry: returns the launch's cudaError_t (0 on success).  `cb` is the
// number of ciphertexts per cluster tile (64 or 128), `nw` the coefficients
// per warpgroup (32 or 64), `cluster` the CTAs per tile, `dig` a
// [ceil(batch/cb)*cb, K] int8 scratch, `hankel` the keys' table of H
// blocks [n][L*(k+1)][rows][2N/8][128] (16-aligned; ops/fused_blind_rotate.py
// hankel_table).
extern "C" int fbr_k1_blind_rotate(const void* b_init, const void* a_t,
                                   const void* tv, const void* hankel,
                                   void* out, void* dig, int steps,
                                   int batch, int n, int k1, int l, int b,
                                   int n_limbs, int cb, int nw, int cluster,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define FBR_K1_LAUNCH(L, CB, NW)                                             \
  if (n_limbs == L && cb == CB && nw == NW)                                  \
    return static_cast<int>(fbr::k1::launch<L, CB, NW>(                      \
        b_init, a_t, tv, hankel, out, dig, steps, batch, n, k1, l, b,       \
        cluster, st));
  FBR_K1_CASES(FBR_K1_LAUNCH)
#undef FBR_K1_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `cluster` CTAs the card runs at once
// (cudaOccupancyMaxActiveClusters), into *count.
extern "C" int fbr_k1_max_clusters(int n_limbs, int cb, int nw, int cluster,
                                   int* count) {
#define FBR_K1_OCC(L, CB, NW)                                               \
  if (n_limbs == L && cb == CB && nw == NW)                                 \
    return static_cast<int>(fbr::max_active_clusters(                       \
        fbr::k1::k1_kernel<L, CB, NW>, cluster,                            \
        fbr::k1::Stage<L, CB / fbr::kM, NW>::kSmem, count,                 \
        fbr::k1::kK1Threads));
  FBR_K1_CASES(FBR_K1_OCC)
#undef FBR_K1_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}

// The ring stages and the dynamic shared memory a CTA of (n_limbs, cb, nw)
// launches with, into *stages and *smem.
extern "C" int fbr_k1_layout(int n_limbs, int cb, int nw, int* stages,
                             int* smem) {
#define FBR_K1_LAYOUT(L, CB, NW)                                            \
  if (n_limbs == L && cb == CB && nw == NW) {                               \
    using St = fbr::k1::Stage<L, CB / fbr::kM, NW>;                         \
    *stages = St::kStages;                                                  \
    *smem = St::kSmem;                                                      \
    return 0;                                                               \
  }
  FBR_K1_CASES(FBR_K1_LAYOUT)
#undef FBR_K1_LAYOUT
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fbr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
