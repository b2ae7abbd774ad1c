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
//   slices through a ring of 4-6 stages (as many as shared memory holds
//   beside the staging buffer), each the slice's digit rows and H blocks.
//   Three warpgroups: the producer's first thread (the warpgroup at 56
//   registers after setmaxnreg) claims a stage once the consumers release
//   it and issues its copies: the digit rows by TMA (128B swizzle), the H
//   blocks by one bulk copy a limb from the table.  The H blocks do not
//   depend on the digits, so it issues the next step's first stages during
//   the digit pass.  Two consumers (224 registers) each own NW of the
//   chunk's coefficients and run, per limb and 64-row block, m64n(NW)k32
//   wgmma s8*s8->s32 with A (digits) and B (H) from shared memory, one
//   wgmma group in flight; they compute the digit pass.  Stages pass
//   between them by three mbarriers each (digits landed, H landed, stage
//   consumed).
// * The ACC epilogue: the product warpgroups never read ACC.  They add a
//   chunk's L limbs' accumulators into one uint32 a coefficient, store
//   them in boxes of 64 rows x 32 columns (128B swizzle) into a staging
//   buffer beside the ring and go on to the next chunk's products; another
//   thread adds the boxes into ACC by TMA (cp.reduce.async.bulk.tensor
//   .add.u32 over ACC as [k+1][batch][N]: mod 2^32 as the adds were, rows
//   past the batch left out), frees the buffer once TMA has read it and,
//   after a block's last chunk, waits for the adds, fences and tells the
//   cluster.  The buffer holds a whole chunk (32 KB at CB=64, NW=64,
//   beside 4 stages), or half of one where that leaves fewer than 4.
//   Staged and freed are two more mbarriers.
// * A cluster carries one tile (k1_kernel) or two in turns
//   (k1_kernel_pair): the ring's blocks of iterations alternate between the
//   two tiles' steps, and while the product warpgroups multiply one tile's
//   step, a warp of its own reduce-adds the other tile's last step and six
//   digit warps write its next digits, each tile with its own two cluster
//   barriers (mbarriers every CTA arrives on).  In k1_kernel the producer
//   warpgroup's second warp reduce-adds before the cluster barrier that
//   closes a step.  The launch side's plan (k1_ring_plan) takes a pair
//   where its waves, at K1_PAIR_COST times a one-tile cluster's time, cost
//   less.
// * What bounds it on the H100: the products' shared-memory operands and
//   the serial work around them.  At n=578, B=1024, one tile on clusters
//   of 6 (64 x 6, nw 64): 23.8 ms a launch against a least time of 11.29
//   (25.3 with the product warps' own loads and stores of ACC beside 5
//   stages; 24.7 beside 4); at B=520, pairs on clusters of 12: 20.9
//   (21.7; 21.2).  The phase bisect (runtime/bisect.py) before the
//   reduce-add: at B=1024 15.3 without the products, 24.8 without the H
//   copies, 20.7 without the digit pass, 23.3 without the epilogue's
//   loads, adds and stores; at B=520 10.8, 21.4, 20.1 and 20.1.  At
//   Kreyvium's fam1, B=3200, pairs on clusters of 4: 223.8 (236.4).
//   AES-128's 15 and 16 tiles find no pair plan that fills the card (7
//   clusters of 12 at once), so they stay one tile a cluster.
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
// dynamic shared memory beside the ring and the staging buffer (1024-byte
// alignment, mbarriers) and the static amt[2][CB]
constexpr int kSmemBeside = 2048;
constexpr int kSmemStatic = 1024;
// the fewest ring stages left beside a whole column chunk's staging buffer;
// with fewer the chunk is staged in two parts
constexpr int kWholeStages = 4;
constexpr int kProducer = 128;  // the producer warpgroup's threads
constexpr int kK1Threads = kThreads + kProducer;
// registers a thread after setmaxnreg: 256 * 224 + 128 * 56 = 384 * 168
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;
// The paired schedule (k1_kernel_pair): two product warpgroups, a digit
// warpgroup and the producer's, whose first warp issues the copies, whose
// next two write digits too and whose last reduce-adds the staged sums
// into ACC: 512 threads of 128 registers at launch, 2 * 200 + 56 + 56 =
// 4 * 128 after setmaxnreg.
constexpr int kPairThreads = kThreads + 128 + kProducer;
constexpr int kDigitThreads = 128 + 64;  // six digit warps
constexpr int kPairConsumerRegs = 200;
constexpr int kPairDigitRegs = 56;
constexpr int kDigitUnroll = 2;  // digit groups in flight a thread
static_assert(2 * kPairConsumerRegs + 2 * kPairDigitRegs <= 65536 / 128,
              "the paired schedule's registers exceed the SM's");

// One ring stage: the slice's two 128-byte columns of MT blocks of 64
// digit rows (TMA, 128B swizzle, so 1024-aligned), then L limbs of kHB H
// blocks of 128 bytes: those that a chunk of 2*NW coefficients and kSlice
// contraction bytes touch, (2*NW - 8 + kSlice - 16) / 8 + 1.  After the
// stages, the staging buffer of a column chunk's limb-summed accumulators
// on their way into ACC: boxes of 64 rows x 32 uint32 columns (128-byte
// rows, 128B swizzle), kBoxes a warpgroup, in kParts parts where the whole
// chunk would leave fewer than kWholeStages stages.  The ring takes as many
// stages as fit the 227 KB a CTA may have beside the buffer, at most
// kMaxStages; kSmem is the dynamic shared memory a CTA launches with.  The
// launch side asks fbr_k1_layout for both.
template <int L, int MT, int NW>
struct Stage {
  static constexpr int kHB = (2 * NW + kSlice) / 8 - 2;  // H blocks a limb
  static constexpr int kA = 2 * MT * kM * kKc;
  static constexpr int kH = L * kHB * 128;
  static constexpr int kBytes = (kA + kH + 1023) / 1024 * 1024;
  static constexpr int kBox = kM * 32 * 4;
  static constexpr int kBoxes = MT * NW / 32;
  static constexpr int kRoom = 232448 - kSmemBeside - kSmemStatic;
  static constexpr int kParts =
      (kRoom - 2 * kBoxes * kBox) / kBytes >= kWholeStages ? 1 : 2;
  static constexpr int kStaging = 2 * kBoxes * kBox / kParts;
  static constexpr int kFit = (kRoom - kStaging) / kBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kStages * kBytes + kStaging + kSmemBeside;
  static_assert(kStages >= 4, "a ring of fewer than 4 stages");
  static_assert(kBoxes % kParts == 0, "a part of no whole boxes");
  // alignment, 3 mbarriers a stage, the staging buffer's 2 and the paired
  // schedule's 4
  static_assert(1023 + 8 * (3 * kMaxStages + 2 + 4) <= kSmemBeside,
                "mbarriers overflow the bytes beside the ring");
};

// A CTA's ring: stage s at smem0 + s * kBytes, the staging buffer after the
// stages; per stage the mbarriers afull (digits landed, TMA), hfull (H
// landed, bulk copies) and empty (consumed: one arrival per product warp),
// 8 bytes apart; then the staging buffer's staged (a part written: one
// arrival per product warp) and freed (its reduce-add has read it).
struct Ring {
  uint32_t smem0, staging, afull, hfull, empty, staged, freed;
};

// The chunk's limb-summed accumulators, ACC's addends, into the staging
// buffer (the product warpgroups): sum_limb d << 8*(limb + drop) mod 2^32,
// box (m, j) of warpgroup wg its rows 64m .. 64m + 63 and columns 32j ..
// 32j + 31 (the 16-byte units of a 128-byte row XOR-swizzled by the row,
// as TMA reads them), part by part: each once the reduce-add has read the
// buffer's last part out (freed), then announced (staged).  `use` counts
// the buffer's parts before the chunk's first.
template <int L, int CB, int NW>
__device__ __forceinline__ void stage_chunk(
    const int (&d)[CB / kM][L][16 * (NW / 32)], const Ring& rg, int use,
    int wg, int lane, int wrow, bool& stuck) {
  using St = Stage<L, CB / kM, NW>;
  constexpr int BP = St::kBoxes / St::kParts;  // a warpgroup's boxes a part
  const int drop = 4 - L;
#pragma unroll
  for (int p = 0; p < St::kParts; ++p) {
    if (use + p > 0)
      mbar_wait_or_give_up(rg.freed, (use + p - 1) & 1, stuck);
#pragma unroll
    for (int x = 0; x < BP; ++x) {
      const int box = p * BP + x, m = box / (NW / 32), j = box % (NW / 32);
      const uint32_t base = rg.staging + (wg * BP + x) * St::kBox;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = (4 * j + jj) * 4 + 2 * h;  // n8 block 4j + jj
          uint32_t v0 = 0, v1 = 0;
#pragma unroll
          for (int lb = 0; lb < L; ++lb) {
            const uint32_t sh = 8u * static_cast<uint32_t>(lb + drop);
            v0 += static_cast<uint32_t>(d[m][lb][e]) << sh;
            v1 += static_cast<uint32_t>(d[m][lb][e + 1]) << sh;
          }
          const int row = wrow + (lane >> 2) + 8 * h;
          const int unit = (2 * jj + ((lane & 3) >> 1)) ^ (row & 7);
          st_shared_v2(base + row * 128 + unit * 16 + (lane & 1) * 8, v0,
                       v1);
        }
    }
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(rg.staged);
  }
}

// The copies of one block of `total` ring iterations from G0: step i of the
// tile whose first ciphertext is g0, its f-th iteration column chunk f / nk
// and K slice f % nk.  First the H blocks of the block's first stages (they
// do not depend on the digits), then, once ready() returns (the tile's
// digits of step i are complete in the cluster), each stage's digit rows
// by TMA and the other stages' H blocks.  Every producer thread calls it
// (ready() may be a cluster barrier); `issuer` alone copies.
template <int L, int CB, int NW, typename Ready>
__device__ __forceinline__ void produce(const Ring& rg,
                                        const CUtensorMap* dig_map,
                                        const int8_t* hankel, int G0, int i,
                                        int g0, int q_lo, int nk, int total,
                                        int n, int k1, int rows, bool issuer,
                                        bool& stuck, Ready ready) {
  using St = Stage<L, CB / kM, NW>;
  constexpr int kS = St::kStages;
  constexpr int CW = 2 * NW;
  const int pre = total < kS ? total : kS;
  const int log_n = __ffs(n) - 1;
  // the table's blocks of one (step, limb, comp, row): 2N/8 of 128 bytes
  const size_t row_bytes = static_cast<size_t>(32) * n;
  const size_t limb_stride = static_cast<size_t>(k1) * rows * row_bytes;
  // wait until the consumers are done with the previous iteration of G's
  // stage
  auto claim = [&](int G) {
    if (G >= kS)
      mbar_wait_or_give_up(rg.empty + 8 * (G % kS), ((G / kS) + 1) & 1,
                           stuck);
  };
  // the H blocks of iteration G (the block's f-th): for limb lb the kHB
  // blocks from o0 / 8 of (step, limb, comp c, row r), o0 = t_c + j0' (the
  // chunk's first coefficient and the slice's first column, both
  // 16-aligned), one bulk copy each, completing on the stage's H barrier
  auto copy_h = [&](int G, int f) {
    const int s = G % kS;
    const int q0 = q_lo + (f / nk) * CW, x = (f % nk) * kSlice;
    const int c = q0 >> log_n, r = x >> log_n;
    const int8_t* h0 =
        hankel + ((static_cast<size_t>(i) * L * k1 + c) * rows + r) *
                     row_bytes +
        static_cast<size_t>((q0 & (n - 1)) + (x & (n - 1))) * 16;
    mbar_expect_tx(rg.hfull + 8 * s, St::kH);
    for (int lb = 0; lb < L; ++lb)
      bulk_load(rg.smem0 + s * St::kBytes + St::kA + lb * St::kHB * 128,
                h0 + lb * limb_stride, St::kHB * 128, rg.hfull + 8 * s);
  };
  if (issuer)
    for (int f = 0; f < pre; ++f) {
      claim(G0 + f);
      copy_h(G0 + f, f);
    }
  ready();
  if (issuer)
    for (int f = 0, sl = 0; f < total; ++f) {
      const int G = G0 + f, s = G % kS;
      if (f >= pre) claim(G);
      mbar_expect_tx(rg.afull + 8 * s, St::kA);  // the digit rows of G
      for (int h = 0; h < 2; ++h)
        tma_load(rg.smem0 + s * St::kBytes + h * (St::kA / 2), dig_map,
                 sl * kSlice + h * kKc, g0, rg.afull + 8 * s);
      if (f >= pre) copy_h(G, f);
      if (++sl == nk) sl = 0;
    }
}

// One column chunk of a tile, run by the two product warpgroups (wg 0, 1,
// each NW of its 2*NW columns): the products of its nk K slices, ring
// iterations G0 .. G0 + nk - 1, pipelined with one wgmma group in flight
// (accumulators untouched inside), then its ACC addends staged for the
// reduce-add (stage_chunk); the product warps never read ACC.  The chunk
// is the ring's (G0 / nk)-th, so its staging buffer's uses begin at
// kParts * G0 / nk.
template <int L, int CB, int NW>
__device__ __forceinline__ void chunk(int (&d)[CB / kM][L][16 * (NW / 32)],
                                      const Ring& rg, int G0, int nk, int wg,
                                      int lane, int wrow, bool& stuck) {
  constexpr int MT = CB / kM;  // 64-row blocks of the tile
  constexpr int R = NW / 32;   // wgmma_s8<R> is m64n(NW)k32
  using St = Stage<L, MT, NW>;
  constexpr int kS = St::kStages;
  for (int sl = 0; sl < nk; ++sl) {
    const int G = G0 + sl, s = G % kS;
    const uint32_t st = rg.smem0 + s * St::kBytes;
    mbar_wait_or_give_up(rg.hfull + 8 * s, (G / kS) & 1, stuck);
    mbar_wait_or_give_up(rg.afull + 8 * s, (G / kS) & 1, stuck);
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
    // the products of iteration G may still run; those of G - 1 are done,
    // and its stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (sl > 0 && lane == 0) mbar_arrive(rg.empty + 8 * ((G - 1) % kS));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  if (lane == 0) mbar_arrive(rg.empty + 8 * ((G0 + nk - 1) % kS));
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int lb = 0; lb < L; ++lb) fence_regs(d[m][lb]);
  stage_chunk<L, CB, NW>(d, rg, St::kParts * (G0 / nk), wg, lane, wrow,
                         stuck);
}

// The reduce-add into ACC of a tile's block of `chunks` column chunks, the
// ring's chunks c0 .. c0 + chunks - 1 from column q_lo (one thread,
// neither a product warp's nor the copies' issuer): each part of a chunk
// once the product warps have staged it, one tensor reduce a box (TMA adds
// its uint32 values into ACC, [k1][batch][n], mod 2^32, and leaves out the
// rows past the batch), the buffer freed once TMA has read it; then the
// adds completed and fenced, so the block's ACC is visible to the cluster
// once the caller signals.
template <int L, int CB, int NW>
__device__ __forceinline__ void reduce_block(const Ring& rg,
                                             const CUtensorMap* acc_map,
                                             int c0, int chunks, int g0,
                                             int q_lo, int n, bool& stuck) {
  using St = Stage<L, CB / kM, NW>;
  constexpr int BP = St::kBoxes / St::kParts;
  const int log_n = __ffs(n) - 1;
  for (int ch = 0; ch < chunks; ++ch)
    for (int p = 0; p < St::kParts; ++p) {
      mbar_wait_or_give_up(rg.staged, (St::kParts * (c0 + ch) + p) & 1,
                           stuck);
      for (int wg = 0; wg < 2; ++wg)
        for (int x = 0; x < BP; ++x) {
          const int box = p * BP + x, m = box / (NW / 32);
          const int q = q_lo + ch * 2 * NW + wg * NW + 32 * (box % (NW / 32));
          tma_reduce_add(acc_map, rg.staging + (wg * BP + x) * St::kBox,
                         q & (n - 1), g0 + m * kM, q >> log_n);
        }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(rg.freed);
    }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __threadfence();
}

// A CTA's ring in its dynamic shared memory, the staging buffer after the
// stages, its mbarriers after that (and, for the paired schedule, its four
// cluster mbarriers after those, at freed + 8).
template <int L, int CB, int NW>
__device__ __forceinline__ Ring ring(const unsigned char* smem_raw) {
  using St = Stage<L, CB / kM, NW>;
  constexpr int kS = St::kStages;
  const uint32_t smem0 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t staging = smem0 + kS * St::kBytes;
  const uint32_t afull = staging + St::kStaging;
  return {smem0,           staging,         afull,
          afull + 8 * kS,  afull + 16 * kS, afull + 24 * kS,
          afull + 24 * kS + 8};
}

// Initialise the ring's mbarriers (one thread).
template <int L, int CB, int NW>
__device__ __forceinline__ void init_ring(const Ring& rg) {
  for (int s = 0; s < Stage<L, CB / kM, NW>::kStages; ++s) {
    mbar_init(rg.afull + 8 * s, 1);
    mbar_init(rg.hfull + 8 * s, 1);
    mbar_init(rg.empty + 8 * s, kThreads / 32);
  }
  mbar_init(rg.staged, kThreads / 32);
  mbar_init(rg.freed, 1);
}

template <int L, int CB, int NW>
__global__ void __launch_bounds__(kK1Threads, 1)
k1_kernel(const __grid_constant__ CUtensorMap dig_map,
          const __grid_constant__ CUtensorMap acc_map,
          const int32_t* __restrict__ b_init,
          const int32_t* __restrict__ a_t, const int32_t* __restrict__ tv,
          const int8_t* __restrict__ hankel, int32_t* out, int8_t* dig,
          int steps, int batch, int n, int k1, int l, int b, int cluster) {
  constexpr int CW = 2 * NW;   // coefficients a chunk (two warpgroups)
  constexpr int R = NW / 32;
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
  uint32_t* acc = reinterpret_cast<uint32_t*>(out);  // [k1][batch][n]
  const Ring rg = ring<L, CB, NW>(smem_raw);
  bool stuck = false;  // an mbarrier wait gave up: trap once the loops end

  if (tid == 0) {
    init_ring<L, CB, NW>(rg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Ring iteration G counts over all steps: step G / total, column chunk
  // (G % total) / nk, K slice G % nk.
  if (tid >= kThreads) {
    // ---- producer warpgroup: its first thread issues every copy (the H
    // blocks of a stage from the table, its digit tiles by TMA); the first
    // thread of its second warp reduce-adds each step's staged chunks into
    // ACC before the cluster barrier that closes the step
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const bool reducer = tid == kThreads + 32;
    for (int i = 0, G = 0; i < steps; ++i, G += total)
      produce<L, CB, NW>(rg, &dig_map, hankel, G, i, g0, q_lo, nk, total, n,
                         k1, rows, tid == kThreads, stuck, [&] {
                           if (reducer && i > 0)
                             reduce_block<L, CB, NW>(rg, &acc_map,
                                                     (i - 1) * chunks,
                                                     chunks, g0, q_lo, n,
                                                     stuck);
                           __syncwarp();
                           cluster_sync();  // ACC of the last step complete
                           cluster_sync();  // the digits of step i complete
                         });
    if (reducer)
      reduce_block<L, CB, NW>(rg, &acc_map, (steps - 1) * chunks, chunks, g0,
                              q_lo, n, stuck);
    if (stuck) __trap();
    return;
  }

  // ---- consumer warpgroups: digits, products, the ACC addends
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  init_acc(acc, b_init, tv, g0, CB, q_lo, span, batch, n, k1);
  auto load_amounts = [&](int i) {
    for (int r = tid; r < CB; r += kThreads)
      amt[i & 1][r] =
          g0 + r < batch ? a_t[static_cast<size_t>(i) * batch + g0 + r] : 0;
  };
  load_amounts(0);

  int d[CB / kM][L][16 * R];
  for (int i = 0, G = 0; i < steps; ++i, G += total) {
    cluster_sync();  // ACC of the last step is complete; its digits consumed
    digit_pass<CB, true>(acc, dig, amt[i & 1], g0, q_lo, span, batch, n, l, b,
                         K);
    cluster_sync();  // the tile's digits of step i are complete
    for (int ch = 0; ch < chunks; ++ch)
      chunk<L, CB, NW>(d, rg, G + ch * nk, nk, wg, lane, wrow, stuck);
    if (i + 1 < steps) load_amounts(i + 1);
  }
  if (stuck) __trap();
}

// Arrive on mbarrier `bar` (an address of this CTA's shared memory) of CTA
// `cta` of the cluster, releasing this thread's earlier writes to it.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(cta));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// A warp tells every CTA of the cluster that its global writes (ACC,
// digits) are complete: each thread's writes visible to the cluster, TMA
// reads included, then lane j arrives on CTA j's `bar`.
__device__ __forceinline__ void signal_cluster(uint32_t bar, int cluster,
                                               int lane) {
  __threadfence();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __syncwarp();
  if (lane < cluster) mbar_arrive_cluster(bar, lane);
}

// Wait for the phase of parity `parity` of a barrier the cluster's CTAs
// arrive on (signal_cluster): their writes are visible after it, TMA reads
// included.  Gives up as mbar_wait_or_give_up.
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity,
                                             bool& stuck) {
  for (int spin = 0; !stuck; ++spin) {
    if (spin >= kSpin) {
      stuck = true;
      return;
    }
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) break;
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The paired schedule: each cluster carries two tiles, A (the pair's first)
// and B, over the same span and the same n steps, in turns.  The ring's
// blocks of iterations run A's step 0, B's step 0, A's step 1, ...; the
// product warpgroups take them in that order and stage each chunk's ACC
// addends, so while they multiply B's step i, a reducing warp adds A's
// step i into ACC and tells the cluster, six digit warps (the third
// warpgroup and two of the producer's) wait for A's ACC in the cluster and
// write A's digits of step i + 1, and the producer's TMA of them waits for
// those digits in the cluster: one tile's epilogue, digit pass, cluster
// barriers and TMA latency run under the other tile's products.
// Each tile has its own two cluster barriers, mbarriers every CTA of the
// cluster arrives on (signal_cluster): acc_done[t] (the reducing warp's
// ACC of the last step, or the initial ACC) and dig_done[t] (the digit
// warps' digits of the step).  A pair whose B lies past the batch (an odd
// tile count) runs A alone.
template <int L, int CB, int NW>
__global__ void __launch_bounds__(kPairThreads, 1)
k1_kernel_pair(const __grid_constant__ CUtensorMap dig_map,
               const __grid_constant__ CUtensorMap acc_map,
               const int32_t* __restrict__ b_init,
               const int32_t* __restrict__ a_t,
               const int32_t* __restrict__ tv,
               const int8_t* __restrict__ hankel, int32_t* out, int8_t* dig,
               int steps, int batch, int n, int k1, int l, int b,
               int cluster) {
  constexpr int CW = 2 * NW;
  constexpr int R = NW / 32;
  constexpr int kInitThreads = kDigitThreads + 32;  // and the reducing warp
  extern __shared__ unsigned char smem_raw[];
  __shared__ int amt[CB];  // the digit warps' amounts of their (step, tile)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;
  const int rank = static_cast<int>(cluster_rank());
  const int g0 = (blockIdx.x / cluster) * 2 * CB;  // tile A's first; B's + CB
  const int tiles = g0 + CB < batch ? 2 : 1;
  const int kn = k1 * n;
  const int span = kn / cluster;
  const int q_lo = rank * span;
  const int rows = k1 * l;
  const int K = rows * n;
  const int nk = K / kSlice;
  const int chunks = span / CW;
  const int total = chunks * nk;
  uint32_t* acc = reinterpret_cast<uint32_t*>(out);
  const Ring rg = ring<L, CB, NW>(smem_raw);
  const uint32_t acc_done = rg.freed + 8;  // [2], then dig_done [2]
  const uint32_t dig_done = acc_done + 16;
  bool stuck = false;

  if (tid == 0) {
    init_ring<L, CB, NW>(rg);
    for (int t = 0; t < 2; ++t) {
      mbar_init(acc_done + 8 * t, cluster);
      mbar_init(dig_done + 8 * t, cluster * kDigitThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's mbarriers set before a peer arrives on them

  // the initial ACC of both tiles, by the digit warps and the reducing
  // warp (this thread the it-th of them), visible to the cluster's digit
  // passes and to the reduce-adds
  auto init = [&](int it) {
    for (int t = 0; t < tiles; ++t)
      init_acc(acc, b_init, tv, g0 + t * CB, CB, q_lo, span, batch, n, k1,
               it, kInitThreads);
    __threadfence();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    asm volatile("bar.sync 2, %0;\n" ::"n"(kInitThreads) : "memory");
  };
  // ---- digit warps (the digit warpgroup's four, the producer's second
  // and third): the digits of each (step, tile) in the ring's order, each
  // once the tile's ACC of the last step is complete in the cluster
  auto write_digits = [&](int dt) {
    init(dt);
    for (int i = 0; i < steps; ++i)
      for (int t = 0; t < tiles; ++t) {
        const int gt = g0 + t * CB;
        for (int r = dt; r < CB; r += kDigitThreads)
          amt[r] =
              gt + r < batch ? a_t[static_cast<size_t>(i) * batch + gt + r]
                             : 0;
        asm volatile("bar.sync 1, %0;\n" ::"n"(kDigitThreads) : "memory");
        wait_cluster(acc_done + 8 * t, i & 1, stuck);
        digit_pass<CB, true, kDigitThreads, kDigitUnroll>(
            acc, dig, amt, gt, q_lo, span, batch, n, l, b, K, dt);
        signal_cluster(dig_done + 8 * t, cluster, lane);
        // every read of the amounts done before the next block's
        asm volatile("bar.sync 1, %0;\n" ::"n"(kDigitThreads) : "memory");
      }
  };
  // Ring iteration G counts over the blocks (step i, tile t), i * tiles +
  // t, total a block.
  if (wg == 3) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kPairDigitRegs));
    if (warp == 12) {
      // ---- producer warp: its first thread issues every copy
      const bool issuer = lane == 0;
      for (int i = 0, G = 0; i < steps; ++i)
        for (int t = 0; t < tiles; ++t, G += total)
          produce<L, CB, NW>(rg, &dig_map, hankel, G, i, g0 + t * CB, q_lo,
                             nk, total, n, k1, rows, issuer, stuck, [&] {
                               if (issuer)  // tile t's digits of step i
                                 wait_cluster(dig_done + 8 * t, i & 1,
                                              stuck);
                             });
    } else if (warp == 15) {
      // ---- reducing warp: its first thread reduce-adds each (step,
      // tile) block the product warps staged, in their order; the warp
      // then tells the cluster that the tile's ACC is complete
      init(kDigitThreads + lane);
      for (int t = 0; t < tiles; ++t)
        signal_cluster(acc_done + 8 * t, cluster, lane);
      for (int i = 0; i < steps; ++i)
        for (int t = 0; t < tiles; ++t) {
          if (lane == 0)
            reduce_block<L, CB, NW>(rg, &acc_map, (i * tiles + t) * chunks,
                                    chunks, g0 + t * CB, q_lo, n, stuck);
          __syncwarp();
          if (i + 1 < steps) signal_cluster(acc_done + 8 * t, cluster, lane);
        }
    } else {
      write_digits(tid - kThreads - 32);  // 128 .. 191
    }
  } else if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kPairDigitRegs));
    write_digits(tid - kThreads);
  } else {
    // ---- product warpgroups: each (step, tile) block's chunks, staged
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kPairConsumerRegs));
    int d[CB / kM][L][16 * R];
    for (int G = 0; G < steps * tiles * total; G += nk)
      chunk<L, CB, NW>(d, rg, G, nk, wg, lane, wrow, stuck);
  }
  cluster_sync();  // no CTA leaves while a peer may still arrive on it
  if (stuck) __trap();
}

template <int L, int CB, int NW>
cudaError_t launch(const void* b_init, const void* a_t, const void* tv,
                   const void* hankel, void* out, void* dig, int steps,
                   int batch, int n, int k1, int l, int b, int cluster,
                   int pair, cudaStream_t stream) {
  const int smem = Stage<L, CB / kM, NW>::kSmem;
  auto kern = pair == 2 ? k1_kernel_pair<L, CB, NW> : k1_kernel<L, CB, NW>;
  cudaError_t err = prepare_kernel(kern, cluster, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (batch + CB - 1) / CB;
  const uint64_t K = static_cast<uint64_t>(k1) * l * n;
  CUtensorMap dig_map, acc_map;
  err = encode(&dig_map, dig, K, static_cast<uint64_t>(tiles) * CB, CB);
  if (err != cudaSuccess) return err;
  // ACC, [k1][batch][n] uint32, in boxes of 64 rows x 32 columns: a box of
  // a chunk stays inside one component (n is a multiple of 256), and rows
  // past the batch lie outside the tensor
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch),
                              static_cast<cuuint64_t>(k1)};
  const cuuint64_t strides[2] = {4ull * n, 4ull * n * batch};
  const cuuint32_t box[3] = {32, kM, 1};
  err = encode_tiled(&acc_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, out, dims,
                     strides, box);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      (tiles + pair - 1) / pair * cluster, cluster, smem, attr, stream,
      pair == 2 ? kPairThreads : kK1Threads);
  err = cudaLaunchKernelEx(&cfg, kern, dig_map, acc_map,
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
// per warpgroup (32 or 64), `cluster` the CTAs per tile, `pair` the tiles a
// cluster carries (1, or 2 in turns: k1_kernel_pair), `dig` a
// [ceil(batch/cb)*cb, K] int8 scratch, `hankel` the keys' table of H
// blocks [n][L*(k+1)][rows][2N/8][128] (16-aligned; ops/fused_blind_rotate.py
// hankel_table).
extern "C" int fbr_k1_blind_rotate(const void* b_init, const void* a_t,
                                   const void* tv, const void* hankel,
                                   void* out, void* dig, int steps,
                                   int batch, int n, int k1, int l, int b,
                                   int n_limbs, int cb, int nw, int cluster,
                                   int pair, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (pair != 1 && pair != 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define FBR_K1_LAUNCH(L, CB, NW)                                             \
  if (n_limbs == L && cb == CB && nw == NW)                                  \
    return static_cast<int>(fbr::k1::launch<L, CB, NW>(                      \
        b_init, a_t, tv, hankel, out, dig, steps, batch, n, k1, l, b,       \
        cluster, pair, st));
  FBR_K1_CASES(FBR_K1_LAUNCH)
#undef FBR_K1_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `cluster` CTAs of the schedule carrying `pair` tiles
// the card runs at once (cudaOccupancyMaxActiveClusters), into *count.
extern "C" int fbr_k1_max_clusters(int n_limbs, int cb, int nw, int cluster,
                                   int pair, int* count) {
#define FBR_K1_OCC(L, CB, NW)                                               \
  if (n_limbs == L && cb == CB && nw == NW)                                 \
    return static_cast<int>(                                                \
        pair == 2 ? fbr::max_active_clusters(                               \
                        fbr::k1::k1_kernel_pair<L, CB, NW>, cluster,        \
                        fbr::k1::Stage<L, CB / fbr::kM, NW>::kSmem, count,  \
                        fbr::k1::kPairThreads)                              \
                  : fbr::max_active_clusters(                               \
                        fbr::k1::k1_kernel<L, CB, NW>, cluster,             \
                        fbr::k1::Stage<L, CB / fbr::kM, NW>::kSmem, count,  \
                        fbr::k1::kK1Threads));
  FBR_K1_CASES(FBR_K1_OCC)
#undef FBR_K1_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}

// The ring stages and the dynamic shared memory a CTA of (n_limbs, cb, nw)
// launches with, into *stages and *smem (either schedule).
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
