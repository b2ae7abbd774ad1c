// Device code shared by the two fused blind-rotation kernels, K1
// (fused_blind_rotate.cu, compact keys, the key operand built on chip) and K2
// (fused_blind_rotate_k2.cu, precomputed K-major key matrices that TMA
// stages).  Both run a tile of ciphertexts on a thread-block cluster whose
// CTAs split the (k+1)*N output coefficients, contract on int8 tensor cores
// (wgmma), keep ACC in the output tensor and the digits in an L2-resident
// scratch, and order the CTAs with cluster barriers.  Both replace bodies of
// the Pallas kernel in tfhe_fbs_map_tpu/ops/fused_blind_rotate.py: the
// rotation and the digits below are its _barrel_rotate and
// _decompose_digits.
//
// Torus arithmetic is uint32_t throughout: adds, negations and the
// << 8*(limb+drop) limb shifts wrap mod 2^32 by definition, where the same
// operations on signed ints would be undefined on overflow.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fbr {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kKc = 128;        // contraction bytes a ring stage: a swizzle row
constexpr int kM = 64;          // wgmma's M: digit rows per block
constexpr int kUnroll = 4;      // digit-pass groups of 4 coefficients in flight
// mbarrier polls (seconds) before a wait traps (K2) or gives up (K1); a
// test build lowers it (-DFBR_SPIN=0: K1's first wait gives up).
#ifndef FBR_SPIN
#define FBR_SPIN (1 << 24)
#endif
constexpr int kSpin = FBR_SPIN;

// Coefficient t of X^a * row, a in [0, 2N), row of length N (a power of
// two): the cyclic rotation by a mod N, negated where
// (t < a mod N) XOR (a >= N).  Equal to the TPU kernel's _barrel_rotate;
// on Hopper it is one indexed read.
__device__ __forceinline__ uint32_t rotated_coef(const uint32_t* row, int t,
                                                 int a, int n) {
  const int am = a & (n - 1);
  const uint32_t v = row[(t - am) & (n - 1)];
  const bool neg = (t < am) != ((a & n) != 0);
  return neg ? 0u - v : v;
}

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

// This thread's shared-memory writes become visible to the async proxy
// (wgmma operand reads) after the next barrier.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// The same wait without a trap: after kSpin polls it gives up and sets
// `stuck`, and every later wait returns at once.  A trap reachable inside a
// pipelined wgmma loop makes ptxas wait for every wgmma in flight there
// (C7517), so the kernel traps on `stuck` only once its loops are done: the
// fault still ends the launch with a CUDA error, not with a wrong result.
__device__ __forceinline__ void mbar_wait_or_give_up(uint32_t bar,
                                                     uint32_t parity,
                                                     bool& stuck) {
  for (int spin = 0; !stuck; ++spin) {
    if (spin >= kSpin) {
      stuck = true;
      return;
    }
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// Bulk copy of `bytes` (a multiple of 16) from global `src` to shared
// `dst` (both 16-aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// 3-D TMA reduce-add of one box from shared `src` into the tensor of `map`
// at (x, y, z), in the current bulk group; elements outside the tensor are
// left out.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               uint32_t src, int x, int y,
                                               int z) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t a,
                                             uint32_t b) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a),
               "r"(b)
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

// wgmma descriptor of a K-major operand without swizzle: 8-row x 16-byte
// core matrices of 128 contiguous bytes, `lbo` bytes apart along K and
// `sbo` bytes apart along M/N; `addr` 16-aligned.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (+)= A (64x32, K-major, shared) * B (32Rx32, K-major, shared), s32.
template <int R>
__device__ __forceinline__ void wgmma_s8(int (&d)[16 * R], uint64_t da,
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

// ACC = (0, ..., 0, X^{b_init} * tv) on coefficients [q_lo, q_lo + span)
// of the tile's ciphertexts g0 .. g0 + cb - 1; ACC is [k1][batch][n].
// `threads` threads, this one the tid-th.
__device__ __forceinline__ void init_acc(uint32_t* acc, const int32_t* b_init,
                                         const int32_t* tv, int g0, int cb,
                                         int q_lo, int span, int batch,
                                         int n, int k1,
                                         int tid = threadIdx.x,
                                         int threads = kThreads) {
  const int log_n = __ffs(n) - 1;
  for (int e = tid; e < cb * span; e += threads) {
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
}

// Digits of X^{a_i} * ACC - ACC on this CTA's coefficients [q_lo, q_lo +
// span) of the tile's CB ciphertexts (rotation amounts `amt`), balanced and
// biased-added as the TPU kernel's _decompose_digits, into the int8 scratch
// [tiles*CB][K] at row g and column (c*l + lev)*n + t, or at the reversed
// column (c*l + lev)*n + n - 1 - t where REVERSE.  ACC is read through L2
// (.cg): peer CTAs own the rotated source coefficients.  THREADS threads
// (this one the tid-th) take groups of 4 coefficients, THREADS groups a
// round, UNROLL groups in flight, stepped without divisions; rows past the
// batch get zero digits (a zero ciphertext stays zero).
template <int CB, bool REVERSE, int THREADS = kThreads, int UNROLL = kUnroll>
__device__ __forceinline__ void digit_pass(const uint32_t* acc, int8_t* dig,
                                           const int* amt, int g0, int q_lo,
                                           int span, int batch, int n, int l,
                                           int b, int K,
                                           int tid = threadIdx.x) {
  const int log_n = __ffs(n) - 1;
  const int span4 = span / 4;
  const int row_step = THREADS / span4, grp_step = THREADS % span4;
  const int bl = b * l, half = 1 << (b - 1);
  const uint32_t mask = (1u << b) - 1, rnd = 1u << (31 - bl);
  uint32_t bias = 0;
  for (int j = 0; j < l; ++j) bias += static_cast<uint32_t>(half) << (b * j);

  for (int row = tid / span4, grp = tid % span4; row < CB;) {
    uint32_t diff[UNROLL][4];
    int rows[UNROLL], grps[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      rows[u] = row;
      grps[u] = grp;
      const int g = g0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) diff[u][j] = 0;
      if (row < CB && g < batch) {
        const int q = q_lo + 4 * grp, c = q >> log_n, t = q & (n - 1);
        const uint32_t* src = acc + (static_cast<size_t>(c) * batch + g) * n;
        const int a = amt[row];
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
    for (int u = 0; u < UNROLL; ++u) {
      if (rows[u] >= CB) break;
      const int g = g0 + rows[u];
      const int q = q_lo + 4 * grps[u], c = q >> log_n, t = q & (n - 1);
      uint32_t* dp = reinterpret_cast<uint32_t*>(
          dig + static_cast<size_t>(g) * K + c * l * n +
          (REVERSE ? n - 4 - t : t));
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = ((diff[u][j] + rnd) >> (32 - bl)) + bias;
      for (int lev = 0; lev < l; ++lev) {
        const int sh = b * (l - 1 - lev);
        uint32_t packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          packed |= ((((w[j] >> sh) & mask) - half) & 0xFFu)
                    << (8 * (REVERSE ? 3 - j : j));
        dp[lev * (n / 4)] = g < batch ? packed : 0u;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A tensor map of `rank` dimensions (innermost first), 128B swizzle: byte
// strides of the outer ones, the box, elements of `type`.
inline cudaError_t encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                                int rank, const void* base,
                                const cuuint64_t* dims,
                                const cuuint64_t* strides,
                                const cuuint32_t* box) {
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
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of a row-major [rows][cols] int8 matrix, boxes of 128 bytes by
// `box_rows`, 128B swizzle; rows past the end read as zeros.
inline cudaError_t encode(CUtensorMap* map, const void* base, uint64_t cols,
                          uint64_t rows, uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKc), box_rows};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims,
                      strides, box);
}

// Launch configuration of `blocks` CTAs of `threads` in clusters of
// `cluster`; `attr` holds the cluster attribute.
inline cudaLaunchConfig_t cluster_config(int blocks, int cluster, int smem,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t stream,
                                         int threads = kThreads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
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

// Opt a kernel into `smem` bytes of dynamic shared memory and, above 8,
// into non-portable cluster sizes.
template <typename Kernel>
cudaError_t prepare_kernel(Kernel kern, int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// How many clusters of `cluster` CTAs with `smem` bytes each the card runs
// at once (cudaOccupancyMaxActiveClusters), into *count.
template <typename Kernel>
cudaError_t max_active_clusters(Kernel kern, int cluster, int smem,
                                int* count, int threads = kThreads) {
  cudaError_t err = prepare_kernel(kern, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster * 64, cluster, smem, attr, 0, threads);
  return cudaOccupancyMaxActiveClusters(count, kern, &cfg);
}

}  // namespace fbr
