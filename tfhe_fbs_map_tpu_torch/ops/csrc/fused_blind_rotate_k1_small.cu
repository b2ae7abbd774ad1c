// K1 at N = 32, 64 and 128, the "fused_otf" blind rotation for the rings
// that K1's 256-byte contraction slices do not divide (sm_90a): all n CMux
// steps of a tile of ciphertexts in one launch, the contraction on int8
// tensor cores (mma.sync m16n8k32) with the key operand read out of the
// compact keys in shared memory.
//
// Replaces _kernel_otf of tfhe_fbs_map_tpu/ops/fused_blind_rotate.py
// (:160-242) at N < 256 (the Pallas kernel takes any N, with its strip
// tile T = min(128, N), :248-252).  Keys: [n, L*(k+1), rows, 2N] int8, the
// anti-periodic limb extensions E = [limbs(-poly), limbs(poly)] of every
// (step, limb, comp, row); step i's negacyclic matrix is
// M[(r, j), t] = E[N + t - j], and
//   ACC[comp] += sum_limb (digits @ M_{limb,comp}) << 8*(limb + drop).
//
// The design is simple on purpose: one CTA of eight warps owns a tile of
// kCB = 16 ciphertexts (mma's M) for all n steps, with the tile's ACC
// [k+1][16][N] in shared memory.  A step walks the k+1 input components:
// the CTA copies the step's E rows of that component (L*(k+1) runs of
// l*2N bytes, 9.2 KB at k=2, N=128, l=3) from device memory into shared
// memory and writes the component's digits there, reversed within each
// row's N block (j' = N-1-j), which makes the key operand the Hankel
// matrix B'[(lev, j'), t] = E[t + j' + 1] (as in K1, fused_blind_rotate.cu):
// a B fragment of m16n8k32 is two 4-byte windows of one E row, read as two
// aligned words and a funnel shift.  Warp w owns the n8 output tiles w,
// w+8, ... of the (k+1)*N columns (NT of them) and keeps one int32
// fragment a (limb, tile) over the whole contraction; after the last
// component it adds them, shifted by limb, into ACC.
//
// What bounds it on the H100: nothing at these sizes is large.  A step at
// k=2, N=128, l=3, L=4 is 16 x 1,152 x 1,536 int8 MACs a tile; the
// operands come from shared memory through ldmatrix-free 32-bit loads, two
// loads and a shift a B register, so the shared-memory pipe, not the
// tensor cores, bounds the products, and the two barriers and the digit
// pass a component are serial around them.  Making it fast is later work.
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

constexpr int kCB = 16;                   // ciphertexts a CTA: mma's M
constexpr int kWarps = 8;                 // warps a CTA
constexpr int kThreadsS = 32 * kWarps;
constexpr int kAccPad = 8;   // words past each ACC row (epilogue banks)
constexpr int kDigPad = 16;  // bytes past each digit row (fragment banks)
constexpr int kEPad = 16;    // bytes past the E rows (a window's 2nd word)

// Dynamic shared memory of a CTA: ACC [k1][kCB][n + kAccPad] uint32, the
// digits [kCB][l*n + kDigPad] int8, the E rows [L][k1][l][2n] int8 (the
// launch side asks fbr_k1s_layout for it).
__host__ __device__ inline int acc_bytes(int n, int k1) {
  return 4 * k1 * kCB * (n + kAccPad);
}
__host__ __device__ inline int dig_bytes(int n, int l) {
  return kCB * (l * n + kDigPad);
}
inline int smem_bytes(int n, int k1, int l, int limbs) {
  return acc_bytes(n, k1) + dig_bytes(n, l) + limbs * k1 * l * 2 * n + kEPad;
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

template <int L, int NT>
__global__ void __launch_bounds__(kThreadsS)
k1s_kernel(const int32_t* __restrict__ b_init,
           const int32_t* __restrict__ a_t, const int32_t* __restrict__ tv,
           const int8_t* __restrict__ keys, int32_t* __restrict__ out,
           int steps, int batch, int n, int k1, int l, int b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int g0 = blockIdx.x * kCB;            // first ciphertext of the tile
  const int log_n = __ffs(n) - 1;
  const int accw = n + kAccPad;               // words an ACC row
  const int drow = l * n + kDigPad;           // bytes a digit row
  const int rows = k1 * l, two_n = 2 * n;
  const int tiles = k1 * n / 8;               // n8 output tiles
  constexpr int drop = 4 - L;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);  // [k1][kCB][accw]
  int8_t* dig = reinterpret_cast<int8_t*>(smem + acc_bytes(n, k1));
  int8_t* es = dig + dig_bytes(n, l);                 // [L][k1][l][2n]

  // the digits' constants, as digit_pass in fused_blind_rotate.cuh
  const int bl = b * l, half = 1 << (b - 1);
  const uint32_t mask = (1u << b) - 1, rnd = 1u << (31 - bl);
  uint32_t bias = 0;
  for (int j = 0; j < l; ++j) bias += static_cast<uint32_t>(half) << (b * j);

  // ACC = (0, ..., 0, X^{b_init} * tv)
  for (int e = tid; e < k1 * kCB * n; e += kThreadsS) {
    const int c = e / (kCB * n), g = (e >> log_n) % kCB, t = e & (n - 1);
    const int gg = g0 + g;
    uint32_t v = 0;
    if (c == k1 - 1 && gg < batch)
      v = rotated_coef(
          reinterpret_cast<const uint32_t*>(tv) + static_cast<size_t>(gg) * n,
          t, b_init[gg], n);
    acc[(c * kCB + g) * accw + t] = v;
  }

  int d[L][NT][4];
  for (int i = 0; i < steps; ++i) {
#pragma unroll
    for (int lb = 0; lb < L; ++lb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[lb][nt][r] = 0;

    for (int ci = 0; ci < k1; ++ci) {
      // the last component's products and the epilogue are done with the
      // digits, the E rows and ACC
      __syncthreads();
      // E rows (ci*l .. ci*l + l - 1) of every (limb, comp): L*k1 runs
      const int run = l * two_n / 16;  // uint4 a run
      const uint4* src = reinterpret_cast<const uint4*>(keys);
      uint4* dst = reinterpret_cast<uint4*>(es);
      for (int e = tid; e < L * k1 * run; e += kThreadsS) {
        const int r = e / run, o = e - r * run;  // r = limb*k1 + comp
        dst[e] = __ldg(src + ((static_cast<size_t>(i) * L * k1 + r) * rows +
                              ci * l) * two_n / 16 + o);
      }
      // digits of X^{a_i} * ACC[ci] - ACC[ci], four coefficients a thread,
      // written reversed: coefficient t of level lev at lev*n + n-1-t
      for (int e = tid; e < kCB * (n / 4); e += kThreadsS) {
        const int g = e / (n / 4), t = 4 * (e % (n / 4)), gg = g0 + g;
        uint32_t* dp =
            reinterpret_cast<uint32_t*>(dig + g * drow + (n - 4 - t));
        if (gg >= batch) {
          for (int lev = 0; lev < l; ++lev) dp[lev * (n / 4)] = 0;
          continue;
        }
        const int a = a_t[static_cast<size_t>(i) * batch + gg];
        const uint32_t* row = acc + (ci * kCB + g) * accw;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = ((rotated_coef(row, t + j, a, n) - row[t + j] + rnd) >>
                  (32 - bl)) + bias;
        for (int lev = 0; lev < l; ++lev) {
          const int sh = b * (l - 1 - lev);
          uint32_t packed = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            packed |= ((((w[j] >> sh) & mask) - half) & 0xFFu)
                      << (8 * (3 - j));
          dp[lev * (n / 4)] = packed;
        }
      }
      __syncthreads();

      // products over the component's contraction (lev, j'), 32 at a time:
      // A[g][k] = digits, B'[k][t] = E[limb][comp][ci*l + lev][t + j' + 1]
      for (int lev = 0; lev < l; ++lev)
        for (int j0 = 0; j0 < n; j0 += 32) {
          const int8_t* ar = dig + lev * n + j0 + 4 * tig;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(ar + gid * drow);
          a[1] = *reinterpret_cast<const uint32_t*>(ar + (gid + 8) * drow);
          a[2] = *reinterpret_cast<const uint32_t*>(ar + gid * drow + 16);
          a[3] =
              *reinterpret_cast<const uint32_t*>(ar + (gid + 8) * drow + 16);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int tile = warp + kWarps * nt;
            if (tile < tiles) {
              const int q = 8 * tile + gid;  // this lane's B column
              const int co = q >> log_n, t = q & (n - 1);
              const int at = t + j0 + 4 * tig + 1;
#pragma unroll
              for (int lb = 0; lb < L; ++lb) {
                const int8_t* er = es + ((lb * k1 + co) * l + lev) * two_n;
                mma_s8(d[lb][nt], a, window(er, at), window(er, at + 16));
              }
            }
          }
        }
    }

    // ACC[comp] += sum_limb d << 8*(limb + drop): each (row, column) of the
    // fragments is this thread's alone, and no thread reads ACC until the
    // next step's first barrier
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int tile = warp + kWarps * nt;
      if (tile < tiles) {
        const int q = 8 * tile + 2 * tig;
        const int co = q >> log_n, t = q & (n - 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* ap = acc + (co * kCB + gid + 8 * h) * accw + t;
          uint32_t v0 = 0, v1 = 0;
#pragma unroll
          for (int lb = 0; lb < L; ++lb) {
            const uint32_t sh = 8u * static_cast<uint32_t>(lb + drop);
            v0 += static_cast<uint32_t>(d[lb][nt][2 * h]) << sh;
            v1 += static_cast<uint32_t>(d[lb][nt][2 * h + 1]) << sh;
          }
          ap[0] += v0;
          ap[1] += v1;
        }
      }
    }
  }
  __syncthreads();

  uint32_t* o = reinterpret_cast<uint32_t*>(out);  // [k1][batch][n]
  for (int e = tid; e < k1 * kCB * n; e += kThreadsS) {
    const int c = e / (kCB * n), g = (e >> log_n) % kCB, t = e & (n - 1);
    const int gg = g0 + g;
    if (gg < batch)
      o[(static_cast<size_t>(c) * batch + gg) * n + t] =
          acc[(c * kCB + g) * accw + t];
  }
}

template <int L, int NT>
cudaError_t launch(const void* b_init, const void* a_t, const void* tv,
                   const void* keys, void* out, int steps, int batch, int n,
                   int k1, int l, int b, cudaStream_t stream) {
  auto kern = k1s_kernel<L, NT>;
  const int smem = smem_bytes(n, k1, l, L);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<(batch + kCB - 1) / kCB, kThreadsS, smem, stream>>>(
      static_cast<const int32_t*>(b_init), static_cast<const int32_t*>(a_t),
      static_cast<const int32_t*>(tv), static_cast<const int8_t*>(keys),
      static_cast<int32_t*>(out), steps, batch, n, k1, l, b);
  return cudaGetLastError();
}

// CTAs of (L, NT) at this shape the current card runs at once.
template <int L, int NT>
cudaError_t resident(int n, int k1, int l, int* ctas) {
  auto kern = k1s_kernel<L, NT>;
  const int smem = smem_bytes(n, k1, l, L);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreadsS, smem);
  *ctas = sms * per_sm;
  return err;
}

// The shapes the kernel serves: N a power of two in [32, 128] and the n8
// tiles of the warps covering the (k+1)*N columns.
inline bool serves(int n, int k1, int nt) {
  return n >= 32 && n <= 128 && !(n & (n - 1)) && nt * 8 * kWarps >= k1 * n;
}

}  // namespace k1s
}  // namespace fbr

// (limbs, n8 output tiles a warp)
#define FBR_K1S_CASES(X)                                                   \
  X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(2, 1) X(2, 2) X(2, 4) X(2, 8) X(3, 1) \
  X(3, 2) X(3, 4) X(3, 8) X(4, 1) X(4, 2) X(4, 4) X(4, 8)

// C entry: returns the launch's cudaError_t (0 on success).  `nt` is the
// number of n8 output tiles a warp holds (nt * 8 warps * 8 >= (k+1)*N,
// k1_small_plan); N a power of two in [32, 128].
extern "C" int fbr_k1s_blind_rotate(const void* b_init, const void* a_t,
                                    const void* tv, const void* keys,
                                    void* out, int steps, int batch, int n,
                                    int k1, int l, int b, int n_limbs,
                                    int nt, void* stream) {
  using namespace fbr::k1s;
  if (!serves(n, k1, nt)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define FBR_K1S_LAUNCH(L, NT)                                                \
  if (n_limbs == L && nt == NT)                                              \
    return static_cast<int>(fbr::k1s::launch<L, NT>(                         \
        b_init, a_t, tv, keys, out, steps, batch, n, k1, l, b, st));
  FBR_K1S_CASES(FBR_K1S_LAUNCH)
#undef FBR_K1S_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a CTA launches with at (n, k1, l, n_limbs, nt),
// into *smem, and the CTAs the current card runs at once, into *ctas.
extern "C" int fbr_k1s_layout(int n, int k1, int l, int n_limbs, int nt,
                              int* smem, int* ctas) {
  using namespace fbr::k1s;
  if (!serves(n, k1, nt)) return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(n, k1, l, n_limbs);
#define FBR_K1S_RESIDENT(L, NT)                                              \
  if (n_limbs == L && nt == NT)                                              \
    return static_cast<int>(fbr::k1s::resident<L, NT>(n, k1, l, ctas));
  FBR_K1S_CASES(FBR_K1S_RESIDENT)
#undef FBR_K1S_RESIDENT
  return static_cast<int>(cudaErrorInvalidValue);
}
