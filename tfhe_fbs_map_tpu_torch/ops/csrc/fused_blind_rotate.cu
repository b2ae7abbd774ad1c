// K1, the "fused_otf" blind rotation, for Hopper (sm_90a): all n CMux steps
// in one launch.  K2 ("fused") is in fused_blind_rotate_k2.cu.
//
// Replaces _kernel_otf of tfhe_fbs_map_tpu/ops/fused_blind_rotate.py
// (:160-242): compact anti-periodic limb extensions, keys
// [n, L*(k+1), rows, 2N] int8.  The TPU ran the n steps as a sequential grid
// axis over one core; here the step loop sits inside the kernel and one
// block owns a tile of CB ciphertexts for all n steps, with the tile's
// accumulator [k+1][CB][N] uint32 and digits [CB][rows*N] int8 in shared
// memory.  Slots past the batch (the ragged last tile) run a zero
// ciphertext and are not stored.
//
// Each step: digits of X^{a_i}*ACC - ACC (index reads, biased-add digits),
// then for every limb and output component
//   ACC[comp] += (digits @ M_{limb,comp}) << 8*(limb + drop)   (mod 2^32)
// with int8 x int8 -> int32 dp4a MACs, the negacyclic matrix read straight
// out of the limb's extensions in shared memory, M[j, t] = E[N + t - j].  A
// thread owns four adjacent columns of one component for all limbs, so its
// shared-memory updates never race.
//
// Bound on the H100: MACs; its 42.6 MB of keys at the aes128_p4 preset
// nearly fit the 50 MB L2.  It uses scalar dp4a; tensor cores are later
// work.
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_blind_rotate.cuh"

namespace fbr {

template <int CB>
__global__ void __launch_bounds__(512)
blind_rotate_kernel(const int32_t* __restrict__ b_init,
                    const int32_t* __restrict__ a_t,
                    const int32_t* __restrict__ tv,
                    const int8_t* __restrict__ keys,
                    int32_t* __restrict__ out, int steps, int batch, int n,
                    int k1, int l, int b, int n_limbs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = k1 * l;
  const int rows_n = rows * n;
  const int elems = k1 * CB * n;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);          // [k1][CB][n]
  int8_t* dig = reinterpret_cast<int8_t*>(smem + sizeof(uint32_t) * elems);
  const int* dig32 = reinterpret_cast<const int*>(dig);       // [CB][rows_n]
  int8_t* ext = dig + CB * rows_n;                    // [k1][rows][2n]
  const int b0 = blockIdx.x * CB;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int drop = 4 - n_limbs;

  // ACC = (0, ..., 0, X^{b_init} * tv)
  for (int e = tid; e < elems; e += nthr) {
    const int c = e / (CB * n), rem = e % (CB * n);
    const int g = b0 + rem / n, t = rem % n;
    uint32_t v = 0;
    if (c == k1 - 1 && g < batch)
      v = rotated_coef(
          reinterpret_cast<const uint32_t*>(tv) + static_cast<size_t>(g) * n,
          t, b_init[g], n);
    acc[e] = v;
  }
  __syncthreads();

  for (int i = 0; i < steps; ++i) {
    // digits of X^{a_i} * ACC - ACC, row (c*l + lev) of each ciphertext
    for (int e = tid; e < elems; e += nthr) {
      const int c = e / (CB * n), rem = e % (CB * n);
      const int cb = rem / n, t = rem % n, g = b0 + cb;
      const int a = g < batch ? a_t[static_cast<size_t>(i) * batch + g] : 0;
      const uint32_t* row = acc + (c * CB + cb) * n;
      const uint32_t w = biased_digits(rotated_coef(row, t, a, n) - row[t],
                                       b, l);
      int8_t* dp = dig + static_cast<size_t>(cb) * rows_n + c * l * n + t;
      for (int lev = 0; lev < l; ++lev)
        dp[lev * n] = static_cast<int8_t>(digit_at(w, b, l, lev));
    }
    __syncthreads();

    for (int limb = 0; limb < n_limbs; ++limb) {
      // this limb's extensions for all k+1 output components
      const uint4* src = reinterpret_cast<const uint4*>(
          keys + (static_cast<size_t>(i) * n_limbs + limb) * k1 * rows_n * 2);
      uint4* dst = reinterpret_cast<uint4*>(ext);
      const int words = k1 * rows_n * 2 / 16;
      for (int w = tid; w < words; w += nthr) dst[w] = src[w];
      __syncthreads();
      const uint32_t shift = 8u * static_cast<uint32_t>(limb + drop);
      for (int cg = tid; cg < k1 * n / 4; cg += nthr) {
        const int comp = cg * 4 / n, t0 = cg * 4 % n;
        int s[CB][4];
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[cb][q] = 0;
        otf_dot<CB>(s, ext + static_cast<size_t>(comp) * rows_n * 2, t0, n,
                    rows, dig32);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[(comp * CB + cb) * n + t0 + q] +=
                static_cast<uint32_t>(s[cb][q]) << shift;
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < elems; e += nthr) {
    const int c = e / (CB * n), rem = e % (CB * n);
    const int g = b0 + rem / n, t = rem % n;
    if (g < batch)
      out[(static_cast<size_t>(c) * batch + g) * n + t] =
          static_cast<int32_t>(acc[e]);
  }
}

template <int CB>
cudaError_t launch(const void* b_init, const void* a_t, const void* tv,
                   const void* keys, void* out, int steps, int batch, int n,
                   int k1, int l, int b, int n_limbs, int threads, int smem,
                   cudaStream_t stream) {
  auto kern = blind_rotate_kernel<CB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + CB - 1) / CB;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const int32_t*>(b_init), static_cast<const int32_t*>(a_t),
      static_cast<const int32_t*>(tv), static_cast<const int8_t*>(keys),
      static_cast<int32_t*>(out), steps, batch, n, k1, l, b, n_limbs);
  return cudaGetLastError();
}

}  // namespace fbr

// C entry: returns the launch's cudaError_t (0 on success).  `tile` is the
// number of ciphertexts per block, one of 1, 2, 4, 8.
extern "C" int fbr_k1_blind_rotate(const void* b_init, const void* a_t,
                                   const void* tv, const void* keys,
                                   void* out, int steps, int batch, int n,
                                   int k1, int l, int b, int n_limbs,
                                   int tile, int threads, int smem,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define FBR_CASE(CB)                                                         \
  if (tile == CB)                                                            \
    return static_cast<int>(fbr::launch<CB>(b_init, a_t, tv, keys, out,      \
                                            steps, batch, n, k1, l, b,       \
                                            n_limbs, threads, smem, st));
  FBR_CASE(1)
  FBR_CASE(2)
  FBR_CASE(4)
  FBR_CASE(8)
#undef FBR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fbr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
