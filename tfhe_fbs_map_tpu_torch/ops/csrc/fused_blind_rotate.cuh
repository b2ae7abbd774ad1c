// Device functions shared by the two fused blind-rotation kernels: K1
// (fused_blind_rotate.cu, scalar dp4a over compact key extensions) and K2
// (fused_blind_rotate_k2.cu, int8 wgmma over K-major key matrices that TMA
// stages in a shared-memory ring, one ciphertext tile per thread-block
// cluster whose CTAs split the key columns).  Both replace bodies of the
// Pallas kernel in
// tfhe_fbs_map_tpu/ops/fused_blind_rotate.py: the rotation and the digits
// below are its _barrel_rotate and _decompose_digits.
//
// Torus arithmetic is uint32_t throughout: adds, negations and the
// << 8*(limb+drop) limb shifts wrap mod 2^32 by definition, where the same
// operations on signed ints would be undefined on overflow.
#pragma once

#include <cstdint>

namespace fbr {

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

// Rounded top b*l bits of x plus `half` at every digit position: each
// balanced digit is then one shift, mask and subtract (the biased add of
// the TPU kernel's _decompose_digits).  Needs b*l < 32.
__device__ __forceinline__ uint32_t biased_digits(uint32_t x, int b, int l) {
  const int bl = b * l;
  uint32_t w = (x + (1u << (31 - bl))) >> (32 - bl);
  for (int i = 0; i < l; ++i) w += (1u << (b - 1)) << (b * i);
  return w;
}

// Digit `lev` (0 = most significant) of a biased word, in [-2^(b-1), 2^(b-1)).
__device__ __forceinline__ int digit_at(uint32_t w, int b, int l, int lev) {
  const int i = l - 1 - lev;
  return static_cast<int>((w >> (b * i)) & ((1u << b) - 1)) - (1 << (b - 1));
}

// K1's contraction for output columns t0..t0+3 of one chunk, read straight
// from the chunk's anti-periodic extensions E[rows][2N] in shared memory:
// M[(r, j), t] = E[r][N + t - j].  For digits j..j+3 and column t0+q the
// four key bytes are E[r][N + t0 + q - j - s], s = 0..3, which lie in the
// two aligned words around N + t0 - j.
template <int CB>
__device__ __forceinline__ void otf_dot(int (&s)[CB][4],
                                        const int8_t* __restrict__ ext,
                                        int t0, int n, int rows,
                                        const int* __restrict__ dig32) {
  const int q4 = rows * n / 4;
  for (int r = 0; r < rows; ++r) {
    const int8_t* er = ext + static_cast<size_t>(r) * 2 * n + n + t0;
#pragma unroll 2
    for (int j4 = 0; j4 < n / 4; ++j4) {
      const int8_t* p = er - 4 * j4;
      const uint32_t lo = *reinterpret_cast<const uint32_t*>(p - 4);
      const uint32_t hi = *reinterpret_cast<const uint32_t*>(p);
      const int c[4] = {static_cast<int>(__byte_perm(lo, hi, 0x1234)),
                        static_cast<int>(__byte_perm(lo, hi, 0x2345)),
                        static_cast<int>(__byte_perm(lo, hi, 0x3456)),
                        static_cast<int>(__byte_perm(lo, hi, 0x4567))};
      const int r4 = r * (n / 4) + j4;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const int d = dig32[cb * q4 + r4];
#pragma unroll
        for (int q = 0; q < 4; ++q) s[cb][q] = __dp4a(c[q], d, s[cb][q]);
      }
    }
  }
}

}  // namespace fbr
