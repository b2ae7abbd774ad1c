// Device functions shared by the two fused blind-rotation kernels (K1, K2).
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

// K2's contraction for four adjacent output columns of one limb chunk:
// s[c][q] += sum_R digits[c][R] * K[R][col0 + q] over R < rows_n.  `kcol`
// points at K[0][col0] of a row-major [rows_n, ncol] int8 matrix; four rows
// of one column are gathered into one word with byte permutes so that a
// dp4a does four MACs.
template <int CB>
__device__ __forceinline__ void matrix_dot(int (&s)[CB][4],
                                           const int8_t* __restrict__ kcol,
                                           size_t ncol,
                                           const int* __restrict__ dig32,
                                           int rows_n) {
  const int q4 = rows_n / 4;
#pragma unroll 2
  for (int r4 = 0; r4 < q4; ++r4) {
    const int8_t* p = kcol + static_cast<size_t>(4 * r4) * ncol;
    const uint32_t w0 = __ldg(reinterpret_cast<const unsigned int*>(p));
    const uint32_t w1 = __ldg(reinterpret_cast<const unsigned int*>(p + ncol));
    const uint32_t w2 =
        __ldg(reinterpret_cast<const unsigned int*>(p + 2 * ncol));
    const uint32_t w3 =
        __ldg(reinterpret_cast<const unsigned int*>(p + 3 * ncol));
    const uint32_t p01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t p23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t q01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t q23 = __byte_perm(w2, w3, 0x7362);
    const int c[4] = {static_cast<int>(__byte_perm(p01, p23, 0x5410)),
                      static_cast<int>(__byte_perm(p01, p23, 0x7632)),
                      static_cast<int>(__byte_perm(q01, q23, 0x5410)),
                      static_cast<int>(__byte_perm(q01, q23, 0x7632))};
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      const int d = dig32[cb * q4 + r4];
#pragma unroll
      for (int q = 0; q < 4; ++q) s[cb][q] = __dp4a(c[q], d, s[cb][q]);
    }
  }
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
