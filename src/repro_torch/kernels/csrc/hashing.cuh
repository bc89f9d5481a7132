// Hash family and median network shared by the port's sketch kernels
// (sketch_update.cu, kv_sketch.cu).
//
// The bucket and sign hashes of sketch/hashing.py in native uint32
// arithmetic: multiply-add mod 2^32, then the MurmurHash3 finalizer;
// bucket = mix % C, sign = the top mixed bit (set: -1).  Coefficients are
// one (rows, 4) uint32 array per sketch: (a_bucket, b_bucket, a_sign,
// b_sign) for each row.  The CPU tests hold sketch/hashing.py against the
// JAX package's hashes bitwise; these are the same operations on uint32.
#pragma once

#include <stdint.h>

namespace sketch {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Bucket in [0, C) of index u under coefficients (a, b).
__device__ __forceinline__ uint32_t bucket(uint32_t a, uint32_t b,
                                           uint32_t u, uint32_t C) {
  return mix32(a * u + b) % C;
}

// Division by an invariant 32-bit divisor d >= 1 as a multiply-high and
// shifts (Granlund and Montgomery, "Division by invariant integers using
// multiplication", 1994, fig. 4.1): exact for every 32-bit n.  A
// variable % compiles to a ~20-instruction sequence; the sketch kernels
// take a bucket modulo the table width for every element and row.
struct Divisor {
  uint32_t d, m;
  int s1, s2;
};

__host__ __device__ inline Divisor make_divisor(uint32_t d) {
  int l = 0;
  while (l < 32 && (1ull << l) < d) ++l;          // ceil(log2 d)
  Divisor D;
  D.d = d;
  D.m = (uint32_t)((((1ull << l) - d) << 32) / d + 1);
  D.s1 = l < 1 ? l : 1;
  D.s2 = l > 1 ? l - 1 : 0;
  return D;
}

__device__ __forceinline__ uint32_t mod(uint32_t n, const Divisor& D) {
  const uint32_t t = __umulhi(D.m, n);
  const uint32_t q = (t + ((n - t) >> D.s1)) >> D.s2;
  return n - q * D.d;
}

// bucket() with the width as a Divisor.
__device__ __forceinline__ uint32_t bucket(uint32_t a, uint32_t b,
                                           uint32_t u, const Divisor& C) {
  return mod(mix32(a * u + b), C);
}

// True when the sign of index u under coefficients (a, b) is -1.
__device__ __forceinline__ bool negative(uint32_t a, uint32_t b,
                                         uint32_t u) {
  return (mix32(a * u + b) >> 31) != 0;
}

// numpy's median of e[0..R): the middle value for odd R, the mean of the
// two middle values for even R.  Sorts e in place with the odd-even
// transposition network of the TPU kernels' _median_rows (only min/max).
template <int R>
__device__ __forceinline__ float median(float (&e)[R]) {
#pragma unroll
  for (int p = 0; p < R; ++p) {
#pragma unroll
    for (int j = p % 2; j < R - 1; j += 2) {
      const float lo = fminf(e[j], e[j + 1]);
      const float hi = fmaxf(e[j], e[j + 1]);
      e[j] = lo;
      e[j + 1] = hi;
    }
  }
  if constexpr (R % 2)
    return e[R / 2];
  else
    return 0.5f * (e[R / 2 - 1] + e[R / 2]);
}

}  // namespace sketch
