// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on native u64 (device code).
// Same reduction as plonky2_ecdsa_tpu/fields/goldilocks.py::_reduce128_u64:
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).  All results are canonical (< p).
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p; (x - p) mod 2^64 == x + EPS

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // on carry the true sum is s + 2^64, and s + EPS == sum - p < p
  return (s < a || s >= P) ? s + EPS : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // on borrow the wrapped value is a - b + 2^64 == a - b + EPS (mod p)
  return a < b ? d - EPS : d;
}

__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  uint64_t r2 = hi & EPS;
  uint64_t r3 = hi >> 32;
  uint64_t t = lo - r3;
  if (lo < r3) t -= EPS;
  uint64_t s = t + ((r2 << 32) - r2);
  if (s < t) s += EPS;
  return s >= P ? s + EPS : s;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(__umul64hi(a, b), a * b);
}

// (qlo + 2^32 qhi) mod p for non-negative half-sums below 2^63.
__device__ __forceinline__ uint64_t recombine(uint64_t qlo, uint64_t qhi) {
  uint64_t lo = qlo + (qhi << 32);
  uint64_t top = (((qlo >> 32) + (qhi & EPS)) >> 32) + (qhi >> 32);
  return reduce128(top, lo);
}

}  // namespace gl
