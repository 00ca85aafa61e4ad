// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on native u64 (device code).
// Same reduction as plonky2_ecdsa_tpu/fields/goldilocks.py::_reduce128_u64:
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
//
// Two kinds of word.  A CANONICAL word is the value itself, < p: what
// add/sub/mul return and what every kernel stores.  A LAZY word is any u64
// congruent to the value: what mul_lazy, add_lazy, sub_lazy and fold96 return.
// A chain of lazy operations is made canonical once, by canon(), where it
// leaves the registers.  The carry chains are inline PTX (add.cc / addc /
// subc); each chain is one asm statement, as the carry flag does not live
// from one statement to the next.
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p; (x - p) mod 2^64 == x + EPS

// A sum of words too large for a u64: lo + 2^64 hi.
struct w96 {
  uint64_t lo;
  uint32_t hi;
};

__device__ __forceinline__ uint64_t canon(uint64_t x) { return x >= P ? x + EPS : x; }

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

// a + b for a lazy a and any b <= 2^64 - 2^32 (a canonical word, or a product
// r * EPS with r < 2^32).  On carry the true sum is s + 2^64 == s + EPS, and
// s <= a + b - 2^64 <= 2^64 - 2^32 - 1, so adding EPS cannot carry again.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint64_t s;
  uint32_t c;  // the carry, 0 or 1
  asm("add.cc.u64 %0, %2, %3;\n\t"
      "addc.u32 %1, %4, %4;"
      : "=l"(s), "=r"(c)
      : "l"(a), "l"(b), "r"(0u));
  return s + (uint64_t)c * (uint32_t)EPS;   // one multiply-add
}

// a - b for a lazy a and any b <= 2^64 - 2^32.  On borrow the wrapped value
// a - b + 2^64 is EPS too much and at least 2^32, so EPS comes off without a
// second borrow.
__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b) {
  uint64_t d;
  uint32_t m;  // all-ones (== EPS) on borrow
  asm("sub.cc.u64 %0, %2, %3;\n\t"
      "subc.u32 %1, %4, %4;"
      : "=l"(d), "=r"(m)
      : "l"(a), "l"(b), "r"(0u));
  return d - m;
}

// a + b on 96 bits; the caller's range argument keeps the sum below 2^96.
__device__ __forceinline__ w96 add96(w96 a, w96 b) {
  w96 r;
  asm("add.cc.u64 %0, %2, %4;\n\t"
      "addc.u32 %1, %3, %5;"
      : "=&l"(r.lo), "=r"(r.hi)
      : "l"(a.lo), "r"(a.hi), "l"(b.lo), "r"(b.hi));
  return r;
}

__device__ __forceinline__ w96 add96(w96 a, uint64_t b) { return add96(a, w96{b, 0u}); }

// 4 a on 96 bits (a < 2^94).
__device__ __forceinline__ w96 quad96(w96 a) {
  return w96{a.lo << 2, (a.hi << 2) | (uint32_t)(a.lo >> 62)};
}

// x d + s on 96 bits for a 32-bit d: below 2^96 whenever s.hi + d < 2^32.
__device__ __forceinline__ w96 mad96(uint64_t x, uint32_t d, w96 s) {
  uint64_t a = (uint64_t)(uint32_t)x * d + (uint32_t)s.lo;
  uint64_t b = (uint64_t)(uint32_t)(x >> 32) * d + (a >> 32);
  b += (s.lo >> 32) | ((uint64_t)s.hi << 32);
  return w96{(b << 32) | (uint32_t)a, (uint32_t)(b >> 32)};
}

// lo + 2^64 hi == lo + hi EPS (mod p): a lazy word.  hi EPS <= 2^64 - 2^33 + 1.
__device__ __forceinline__ uint64_t fold96(w96 a) {
  return add_lazy(a.lo, (uint64_t)a.hi * (uint32_t)EPS);
}

// hi 2^64 + lo (mod p) as a lazy word.  With hi = r3 2^32 + r2 it is
// lo - r3 + r2 EPS: sub_lazy's case (r3 < 2^32), then add_lazy's.
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t hi, uint64_t lo) {
  return add_lazy(sub_lazy(lo, hi >> 32), (uint64_t)(uint32_t)hi * (uint32_t)EPS);
}

// Lazy in, lazy out.  The 128-bit product is left to the compiler (mul.lo.u64
// and mul.hi.u64 side by side): it shares their partial products itself, in
// fewer instructions than a product spelt out in 32-bit halves or in
// mad.lo.cc / madc.hi chains, and it drops the repeated cross product of a
// square, which a three-product square written by hand did not beat (PERF.md).
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128_lazy(__umul64hi(a, b), a * b);
}

__device__ __forceinline__ uint64_t sqr_lazy(uint64_t a) { return mul_lazy(a, a); }

// Lazy in, canonical out.
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return canon(mul_lazy(a, b)); }

// A sum of whole 128-bit products: lo + 2^64 hi + 2^128 top.
struct w160 {
  uint64_t lo, hi;
  uint32_t top;
};

// s + a b for any words a and b, the product left unreduced: its two halves
// added with their carry into top.  Below 2^160 for fewer than 2^32 terms.
__device__ __forceinline__ w160 mac160(w160 s, uint64_t a, uint64_t b) {
  const uint64_t lo = a * b, hi = __umul64hi(a, b);
  asm("add.cc.u64 %0, %0, %3;\n\t"
      "addc.cc.u64 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, %5;"
      : "+l"(s.lo), "+l"(s.hi), "+r"(s.top)
      : "l"(lo), "l"(hi), "r"(0u));
  return s;
}

// s (mod p) as a lazy word: 2^128 == -2^32 (mod p), and top 2^32 <= 2^64 -
// 2^32 for any 32-bit top, which sub_lazy takes.
__device__ __forceinline__ uint64_t fold160(w160 s) {
  return sub_lazy(reduce128_lazy(s.hi, s.lo), (uint64_t)s.top << 32);
}

// a^(p - 2) for a lazy a, canonical: the inverse, and 0 for 0.  An addition
// chain of 64 squares and 8 multiplies; x_k = a^(2^k - 1), and p - 2 has
// 31 ones, a zero, 32 ones: (2^31 - 1) 2^33 + 2^32 - 1.
__device__ __forceinline__ uint64_t sqr_n(uint64_t x, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) x = sqr_lazy(x);
  return x;
}

__device__ __forceinline__ uint64_t inverse(uint64_t a) {
  const uint64_t x2 = mul_lazy(sqr_lazy(a), a);
  const uint64_t x3 = mul_lazy(sqr_lazy(x2), a);
  const uint64_t x6 = mul_lazy(sqr_n(x3, 3), x3);
  const uint64_t x12 = mul_lazy(sqr_n(x6, 6), x6);
  const uint64_t x24 = mul_lazy(sqr_n(x12, 12), x12);
  const uint64_t x30 = mul_lazy(sqr_n(x24, 6), x6);
  const uint64_t x31 = mul_lazy(sqr_lazy(x30), a);
  const uint64_t x32 = mul_lazy(sqr_lazy(x31), a);
  return canon(mul_lazy(sqr_n(x31, 33), x32));
}

// One radix-2 butterfly (a, b) -> (a + b w, a - b w): a lazy in and out, b
// lazy in and out, w canonical or lazy.  Only the product is made canonical,
// which is what add_lazy and sub_lazy ask of their second operand.
__device__ __forceinline__ void butterfly(uint64_t& a, uint64_t& b, uint64_t w) {
  const uint64_t t = mul(b, w);
  b = sub_lazy(a, t);
  a = add_lazy(a, t);
}

}  // namespace gl
