// Count-only kernels, for measurement: compiled to a cubin that is never
// run, so that the SASS instruction count of one thread can be taken (no
// kernel here has a loop left after unrolling).  The counts say how many
// issue slots THIS implementation spends on one permutation, one grind
// candidate, one multiply, one add, one butterfly; chip_smoke.py reads them.  The
// permutation and the grind candidate are the very device functions of
// poseidon2.cu that the kernels run (permute_state, grind_word7), with
// their round loops unrolled; the kernels that run keep their loops.  A
// sponge absorption is a permutation with 8 loads in place of 12.
//
//   permute_unrolled  one Poseidon2 permutation, state in and out
//   grind_candidate   one candidate of the grind: first layer from the lane's
//                     constants, all rounds, output word 7 only
//   probe_base        three loads, two stores: the frame of the probes below
//   probe_mul         probe_base + one canonical modular multiply (the NTT's)
//   probe_mul_lazy    probe_base + one lazy multiply (the permutation's)
//   probe_butterfly   probe_base + one NTT butterfly (gl::butterfly: multiply,
//                     lazy add and subtract)
//   probe_add         probe_base + one canonical add (gl::add, field.cu's add)
//   probe_sub         probe_base + one canonical subtract (gl::sub)
//   probe_sum2        three loads, two stores: two words summed on 96 bits,
//                     folded and made canonical (field.cu's reductions)
//   probe_sum3        probe_sum2 with a third word: + one gl::add96 of a word,
//                     the step of a reduction's loop
//   probe_mac2        three loads, two stores: two products summed whole on
//                     160 bits (gl::mac160), folded and made canonical
//   probe_mac3        probe_mac2 with a third product: + one gl::mac160, the
//                     step of fri.cu's sums
//   probe_inverse     probe_base + one gl::inverse (the addition chain)

#include <cuda_runtime.h>

#include <cstdint>

#include "../poseidon2.cu"

extern "C" {

__global__ void permute_unrolled(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                 long long m) {
  permute_state<UNROLLED>(in, out, m, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void grind_candidate(const uint64_t* __restrict__ L, uint64_t* __restrict__ out,
                                unsigned long long base) {
  const unsigned long long c = base + blockIdx.x * blockDim.x + threadIdx.x;
  out[c] = grind_word7<UNROLLED>(L, c);
}

__global__ void probe_base(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                           uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = a[i] ^ w[i];
  o1[i] = b[i];
}

__global__ void probe_mul(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                          uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = a[i] ^ w[i];
  o1[i] = gl::mul(b[i], w[i]);
}

__global__ void probe_mul_lazy(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                               uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = a[i] ^ w[i];
  o1[i] = gl::mul_lazy(b[i], w[i]);
}

__global__ void probe_butterfly(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                                uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  uint64_t x = a[i], y = b[i];
  gl::butterfly(x, y, w[i]);
  o0[i] = x;
  o1[i] = y;
}

__global__ void probe_add(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                          uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = a[i] ^ w[i];
  o1[i] = gl::add(b[i], w[i]);
}

__global__ void probe_sub(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                          uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = a[i] ^ w[i];
  o1[i] = gl::sub(b[i], w[i]);
}

__global__ void probe_sum2(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                           uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = w[i];
  o1[i] = gl::canon(gl::fold96(gl::add96(gl::w96{a[i], 0u}, b[i])));
}

__global__ void probe_sum3(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                           uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = w[i];
  o1[i] = gl::canon(gl::fold96(gl::add96(gl::add96(gl::w96{a[i], 0u}, b[i]), w[i])));
}

__global__ void probe_mac2(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                           uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = w[i];
  o1[i] = gl::canon(gl::fold160(gl::mac160(gl::mac160(gl::w160{0, 0, 0u}, a[i], w[i]), b[i], w[i])));
}

__global__ void probe_mac3(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                           uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = w[i];
  o1[i] = gl::canon(gl::fold160(
      gl::mac160(gl::mac160(gl::mac160(gl::w160{0, 0, 0u}, a[i], w[i]), b[i], w[i]), a[i], b[i])));
}

__global__ void probe_inverse(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                              uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  o0[i] = a[i] ^ w[i];
  o1[i] = gl::inverse(b[i]);
}

}  // extern "C"
