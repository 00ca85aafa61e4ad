// Count-only kernels, for measurement: compiled to a cubin that is never
// run, so that the SASS instruction count of one thread can be taken (no
// kernel here has a loop left after unrolling).  The counts say how many
// issue slots THIS implementation spends on one permutation, one grind
// candidate, one multiply, one butterfly; chip_smoke.py reads them.  The
// round schedules below repeat those of poseidon2.cu (permute, and the
// candidate loop of grind_kernel) with every loop unrolled; the kernels that
// run keep their loops.
//
//   permute_unrolled  one Poseidon2 permutation, state in and out
//   grind_candidate   one candidate of the grind: first layer from the lane's
//                     constants, all rounds, output word 7 only
//   probe_base        three loads, two stores: the frame of the probes below
//   probe_mul         probe_base + one modular multiply
//   probe_butterfly   probe_base + one NTT butterfly (multiply, add, subtract)

#include <cuda_runtime.h>

#include <cstdint>

#include "../poseidon2.cu"

namespace {

__device__ __forceinline__ void rounds_unrolled(uint64_t x[WIDTH]) {
#pragma unroll
  for (int r = 0; r < HALF_FULL; r++) full_round(x, r);
#pragma unroll
  for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; r++) {
    x[0] = sbox(gl::add(x[0], RC[r][0]));
    int_layer(x);
  }
#pragma unroll
  for (int r = HALF_FULL + PARTIAL; r < ROUNDS; r++) full_round(x, r);
}

}  // namespace

extern "C" {

__global__ void permute_unrolled(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                 long long m) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) x[i] = in[i * m + j];
  ext_layer(x);
  rounds_unrolled(x);
#pragma unroll
  for (int i = 0; i < WIDTH; i++) out[i * m + j] = x[i];
}

__global__ void grind_candidate(const uint64_t* __restrict__ L, uint64_t* __restrict__ out,
                                unsigned long long base) {
  const unsigned long long c = base + blockIdx.x * blockDim.x + threadIdx.x;
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) {
    const uint64_t k = ((i & 3) == 0 ? 5 : (i & 3) == 1 ? 4 : 1) * (i < 4 ? 2 : 1);
    x[i] = gl::add(L[i], c * k);
  }
  rounds_unrolled(x);
  out[c] = x[7];
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

__global__ void probe_butterfly(const uint64_t* a, const uint64_t* b, const uint64_t* w,
                                uint64_t* o0, uint64_t* o1) {
  int i = threadIdx.x;
  uint64_t t = gl::mul(b[i], w[i]);
  o0[i] = gl::add(a[i], t);
  o1[i] = gl::sub(a[i], t);
}

}  // extern "C"
