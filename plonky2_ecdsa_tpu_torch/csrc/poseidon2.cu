// Poseidon2 (width 12, x^7, 4 + 22 + 4 rounds) over Goldilocks, and the FRI
// proof-of-work grind built on it.
//
// Replaces plonky2_ecdsa_tpu/hash/poseidon_pallas.py: `_kernel` (the bulk
// permutation, pallas_call at :118) and `_grind_kernel` (the PoW search,
// pallas_call at :208).
//
// What bounds it on the card: integer work.  A permutation is ~200 64-bit
// modular multiplies (each a mul.lo + mul.hi pair and a dozen adds and
// compares) against 192 bytes of state read and written once, so the bulk
// kernel is compute bound.  The design keeps each state in registers:
// one thread per state, the 12 words loaded once from the [12, M] layout
// (neighbouring threads read neighbouring words) and stored once; the round
// constants sit in __constant__ memory, read uniformly by every thread of a
// warp.  The linear layers accumulate 32-bit halves in u64 (the external
// layer grows values 64x, the internal one 33x, which a plain u64 sum would
// overflow) and reduce once per word, as _ext_layer_u64/_int_layer_u64 do.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;

__constant__ uint64_t RC[ROUNDS][WIDTH];  // poseidon._RC_TABLE, round order
__constant__ uint64_t DIAG_M1[WIDTH];     // INTERNAL_DIAG - 1

__device__ __forceinline__ void ext_accum(uint64_t v[WIDTH]) {
  uint64_t y[WIDTH];
#pragma unroll
  for (int g = 0; g < 3; g++) {
    uint64_t x0 = v[4 * g], x1 = v[4 * g + 1], x2 = v[4 * g + 2], x3 = v[4 * g + 3];
    uint64_t t0 = x0 + x1, t1 = x2 + x3;
    uint64_t t2 = x1 + x1 + t1, t3 = x3 + x3 + t0;
    uint64_t t4 = 4 * t1 + t3, t5 = 4 * t0 + t2;
    y[4 * g] = t3 + t5;
    y[4 * g + 1] = t5;
    y[4 * g + 2] = t2 + t4;
    y[4 * g + 3] = t4;
  }
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t s = y[i] + y[4 + i] + y[8 + i];
#pragma unroll
    for (int g = 0; g < 3; g++) v[4 * g + i] = y[4 * g + i] + s;
  }
}

__device__ __forceinline__ void ext_layer(uint64_t x[WIDTH]) {
  uint64_t lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) {
    lo[i] = x[i] & gl::EPS;
    hi[i] = x[i] >> 32;
  }
  ext_accum(lo);
  ext_accum(hi);
#pragma unroll
  for (int i = 0; i < WIDTH; i++) x[i] = gl::recombine(lo[i], hi[i]);
}

__device__ __forceinline__ void int_layer(uint64_t x[WIDTH]) {
  uint64_t slo = 0, shi = 0;
#pragma unroll
  for (int i = 0; i < WIDTH; i++) {
    slo += x[i] & gl::EPS;
    shi += x[i] >> 32;
  }
#pragma unroll
  for (int i = 0; i < WIDTH; i++)
    x[i] = gl::recombine(slo + (x[i] & gl::EPS) * DIAG_M1[i],
                         shi + (x[i] >> 32) * DIAG_M1[i]);
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl::mul(x, x);
  return gl::mul(gl::mul(x2, x2), gl::mul(x2, x));
}

__device__ __forceinline__ void full_round(uint64_t x[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; i++) x[i] = sbox(gl::add(x[i], RC[r][i]));
  ext_layer(x);
}

__device__ void permute(uint64_t x[WIDTH]) {
  ext_layer(x);
  for (int r = 0; r < HALF_FULL; r++) full_round(x, r);
  for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; r++) {
    x[0] = sbox(gl::add(x[0], RC[r][0]));
    int_layer(x);
  }
  for (int r = HALF_FULL + PARTIAL; r < ROUNDS; r++) full_round(x, r);
}

__global__ void permute_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, long long m) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) x[i] = in[i * m + j];
  permute(x);
#pragma unroll
  for (int i = 0; i < WIDTH; i++) out[i * m + j] = x[i];
}

// One block per lane.  Thread t of the block tries candidate base + t, with
// state[0] = candidate and the lane's words 1..11; a hit clears the top
// pow_bits bits of output word 7.  The block takes the smallest hit of each
// sweep (a shared-memory min) and stops at the first sweep with one, so the
// result is the first hit in candidate order, as the numpy sweep finds it.
// out[lane] = (witness, found); candidates run below `cap`.
__global__ void grind_kernel(const uint64_t* __restrict__ states,
                             uint64_t* __restrict__ out, int shift,
                             unsigned long long cap) {
  __shared__ unsigned long long best;
  const uint64_t* st = states + (long long)blockIdx.x * WIDTH;
  const unsigned long long none = ~0ull;
  for (unsigned long long base = 0; base < cap; base += blockDim.x) {
    if (threadIdx.x == 0) best = none;
    __syncthreads();
    unsigned long long c = base + threadIdx.x;
    if (c < cap) {
      uint64_t x[WIDTH];
      x[0] = c;
#pragma unroll
      for (int i = 1; i < WIDTH; i++) x[i] = st[i];
      permute(x);
      if ((x[7] >> shift) == 0) atomicMin(&best, c);
    }
    __syncthreads();
    unsigned long long b = best;
    __syncthreads();  // every thread has read `best` before it is reset
    if (b != none) {
      if (threadIdx.x == 0) {
        out[2 * blockIdx.x] = b;
        out[2 * blockIdx.x + 1] = 1;
      }
      return;
    }
  }
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = 0;
    out[2 * blockIdx.x + 1] = 0;
  }
}

}  // namespace

extern "C" {

// Copies the round constants and the internal diagonal (host arrays) into
// __constant__ memory; called once after the library is loaded.
int p2_set_constants(const uint64_t* rc, const uint64_t* diag_m1) {
  cudaError_t e = cudaMemcpyToSymbol(RC, rc, sizeof(RC));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(DIAG_M1, diag_m1, sizeof(DIAG_M1));
}

int p2_permute(const uint64_t* in, uint64_t* out, long long m, void* stream) {
  const int threads = 128;
  long long blocks = (m + threads - 1) / threads;
  permute_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(in, out, m);
  return (int)cudaGetLastError();
}

int p2_grind(const uint64_t* states, uint64_t* out, int lanes, int pow_bits,
             long long cap, void* stream) {
  grind_kernel<<<lanes, 256, 0, (cudaStream_t)stream>>>(
      states, out, 64 - pow_bits, (unsigned long long)cap);
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
