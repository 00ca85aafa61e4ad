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
//
// The grind is bound by the same integer work, times the candidates it has to
// try: the sum over lanes of (first hit + 1).  Its design (see grind_kernel)
// spreads every lane's search over all the SMs and keeps it exact.

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

// The FRI proof-of-work search: per lane of the [12, lanes] states, the FIRST
// candidate c in ascending order below `cap` for which permuting the lane's
// state with word 0 set to c clears the top bits of output word 7.
//
// The whole card searches every lane.  No block belongs to a lane: each WARP
// draws tickets from a per-lane counter in global memory (ticket k = the 32
// consecutive candidates from 32 k, one per thread), so a lane's candidates
// are handed out in ascending order.  A warp stays on a lane until the lane
// is finished, then moves on to the next lane, through all of them in cyclic
// order; warps start on lane (warp index mod lanes), so with one lane all of
// them work on it, and with many the SMs that finished lanes give up go to
// the lanes still open (the slowest of 32 lanes needs about four times the
// mean).  A hit lowers the lane's `best` word (atomicMin; hits are rare, so
// it is off the common path).  There is no block-wide barrier anywhere.
//
// Why the result is exact whatever the schedule: let h be the lane's true
// first hit.  `best` only ever holds hits, so best >= h at all times.  A
// ticket is dropped only when its base is above `best` (or at or above
// `cap`), hence above h: no ticket that contains a candidate <= h is ever
// dropped, and whoever draws a ticket that is not dropped tries all of it.
// Tickets are consecutive, and every warp keeps drawing from each lane until
// it draws a ticket that is dropped (both words only move one way, so every
// later ticket would be dropped too).  So every candidate <= min(h, cap - 1)
// is tried, h included, and when the kernel ends best == h: the first hit in
// candidate order; best stays all-ones where the cap is exhausted.
//
// The cost of the design is overshoot: candidates above h that are started
// before h's own permutation has finished and lowered `best`, about 1.5 per
// thread then working on the lane.  It grows with the threads in flight and
// the rate does not: two warps per scheduler already reach the rate of the
// bulk kernel, at a quarter of its latency per permutation.  So the grid is
// ONE block of 256 threads per SM (33 792 threads on 132 SMs), not the
// occupancy the registers would allow.  Spread over the k lanes still open,
// each finish wastes about 1.5 * 33 792 / k: summed over 32 lanes,
// 1.5 * 33 792 * H(32) = 206 000 candidates, 10% of the 32 * 2^16 useful
// ones at 16 bits.
//
// Small savings: words 1..11 are constants of the lane, so the first
// external layer is linear in the candidate: L = ext_layer(0, w1..w11) is
// computed once per visit of a lane (kept in shared memory, 96 bytes a warp)
// and a candidate's state is L + c * (column 0 of the matrix); and only word
// 7 of the output is read, so the last round is written out of the loop,
// where the compiler drops the rest of its external layer.
//
// best[lanes] and ticket[lanes] both start as all-ones (a ticket counter
// wraps to 0 on its first draw), so the caller fills one buffer.
constexpr int GRIND_THREADS = 256;
constexpr int GRIND_BLOCKS_PER_SM = 1;
constexpr int GRIND_WARPS = GRIND_THREADS / 32;
constexpr unsigned FULL_WARP = 0xffffffffu;

__global__ void __launch_bounds__(GRIND_THREADS, GRIND_BLOCKS_PER_SM)
grind_kernel(const uint64_t* __restrict__ states, unsigned long long* best,
             unsigned long long* ticket, int lanes, int shift,
             unsigned long long cap) {
  __shared__ uint64_t first_layer[GRIND_WARPS][WIDTH];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const unsigned gw = blockIdx.x * GRIND_WARPS + warp;
  uint64_t* L = first_layer[warp];
  for (int visit = 0; visit < lanes; visit++) {
    const int lane = (int)((gw + (unsigned)visit) % (unsigned)lanes);
    __syncwarp();  // every thread is done with the previous lane's L
    if (t == 0) {
      uint64_t x[WIDTH];
      x[0] = 0;
#pragma unroll
      for (int i = 1; i < WIDTH; i++) x[i] = states[(long long)i * lanes + lane];
      ext_layer(x);
#pragma unroll
      for (int i = 0; i < WIDTH; i++) L[i] = x[i];
    }
    __syncwarp();
    for (;;) {
      unsigned long long base = 0, seen = 0;
      if (t == 0) {
        base = (atomicAdd(&ticket[lane], 1ull) + 1ull) * 32ull;
        seen = *(volatile unsigned long long*)&best[lane];
      }
      base = __shfl_sync(FULL_WARP, base, 0);
      seen = __shfl_sync(FULL_WARP, seen, 0);
      if (base >= cap || base > seen) break;  // the lane is finished (warp-uniform)
      const unsigned long long c = base + t;
      if (c < cap) {
        uint64_t x[WIDTH];
#pragma unroll
        for (int i = 0; i < WIDTH; i++) {
          // column 0 of circ(2 M4, M4, M4): M4's first column is (5, 4, 1, 1)
          const uint64_t k = ((i & 3) == 0 ? 5 : (i & 3) == 1 ? 4 : 1) * (i < 4 ? 2 : 1);
          x[i] = gl::add(L[i], c * k);  // c < 2^31, so c * k < p
        }
        for (int r = 0; r < HALF_FULL; r++) full_round(x, r);
        for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; r++) {
          x[0] = sbox(gl::add(x[0], RC[r][0]));
          int_layer(x);
        }
        for (int r = HALF_FULL + PARTIAL; r < ROUNDS - 1; r++) full_round(x, r);
        full_round(x, ROUNDS - 1);  // only x[7] is read below
        if ((x[7] >> shift) == 0) atomicMin(&best[lane], c);
      }
    }
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

// states [12, lanes]; scratch [2, lanes], filled with all-ones by the caller:
// row 0 comes back as each lane's first hit (all-ones: none below cap), row 1
// is the ticket counters.  Launches on the current device.
int p2_grind(const uint64_t* states, uint64_t* scratch, int lanes, int pow_bits,
             long long cap, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  unsigned long long* s = (unsigned long long*)scratch;
  grind_kernel<<<sms * GRIND_BLOCKS_PER_SM, GRIND_THREADS, 0, (cudaStream_t)stream>>>(
      states, s, s + lanes, lanes, 64 - pow_bits, (unsigned long long)cap);
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
