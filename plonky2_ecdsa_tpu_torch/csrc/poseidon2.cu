// Poseidon2 (width 12, x^7, 4 + 22 + 4 rounds) over Goldilocks: the bulk
// permutation, the leaf sponge built on it, and the FRI proof-of-work grind.
//
// Replaces plonky2_ecdsa_tpu/hash/poseidon_pallas.py: `_kernel` (the bulk
// permutation, pallas_call at :118; permute_kernel and sponge_kernel here) and
// `_grind_kernel` (the PoW search, pallas_call at :208).
//
// What bounds it on the card: integer work.  A permutation is 472 64-bit
// modular multiplies and 31 linear layers against 192 bytes of state, so every
// kernel here is compute bound and the design spends as few instructions on a
// permutation as it can:
//
//   * one thread per state, the 12 words in registers from load to store, the
//     round constants in __constant__ memory (read uniformly by a warp);
//   * LAZY words (goldilocks.cuh): inside a permutation a word is any u64
//     congruent to its value.  A product is folded below 2^64 and no further;
//     a word is made canonical once, where it is stored (and, in the grind,
//     before the hit test reads its top bits);
//   * the linear layers sum in 96-bit accumulators (a u64 and a u32 of
//     carries, add.cc / addc) and fold the small top word once per output.
//     Range: the inputs are lazy words, below 2^64.  The external matrix
//     circ(2 M4, M4, M4) has row sums 4 * 16 = 64 (M4's largest row is
//     5 + 7 + 1 + 3), so every output and every partial sum on the way is
//     below 2^70.  The internal layer's output i is (sum of the 12 words) +
//     x_i (mu_i - 1) with mu_i - 1 <= 21: below 33 * 2^64 < 2^70.  So the top
//     word stays below 2^6 and mad96's condition (s.hi + d < 2^32) holds;
//   * the sponge keeps a leaf's state in registers over ALL its absorptions
//     and reads the absorbed words straight from the caller's tensor: where
//     the sponge used to be one launch and one copy of the whole state per 8
//     columns, it is one launch, each input word read once, 32 bytes written
//     a leaf.
//
// Latency: the 22 partial rounds are one dependent chain a state (the S-box
// of word 0, then a layer that waits for it).  A thread carries one state and
// the other warps of the SM fill the chain's gaps: the kernels are bound by
// instruction issue, not by latency (PERF.md holds what two states a thread
// read on the card: slower).
//
// The grind is bound by the same integer work, times the candidates it has to
// try: the sum over lanes of (first hit + 1).  Its design (see grind_kernel)
// spreads every lane's search over all the SMs and keeps it exact.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 2 * HALF_FULL + PARTIAL;
constexpr int LOOP = 1;        // `#pragma unroll 1`: the round loops stay loops
constexpr int UNROLLED = 64;   // every round loop unrolled (the count-only build)

__constant__ uint64_t RC[ROUNDS][WIDTH];  // poseidon._RC_TABLE, round order; canonical
__constant__ uint32_t DIAG_M1[WIDTH];     // INTERNAL_DIAG - 1

// circ(2 M4, M4, M4) on lazy words: the Poseidon2 paper's M4 schedule per
// group of four, then out_g = y_g + sum_h y_h, all on 96 bits (< 2^70).
__device__ __forceinline__ void ext_layer(uint64_t x[WIDTH]) {
  gl::w96 y[WIDTH];
#pragma unroll
  for (int g = 0; g < 3; g++) {
    const uint64_t x0 = x[4 * g], x1 = x[4 * g + 1], x2 = x[4 * g + 2], x3 = x[4 * g + 3];
    const gl::w96 t0 = gl::add96(gl::w96{x0, 0u}, x1), t1 = gl::add96(gl::w96{x2, 0u}, x3);
    const gl::w96 t2 = gl::add96(gl::add96(t1, x1), x1), t3 = gl::add96(gl::add96(t0, x3), x3);
    const gl::w96 t4 = gl::add96(gl::quad96(t1), t3), t5 = gl::add96(gl::quad96(t0), t2);
    y[4 * g] = gl::add96(t3, t5);
    y[4 * g + 1] = t5;
    y[4 * g + 2] = gl::add96(t2, t4);
    y[4 * g + 3] = t4;
  }
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const gl::w96 s = gl::add96(gl::add96(y[i], y[4 + i]), y[8 + i]);
#pragma unroll
    for (int g = 0; g < 3; g++) x[4 * g + i] = gl::fold96(gl::add96(y[4 * g + i], s));
  }
}

// ones + diag(mu - 1) on lazy words: out_i = sum + x_i (mu_i - 1) (< 2^70).
__device__ __forceinline__ void int_layer(uint64_t x[WIDTH]) {
  gl::w96 s{x[0], 0u};
#pragma unroll
  for (int i = 1; i < WIDTH; i++) s = gl::add96(s, x[i]);
#pragma unroll
  for (int i = 0; i < WIDTH; i++) x[i] = gl::fold96(gl::mad96(x[i], DIAG_M1[i], s));
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::sqr_lazy(x);
  return gl::mul_lazy(gl::sqr_lazy(x2), gl::mul_lazy(x2, x));
}

__device__ __forceinline__ void full_round(uint64_t x[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; i++) x[i] = sbox(gl::add_lazy(x[i], RC[r][i]));
  ext_layer(x);
}

// Full rounds first..last-1 (lazy words in and out).
template <int U>
__device__ __forceinline__ void full_rounds(uint64_t x[WIDTH], int first, int last) {
#pragma unroll U
  for (int r = first; r < last; r++) full_round(x, r);
}

template <int U>
__device__ __forceinline__ void partial_rounds(uint64_t x[WIDTH]) {
#pragma unroll U
  for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; r++) {
    x[0] = sbox(gl::add_lazy(x[0], RC[r][0]));
    int_layer(x);
  }
}

// The permutation: any u64 in, lazy words out.
template <int U>
__device__ __forceinline__ void permute(uint64_t x[WIDTH]) {
  ext_layer(x);
  full_rounds<U>(x, 0, HALF_FULL);
  partial_rounds<U>(x);
  full_rounds<U>(x, HALF_FULL + PARTIAL, ROUNDS);
}

// in, out [12, m]: thread j permutes state j.
template <int U>
__device__ __forceinline__ void permute_state(const uint64_t* __restrict__ in,
                                              uint64_t* __restrict__ out, long long m,
                                              long long j) {
  if (j >= m) return;
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) x[i] = in[i * m + j];
  permute<U>(x);
#pragma unroll
  for (int i = 0; i < WIDTH; i++) out[i * m + j] = gl::canon(x[i]);
}

constexpr int PERMUTE_THREADS = 128;

__global__ void __launch_bounds__(PERMUTE_THREADS)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, long long m) {
  permute_state<LOOP>(in, out, m, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

// One absorption of the overwrite-mode sponge: words 0..r-1 of the state are
// replaced by r <= 8 words read at `src` with stride `sc`, the rest stay.
__device__ __forceinline__ void absorb(uint64_t x[WIDTH], const uint64_t* __restrict__ src,
                                       long long sc, int r, bool pairs) {
  if (pairs) {  // sc == 1, r even, src 16-byte aligned: 16 bytes a load
    const ulonglong2* p = reinterpret_cast<const ulonglong2*>(src);
#pragma unroll
    for (int i = 0; i < RATE / 2; i++) {
      if (2 * i < r) {
        const ulonglong2 v = p[i];
        x[2 * i] = v.x;
        x[2 * i + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RATE; i++) {
      if (i < r) x[i] = src[i * sc];
    }
  }
}

// The leaf sponge (hash_no_pad): leaf g = b * points + j absorbs the k words
// in[b * sb + c * sc + j * sp], c < k, eight at a time from a zero state, one
// permutation after each, and writes digest word i to out[g * ol + i * ow].
// One thread per leaf; the state never leaves its registers.  With sp == 1 a
// warp reads 32 neighbouring words per column; with sc == 1 a thread reads its
// own row, 16 bytes a load where the row's alignment allows (in_pairs); the
// digest goes out as two 16-byte stores where it is contiguous (out_pairs).
template <int U>
__device__ __forceinline__ void sponge_leaf(const uint64_t* __restrict__ in,
                                            uint64_t* __restrict__ out, long long g,
                                            long long points, int k, long long sb, long long sc,
                                            long long sp, long long ow, long long ol,
                                            bool in_pairs, bool out_pairs) {
  const uint64_t* src = in + (g / points) * sb + (g % points) * sp;
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) x[i] = 0;
#pragma unroll 1
  for (int off = 0; off < k; off += RATE) {
    absorb(x, src + off * sc, sc, min(RATE, k - off), in_pairs);
    permute<U>(x);
  }
  uint64_t* dst = out + g * ol;
  if (out_pairs) {  // ow == 1, ol even, out 16-byte aligned
    ulonglong2* d = reinterpret_cast<ulonglong2*>(dst);
    d[0] = make_ulonglong2(gl::canon(x[0]), gl::canon(x[1]));
    d[1] = make_ulonglong2(gl::canon(x[2]), gl::canon(x[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; i++) dst[i * ow] = gl::canon(x[i]);
  }
}

__global__ void __launch_bounds__(PERMUTE_THREADS)
sponge_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, long long leaves,
              long long points, int k, long long sb, long long sc, long long sp, long long ow,
              long long ol, int in_pairs, int out_pairs) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < leaves) {
    sponge_leaf<LOOP>(in, out, g, points, k, sb, sc, sp, ow, ol, in_pairs != 0, out_pairs != 0);
  }
}

// One candidate of the grind: the lane's first layer L (lazy words; linear in
// the candidate, see grind_kernel), all 30 rounds, output word 7 canonical.
// Only word 7 is read, so the last round is written out of the loop, where
// the compiler drops the rest of its external layer.
template <int U>
__device__ __forceinline__ uint64_t grind_word7(const uint64_t* L, unsigned long long c) {
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; i++) {
    // column 0 of circ(2 M4, M4, M4): M4's first column is (5, 4, 1, 1)
    const uint64_t k = ((i & 3) == 0 ? 5 : (i & 3) == 1 ? 4 : 1) * (i < 4 ? 2 : 1);
    x[i] = gl::add_lazy(L[i], c * k);  // c < 2^31, so c * k < 2^35
  }
  full_rounds<U>(x, 0, HALF_FULL);
  partial_rounds<U>(x);
  full_rounds<U>(x, HALF_FULL + PARTIAL, ROUNDS - 1);
  full_round(x, ROUNDS - 1);
  return gl::canon(x[7]);  // the hit test reads the top bits of the value itself
}

// Test entry: the field primitives above on arrays of operands, one thread a
// pair; out [FIELD_CHECK_ROWS, n].  Rows 0-4 are lazy words (compare modulo
// p), the rest exact.
constexpr int FIELD_CHECK_ROWS = 12;

__global__ void field_check_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                                   uint64_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t x = a[i], y = b[i];
  const gl::w96 s{y, (uint32_t)(x >> 32) & 63u};   // a layer's sum: top word < 2^6
  const uint32_t d = (uint32_t)x & 31u;             // a diagonal entry
  const gl::w96 m = gl::mad96(x, d, s);
  const gl::w96 q = gl::quad96(gl::add96(s, x));
  uint64_t* o = out + i;
  o[0 * n] = gl::mul_lazy(x, y);
  o[1 * n] = gl::sqr_lazy(x);
  o[2 * n] = gl::fold96(gl::w96{x, (uint32_t)y});       // x + 2^64 (y mod 2^32)
  o[3 * n] = gl::add_lazy(x, gl::canon(y));
  o[4 * n] = gl::sub_lazy(x, gl::canon(y));
  o[5 * n] = gl::canon(gl::mul_lazy(x, y));
  o[6 * n] = gl::canon(x);
  o[7 * n] = m.lo;
  o[8 * n] = m.hi;
  o[9 * n] = q.lo;
  o[10 * n] = q.hi;
  o[11 * n] = gl::mul(x, y);
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
// 7 of the output is read (grind_word7).  The arithmetic is the permutation's
// lazy one; word 7 is made canonical before its top bits are tested, as a
// lazy word p or more too large would read as a miss.
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
      if (c < cap && (grind_word7<LOOP>(L, c) >> shift) == 0) atomicMin(&best[lane], c);
    }
  }
}

}  // namespace

extern "C" {

// Copies the round constants and the internal diagonal (host arrays) into the
// CURRENT device's __constant__ memory (each device has its own copy): called
// once for every device before a kernel is launched there.  Returns when the
// copies have landed, whatever stream the kernels then run on.
int p2_set_constants(const uint64_t* rc, const uint32_t* diag_m1) {
  cudaError_t e = cudaMemcpyToSymbol(RC, rc, sizeof(RC));
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(DIAG_M1, diag_m1, sizeof(DIAG_M1));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

// in, out [12, m].
int p2_permute(const uint64_t* in, uint64_t* out, long long m, void* stream) {
  const unsigned blocks = (unsigned)((m + PERMUTE_THREADS - 1) / PERMUTE_THREADS);
  permute_kernel<<<blocks, PERMUTE_THREADS, 0, (cudaStream_t)stream>>>(in, out, m);
  return (int)cudaGetLastError();
}

// The leaf sponge over `batches * points` leaves of k words each; strides in
// words (see sponge_kernel).
int p2_sponge(const uint64_t* in, uint64_t* out, long long batches, long long points, int k,
              long long sb, long long sc, long long sp, long long ow, long long ol,
              void* stream) {
  const long long leaves = batches * points;
  const unsigned blocks = (unsigned)((leaves + PERMUTE_THREADS - 1) / PERMUTE_THREADS);
  // 16-byte loads: every leaf's row contiguous, even in length and in offset
  const int in_pairs = sc == 1 && k % 2 == 0 && sb % 2 == 0 && sp % 2 == 0 &&
                       (uintptr_t)in % 16 == 0;
  const int out_pairs = ow == 1 && ol % 2 == 0 && (uintptr_t)out % 16 == 0;
  sponge_kernel<<<blocks, PERMUTE_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, leaves, points, k, sb, sc, sp, ow, ol, in_pairs, out_pairs);
  return (int)cudaGetLastError();
}

// a, b [n]; out [FIELD_CHECK_ROWS, n].
int p2_field_check(const uint64_t* a, const uint64_t* b, uint64_t* out, long long n,
                   void* stream) {
  field_check_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(a, b, out, n);
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
