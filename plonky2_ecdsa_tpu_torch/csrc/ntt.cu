// Fused radix-2 DIT sub-NTT over Goldilocks along the row axis.
//
// Replaces plonky2_ecdsa_tpu/prover/ntt_pallas.py::_sub_ntt_kernel (the
// pallas_call at :181), which ntt_pallas.four_step runs twice with a
// transpose between.  One launch does, for x[m, rows_in, L] -> y[m, n_t, L]
// (or, transposed, y[m, L, n_t]): optional pre-multiply (coset powers), zero
// rows rows_in..n_t-1 (compact LDE input: the padding is never read), bit
// reversal, log2(n_t) butterfly stages, optional post-multiply (the four-step
// twiddle, 1/n folded in).
//
// What bounds it on the card: device memory first (a pass reads and writes
// each element once, 16 bytes, for log2(n_t) / 2 modular multiplies), then the
// trips through shared memory and the barriers between stages.  The design:
//
//   * one block per (m, tile of TL columns) holds the whole [n_t, TL]
//     sub-matrix (4096 words); n_t and TL are compile-time, so every index is
//     a shift or a mask;
//   * stages run two or three at a time in registers: a thread holds the 4 or
//     8 rows of one column that those stages combine, so a transform of 128
//     or 256 rows has 3 groups and 3 barriers where it had 7 or 8 stages and
//     barriers, and a third of the shared-memory traffic.  The first group
//     loads straight from device memory (bit-reversed rows, pre-multiply), the
//     last one applies the post-multiply and, unless the output is transposed,
//     stores straight to device memory; threads walk a tile column-fastest, so
//     a warp reads and writes TL consecutive words of a row;
//   * the stage twiddles (n_t - 1 words) are staged in shared memory once a
//     block; stage 0's twiddle is 1 and its multiply is left out;
//   * between the first load and the last store the words are lazy
//     (goldilocks.cuh): a butterfly makes its product canonical and nothing
//     else, and the sums and differences are reduced only below 2^64;
//   * transposed output (the first pass of a four-step): the tile is written
//     as out[m, c, r], each column n_t contiguous words, read from shared
//     memory across rows; the rows are padded to TL + 1 words, which makes the
//     column walk free of bank conflicts.  The four-step needs no copy between
//     its two passes.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_WORDS = 4096;
constexpr int MAX_LOG_N = 12;

constexpr int tile_cols(int log_n) {
  const int t = TILE_WORDS >> log_n;
  return t > 32 ? 32 : (t < 1 ? 1 : t);
}

constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v / 2); }

template <int LOG_N>
struct Shape {
  static constexpr int N_T = 1 << LOG_N;
  static constexpr int TL = tile_cols(LOG_N);
  static constexpr int LOG_TL = log2_of(TL);
  static constexpr int STRIDE = TL + (TL > 1 ? 1 : 0);   // padded row of the tile
  static constexpr size_t SMEM = (size_t)(N_T * STRIDE + N_T) * sizeof(uint64_t);
};

struct Args {
  const uint64_t* src;    // in + m * rows_in * L + col0
  uint64_t* dst;          // out + m * n_t * L + col0 (not transposed)
  const uint64_t* pre;    // + col0, or null
  const uint64_t* post;   // + col0, or null
  uint64_t* sm;           // the tile
  const uint64_t* twsm;   // stage twiddles: stage s (half = 2^s) at half - 1
  long long L;
  int rows_in, width;
};

// Stages S..S+G-1 on the 2^G rows {base + j 2^S} of one column, in registers.
template <int LOG_N, bool TR, int S, int G>
__device__ __forceinline__ void stage_group(const Args& a) {
  using Sh = Shape<LOG_N>;
  constexpr int R = 1 << G;
  constexpr bool FIRST = S == 0, LAST = S + G == LOG_N;
  for (int e = threadIdx.x; e < (Sh::N_T >> G) * Sh::TL; e += THREADS) {
    const int c = e & (Sh::TL - 1), q = e >> Sh::LOG_TL;
    if (c >= a.width) continue;
    const int lo = q & ((1 << S) - 1);
    const int base = ((q >> S) << (S + G)) | lo;
    uint64_t v[R];
#pragma unroll
    for (int j = 0; j < R; j++) {
      const int row = base + (j << S);
      if (FIRST) {
        const int srow = LOG_N ? (int)(__brev((unsigned)row) >> (32 - LOG_N)) : 0;
        v[j] = 0;
        if (srow < a.rows_in) {
          v[j] = a.src[srow * a.L + c];
          if (a.pre) v[j] = gl::mul(v[j], a.pre[srow * a.L + c]);
        }
      } else {
        v[j] = a.sm[row * Sh::STRIDE + c];
      }
    }
#pragma unroll
    for (int g = 0; g < G; g++) {
      const int h = 1 << g;
#pragma unroll
      for (int j = 0; j < R; j++) {
        if (j & h) continue;
        if (S + g > 0) {
          const int pos = lo + ((j & (h - 1)) << S);
          gl::butterfly(v[j], v[j + h], a.twsm[(1 << (S + g)) - 1 + pos]);
        } else {   // stage 0's twiddle is 1: no multiply
          const uint64_t t = gl::canon(v[j + h]);
          v[j + h] = gl::sub_lazy(v[j], t);
          v[j] = gl::add_lazy(v[j], t);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; j++) {
      const int row = base + (j << S);
      if (LAST) {   // the words leave as canonical ones
        v[j] = a.post ? gl::mul(v[j], a.post[row * a.L + c]) : gl::canon(v[j]);
      }
      if (LAST && !TR) {
        a.dst[row * a.L + c] = v[j];
      } else {
        a.sm[row * Sh::STRIDE + c] = v[j];
      }
    }
  }
}

// All stages from S on, in groups of at most three, a barrier between groups.
template <int LOG_N, bool TR, int S>
__device__ __forceinline__ void stage_groups(const Args& a) {
  constexpr int LEFT = LOG_N - S;
  constexpr int GROUPS = (LEFT + 2) / 3;
  constexpr int G = GROUPS ? (LEFT + GROUPS - 1) / GROUPS : 0;
  stage_group<LOG_N, TR, S, G>(a);
  if constexpr (S + G < LOG_N) {
    __syncthreads();
    stage_groups<LOG_N, TR, S + G>(a);
  }
}

// tw: the stage twiddle rows of ntt_cuda.twiddles concatenated; stage s (half
// = 2^s) starts at offset half - 1 and holds w_{2 half}^j, j < half.
template <int LOG_N, bool TR>
__global__ void __launch_bounds__(THREADS)
sub_ntt_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               const uint64_t* __restrict__ tw, const uint64_t* __restrict__ pre,
               const uint64_t* __restrict__ post, int rows_in, long long L, long long tiles) {
  using Sh = Shape<LOG_N>;
  extern __shared__ uint64_t sm[];   // tile [N_T][STRIDE], then the twiddles
  uint64_t* twsm = sm + Sh::N_T * Sh::STRIDE;
  const long long m = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * Sh::TL;
  Args a;
  a.src = in + m * rows_in * L + col0;
  a.dst = out + m * Sh::N_T * L + col0;
  a.pre = pre ? pre + col0 : nullptr;
  a.post = post ? post + col0 : nullptr;
  a.sm = sm;
  a.twsm = twsm;
  a.L = L;
  a.rows_in = rows_in;
  a.width = (int)min((long long)Sh::TL, L - col0);

  for (int i = threadIdx.x; i < Sh::N_T - 1; i += THREADS) twsm[i] = tw[i];
  __syncthreads();
  stage_groups<LOG_N, TR, 0>(a);
  if (TR) {
    __syncthreads();
    uint64_t* dst_t = out + (m * L + col0) * Sh::N_T;   // out[m, col0 + c, r]
    for (int e = threadIdx.x; e < Sh::N_T * Sh::TL; e += THREADS) {
      const int r = e & (Sh::N_T - 1), c = e >> LOG_N;
      if (c < a.width) dst_t[(long long)c * Sh::N_T + r] = sm[r * Sh::STRIDE + c];
    }
  }
}

template <int LOG_N, bool TR>
int launch(const uint64_t* in, uint64_t* out, const uint64_t* tw, const uint64_t* pre,
           const uint64_t* post, long long M, int rows_in, long long L, cudaStream_t stream) {
  using Sh = Shape<LOG_N>;
  auto kernel = sub_ntt_kernel<LOG_N, TR>;
  if (Sh::SMEM > 48 * 1024) {   // per device, so asked for at every launch
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Sh::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (L + Sh::TL - 1) / Sh::TL;
  kernel<<<(unsigned)(M * tiles), THREADS, Sh::SMEM, stream>>>(in, out, tw, pre, post, rows_in,
                                                              L, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, rows_in, L] -> y [M, 2^log_n, L], or y [M, L, 2^log_n] with
// transpose_out; log_n <= 12.
extern "C" int ntt_sub(const uint64_t* in, uint64_t* out, const uint64_t* tw,
                       const uint64_t* pre, const uint64_t* post, long long M,
                       int log_n, int rows_in, long long L, int transpose_out,
                       void* stream) {
  static_assert(MAX_LOG_N == 12, "ntt_sub's cases end at MAX_LOG_N");
  cudaStream_t st = (cudaStream_t)stream;
#define NTT_CASE(N)                                                                      \
  case N:                                                                                \
    return transpose_out ? launch<N, true>(in, out, tw, pre, post, M, rows_in, L, st)    \
                         : launch<N, false>(in, out, tw, pre, post, M, rows_in, L, st);
  switch (log_n) {
    NTT_CASE(0) NTT_CASE(1) NTT_CASE(2) NTT_CASE(3) NTT_CASE(4) NTT_CASE(5) NTT_CASE(6)
    NTT_CASE(7) NTT_CASE(8) NTT_CASE(9) NTT_CASE(10) NTT_CASE(11) NTT_CASE(12)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NTT_CASE
}
