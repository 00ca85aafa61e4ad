// Fused radix-2 DIT sub-NTT over Goldilocks along the row axis.
//
// Replaces plonky2_ecdsa_tpu/prover/ntt_pallas.py::_sub_ntt_kernel (the
// pallas_call at :181), which ntt_pallas.four_step runs twice with a
// transpose between.  One launch does, for x[m, rows_in, L] -> y[m, n_t, L]:
// optional pre-multiply (coset powers), zero rows rows_in..n_t-1 (compact LDE
// input: the padding is never read), bit reversal, log2(n_t) butterfly
// stages, optional post-multiply (the four-step twiddle, 1/n folded in).
//
// What bounds it on the card: device memory.  A pass reads and writes each
// element once (16 bytes) and does log2(n_t) / 2 modular multiplies per
// element, far below the integer rate, so the design keeps every stage in
// shared memory: one block per (m, tile of TL columns) holds the whole
// [n_t, TL] sub-matrix (at most 4096 words, 32 KiB, so no opt-in to more
// than 48 KiB of dynamic shared memory is needed), loads it once in
// bit-reversed row order, runs all stages between __syncthreads(), and
// stores it once.  Threads walk the tile column-fastest, so a warp reads
// TL consecutive words of a row.

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;

// tw: the stage twiddle rows of ntt._stage_rows concatenated; stage s (half
// = 2^s) starts at offset half - 1 and holds w_{2 half}^j, j < half.
__global__ void sub_ntt_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out,
                               const uint64_t* __restrict__ tw,
                               const uint64_t* __restrict__ pre,
                               const uint64_t* __restrict__ post,
                               int log_n, int rows_in, long long L, int TL,
                               long long tiles) {
  extern __shared__ uint64_t sm[];  // [n_t][TL]
  const int n_t = 1 << log_n;
  const long long m = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * TL;
  const int width = (int)min((long long)TL, L - col0);
  const uint64_t* src = in + m * rows_in * L + col0;
  uint64_t* dst = out + m * (long long)n_t * L + col0;

  for (int e = threadIdx.x; e < n_t * TL; e += blockDim.x) {
    int r = e / TL, c = e % TL;
    uint64_t v = 0;
    if (r < rows_in && c < width) {
      v = src[r * L + c];
      if (pre) v = gl::mul(v, pre[r * L + col0 + c]);
    }
    int rr = log_n ? (int)(__brev((unsigned)r) >> (32 - log_n)) : 0;
    sm[rr * TL + c] = v;
  }
  __syncthreads();

  for (int s = 0; s < log_n; s++) {
    const int half = 1 << s;
    const uint64_t* w = tw + (half - 1);
    for (int e = threadIdx.x; e < (n_t / 2) * TL; e += blockDim.x) {
      int b = e / TL, c = e % TL;
      int pos = b & (half - 1);
      int i0 = ((b >> s) << (s + 1)) + pos;
      uint64_t u = sm[i0 * TL + c];
      uint64_t t = gl::mul(sm[(i0 + half) * TL + c], w[pos]);
      sm[i0 * TL + c] = gl::add(u, t);
      sm[(i0 + half) * TL + c] = gl::sub(u, t);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < n_t * TL; e += blockDim.x) {
    int r = e / TL, c = e % TL;
    if (c < width) {
      uint64_t v = sm[r * TL + c];
      if (post) v = gl::mul(v, post[r * L + col0 + c]);
      dst[r * L + c] = v;
    }
  }
}

}  // namespace

extern "C" int ntt_sub(const uint64_t* in, uint64_t* out, const uint64_t* tw,
                       const uint64_t* pre, const uint64_t* post, long long M,
                       int log_n, int rows_in, long long L, int TL,
                       void* stream) {
  long long tiles = (L + TL - 1) / TL;
  size_t smem = ((size_t)1 << log_n) * TL * sizeof(uint64_t);
  sub_ntt_kernel<<<(unsigned)(M * tiles), THREADS, smem, (cudaStream_t)stream>>>(
      in, out, tw, pre, post, log_n, rows_in, L, TL, tiles);
  return (int)cudaGetLastError();
}
