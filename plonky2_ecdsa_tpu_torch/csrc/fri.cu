// FRI's DEEP-reduced polynomial in one pass over the LDEs
// (plonky2_ecdsa_tpu_torch/prover/fri_cuda.py launches it).
//
// For lane b and point x_j of a domain slice:
//
//   F(x_j) = (sum_t a^t p_t(x_j) - y) / (x_j - zeta)
//          + a^T (sum_k a^k z_k(x_j) - y') / (x_j - g zeta)
//
// over the quadratic extension (x^2 = 7), with y = sum_t a^t open0_t and
// y' = sum_k a^k open1_k; the p_t are the rows of four sources in order
// (the fixed LDE [Tf, m], shared by the lanes; the wires, zs and quotient
// LDEs [B, rows, m]), T of them, and z_k is zs row zrows[k].
//
// Replaces no TPU kernel: the JAX package's reduction
// (plonky2_ecdsa_tpu/prover/prover.py:1406) is jnp that XLA fuses.  Eager
// PyTorch spelt it as two Fermat ladders a point, a [B, T, m] copy of the
// sources and ~45 int64 kernels a field multiply.  Bound: bytes (each LDE
// word read once, ~2.2 GB a B=32 proof) and, about as near, instructions
// (two products a word).  So each word is loaded once, straight from its
// LDE where it lies; its two products (one a component) go into 160-bit
// sums unreduced (gl::mac160) and are reduced once a point; the weights
// a^t sit in shared memory, made by each block for its lane (doubling,
// log2 T rounds), with y and y' (block sums); both denominators of a
// thread's points are inverted by one Fermat chain (Montgomery's trick; a
// zero norm, x_j - zeta = 0, gets 0, as the plain field's inverse does).
// A block is one lane's tile of TILE points; blocks run lane by lane within
// a tile, so the blocks resident at once read the same fixed columns, from
// L2 after the first lane.
//
// One launch, on the caller's stream; allocates nothing; returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take (more than MAX_TERMS rows, more than MAX_Z second rows, B m of 2^31
// words or more).

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int V = 2;                   // points a thread, THREADS apart
constexpr int TILE = THREADS * V;      // points a block
constexpr int MAX_Z = 16;              // rows of the second sum
constexpr int MAX_TERMS = 2048;        // rows of the first: a^0..a^T in 32 KiB of shared memory
constexpr uint64_t W_EXT = 7;

// Words at ptr + b lane + i col (+ j): a source [B, rows, m] (lane 0 where
// the lanes share it), a per-lane value [B], or openings [B, n].
struct Mat {
  const uint64_t* ptr;
  long long lane, col, rows;
};

struct Args {
  Mat src[4];                          // fixed, wires, zs, quotient; col is the row stride
  Mat x;                               // the slice's points, [m]
  Mat zeta[2], gzeta[2], alpha[2];     // extension components, one a lane
  Mat open0[2], open1[2];              // [B, T] and [B, K]
  uint64_t* out;                       // [2, B, m]
  long long B, m, K;
  long long zrows[MAX_Z];              // zs rows of the second sum
};

struct Ext {
  uint64_t c0, c1;
};

__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ uint64_t neg(uint64_t a) { return a == 0 ? 0 : gl::P - a; }

// Canonical in, canonical out.
__device__ __forceinline__ Ext ext_mul(Ext a, Ext b) {
  return Ext{gl::add(gl::mul(a.c0, b.c0), gl::mul(gl::mul_lazy(a.c1, b.c1), W_EXT)),
             gl::add(gl::mul(a.c0, b.c1), gl::mul(a.c1, b.c0))};
}

__device__ __forceinline__ Ext ext_add(Ext a, Ext b) {
  return Ext{gl::add(a.c0, b.c0), gl::add(a.c1, b.c1)};
}

__device__ __forceinline__ Ext ext_sub(Ext a, Ext b) {
  return Ext{gl::sub(a.c0, b.c0), gl::sub(a.c1, b.c1)};
}

__device__ __forceinline__ Ext lane_ext(const Mat (&v)[2], long long b) {
  return Ext{ld(v[0].ptr + b * v[0].lane), ld(v[1].ptr + b * v[1].lane)};
}

// *dst = sum over t < n of a^t o[b, t], for the block to read after its
// next barrier.
__device__ __forceinline__ void lane_dot(const ulonglong2* pw, const Mat (&o)[2], long long b,
                                         long long n, unsigned long long (&part)[2][WARPS],
                                         ulonglong2* dst) {
  gl::w160 s0{0, 0, 0u}, s1{0, 0, 0u};
  for (long long t = threadIdx.x; t < n; t += THREADS) {
    const ulonglong2 w = pw[t];
    const uint64_t u0 = ld(o[0].ptr + b * o[0].lane + t * o[0].col);
    const uint64_t u1 = ld(o[1].ptr + b * o[1].lane + t * o[1].col);
    s0 = gl::mac160(gl::mac160(s0, w.x, u0), gl::mul_lazy(w.y, u1), W_EXT);
    s1 = gl::mac160(gl::mac160(s1, w.x, u1), w.y, u0);
  }
  unsigned long long r0 = gl::canon(gl::fold160(s0)), r1 = gl::canon(gl::fold160(s1));
  for (int d = 16; d; d >>= 1) {
    r0 = gl::add(r0, __shfl_xor_sync(0xFFFFFFFFu, r0, d));
    r1 = gl::add(r1, __shfl_xor_sync(0xFFFFFFFFu, r1, d));
  }
  if (threadIdx.x % 32 == 0) {
    part[0][threadIdx.x / 32] = r0;
    part[1][threadIdx.x / 32] = r1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Ext r{0, 0};
    for (int w = 0; w < WARPS; ++w) r = ext_add(r, Ext{part[0][w], part[1][w]});
    *dst = make_ulonglong2(r.c0, r.c1);
  }
  __syncthreads();
}

// x_j - zeta (d = 0) or x_j - g zeta (d = 1) of lane b.
__device__ __forceinline__ Ext denominator(const Args& a, long long b, int j, int d) {
  const Ext z = lane_ext(d ? a.gzeta : a.zeta, b);
  return Ext{gl::sub(ld(a.x.ptr + j), z.c0), neg(z.c1)};
}

// r[i] = 1 / n[i] for canonical n[i], 0 where n[i] is 0: one inversion.
template <int N>
__device__ __forceinline__ void batch_inverse(const uint64_t (&n)[N], uint64_t (&r)[N]) {
  uint64_t pre[N];
  uint64_t acc = 1;
#pragma unroll
  for (int i = 0; i < N; ++i) pre[i] = acc = gl::mul(acc, n[i] ? n[i] : 1);
  uint64_t inv = gl::inverse(acc);
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    r[i] = n[i] == 0 ? 0 : i ? gl::mul(inv, pre[i - 1]) : inv;
    inv = gl::mul(inv, n[i] ? n[i] : 1);
  }
}

__global__ void __launch_bounds__(THREADS) fri_reduced_kernel(const Args a) {
  extern __shared__ ulonglong2 pw[];   // pw[t] = a^t, t <= T
  __shared__ unsigned long long part[2][WARPS];
  __shared__ ulonglong2 y[2];          // y and y'

  // 32-bit: a 64-bit division is a call, whose frame spills
  const unsigned lanes = (unsigned)a.B;
  const long long b = blockIdx.x % lanes, tile = blockIdx.x / lanes;
  const long long T = a.src[0].rows + a.src[1].rows + a.src[2].rows + a.src[3].rows;

  // the lane's weights: powers of a by doubling, [s, 2s) from [0, s) times a^s
  if (threadIdx.x == 0) pw[0] = make_ulonglong2(1, 0);
  __syncthreads();
  Ext step = lane_ext(a.alpha, b);
  for (long long s = 1; s <= T; s *= 2) {
    for (long long i = threadIdx.x; i < s && s + i <= T; i += THREADS) {
      const Ext r = ext_mul(Ext{pw[i].x, pw[i].y}, step);
      pw[s + i] = make_ulonglong2(r.c0, r.c1);
    }
    __syncthreads();
    step = ext_mul(step, step);
  }
  lane_dot(pw, a.open0, b, T, part, &y[0]);
  lane_dot(pw, a.open1, b, a.K, part, &y[1]);

  // the points (a.m < 2^31): past the slice's end a thread repeats its last
  // point, unstored
  const int first = (int)tile * TILE + threadIdx.x;
  int j[V];
#pragma unroll
  for (int v = 0; v < V; ++v) j[v] = min(first + v * THREADS, (int)a.m - 1);

  gl::w160 acc[V][2];
  for (int v = 0; v < V; ++v) acc[v][0] = acc[v][1] = gl::w160{0, 0, 0u};
  const ulonglong2* w = pw;            // the weight of each row in turn
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const Mat src = a.src[s];
    const uint64_t* p[V];                // each point's word of the row
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = src.ptr + b * src.lane + j[v];
    const int rows = (int)src.rows;
#pragma unroll 4
    for (int r = 0; r < rows; ++r, ++w) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint64_t u = ld(p[v]);
        p[v] += src.col;
        acc[v][0] = gl::mac160(acc[v][0], u, w->x);
        acc[v][1] = gl::mac160(acc[v][1], u, w->y);
      }
    }
  }
  Ext num[V][2];
  for (int v = 0; v < V; ++v) {
    num[v][0] = ext_sub(Ext{gl::canon(gl::fold160(acc[v][0])), gl::canon(gl::fold160(acc[v][1]))},
                        Ext{y[0].x, y[0].y});
    acc[v][0] = acc[v][1] = gl::w160{0, 0, 0u};
  }
  const uint64_t* zs = a.src[2].ptr + b * a.src[2].lane;
  for (long long k = 0; k < a.K; ++k) {
    const ulonglong2 w = pw[k];
    const uint64_t* row = zs + a.zrows[k] * a.src[2].col;
    for (int v = 0; v < V; ++v) {
      const uint64_t u = ld(row + j[v]);
      acc[v][0] = gl::mac160(acc[v][0], u, w.x);
      acc[v][1] = gl::mac160(acc[v][1], u, w.y);
    }
  }
  for (int v = 0; v < V; ++v) {
    num[v][1] = ext_sub(Ext{gl::canon(gl::fold160(acc[v][0])), gl::canon(gl::fold160(acc[v][1]))},
                        Ext{y[1].x, y[1].y});
  }

  // the denominators x - zeta and x - g zeta, inverted as conjugate over
  // norm; made twice (for the norms, then for the conjugates) rather than
  // kept live across the inversion
  uint64_t norm[2 * V], inv[2 * V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const Ext den = denominator(a, b, j[v], d);
      norm[2 * v + d] =
          gl::sub(gl::mul(den.c0, den.c0), gl::mul(gl::mul_lazy(den.c1, den.c1), W_EXT));
    }
  }
  batch_inverse(norm, inv);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (first + v * THREADS >= a.m) continue;
    Ext q[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const Ext den = denominator(a, b, j[v], d);
      const uint64_t i = inv[2 * v + d];
      q[d] = ext_mul(num[v][d], Ext{gl::mul(den.c0, i), gl::mul(neg(den.c1), i)});
    }
    const Ext f = ext_add(q[0], ext_mul(Ext{pw[T].x, pw[T].y}, q[1]));   // a^T
    uint64_t* out = a.out + b * a.m + j[v];
    out[0] = f.c0;
    out[a.B * a.m] = f.c1;
  }
}

}  // namespace

// The reduced polynomial over a slice (Args, as fri_cuda.py lays it out),
// into a.out [2, B, m].
extern "C" int fri_reduced(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  long long T = 0;
  for (const Mat& s : a.src) T += s.rows;
  const long long tiles = (a.m + TILE - 1) / TILE;
  if (a.B <= 0 || a.m <= 0 || T > MAX_TERMS || a.K < 0 || a.K > MAX_Z || a.K > T + 1 ||
      a.B * a.m >= (1ll << 31) || a.B * tiles >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t shared = (size_t)(T + 1) * sizeof(ulonglong2);
  fri_reduced_kernel<<<(unsigned)(a.B * tiles), THREADS, shared, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
