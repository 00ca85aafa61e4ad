// Goldilocks arithmetic of the prover's quotient over strided int64 tensors
// (plonky2_ecdsa_tpu_torch/fields/goldilocks_cuda.py launches these).
//
// Replaces no TPU kernel: the JAX package leaves this arithmetic to XLA,
// which fuses it.  Eager PyTorch has no unsigned 64-bit arithmetic and spells
// one modular multiply as ~45 int64 elementwise kernels, each reading and
// writing full-size tensors.  Here one launch is one field operation: the
// operands are read once, the result written once, and the 128-bit product
// and the carries stay in registers.  Bound: bytes (8 a word read or
// written; a canonical multiply is ~32 instructions against the ~80 the card
// issues in the time its memory moves three words).
//
// field_binary_kernel: out = a op b for op add, sub, mul, or neg of a.  The
//   operands are laid onto the output's shape by strides (0 on a broadcast
//   axis) over four axes, the wrapper having merged what it can; either one
//   may be a u64 constant instead.  The output is contiguous.  With V = 2 a
//   thread takes two neighbouring words of the innermost axis, by one 16-byte
//   load where an operand's innermost stride is 1 (the wrapper checks the
//   alignment) and one 8-byte load where it is 0.
// field_reduce_kernel: out = sum_k x_k, or sum_k x_k w_k, over one axis of
//   K words (K < 2^31).  One thread an output word (two with V = 2), the
//   sum kept in 96 bits (lazy products, made canonical once at the store).
//   Neighbouring threads read neighbouring words of the innermost axis.
//
// Grid-stride loops with 32-bit slot indices: an entry refuses an output of
// 2^31 words or more (cudaErrorInvalidValue), so that a slot plus the grid's
// stride stays below 2^32; the operands' offsets are 64-bit.  Each entry
// launches on the caller's stream, allocates nothing, keeps nothing between
// calls and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int DIMS = 4;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

enum Op { ADD = 0, SUB = 1, MUL = 2, NEG = 3 };

struct Dims {
  long long size[DIMS];
};

// Words at ptr + sum_d i_d stride[d]; the constant `value` where ptr is null.
struct Operand {
  const uint64_t* ptr;
  long long stride[DIMS];
  uint64_t value;
};

template <int OP>
__device__ __forceinline__ uint64_t apply(uint64_t a, uint64_t b) {
  if constexpr (OP == ADD) {
    return gl::add(a, b);
  } else if constexpr (OP == SUB) {
    return gl::sub(a, b);
  } else if constexpr (OP == MUL) {
    return gl::mul(a, b);
  } else {
    return a == 0 ? 0 : gl::P - a;
  }
}

__device__ __forceinline__ long long offset(const Operand& o, long long i0, long long i1,
                                            long long i2, long long i3) {
  return i0 * o.stride[0] + i1 * o.stride[1] + i2 * o.stride[2] + i3 * o.stride[3];
}

// The V words of operand o from offset off along its innermost axis.
template <int V>
__device__ __forceinline__ void load(const Operand& o, long long off, uint64_t (&v)[V]) {
  if (o.ptr == nullptr) {
    for (int j = 0; j < V; ++j) v[j] = o.value;
  } else if (V == 1 || o.stride[3] == 0) {
    const uint64_t x = o.ptr[off];
    for (int j = 0; j < V; ++j) v[j] = x;
  } else {
    const ulonglong2 x = *reinterpret_cast<const ulonglong2*>(o.ptr + off);
    v[0] = x.x;
    v[V - 1] = x.y;
  }
}

// Slot s (V words of the innermost axis) -> its index on the four axes.
template <int V>
__device__ __forceinline__ void unravel(uint32_t s, const Dims& d, long long (&i)[DIMS]) {
  const uint32_t n3 = (uint32_t)(d.size[3] / V), n2 = (uint32_t)d.size[2],
                 n1 = (uint32_t)d.size[1];
  uint32_t r = s / n3;
  i[3] = (long long)(s - r * n3) * V;
  uint32_t q = r / n2;
  i[2] = (long long)(r - q * n2);
  r = q / n1;
  i[1] = (long long)(q - r * n1);
  i[0] = (long long)r;
}

template <int OP, int V>
__global__ void __launch_bounds__(THREADS)
    field_binary_kernel(Operand a, Operand b, uint64_t* __restrict__ out, Dims d, uint32_t slots) {
  for (uint32_t s = blockIdx.x * THREADS + threadIdx.x; s < slots; s += gridDim.x * THREADS) {
    long long i[DIMS];
    unravel<V>(s, d, i);
    uint64_t x[V], y[V], r[V];
    load<V>(a, offset(a, i[0], i[1], i[2], i[3]), x);
    if constexpr (OP != NEG) load<V>(b, offset(b, i[0], i[1], i[2], i[3]), y);
    for (int j = 0; j < V; ++j) r[j] = apply<OP>(x[j], OP == NEG ? 0 : y[j]);
    if constexpr (V == 2) {
      reinterpret_cast<ulonglong2*>(out)[s] = make_ulonglong2(r[0], r[1]);
    } else {
      out[s] = r[0];
    }
  }
}

template <bool WEIGHTED, int V>
__global__ void __launch_bounds__(THREADS)
    field_reduce_kernel(Operand x, Operand w, long long x_k, long long w_k, int K,
                        uint64_t* __restrict__ out, Dims d, uint32_t slots) {
  for (uint32_t s = blockIdx.x * THREADS + threadIdx.x; s < slots; s += gridDim.x * THREADS) {
    long long i[DIMS];
    unravel<V>(s, d, i);
    const long long ox = offset(x, i[0], i[1], i[2], i[3]);
    const long long ow = WEIGHTED ? offset(w, i[0], i[1], i[2], i[3]) : 0;
    gl::w96 acc[V];
    for (int j = 0; j < V; ++j) acc[j] = gl::w96{0, 0u};
    // K < 2^31 words below 2^64 each: the sums stay below 2^96
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      uint64_t v[V];
      load<V>(x, ox + k * x_k, v);
      if constexpr (WEIGHTED) {
        uint64_t u[V];
        load<V>(w, ow + k * w_k, u);
        for (int j = 0; j < V; ++j) v[j] = gl::mul_lazy(v[j], u[j]);
      }
      for (int j = 0; j < V; ++j) acc[j] = gl::add96(acc[j], v[j]);
    }
    uint64_t r[V];
    for (int j = 0; j < V; ++j) r[j] = gl::canon(gl::fold96(acc[j]));
    if constexpr (V == 2) {
      reinterpret_cast<ulonglong2*>(out)[s] = make_ulonglong2(r[0], r[1]);
    } else {
      out[s] = r[0];
    }
  }
}

Dims dims_of(const long long* sizes) {
  Dims d;
  for (int j = 0; j < DIMS; ++j) d.size[j] = sizes[j];
  return d;
}

Operand operand_of(const void* ptr, const long long* strides, unsigned long long value) {
  Operand o;
  o.ptr = static_cast<const uint64_t*>(ptr);
  for (int j = 0; j < DIMS; ++j) o.stride[j] = ptr ? strides[j] : 0;
  o.value = value;
  return o;
}

long long words_of(const Dims& d) { return d.size[0] * d.size[1] * d.size[2] * d.size[3]; }

// An output of fewer than 2^31 words: slot indices fit 32 bits, grid stride
// (below 2^20) included.
constexpr long long MAX_WORDS = 1ll << 31;

int blocks_of(long long slots) {
  const long long b = (slots + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <int OP>
void launch_binary(const Operand& a, const Operand& b, uint64_t* out, const Dims& d, int vec,
                   cudaStream_t stream) {
  const long long slots = words_of(d) / (vec ? 2 : 1);
  if (vec) {
    field_binary_kernel<OP, 2><<<blocks_of(slots), THREADS, 0, stream>>>(a, b, out, d,
                                                                         (uint32_t)slots);
  } else {
    field_binary_kernel<OP, 1><<<blocks_of(slots), THREADS, 0, stream>>>(a, b, out, d,
                                                                         (uint32_t)slots);
  }
}

template <bool W>
void launch_reduce(const Operand& x, const Operand& w, long long x_k, long long w_k, int K,
                   uint64_t* out, const Dims& d, int vec, cudaStream_t stream) {
  const long long slots = words_of(d) / (vec ? 2 : 1);
  if (vec) {
    field_reduce_kernel<W, 2><<<blocks_of(slots), THREADS, 0, stream>>>(x, w, x_k, w_k, K, out,
                                                                        d, (uint32_t)slots);
  } else {
    field_reduce_kernel<W, 1><<<blocks_of(slots), THREADS, 0, stream>>>(x, w, x_k, w_k, K, out,
                                                                        d, (uint32_t)slots);
  }
}

}  // namespace

// out[sizes] = a op b (op: 0 add, 1 sub, 2 mul, 3 neg of a).  An operand is
// `ptr` read by its four `strides`, or, with a null ptr, the constant `value`.
// vec: the innermost size is even and each operand's innermost stride is 0
// or 1, its other strides even and its pointer 16-byte aligned.  Fewer than
// 2^31 output words.
extern "C" int gl_binary(int op, const void* a, const long long* a_strides,
                         unsigned long long a_value, const void* b, const long long* b_strides,
                         unsigned long long b_value, void* out, const long long* sizes, int vec,
                         void* stream) {
  const Dims d = dims_of(sizes);
  if (words_of(d) >= MAX_WORDS) return (int)cudaErrorInvalidValue;
  const Operand oa = operand_of(a, a_strides, a_value), ob = operand_of(b, b_strides, b_value);
  uint64_t* o = static_cast<uint64_t*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case ADD: launch_binary<ADD>(oa, ob, o, d, vec, s); break;
    case SUB: launch_binary<SUB>(oa, ob, o, d, vec, s); break;
    case MUL: launch_binary<MUL>(oa, ob, o, d, vec, s); break;
    case NEG: launch_binary<NEG>(oa, ob, o, d, vec, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[sizes] = sum over k < K of x_k (times w_k where w is not null).  Each
// tensor is read by four strides over the output's axes and one more along
// k (x_strides[4], w_strides[4]); vec as in gl_binary, the k strides even too.
// Fewer than 2^31 output words and terms.
extern "C" int gl_reduce(const void* x, const long long* x_strides, const void* w,
                         const long long* w_strides, long long K, void* out,
                         const long long* sizes, int vec, void* stream) {
  const Dims d = dims_of(sizes);
  if (x == nullptr || K < 0 || K >= MAX_WORDS || words_of(d) >= MAX_WORDS) {
    return (int)cudaErrorInvalidValue;
  }
  const Operand ox = operand_of(x, x_strides, 0), ow = operand_of(w, w_strides, 0);
  uint64_t* o = static_cast<uint64_t*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (w) {
    launch_reduce<true>(ox, ow, x_strides[DIMS], w_strides[DIMS], (int)K, o, d, vec, s);
  } else {
    launch_reduce<false>(ox, ow, x_strides[DIMS], 0, (int)K, o, d, vec, s);
  }
  return (int)cudaGetLastError();
}
