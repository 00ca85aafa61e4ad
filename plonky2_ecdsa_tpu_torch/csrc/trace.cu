// The prover's device stamps (plonky2_ecdsa_tpu_torch/trace.py): one thread
// writes the device's nanosecond timer (%globaltimer) into one slot of a
// small int64 buffer.  Launched on the prover's stream, a stamp runs after
// the work queued before it and before the work queued after it; inside a
// CUDA graph capture it becomes a kernel node with its slot fixed.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void stamp_kernel(long long* slots, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[slot] = (long long)t;
}

}  // namespace

extern "C" int trace_stamp(long long* slots, int slot, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(slots, slot);
  return (int)cudaGetLastError();
}
