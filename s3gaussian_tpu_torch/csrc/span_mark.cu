// A stage boundary of the train step on the device's clock: one thread
// writes %globaltimer (ns) into slot k of a stamp buffer.
//
// No Pallas kernel of the JAX package corresponds: the marks are the
// port's tracing (s3gaussian_tpu_torch/utils/spans.py).  A mark made
// while a stream captures a CUDA graph is a node of the graph, so it
// runs again, in stream order, on every replay; a profiler's device trace
// records it under the kernel's name, ``span_mark``, on the trace's own
// clock, so the stage boundaries appear between the stages' kernels.
//
// What bounds it: the launch, one thread and one 8-byte store.
#include <cuda_runtime.h>
#include <cstdint>

extern "C" __global__ void span_mark(int64_t* __restrict__ stamps,
                                     int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[slot] = static_cast<int64_t>(t);
}

extern "C" int span_mark_at(int64_t* stamps, int slot, void* stream) {
  span_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(stamps, slot);
  return static_cast<int>(cudaGetLastError());
}
