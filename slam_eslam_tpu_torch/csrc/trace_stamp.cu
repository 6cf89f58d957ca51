// The tracer's stamp: one record of (code, value) written into a ring in
// device memory, by one thread (slam_eslam_tpu_torch/utils/tracing.py).
//
// No TPU kernel stands behind it: the JAX package has no tracing inside a
// jitted step.  It exists because a CUDA graph replays its kernels with no
// host code between them, so a stage boundary inside a captured step can
// only be marked by work on the device itself.  A stamp is a kernel node of
// the graph: it runs when the stream reaches it, that is after the kernels
// launched before it have finished, and reads the card's nanosecond clock
// (%globaltimer) there, or a count that earlier kernels left in device
// memory.
//
// Bound: launch latency alone (one thread, 16 bytes written).  The slot
// comes from an atomic cursor in device memory, so each replay of a graph
// writes the next records of the ring and the host never reads the cursor
// until the tracer's records are read.
//
// mode 0: value <- %globaltimer (ns); 1: value <- imm; 2: value <- *value_ptr
// (int64).

#include <cuda_runtime.h>

__global__ void trace_stamp_kernel(long long* ring,
                                   unsigned long long* cursor,
                                   unsigned long long capacity,
                                   long long code,
                                   const long long* value_ptr, int mode,
                                   long long imm) {
  long long value;
  if (mode == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    value = static_cast<long long>(t);
  } else if (mode == 1) {
    value = imm;
  } else {
    value = *value_ptr;
  }
  const unsigned long long slot = atomicAdd(cursor, 1ULL) % capacity;
  ring[2 * slot] = code;
  ring[2 * slot + 1] = value;
}

extern "C" int trace_stamp_launch(void* ring, void* cursor,
                                  long long capacity, long long code,
                                  const void* value_ptr, int mode,
                                  long long imm, void* stream) {
  if (capacity <= 0 || mode < 0 || mode > 2 || (mode == 2 && !value_ptr))
    return (int)cudaErrorInvalidValue;
  trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring),
      static_cast<unsigned long long*>(cursor),
      static_cast<unsigned long long>(capacity), code,
      static_cast<const long long*>(value_ptr), mode, imm);
  return (int)cudaGetLastError();
}
