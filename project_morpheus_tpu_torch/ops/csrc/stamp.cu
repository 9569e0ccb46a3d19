// A device timestamp: one thread writes (code, %globaltimer) to a row of
// an int64 (n, 2) buffer.
//
// Not a Pallas kernel: the engine's trace (engine/trace.py) marks the
// stage boundaries of a frame program with it, inside the captured CUDA
// graph, where a torch.cuda.Event node would be recorded again by the
// next replay before the host has read it.  The card's global timer
// counts nanoseconds; the kernel runs once every kernel before it on the
// stream has ended, so its reading is the time that work finished.
//
// It takes part in a programmatic dependent launch: it lets the kernel
// after it launch at once (griddepcontrol.launch_dependents), so an int8
// GEMV that follows a stamp streams its weights while the stamp runs, as
// it would behind the kernel the stamp follows.  It reads nothing another
// kernel wrote, and the GEMV's own griddepcontrol.wait still waits for the
// stamp to end.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* row, long long code) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  row[0] = code;
  row[1] = static_cast<long long>(t);
}

}  // namespace

// Status: 0 or a cudaError_t.
extern "C" int mp_stamp(void* row, long long code, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(row),
                                                                code);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
