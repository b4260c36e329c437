// Latency probes for Hopper (sm_90a), bound to Python with ctypes.  Not part
// of the search: chip_smoke.py times them beside the descent kernel.
//
// l2_chase: one thread follows a chain of indices i -> next[i] from 0 for
// `steps` links, each load waiting for the one before; ld.global.cg keeps
// the loads in L2.  The last index is written to sink so the loop is not
// removed.  It gives the descent's latency floor (one dependent L2 load
// per tree level).
//
// noop: an empty kernel of one thread.  Its device time is the floor under
// any launch's, the descent's included.

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int steps,
                             int* __restrict__ sink) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *sink = i;
}

__global__ void noop_kernel() {}

}  // namespace

extern "C" int l2_chase_launch(const int* next, int steps, int* sink,
                               void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, steps,
                                                               sink);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
