// Fused MCTS backup for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel alphazero_tpu/ops/fused_backup.py::fused_backup
// (body _kernel) and takes over the packed-layout update that the JAX main
// path runs in XLA, alphazero_tpu/search/mcts.py::_backprop_fused.  For each
// board b (stats is [B, M, 4, C] float32, lanes PVALID, CHILD, EN, EW):
//
//   for each level s with path_p[b,s] < M (M is the drop sentinel):
//       stats[b, p, EN, a] += w[b,s,0];  stats[b, p, EW, a] += w[b,s,1]
//       and, with node_col >= 0, the same at column node_col
//   if child_v[b] != 0:  stats[b, child_p[b], CHILD, child_a[b]] += child_v[b]
//   stats[b, slot[b], lanes, :] += row[b]   (row_lanes == 1: lane PVALID only;
//                                            row_lanes == 4: all four lanes)
//
// The split contract of the Pallas kernel is C = A, node_col = -1 and a
// one-lane row; the packed contract of the search is C = A + 2 with node
// column A (the node's visit count and value sum) and the expanded node's
// full four-lane row.
//
// What bounds it: the update touches only a few hundred bytes per board on
// the path plus the slot row (2 x 4 x C floats read and written, and the row
// input), about 20 KB per board or 20 MB at B = 1024, i.e. a few
// microseconds of HBM time at 3.35 TB/s.  The TPU versions instead stream
// the whole [B, M, 4, C] array (437 MB at the search shape) through a dense
// one-hot matmul.  Here the time goes to latency: the path walk is a chain
// of dependent read-modify-writes, and the launch itself.
//
// Design: one block per board, so no two blocks touch the same element.
// Thread 0 walks the levels in level order, which makes repeated (p, a)
// pairs accumulate in the same order as a sequential reference, then does
// the child install; after a barrier all threads add the slot row with
// coalesced accesses.  Float32 throughout (the Pallas kernel used a bf16
// one-hot matmul), so the result is exact.  The update is in place: the JAX
// versions alias stats from input to output.

#include <cuda_runtime.h>

namespace {

constexpr int kPValid = 0;
constexpr int kChild = 1;
constexpr int kEN = 2;
constexpr int kEW = 3;
constexpr int kThreads = 128;

__global__ void fused_backup_kernel(float* __restrict__ stats, int M, int C,
                                    int node_col, const int* __restrict__ path_p,
                                    const int* __restrict__ path_a,
                                    const float* __restrict__ w, int S1,
                                    const int* __restrict__ child_p,
                                    const int* __restrict__ child_a,
                                    const float* __restrict__ child_v,
                                    const float* __restrict__ row, int row_lanes,
                                    const int* __restrict__ slot) {
  const int b = blockIdx.x;
  const size_t node_stride = static_cast<size_t>(4) * C;
  float* sb = stats + static_cast<size_t>(b) * M * node_stride;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S1; ++s) {
      const int i = b * S1 + s;
      const int p = path_p[i];
      if (static_cast<unsigned>(p) >= static_cast<unsigned>(M)) continue;
      const int a = path_a[i];
      const float w_en = w[2 * i];
      const float w_ew = w[2 * i + 1];
      float* r = sb + p * node_stride;
      r[kEN * C + a] += w_en;
      r[kEW * C + a] += w_ew;
      if (node_col >= 0) {
        r[kEN * C + node_col] += w_en;
        r[kEW * C + node_col] += w_ew;
      }
    }
    const float cv = child_v[b];
    if (cv != 0.0f) {
      sb[child_p[b] * node_stride + kChild * C + child_a[b]] += cv;
    }
  }
  __syncthreads();

  const int n = row_lanes * C;
  float* dst = sb + slot[b] * node_stride + (row_lanes == 1 ? kPValid * C : 0);
  const float* src = row + static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] += src[j];
}

}  // namespace

extern "C" int fused_backup_launch(float* stats, int B, int M, int C,
                                   int node_col, const int* path_p,
                                   const int* path_a, const float* w, int S1,
                                   const int* child_p, const int* child_a,
                                   const float* child_v, const float* row,
                                   int row_lanes, const int* slot,
                                   void* stream) {
  if (B <= 0) return 0;
  fused_backup_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      stats, M, C, node_col, path_p, path_a, w, S1, child_p, child_a, child_v,
      row, row_lanes, slot);
  return static_cast<int>(cudaGetLastError());
}
