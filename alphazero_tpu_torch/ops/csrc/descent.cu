// Batched PUCT descent for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces alphazero_tpu/search/mcts.py::_select (with _ucb_pick_rows), the
// JAX search's per-simulation tree descent.  That was never a Pallas kernel:
// XLA runs it as a while loop of one-level steps over all boards in
// lockstep, and the port's plain version (ops/descent.py::select_plain) does
// the same with some 50 PyTorch launches per level.  stats is the packed
// [B, M, 4, C] float32 tree (C = A + 2; lanes PVALID, CHILD, EN, EW; the
// node scalars in column A), read only.  For board b, from node 0:
//
//   u[a] = q[a] + ((cpuct * prior[a]) * sqrt(Ns)) / (1 + EN[a])  if EN[a] > 0
//        = fpu_init + (cpuct * prior[a]) * sqrt(Ns + 1e-8)        otherwise
//   with q[a] = EW[a] / max(EN[a], 1), Ns = EN[A], prior = max(PVALID, 0),
//   fpu_init = EW[A] / (Ns + 1) - fpu if fpu > 0 else fpu, u = -inf where
//   PVALID < 0; a = the first maximum of u (0 for a row of -inf).  At the
//   root (node 0) with forced playouts, a = the first valid a with EN[a] <
//   floor(sqrt((k_forced * prior[a]) * sim_idx)) where there is one.
//   The level records (node, a, (int) CHILD[A]); the descent stops when
//   CHILD[a] is 0 (unexpanded), negative (terminal child) or the level is
//   depth_cap - 1, else it goes on to node |CHILD[a]|.
//
// Outputs, per board: parent, action, existing (|CHILD[a]| at the stop) and
// parent_rot (the stopping node's (int) CHILD[A]) as int64, depth (levels
// recorded) as int32, and path_p / path_a / path_r [depth_cap] int32 with
// the sentinels M, 0, 0 past the stop: what the plain version returns.
//
// Exactness.  Every float operation is written with a round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in the JAX
// search's association, so nvcc contracts nothing into an FMA and u has the
// bits PyTorch's elementwise ops give; ties go to the lowest index as
// torch.argmax's do (NaN above every number, as there).
//
// What bounds it on this card.  A level reads three edge lanes of one node
// row (3 * 409 floats at A = 409) and four scalars; at B = 1024 boards and
// 2-4 levels that is some 15 MB per launch, 4-5 us at 3.35 TB/s.  Below a
// few hundred boards the chain of dependent loads bounds it instead: a
// level's row address comes from the level before.
//
// Design.  One warp per board, one block per warp: a board's levels are a
// chain and boards share nothing, so no block waits on another, and all
// 1024 boards of a search are resident at once (32 blocks per SM).  A lane
// holds up to 16 columns of each edge lane per tile (512 columns), issues
// all of a tile's loads before it computes, keeps its own first maximum,
// and the warp reduces (value, index) pairs with shuffles.  Each level then
// reads the chosen edge's child pointer (one word, the same for every
// lane), so a level costs two dependent round trips.  A board runs until it
// stops: no level bound from the host and no host sync.  Offsets into stats
// are 64-bit (a reused tree reaches 1.57 GiB).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPValid = 0;
constexpr int kChild = 1;
constexpr int kEN = 2;
constexpr int kEW = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kPerLane = 16;                 // columns a lane holds per tile
constexpr int kTile = kWarp * kPerLane;
constexpr float kEps = 1e-8f;

// torch.argmax's order: NaN above every number, then the larger value, then
// the lower index among equal values.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

__global__ void __launch_bounds__(kWarp)
descent_kernel(const float* __restrict__ stats, int M, int C, int depth_cap,
               float cpuct, float fpu, int fpu_from_parent, int forced,
               float k_forced, float sim_f, long long* __restrict__ out64,
               int B, int* __restrict__ depth_out, int* __restrict__ paths) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int A = C - 2;
  const long long node_stride = 4LL * C;
  const float* board = stats + static_cast<long long>(b) * M * node_stride;
  const long long plane = static_cast<long long>(B) * depth_cap;
  int* pp = paths + static_cast<long long>(b) * depth_cap;
  int* pa = pp + plane;
  int* pr = pa + plane;

  long long node = 0, parent = 0, action = 0, existing = 0, prot = 0;
  int level = 0;
  while (level < depth_cap) {
    const float* row = board + node * node_stride;
    const float ns = row[kEN * C + A];
    const float ws = row[kEW * C + A];
    const long long rot = static_cast<long long>(row[kChild * C + A]);
    const float qs = __fdiv_rn(ws, __fadd_rn(ns, 1.0f));
    const float fpu_init = fpu_from_parent ? __fsub_rn(qs, fpu) : fpu;
    const float sq = __fsqrt_rn(ns);
    const float sq_eps = __fsqrt_rn(__fadd_rn(ns, kEps));
    const bool force_here = forced && node == 0;

    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    int first_forced = A;
    for (int base = 0; base < A; base += kTile) {
      float pv[kPerLane], en[kPerLane], ew[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = base + k * kWarp + lane;
        if (c < A) {
          pv[k] = row[kPValid * C + c];
          en[k] = row[kEN * C + c];
          ew[k] = row[kEW * C + c];
        }
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = base + k * kWarp + lane;
        if (c >= A) continue;
        const bool valid = pv[k] >= 0.0f;
        const float prior = valid ? pv[k] : 0.0f;
        const float cp = __fmul_rn(cpuct, prior);
        float u;
        if (en[k] > 0.0f) {
          const float q = __fdiv_rn(ew[k], fmaxf(en[k], 1.0f));
          u = __fadd_rn(q, __fdiv_rn(__fmul_rn(cp, sq),
                                     __fadd_rn(1.0f, en[k])));
        } else {
          u = __fadd_rn(fpu_init, __fmul_rn(cp, sq_eps));
        }
        if (!valid) u = -CUDART_INF_F;
        if (beats(u, c, bv, bi)) {
          bv = u;
          bi = c;
        }
        if (force_here && valid && c < first_forced) {
          const float th = floorf(__fsqrt_rn(
              __fmul_rn(__fmul_rn(k_forced, prior), sim_f)));
          if (en[k] < th) first_forced = c;
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
      first_forced = min(first_forced,
                         __shfl_xor_sync(kFull, first_forced, off));
    }
    const int a = first_forced < A ? first_forced : bi;
    const float child_raw = row[kChild * C + a];
    const long long child = static_cast<long long>(fabsf(child_raw));
    if (lane == 0) {
      pp[level] = static_cast<int>(node);
      pa[level] = a;
      pr[level] = static_cast<int>(rot);
    }
    parent = node;
    action = a;
    existing = child;
    prot = rot;
    ++level;
    if (child == 0 || child_raw < 0.0f || level >= depth_cap) break;
    node = child;
  }
  for (int l = level + lane; l < depth_cap; l += kWarp) {
    pp[l] = M;
    pa[l] = 0;
    pr[l] = 0;
  }
  if (lane == 0) {
    out64[b] = parent;
    out64[B + b] = action;
    out64[2 * B + b] = existing;
    out64[3 * B + b] = prot;
    depth_out[b] = level;
  }
}

}  // namespace

// out64: [4, B] int64 (parent, action, existing, parent_rot); depth: [B]
// int32; paths: [3, B, depth_cap] int32 (path_p, path_a, path_r).
extern "C" int descent_launch(const float* stats, int B, int M, int C,
                              int depth_cap, float cpuct, float fpu,
                              int fpu_from_parent, int forced, float k_forced,
                              float sim_f, long long* out64, int* depth,
                              int* paths, void* stream) {
  if (B <= 0) return 0;
  descent_kernel<<<B, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      stats, M, C, depth_cap, cpuct, fpu, fpu_from_parent, forced, k_forced,
      sim_f, out64, B, depth, paths);
  return static_cast<int>(cudaGetLastError());
}
