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
// Element types.  The kernel is a template on the stats element type: the
// float32 instantiation, and a bfloat16 one for MCTSConfig.stats_dtype =
// "bfloat16" (the JAX search's bf16 tree stats, which _select upcasts to
// float32 row by row before any arithmetic).  The bf16 kernel converts each
// element to float32 as it reads it from shared memory, then scores,
// orders and reduces exactly as the float32 one.  A bf16 row is 8 * C
// bytes (3,288 at A = 409), so its start is 16-byte aligned only for even
// b * M + node and the bulk copy cannot take it whole: thread 0 copies the
// 16-byte-aligned span from the 16-byte boundary at or below the row's
// start to the one at or below its end, and reads the last 8 bytes beyond
// that (when the end is not aligned) with an ordinary load, which it
// stores to shared memory before a second arrival on the row's barrier.
// The span never passes the row's end, so the last row of the last board
// is read in bounds; it may begin 8 bytes before the row (inside the row
// before it), and the row is read from shared memory at that offset.
//
// Exactness.  Every float operation is written with a round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in the JAX
// search's association, so nvcc contracts nothing into an FMA and u has the
// bits PyTorch's elementwise ops give; ties go to the lowest index as
// torch.argmax's do (NaN above every number, as there).
//
// What bounds it on this card.  A level needs three edge lanes of one node
// row (3 * 409 floats at A = 409), the node's scalars and one child pointer:
// at B = 1024 boards and 1.6 levels a board some 9 MB per launch, 2.7 us at
// 3.35 TB/s, so bytes bound it there.  Per board the levels are a chain (a
// level's row address comes from the level before), so each level costs
// one bulk copy's latency plus the block's scoring and reduction, and below
// a few hundred boards that chain bounds it instead.  The copy reads the
// whole row, a third more bytes than the bound counts, because the CHILD
// lane comes whole in place of one word: the chosen edge's child pointer is
// then read from shared memory; loading that word from device memory after
// the argmax would cost a second dependent round trip per level.
//
// Design.  One block of four warps (128 threads) per board, grid B: at
// B = 1024 all boards are resident at once (~8 blocks, ~31 warps per SM).
// Per level, thread 0 arms an mbarrier with the row's byte count and issues
// one TMA bulk copy (cp.async.bulk) of the whole node row, 16 * C bytes
// (6,576 at A = 409), into shared memory; every thread waits on the
// barrier's phase parity.  The row's byte offset, (b * M + node) * 16 * C,
// is a multiple of 16, as the bulk copy needs, whenever stats is 16-byte
// aligned (the wrapper checks).  The root's copy is issued before the
// block's first barrier, each later one as soon as the level's pick is
// known; beside it every thread loads the node's visit count and value
// sum (the same round trip) and computes their square roots and division
// while the copy is in flight.  A thread reads the priors of the columns tid, tid + 128, ...;
// the warp lists its valid columns (ballots), and a lane scores each
// listed column, so the slow paths (two IEEE divisions for a visited edge,
// a square root for forced playouts at the root) run once per 32 valid
// columns of a warp, not once per column slot in which any lane has one.
// A score becomes an unsigned key in torch.argmax's order (NaN first, then
// the value); each warp reduces (key, column) pairs with two warp-wide
// reductions (__reduce_max_sync, then __reduce_min_sync of the column among
// the lanes holding the largest key: the lower column among equal keys)
// and the first forced column with a third; lane 0 writes the warp's
// winner to shared memory, and after one __syncthreads every thread
// combines the four winners in the same order, so all threads agree on the
// pick and the next node.  Rows, barriers and winners come in two sets
// used on alternate levels: the copy for level L + 1 is issued after level
// L's __syncthreads, which every thread reaches only once it is done
// reading level L - 1's row and winners, so no copy overwrites a row still
// being read and no proxy fence is needed.  A board runs until it stops: no
// level bound from the host and no host sync.  Offsets into stats are
// 64-bit (a reused tree reaches 1.57 GiB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kPValid = 0;
constexpr int kChild = 1;
constexpr int kEN = 2;
constexpr int kEW = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarp * kWarps;
constexpr int kPer = 4;                      // columns a thread scans per tile
constexpr int kTile = kThreads * kPer;       // 512 columns
constexpr int kList = kWarp * kPer;          // a warp's columns in a tile
constexpr float kEps = 1e-8f;
// shared memory per block: two node rows (2 * 16 * C bytes), then two
// mbarriers, two sets of the warps' winners (key, column, first forced
// column) and one column list per warp; ops/descent.py::smem_bytes gives
// the same count
constexpr int kTailBytes = 2 * 8 + 2 * kWarps * 3 * 4 + kWarps * kList * 4;
constexpr int kMaxSmem = 232448;             // what a block may use (227 KB)
constexpr int kDefaultSmem = 48 * 1024;      // usable without opting in
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Bytes of shared memory one node row takes: a float32 row is copied
// whole (16 * C bytes), a bf16 row as up to 8 * C + 8 bytes from the
// 16-byte boundary at or below its start.
template <typename T>
__host__ __device__ constexpr int row_buf_bytes(int C) {
  return sizeof(T) == 4 ? 16 * C : (8 * C + 8 + 15) / 16 * 16;
}

// torch.argmax's order on floats as an unsigned key, the pick being the
// largest: NaN above every number, then the larger value, -0.0 equal to
// 0.0 (ties go to the lower column, which the callers keep); every value,
// -inf included, keys above 0.
__device__ __forceinline__ unsigned order_key(float u) {
  const unsigned bits = __float_as_uint(__fadd_rn(u, 0.0f));  // -0.0 -> 0.0
  const unsigned key =
      bits ^ (static_cast<unsigned>(static_cast<int>(bits) >> 31) |
              0x80000000u);
  return isnan(u) ? 0xffffffffu : key;
}

constexpr unsigned kKeyNegInf = 0x007fffffu;   // order_key(-inf)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// thread 0: expect `bytes` on `bar` and copy them from src to dst (TMA)
__device__ __forceinline__ void bulk_copy_row(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// mbarrier arrivals per row copy: the bulk copy's, and for bf16 rows a
// second one once the row's unaligned last 8 bytes are in shared memory
template <typename T>
constexpr unsigned kArrivals = sizeof(T) == 4 ? 1u : 2u;

// thread 0: the node row `src` (4 * C elements) on its way to the row
// buffer `buf` (16-byte aligned), completing on `bar`
__device__ __forceinline__ void start_row_copy(unsigned char* buf,
                                               const float* src, int C,
                                               uint32_t bar) {
  bulk_copy_row(smem_addr(buf), src, static_cast<uint32_t>(16 * C), bar);
}

__device__ __forceinline__ void start_row_copy(unsigned char* buf,
                                               const __nv_bfloat16* src,
                                               int C, uint32_t bar) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = s + 8 * static_cast<uintptr_t>(C);
  const uintptr_t s16 = s & ~static_cast<uintptr_t>(15);
  const uintptr_t e16 = e & ~static_cast<uintptr_t>(15);
  bulk_copy_row(smem_addr(buf), reinterpret_cast<const void*>(s16),
                static_cast<uint32_t>(e16 - s16), bar);
  if (e16 != e)
    *reinterpret_cast<uint2*>(buf + (e16 - s16)) =
        __ldg(reinterpret_cast<const uint2*>(e16));
  // release: the tail's store is seen by every thread that waits on bar
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// where the row start_row_copy copied to `buf` begins in shared memory
template <typename T>
__device__ __forceinline__ const T* row_in(const unsigned char* buf,
                                           const T* src) {
  return reinterpret_cast<const T*>(
      buf + (sizeof(T) == 4 ? 0 : reinterpret_cast<uintptr_t>(src) & 15));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Appends this lane's column c to the warp's list where `take`; every lane
// of the warp calls it.  Returns the list's new length.
__device__ __forceinline__ unsigned list_push(int* list, unsigned n, bool take,
                                              int c, int lane) {
  const unsigned m = __ballot_sync(kFull, take);
  if (take) list[n + __popc(m & ((1u << lane) - 1u))] = c;
  return n + __popc(m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
descent_kernel(const T* __restrict__ stats, int M, int C, int depth_cap,
               float cpuct, float fpu, int fpu_from_parent, int forced,
               float k_forced, float sim_f, long long* __restrict__ out64,
               int B, int* __restrict__ depth_out, int* __restrict__ paths) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int A = C - 2;
  const long long node_stride = 4LL * C;
  const int row_buf = row_buf_bytes<T>(C);
  unsigned char* rows = smem;                              // [2][row_buf]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * row_buf);
  unsigned* win_h = reinterpret_cast<unsigned*>(bars + 2); // [2][kWarps]
  int* win_c = reinterpret_cast<int*>(win_h + 2 * kWarps); // [2][kWarps]
  int* win_f = win_c + 2 * kWarps;                         // [2][kWarps]
  int* list = win_f + 2 * kWarps + warp * kList;           // this warp's

  const T* board = stats + static_cast<long long>(b) * M * node_stride;
  const long long plane = static_cast<long long>(B) * depth_cap;
  int* pp = paths + static_cast<long long>(b) * depth_cap;
  int* pa = pp + plane;
  int* pr = pa + plane;

  if (tid == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_addr(bars + k)), "r"(kArrivals<T>) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the root's row is on its way while the block meets
    if (depth_cap > 0) start_row_copy(rows, board, C, smem_addr(bars));
  }
  __syncthreads();

  // the node's visit count and value sum, loaded beside the row's copy
  float ns = 0.0f, ws = 0.0f;
  if (depth_cap > 0) {
    ns = to_f(__ldg(board + kEN * C + A));
    ws = to_f(__ldg(board + kEW * C + A));
  }
  const T* src = board;                      // the row being read
  long long node = 0, parent = 0, action = 0, existing = 0, prot = 0;
  int level = 0;
  while (level < depth_cap) {
    const int set = level & 1;
    const T* row = row_in(rows + set * row_buf, src);
    const float fpu_init =
        fpu_from_parent ? __fsub_rn(__fdiv_rn(ws, __fadd_rn(ns, 1.0f)), fpu)
                        : fpu;
    const float sq = __fsqrt_rn(ns);
    // from one visit on, ns + 1e-8 rounds to ns: one square root
    const float ns_eps = __fadd_rn(ns, kEps);
    const float sq_eps = ns_eps == ns ? sq : __fsqrt_rn(ns_eps);
    // the barrier of this set completes once per use: levels set, set + 2, ..
    wait_parity(smem_addr(bars + set), static_cast<uint32_t>(level >> 1) & 1u);
    const long long rot = static_cast<long long>(to_f(row[kChild * C + A]));
    const bool force_here = forced && node == 0;

    // Scores.  Only valid columns can win unless every u is -inf, and
    // then so is every column's and the pick is column 0.  So a thread
    // reads the priors of its columns (all loads first), the warp lists its
    // valid columns, and a lane scores each listed column: a warp runs the
    // slow paths (two divisions for a visited column, a square root for
    // forced playouts at the root) once per 32 valid columns of a tile, not
    // once per column of every lane.  A lane's listed columns rise, so
    // keeping its first best key keeps the lower column among equal keys.
    unsigned best_h = 0;
    int best_c = 0x7fffffff;
    int first_forced = A;
    for (int base = 0; base < A; base += kTile) {
      float pv[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int c = base + k * kThreads + tid;
        pv[k] = c < A ? to_f(row[kPValid * C + c]) : -1.0f;
      }
      unsigned n = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        n = list_push(list, n, pv[k] >= 0.0f, base + k * kThreads + tid,
                      lane);
      __syncwarp();
      for (unsigned j = lane; j < n; j += kWarp) {
        const int c = list[j];
        const float p = to_f(row[kPValid * C + c]);
        const float e = to_f(row[kEN * C + c]);
        const float cp = __fmul_rn(cpuct, p);
        float u;
        if (e > 0.0f) {
          const float q = __fdiv_rn(to_f(row[kEW * C + c]), fmaxf(e, 1.0f));
          u = __fadd_rn(q, __fdiv_rn(__fmul_rn(cp, sq), __fadd_rn(1.0f, e)));
        } else {
          u = __fadd_rn(fpu_init, __fmul_rn(cp, sq_eps));
        }
        const unsigned h = order_key(u);
        if (h > best_h) {
          best_h = h;
          best_c = c;
        }
        if (force_here) {
          const float th = floorf(__fsqrt_rn(
              __fmul_rn(__fmul_rn(k_forced, p), sim_f)));
          if (e < th) first_forced = min(first_forced, c);
        }
      }
      __syncwarp();
    }
    // the warp's pick, then the block's: every thread reduces the four
    // winners in the same order and agrees on the pick
    const unsigned wh = __reduce_max_sync(kFull, best_h);
    const int wc = __reduce_min_sync(kFull, best_h == wh ? best_c : 0x7fffffff);
    first_forced = __reduce_min_sync(kFull, first_forced);
    if (lane == 0) {
      win_h[set * kWarps + warp] = wh;
      win_c[set * kWarps + warp] = wc;
      win_f[set * kWarps + warp] = first_forced;
    }
    __syncthreads();
    best_h = win_h[set * kWarps];
    best_c = win_c[set * kWarps];
    first_forced = win_f[set * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const unsigned h = win_h[set * kWarps + w];
      const int c = win_c[set * kWarps + w];
      if (h > best_h || (h == best_h && c < best_c)) {
        best_h = h;
        best_c = c;
      }
      first_forced = min(first_forced, win_f[set * kWarps + w]);
    }
    const int a = first_forced < A      ? first_forced
                  : best_h > kKeyNegInf ? best_c
                                        : 0;
    const float child_raw = to_f(row[kChild * C + a]);
    const long long child = static_cast<long long>(fabsf(child_raw));
    const bool stop = child == 0 || child_raw < 0.0f || level + 1 >= depth_cap;
    // the next level's row is on its way before this level's records
    if (!stop) src = board + child * node_stride;
    if (tid == 0 && !stop)
      start_row_copy(rows + (set ^ 1) * row_buf, src, C,
                     smem_addr(bars + (set ^ 1)));
    if (!stop) {
      ns = to_f(__ldg(src + kEN * C + A));
      ws = to_f(__ldg(src + kEW * C + A));
    }
    if (tid == 0) {
      pp[level] = static_cast<int>(node);
      pa[level] = a;
      pr[level] = static_cast<int>(rot);
    }
    parent = node;
    action = a;
    existing = child;
    prot = rot;
    ++level;
    if (stop) break;
    node = child;
  }
  for (int l = level + tid; l < depth_cap; l += kThreads) {
    pp[l] = M;
    pa[l] = 0;
    pr[l] = 0;
  }
  if (tid == 0) {
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
// smem_bytes is ops/descent.py::smem_bytes(C, element size); stats must be
// 16-byte aligned.  Returns the CUDA error code (cudaErrorInvalidValue
// where smem_bytes is not what the kernel lays out or exceeds a block's
// share).
template <typename T>
static int launch(const T* stats, int B, int M, int C, int depth_cap,
                  float cpuct, float fpu, int fpu_from_parent, int forced,
                  float k_forced, float sim_f, long long* out64, int* depth,
                  int* paths, int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  if (C < 3 || smem_bytes != 2 * row_buf_bytes<T>(C) + kTailBytes ||
      smem_bytes > kMaxSmem || reinterpret_cast<uintptr_t>(stats) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > kDefaultSmem) {
    // opt in once per device, to the most a block may use
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || !opted_in[dev]) {
      err = cudaFuncSetAttribute(descent_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
  }
  descent_kernel<T><<<B, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      stats, M, C, depth_cap, cpuct, fpu, fpu_from_parent, forced, k_forced,
      sim_f, out64, B, depth, paths);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int descent_launch(const float* stats, int B, int M, int C,
                              int depth_cap, float cpuct, float fpu,
                              int fpu_from_parent, int forced, float k_forced,
                              float sim_f, long long* out64, int* depth,
                              int* paths, int smem_bytes, void* stream) {
  return launch(stats, B, M, C, depth_cap, cpuct, fpu, fpu_from_parent,
                forced, k_forced, sim_f, out64, depth, paths, smem_bytes,
                stream);
}

// the same on bfloat16 stats
extern "C" int descent_bf16_launch(const void* stats, int B, int M, int C,
                                   int depth_cap, float cpuct, float fpu,
                                   int fpu_from_parent, int forced,
                                   float k_forced, float sim_f,
                                   long long* out64, int* depth, int* paths,
                                   int smem_bytes, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(stats), B, M, C, depth_cap,
                cpuct, fpu, fpu_from_parent, forced, k_forced, sim_f, out64,
                depth, paths, smem_bytes, stream);
}
