// Fused MCTS backup for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel alphazero_tpu/ops/fused_backup.py::fused_backup
// (body _kernel) and takes over the packed-layout update that the JAX main
// path runs in XLA, alphazero_tpu/search/mcts.py::_backprop_fused.  stats is
// [B, M, 4, C] float32 with lanes PVALID, CHILD, EN, EW, updated in place.
// Three contracts, two kernels:
//
// fused_backup_operand_kernel (operands built by the caller), for board b:
//   for each level s with path_p[b,s] < M (M is the drop sentinel):
//       stats[b, p, EN, a] += w[b,s,0];  stats[b, p, EW, a] += w[b,s,1]
//       and, with node_col >= 0, the same at column node_col
//   if child_v[b] != 0:  stats[b, child_p[b], CHILD, child_a[b]] += child_v[b]
//   stats[b, slot[b], lanes, :] += row[b]   (row_lanes == 1: lane PVALID only;
//                                            row_lanes == 4: all four lanes)
//   * split contract (the Pallas kernel's): C = A, node_col = -1, 1-lane row;
//   * packed operand contract: C = A + 2, node_col = A, 4-lane row.
//
// fused_backup_entry_kernel (the arguments of _backprop_fused; C = A + 2):
//   level l < depth[b] is live, with weights (1, value_vec[b, (path_r[b,l] -
//   leaf_rot[b]) mod P]) at columns path_a[b,l] and A; a fresh edge gets the
//   pointer +slot, or -slot when the child is terminal; row slot receives
//   pvalid_new[b] + 1 in lane PVALID and the node scalars in columns A and
//   A + 1 (terminal flag, rotation, initial value; term_vec in lanes 0..P-1).
//   It builds in registers what the operand contract is handed as tensors
//   and touches only the elements that receive a term.  Given a counter
//   (a profiler records), each board adds min(depth, S1) + (installs << 32)
//   to it with one atomicAdd: the search's live path levels and child
//   installs, which the descent's and the backup's byte counts need.
//
// What bounds each contract on this card (B = 1024, C = 411): the packed
// operand contract moves about 20 MB per launch, nearly all of it the
// four-lane row (read) and the slot row (read and written), so bytes at
// 3.35 TB/s bound it; the split contract moves the one-lane row, a quarter of
// that; the entry reads pvalid_new and updates one lane of the slot row,
// about 5 MB, and there the chain of dependent round trips to device memory
// (indices, then elements) and the launch take longer than the bytes.
//
// Design.  A block of four warps owns a board, so no two blocks touch the
// same element.  Its first warp walks the path and installs the child; the
// other three add the slot's row.  The two jobs share no registers, so the
// kernel fits 64 a thread and all 1024 boards of a search are resident at
// once, and the walker's few loads are not queued behind its own row's.
//  * Path walk.  The lanes read 32 levels at once, coalesced; each live level
//    belongs to its lane, which starts all of its loads before its first
//    store.  Where a node p repeats among the live levels, the first lane of
//    each (p, a) pair sums the pair's weights in registers in level order,
//    and the first lane of each p does so for the node column, so the stored
//    bits equal those of a level-by-level walk.  Later chunks of 32 levels
//    follow in order, each after a __syncwarp(), their nodes read one chunk
//    ahead.
//  * Overlap.  The slot row and the child install run beside the path walk,
//    with no barrier.  They touch other elements than the path except where
//    a live p or the child's parent equals slot (and the row has four lanes,
//    or, in the entry, node columns); every warp detects that from the same
//    indices, and then the block adds in the order path, child, row.
//  * 16-byte accesses.  Every node row starts on a 16-byte boundary (its
//    stride is 4 * C floats), so the slot row moves as float4; a source that
//    is not aligned (the one-lane row when C % 4 != 0) is read as scalars.
//    A row thread reads its share of the source at the kernel's start and
//    holds it in registers until the slot is known (a row wider than the
//    registers take goes on part by part).  The row is added with
//    red.global.add (its .v4.f32 form), which does not wait for a read of
//    stats; each element receives one add, so the sum is the one a load,
//    add and store would give.
//  * The entry reads the first eight levels before it knows the depth: they
//    share one 32-byte sector per array, and a search's paths rarely go
//    deeper, so indices and per-board scalars arrive in one round trip and
//    the elements in a second.
//  * Grid: B blocks of 128 threads, eight to an SM: all resident at once at
//    B = 1024, and one block to an SM at self-play's B = 64.
// Float32 throughout (the Pallas kernel used a bf16 one-hot matmul), so the
// result equals the plain version's bit for bit.
//
// bfloat16 stats (MCTSConfig.stats_dtype = "bfloat16") take the entry only:
// fused_backup_entry_kernel is a template on the stats element type, and the
// operand contract and the split stay float32, as the Pallas kernel is.
// The JAX update on bf16 stats is stats + bf16(delta) + bf16(row_add), where
// delta is one element's float32 sum over levels (and the two halves of the
// child pointer), each addend rounded to bf16 before its add and each add
// rounded to bf16 (the row's after the path's where they meet).  So the bf16
// walker sums an element's levels in float32 in level order, from 0, rounds
// the sum to bf16 (nearest even) and then adds it to the old value with one
// more rounding; the child pointer and each node scalar are one addend
// each.  The prior row's lane PVALID receives bf16(p + 1) by
// red.global.add.noftz.bf16x2 (pairs of columns; a row starts 8-byte
// aligned, so a pair is 4-byte aligned), and a lone last column by the
// bf16 form: the add rounds to nearest even, as the JAX add does, and an
// element receives no other add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPValid = 0;
constexpr int kChild = 1;
constexpr int kEN = 2;
constexpr int kEW = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;    // a block: four warps, one board
constexpr int kRowThreads = kThreads - 32;   // all but the first warp
constexpr int kBlocksPerSM = 8;  // 1024 boards resident on 132 SMs: 64 registers
constexpr int kOperandBatch = 5; // float4 a row thread holds of a row [4, C]
constexpr int kEntryBatch = 2;   // ... and of pvalid_new [A]
constexpr int kBatch = 4;        // ... and has in flight in what lies beyond
constexpr int kBf16Pairs = 3;    // bf16 column pairs a row thread has in flight
constexpr int kSpecLevels = 8;   // levels the entry reads before it knows the depth
constexpr int kChildLane = 23;   // the entry's lane for the child install
constexpr int kNodeLane0 = 24;   // the entry's lanes 24..31 add the node scalars

// How an element of stats takes its adds.  A float32 element sums its
// addends onto the old value one by one.  A bf16 element sums them in
// float32 from 0, then adds bf16(sum) to the old value, rounding to bf16.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ float start(float old) { return old; }
  static __device__ __forceinline__ void put(float* p, float, float sum) {
    *p = sum;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float start(float) { return 0.0f; }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float old,
                                             float sum) {
    *p = __float2bfloat16_rn(
        __fadd_rn(old, __bfloat162float(__float2bfloat16_rn(sum))));
  }
};

// *p receives one addend x
template <typename T>
__device__ __forceinline__ void add_one(T* p, float x) {
  const float old = Elem<T>::get(p);
  Elem<T>::put(p, old, Elem<T>::start(old) + x);
}

// Up to 32 levels of one board's path, one per lane.
template <typename T>
struct Levels {
  T* r;                            // the level's node row
  int p, a;                        // p = -1 where the lane holds no live level
  float w_en, w_ew;
  float o_en_a, o_ew_a, o_en_n, o_ew_n;  // old values
  float en_a, ew_a, en_n, ew_n;    // the sums to store
};

template <typename T>
__device__ __forceinline__ void levels_load(Levels<T>& L, T* sb,
                                            size_t node_stride, int C,
                                            int node_col) {
  L.o_en_a = L.o_ew_a = L.o_en_n = L.o_ew_n = 0.0f;
  L.en_a = L.ew_a = L.en_n = L.ew_n = 0.0f;
  L.r = sb;
  if (L.p < 0) return;
  L.r = sb + L.p * node_stride;
  L.o_en_a = Elem<T>::get(L.r + kEN * C + L.a);
  L.o_ew_a = Elem<T>::get(L.r + kEW * C + L.a);
  if (node_col >= 0) {
    L.o_en_n = Elem<T>::get(L.r + kEN * C + node_col);
    L.o_ew_n = Elem<T>::get(L.r + kEW * C + node_col);
  }
  L.en_a = Elem<T>::start(L.o_en_a);
  L.ew_a = Elem<T>::start(L.o_ew_a);
  L.en_n = Elem<T>::start(L.o_en_n);
  L.ew_n = Elem<T>::start(L.o_ew_n);
}

// Adds the weights to what levels_load read: each live lane that owns an
// element (the first lane of its (p, a), and of its p for the node column)
// sums the chunk's levels of that element in level order.  All 32 lanes
// call it together.
template <typename T>
__device__ __forceinline__ void levels_sum(Levels<T>& L, int lane,
                                           bool& own_edge, bool& own_node) {
  const bool live = L.p >= 0;
  own_edge = own_node = live;
  const unsigned live_mask = __ballot_sync(kFull, live);
  if (live_mask == 0) return;
  // lanes of equal p; a lane without a level gets a key of its own
  const unsigned same_p = __match_any_sync(kFull, live ? L.p : ~lane);
  if (!__any_sync(kFull, same_p != (1u << lane))) {
    L.en_a += L.w_en;
    L.ew_a += L.w_ew;
    L.en_n += L.w_en;
    L.ew_n += L.w_ew;
  } else {
    const unsigned long long key =
        live ? (static_cast<unsigned long long>(L.p) << 32) |
                   static_cast<unsigned>(L.a)
             : ~static_cast<unsigned long long>(lane);
    const unsigned same_pa = __match_any_sync(kFull, key);
    own_node = live && lane == __ffs(same_p) - 1;
    own_edge = live && lane == __ffs(same_pa) - 1;
    for (unsigned m = live_mask; m; m &= m - 1) {      // level order
      const int j = __ffs(m) - 1;
      const int pj = __shfl_sync(kFull, L.p, j);
      const int aj = __shfl_sync(kFull, L.a, j);
      const float en = __shfl_sync(kFull, L.w_en, j);
      const float ew = __shfl_sync(kFull, L.w_ew, j);
      if (pj == L.p) {
        L.en_n += en;
        L.ew_n += ew;
        if (aj == L.a) {
          L.en_a += en;
          L.ew_a += ew;
        }
      }
    }
  }
}

// Stores the owned sums.
template <typename T>
__device__ __forceinline__ void levels_put(const Levels<T>& L, int C,
                                           int node_col, bool own_edge,
                                           bool own_node) {
  if (own_edge) {
    Elem<T>::put(L.r + kEN * C + L.a, L.o_en_a, L.en_a);
    Elem<T>::put(L.r + kEW * C + L.a, L.o_ew_a, L.ew_a);
  }
  if (own_node && node_col >= 0) {
    Elem<T>::put(L.r + kEN * C + node_col, L.o_en_n, L.en_n);
    Elem<T>::put(L.r + kEW * C + node_col, L.o_ew_n, L.ew_n);
  }
}

template <typename T>
__device__ __forceinline__ void levels_store(Levels<T>& L, int C,
                                             int node_col, int lane) {
  bool own_edge, own_node;
  levels_sum(L, lane, own_edge, own_node);
  levels_put(L, C, node_col, own_edge, own_node);
}

// A bf16 element takes one rounded sum of all its levels, so on a path of
// more than one chunk of 32 levels the owner of an element is its first
// level on the whole path: a live lane of the chunk from `base` gives up
// what an earlier chunk holds and adds what later chunks hold, in level
// order, reading their levels from device memory (paths that long occur
// only on made-up inputs: a fresh bf16 tree has no repeats).  `vals` is
// value_vec[b] (P <= 4 lanes).
__device__ __forceinline__ void cross_chunks(
    Levels<__nv_bfloat16>& L, const int* __restrict__ pp,
    const int* __restrict__ pa, const int* __restrict__ pr, int lr, int P,
    const float* vals, int base, int d, bool& own_edge, bool& own_node) {
  if (L.p < 0) return;
  for (int k = 0; k < base; ++k) {
    if (pp[k] == L.p) {
      own_node = false;
      if (pa[k] == L.a) own_edge = false;
    }
  }
  for (int k = base + 32; k < d && (own_edge || own_node); ++k) {
    if (pp[k] != L.p) continue;
    int m = (pr[k] - lr) % P;
    if (m < 0) m += P;
    const float v = vals[m];
    if (own_node) {
      L.en_n += 1.0f;
      L.ew_n += v;
    }
    if (own_edge && pa[k] == L.a) {
      L.en_a += 1.0f;
      L.ew_a += v;
    }
  }
}

__device__ __forceinline__ float4 load4(const float* __restrict__ src, int j,
                                        bool aligned, float bias) {
  float4 v;
  if (aligned) {
    v = __ldg(reinterpret_cast<const float4*>(src) + j);
  } else {
    v.x = __ldg(src + 4 * j);
    v.y = __ldg(src + 4 * j + 1);
    v.z = __ldg(src + 4 * j + 2);
    v.w = __ldg(src + 4 * j + 3);
  }
  v.x += bias;
  v.y += bias;
  v.z += bias;
  v.w += bias;
  return v;
}

// The row threads' (rid = 0 .. kRowThreads - 1) share of a row add, dst[0..n)
// += src[0..n) + bias with dst 16-byte aligned, for kRowThreads * kN float4
// from float4 `begin` on (and, with begin == 0, the row's last n % 4 floats).
// In two steps, so that the source can be on its way before the destination
// is known: load() reads the source into registers, add() adds them.
template <int kN>
struct RowPart {
  float4 v[kN];
  float tail;

  __device__ __forceinline__ void load(const float* __restrict__ src, int n,
                                       float bias, int rid, int begin) {
    const bool aligned = (reinterpret_cast<size_t>(src) & 15) == 0;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int j = begin + rid + kRowThreads * k;
      if (j < (n >> 2)) v[k] = load4(src, j, aligned, bias);
    }
    const int t = (n & ~3) + rid;
    if (begin == 0 && t < n) tail = __ldg(src + t) + bias;
  }

  // atomicAdd with its result unused compiles to red.global.add
  __device__ __forceinline__ void add(float* dst, int n, int rid,
                                      int begin) const {
    const int n4 = n >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int j = begin + rid + kRowThreads * k;
      if (j < n4) atomicAdd(dst4 + j, v[k]);
    }
    const int t = 4 * n4 + rid;
    if (begin == 0 && t < n) atomicAdd(dst + t, tail);
  }
};

// The row add from float4 `begin` on, part by part.
__device__ __forceinline__ void add_row(float* dst,
                                        const float* __restrict__ src, int n,
                                        float bias, int rid, int begin) {
  for (int j = begin; j < max(n >> 2, 1); j += kRowThreads * kBatch) {
    RowPart<kBatch> part;
    part.load(src, n, bias, rid, j);
    part.add(dst, n, rid, j);
  }
}

__device__ __forceinline__ void red_add_bf16x2(__nv_bfloat16* p, float lo,
                                               float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo at p
  asm volatile("red.global.add.noftz.bf16x2 [%0], %1;\n"
               :: "l"(__cvta_generic_to_global(p)),
                  "r"(*reinterpret_cast<const unsigned*>(&v))
               : "memory");
}

__device__ __forceinline__ void red_add_bf16(__nv_bfloat16* p, float x) {
  const __nv_bfloat16 v = __float2bfloat16_rn(x);
  asm volatile("red.global.add.noftz.bf16 [%0], %1;\n"
               :: "l"(__cvta_generic_to_global(p)),
                  "h"(*reinterpret_cast<const unsigned short*>(&v))
               : "memory");
}

// The row threads' share of the bf16 prior row: dst[c] += bf16(src[c] + 1)
// for c < A, the columns in pairs (dst is 4-byte aligned), kN pairs a
// thread in flight.
template <int kN>
__device__ __forceinline__ void add_prior_row_bf16(
    __nv_bfloat16* dst, const float* __restrict__ src, int A, int rid) {
  const int np = A >> 1;
  for (int j0 = rid; j0 < np; j0 += kRowThreads * kN) {
    float2 v[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int j = j0 + kRowThreads * k;
      if (j < np) {
        v[k].x = __ldg(src + 2 * j) + 1.0f;
        v[k].y = __ldg(src + 2 * j + 1) + 1.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int j = j0 + kRowThreads * k;
      if (j < np) red_add_bf16x2(dst + 2 * j, v[k].x, v[k].y);
    }
  }
  if ((A & 1) && rid == 0) red_add_bf16(dst + A - 1, __ldg(src + A - 1) + 1.0f);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_backup_operand_kernel(
    float* stats, int M, int C, int node_col, const int* __restrict__ path_p,
    const int* __restrict__ path_a, const float* __restrict__ w, int S1,
    const int* __restrict__ child_p, const int* __restrict__ child_a,
    const float* __restrict__ child_v, const float* __restrict__ row,
    int row_lanes, const int* __restrict__ slot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool walker = tid < 32;
  const int b = blockIdx.x;
  const size_t node_stride = static_cast<size_t>(4) * C;
  float* sb = stats + static_cast<size_t>(b) * M * node_stride;
  const int* pp = path_p + static_cast<size_t>(b) * S1;
  const float* src = row + static_cast<size_t>(b) * row_lanes * C;
  const int n = row_lanes * C;

  // one round trip: the row, the per-board scalars and the first 32 levels
  RowPart<kOperandBatch> R;
  if (!walker) R.load(src, n, 0.0f, tid - 32, 0);
  const int* pa = path_a + static_cast<size_t>(b) * S1;
  const float2* pw = reinterpret_cast<const float2*>(w) +
                     static_cast<size_t>(b) * S1;
  const int sl = slot[b];
  const float cv = child_v[b];
  const int cp = child_p[b];
  const int ca = child_a[b];
  int next_p = lane < S1 ? pp[lane] : M;
  int a0 = 0;
  float2 w0 = make_float2(0.0f, 0.0f);
  if (walker && lane < S1) {
    a0 = pa[lane];
    w0 = pw[lane];
  }
  float* dst = sb + sl * node_stride;          // lane PVALID comes first
  // Only a four-lane row shares elements with the path (a live p == slot)
  // or the child (its parent == slot); then the order path, child, row
  // holds.  Every warp finds that out for itself, from the same indices.
  bool ordered = false;
  if (row_lanes == 4) {
    bool hit = next_p == sl || (cv != 0.0f && cp == sl);
    for (int l = 32 + lane; l < S1; l += 32) hit |= pp[l] == sl;
    ordered = __any_sync(kFull, hit);
  }

  if (!walker) {
    if (!ordered) {
      R.add(dst, n, tid - 32, 0);
      add_row(dst, src, n, 0.0f, tid - 32,
              kRowThreads * kOperandBatch);    // a row wider than R
    }
  } else {
    Levels<float> L;
    for (int base = 0; base < S1; base += 32) {
      const int l = base + lane;
      L.p = next_p;               // read one chunk ahead
      next_p = l + 32 < S1 ? pp[l + 32] : M;
      if (static_cast<unsigned>(L.p) >= static_cast<unsigned>(M)) L.p = -1;
      if (base > 0 && !__any_sync(kFull, L.p >= 0)) continue;
      L.a = a0;
      L.w_en = w0.x;
      L.w_ew = w0.y;
      if (base > 0 && L.p >= 0) {
        L.a = pa[l];
        const float2 wl = pw[l];
        L.w_en = wl.x;
        L.w_ew = wl.y;
      }
      __syncwarp();               // the chunk before has stored
      levels_load(L, sb, node_stride, C, node_col);
      float* ce = nullptr;
      float child_old = 0.0f;
      if (base == 0 && lane == 0 && cv != 0.0f) {
        ce = sb + cp * node_stride + kChild * C + ca;
        child_old = *ce;
      }
      levels_store(L, C, node_col, lane);
      if (ce != nullptr) *ce = child_old + cv;
    }
  }
  if (ordered) {
    __syncthreads();              // the path and the child have stored
    if (!walker) add_row(dst, src, n, 0.0f, tid - 32, 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_backup_entry_kernel(
    T* stats, int M, int C, int P, const int* __restrict__ path_p,
    const int* __restrict__ path_a, const int* __restrict__ path_r, int S1,
    const int* __restrict__ depth, const float* __restrict__ value_vec,
    const long long* __restrict__ leaf_rot,
    const long long* __restrict__ parent, const long long* __restrict__ action,
    const unsigned char* __restrict__ fresh, const int* __restrict__ slot,
    const float* __restrict__ pvalid_new,
    const unsigned char* __restrict__ child_term,
    const long long* __restrict__ child_rot,
    const float* __restrict__ leaf_init_v, long long leaf_init_stride,
    const float* __restrict__ term_vec, unsigned long long* counter) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  const int A = C - 2;
  const size_t node_stride = static_cast<size_t>(4) * C;
  T* sb = stats + static_cast<size_t>(b) * M * node_stride;

  if (tid >= 32) {
    // The slot row's lane PVALID needs nothing of the path and shares no
    // element with it.
    const float* src = pvalid_new + static_cast<size_t>(b) * A;
    if constexpr (sizeof(T) == 2) {
      add_prior_row_bf16<kBf16Pairs>(sb + slot[b] * node_stride, src, A,
                                     tid - 32);
    } else {
      RowPart<kEntryBatch> R;
      R.load(src, A, 1.0f, tid - 32, 0);
      float* dst = sb + slot[b] * node_stride;
      R.add(dst, A, tid - 32, 0);
      add_row(dst, src, A, 1.0f, tid - 32,
              kRowThreads * kEntryBatch);      // a row wider than R
    }
    return;
  }

  // one round trip: what depends on b alone, and the first levels
  const int* pp = path_p + static_cast<size_t>(b) * S1;
  const int* pa = path_a + static_cast<size_t>(b) * S1;
  const int* pr = path_r + static_cast<size_t>(b) * S1;
  const int sl = slot[b];
  T* dst = sb + sl * node_stride;
  const int d = min(depth[b], S1);
  const int lr = static_cast<int>(leaf_rot[b]);
  const bool fr = fresh[b] != 0;
  const bool ct = child_term[b] != 0;
  const float vv = lane < P ? value_vec[static_cast<size_t>(b) * P + lane]
                            : 0.0f;
  float vals[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // value_vec[b], for bf16
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) vals[k] = __shfl_sync(kFull, vv, k);
  }
  // the node scalars of row slot: lanes 24..27 hold column A of stats lanes
  // 0..3, lanes 28..31 column A + 1; a zero term is left out
  const int t = lane - kNodeLane0;
  float node_term = 0.0f;
  bool has_node_term = false;
  if (t == kPValid) {
    node_term = ct ? 1.0f : 0.0f;
    has_node_term = true;
  } else if (t == kChild) {
    node_term = static_cast<float>(child_rot[b]);
    has_node_term = true;
  } else if (t == kEW) {
    node_term = leaf_init_v[static_cast<long long>(b) * leaf_init_stride];
    has_node_term = true;
  } else if (t >= 4 && t - 4 < P) {
    node_term = term_vec[static_cast<size_t>(b) * P + (t - 4)];
    has_node_term = true;
  }
  long long cpar = 0, cact = 0;
  if (lane == kChildLane) {
    cpar = parent[b];
    cact = action[b];
  }
  Levels<T> L;
  int r = 0;
  L.p = M;
  L.a = 0;
  if (lane < kSpecLevels && lane < S1) {
    L.p = pp[lane];
    L.a = pa[lane];
    r = pr[lane];
  }
  T* ne = nullptr;
  if (has_node_term) ne = dst + (t & 3) * C + A + (t >> 2);

  if (lane >= kSpecLevels && lane < d) {
    L.p = pp[lane];
    L.a = pa[lane];
    r = pr[lane];
  }
  if (lane >= d || static_cast<unsigned>(L.p) >= static_cast<unsigned>(M)) {
    L.p = -1;
    r = lr;
  }
  // A live p == slot shares the node column's EW element with the row.
  bool hit = L.p == sl;
  for (int l = 32 + lane; l < d; l += 32) hit |= pp[l] == sl;
  const bool ordered = __any_sync(kFull, hit);
  int m = (r - lr) % P;            // the mathematical modulo: C's % keeps
  if (m < 0) m += P;               // the sign of its left side
  L.w_en = 1.0f;
  L.w_ew = __shfl_sync(kFull, vv, m);
  levels_load(L, sb, node_stride, C, A);

  const float cv = fr ? (ct ? -static_cast<float>(sl) : static_cast<float>(sl))
                      : 0.0f;
  T* ce = nullptr;
  float child_old = 0.0f;
  if (lane == kChildLane && cv != 0.0f) {
    ce = sb + cpar * node_stride + kChild * C + cact;
    child_old = Elem<T>::get(ce);
  }
  float node_old = 0.0f;
  if (ne != nullptr && !ordered) node_old = Elem<T>::get(ne);

  bool own_edge, own_node;
  levels_sum(L, lane, own_edge, own_node);
  if constexpr (sizeof(T) == 2) {
    if (d > 32)
      cross_chunks(L, pp, pa, pr, lr, P, vals, 0, d, own_edge, own_node);
  }
  levels_put(L, C, A, own_edge, own_node);
  if (ce != nullptr)
    Elem<T>::put(ce, child_old, Elem<T>::start(child_old) + cv);
  if (ne != nullptr && !ordered)
    Elem<T>::put(ne, node_old, Elem<T>::start(node_old) + node_term);

  for (int base = 32; base < d; base += 32) {
    const int l = base + lane;
    L.p = l < d ? pp[l] : M;
    if (static_cast<unsigned>(L.p) >= static_cast<unsigned>(M)) L.p = -1;
    r = lr;
    L.a = 0;
    if (L.p >= 0) {
      L.a = pa[l];
      r = pr[l];
    }
    m = (r - lr) % P;
    if (m < 0) m += P;
    L.w_ew = __shfl_sync(kFull, vv, m);
    __syncwarp();                 // the chunk before has stored
    levels_load(L, sb, node_stride, C, A);
    levels_sum(L, lane, own_edge, own_node);
    if constexpr (sizeof(T) == 2)
      cross_chunks(L, pp, pa, pr, lr, P, vals, base, d, own_edge, own_node);
    levels_put(L, C, A, own_edge, own_node);
  }
  if (ordered) {
    __syncwarp();                 // the path has stored
    if (ne != nullptr) add_one(ne, node_term);
  }
  if (counter != nullptr && lane == 0)
    atomicAdd(counter, static_cast<unsigned long long>(max(d, 0)) |
                           (static_cast<unsigned long long>(cv != 0.0f) << 32));
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
  fused_backup_operand_kernel<<<B, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      stats, M, C, node_col, path_p, path_a, w, S1, child_p, child_a, child_v,
      row, row_lanes, slot);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int entry_launch(
    T* stats, int B, int M, int C, int P, const int* path_p,
    const int* path_a, const int* path_r, int S1, const int* depth,
    const float* value_vec, const long long* leaf_rot, const long long* parent,
    const long long* action, const unsigned char* fresh, const int* slot,
    const float* pvalid_new, const unsigned char* child_term,
    const long long* child_rot, const float* leaf_init_v,
    long long leaf_init_stride, const float* term_vec,
    unsigned long long* counter, void* stream) {
  if (B <= 0) return 0;
  fused_backup_entry_kernel<T><<<B, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      stats, M, C, P, path_p, path_a, path_r, S1, depth, value_vec, leaf_rot,
      parent, action, fresh, slot, pvalid_new, child_term, child_rot,
      leaf_init_v, leaf_init_stride, term_vec, counter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_backup_entry_launch(
    float* stats, int B, int M, int C, int P, const int* path_p,
    const int* path_a, const int* path_r, int S1, const int* depth,
    const float* value_vec, const long long* leaf_rot, const long long* parent,
    const long long* action, const unsigned char* fresh, const int* slot,
    const float* pvalid_new, const unsigned char* child_term,
    const long long* child_rot, const float* leaf_init_v,
    long long leaf_init_stride, const float* term_vec,
    unsigned long long* counter, void* stream) {
  return entry_launch(stats, B, M, C, P, path_p, path_a, path_r, S1, depth,
                      value_vec, leaf_rot, parent, action, fresh, slot,
                      pvalid_new, child_term, child_rot, leaf_init_v,
                      leaf_init_stride, term_vec, counter, stream);
}

// the entry on bfloat16 stats
extern "C" int fused_backup_entry_bf16_launch(
    void* stats, int B, int M, int C, int P, const int* path_p,
    const int* path_a, const int* path_r, int S1, const int* depth,
    const float* value_vec, const long long* leaf_rot, const long long* parent,
    const long long* action, const unsigned char* fresh, const int* slot,
    const float* pvalid_new, const unsigned char* child_term,
    const long long* child_rot, const float* leaf_init_v,
    long long leaf_init_stride, const float* term_vec,
    unsigned long long* counter, void* stream) {
  return entry_launch(static_cast<__nv_bfloat16*>(stats), B, M, C, P, path_p,
                      path_a, path_r, S1, depth, value_vec, leaf_rot, parent,
                      action, fresh, slot, pvalid_new, child_term, child_rot,
                      leaf_init_v, leaf_init_stride, term_vec, counter,
                      stream);
}
