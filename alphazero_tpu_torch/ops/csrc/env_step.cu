// In-tree transition of the batched search for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces alphazero_tpu/games/splendor/adapter.py::make_search_step_fn
// (lines 53-67), the JAX search's per-simulation transition: the
// deterministic env step from the canonical frame (env.py::step with chance
// collapsed), the seat swap (swap_players), the terminal vector
// (check_end_game with judge) and the valid-move mask of seat 0
// (valid_moves).  XLA computed it on the TPU; it was never a Pallas kernel.
// The port's plain version (ops/env_step.py::search_step_plain) computes
// every branch of every action kind for every board and picks with
// torch.where: hundreds of PyTorch launches per simulation.
//
// Inputs: states [B, R, 7] int8 (R = 56, 71, 88 rows at 2, 3, 4 players),
// actions [B] int64, and the packed action tables [2, 409] int32 that
// ops/env_step.py::pack_tables builds from tables.py (uploaded once per
// device):
//   step word  bits 0-2 kind, 3-6 param (a card or reserve slot),
//              7 + 2c .. 8 + 2c the gems of colour c taken;
//   mask word  bits 3c .. 3c + 2 the bank's minimum of colour c for the
//              take, 15 + 2c .. 16 + 2c the gems of colour c given back,
//              25-26 the exchange class, 27-28 the gems taken in all.
// Outputs, per board: the child [R, 7] int8 in the next seat's frame, the
// terminal vector [P] float32, the valid mask [409] bool and the seat
// advance (int64: 1, or 0 on a pending noble-select ply that keeps the
// turn): what the plain version returns.  The game's switches (players,
// token_limit, enable_reserve, enable_giveback, enable_noble_select,
// score_win) are kernel arguments.
//
// Exactness.  All arithmetic is int32 on a copy of the board, as the plain
// env's is; the child is stored with the int8 wrap (the round counter,
// column 6 of the bank row, passes 127 at 3 and 4 players; it is read back
// as uint8), and the terminal vector and the mask are computed from the
// wrapped, swapped child, as the plain version computes them from the int8
// tensor it stored.  The only floats are the judge's 1, -1 and 0.01f.  An
// action id of any kind is applied with its kind's branch alone, as
// lax.switch does, with its parameter clamped as the plain version clamps
// it, so every id of [0, 409), legal or not, gives the plain version's
// bytes.  An id outside [0, 409) (the plain version raises on it; not
// checked on the card) is applied as a pass: no table or row out of
// bounds is read.
//
// What bounds it on this card.  A board moves R * 7 bytes in and out, its
// action, its 409-byte mask, its terminal vector and its advance: 1,217
// bytes at 2 players, 1.25 MB at B = 1024, 0.37 us at 3.35 TB/s, under the
// device time of an empty kernel (~0.9 us).  So the launch and the chain of
// dependent shared-memory steps bound it, not bytes: the design keeps one
// launch per simulation and leaves the bytes alone.
//
// Design.  One warp per board, four boards per block.  Each lane first
// requests the table words of its 13 mask actions and of the board's
// action (none depends on the board, so these round trips overlap the
// board's); the warp copies the board into shared memory as int32 (lanes
// on consecutive bytes, all of a lane's loads issued before its first
// store); lane 0 applies the one branch of the action's
// kind (the branches are a few dozen row operations: the rest of the warp
// waits); the warp then stores the child row by row through the seat
// permutation (the rows of player q's blocks come from player q + advance),
// wrapped to int8, into a second shared buffer and to device memory; every
// lane computes the board's scalars (bank, the mover's gems, cards and
// token count, the gates) from that buffer, and the lanes share the 408
// non-pass actions of the mask (lane i takes i, i + 32, ...: coalesced
// table reads and mask stores); a warp vote gives the pass bit, and lane 0
// writes the advance and the terminal vector.  No block-wide barrier: a
// warp past the last board leaves at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kActions = 409;
constexpr int kCols = 7;
constexpr int kWarp = 32;
constexpr int kBoards = 4;                   // boards (warps) per block
constexpr int kMaxCells = 88 * kCols;        // the board of 4 players
constexpr unsigned kFull = 0xffffffffu;

// action kinds, action ranges and exchange classes (tables.py)
constexpr int kBuy = 0, kReserve = 1, kBuyReserve = 2, kGems = 3, kRsvg = 4,
              kNoble = 5;
constexpr int kAReserve = 12, kABuyReserve = 27, kATake = 30,
              kAExchange = 60, kARsvg = 290, kAT3G3 = 365, kANoble = 405,
              kAPass = 408;
constexpr int kXcLm2 = 1, kXcLm1 = 2, kXcElse = 3;
// the mask's non-pass actions a lane takes: lane, lane + 32, ...
constexpr int kPerLane = (kAPass + kWarp - 1) / kWarp;
// the board's cells a lane copies in: lane, lane + 32, ...
constexpr int kCellsPerLane = (kMaxCells + kWarp - 1) / kWarp;
// fixed rows of the board
constexpr int kRowCards = 1, kRowDecks = 25, kRowNobles = 31;

struct Cfg {
  int players, nobles, rows;
  int pgems, pnobles, pcards, prsv;          // first rows of the seat blocks
  int token_limit, reserve, giveback, noble_select, score_win, max_moves;
};

__device__ __forceinline__ int wrap8(int x) { return ((x + 128) & 0xFF) - 128; }

__device__ __forceinline__ int field(int w, int shift, int bits) {
  return (w >> shift) & ((1 << bits) - 1);
}

__device__ __forceinline__ void copy_row(int* s, int to, int from) {
  for (int k = 0; k < kCols; ++k) s[to * kCols + k] = s[from * kCols + k];
}

__device__ __forceinline__ void zero_row(int* s, int r) {
  for (int k = 0; k < kCols; ++k) s[r * kCols + k] = 0;
}

__device__ __forceinline__ int sum5(const int* row) {
  return row[0] + row[1] + row[2] + row[3] + row[4];
}

// env.py::_award_nobles for seat 0: every noble whose requirement the
// seat's cards meet is moved to the seat's noble rows, in index order;
// with noble select, two or more eligible nobles set the pending flags
// (column 5 of the noble rows) instead.
__device__ void award_nobles(int* s, const Cfg& c) {
  const int* pc = s + c.pcards * kCols;
  int elig = 0, n = 0;
  for (int i = 0; i < c.nobles; ++i) {
    const int* nb = s + (kRowNobles + i) * kCols;
    bool meets = sum5(nb) > 0;
    for (int k = 0; k < 5; ++k) meets = meets && pc[k] >= nb[k];
    elig |= int(meets) << i;
    n += meets;
  }
  if (c.noble_select && n >= 2) {
    for (int i = 0; i < c.nobles; ++i)
      s[(kRowNobles + i) * kCols + 5] = (elig >> i) & 1;
    return;
  }
  for (int i = 0; i < c.nobles; ++i) {
    if ((elig >> i) & 1) {
      copy_row(s, c.pnobles + i, kRowNobles + i);
      zero_row(s, kRowNobles + i);
    }
  }
}

// env.py::_pay_and_gain for seat 0: pay the card of rows (crow, grow), gold
// covering what the gems and cards miss, add its gain row, award nobles.
__device__ void pay_and_gain(int* s, const Cfg& c, int crow, int grow) {
  int cost[5], gain[kCols];
  for (int k = 0; k < 5; ++k) cost[k] = s[crow * kCols + k];
  for (int k = 0; k < kCols; ++k) gain[k] = s[grow * kCols + k];
  int* pg = s + c.pgems * kCols;
  int* pc = s + c.pcards * kCols;
  int missing = 0;
  for (int k = 0; k < 5; ++k) {
    missing += max(cost[k] - pg[k] - pc[k], 0);
    const int paid = min(max(cost[k] - pc[k], 0), pg[k]);
    pg[k] -= paid;
    s[k] += paid;
  }
  pg[5] -= missing;
  s[5] += missing;
  for (int k = 0; k < kCols; ++k) pc[k] += gain[k];
  award_nobles(s, c);
}

// env.py::_do_reserve, deterministic: a visible card moves to the first
// empty reserve row of seat 0 (the first reserve row when none is empty)
// and its slot is cleared; a deck's card stays hidden.  Then one gold
// token, if the bank has one.
__device__ void do_reserve(int* s, const Cfg& c, int slot15) {
  int er = c.prsv;
  for (int j = 2; j >= 0; --j)
    if (sum5(s + (c.prsv + 2 * j) * kCols) == 0) er = c.prsv + 2 * j;
  if (slot15 < 12) {
    const int row = kRowCards + 2 * slot15;
    copy_row(s, er, row);
    copy_row(s, er + 1, row + 1);
    zero_row(s, row);
    zero_row(s, row + 1);
  }
  if (s[5] > 0) {
    s[5] -= 1;
    s[c.pgems * kCols + 5] += 1;
  }
}

// env.py::_take_noble: award the (k + 1)-th flagged noble, clear every
// pending flag.
__device__ void take_noble(int* s, const Cfg& c, int k) {
  int cum = 0, hit = 0;
  for (int i = 0; i < c.nobles; ++i) {
    const int f = s[(kRowNobles + i) * kCols + 5];
    cum += f;
    hit |= int(f > 0 && cum == k + 1) << i;
  }
  for (int i = 0; i < c.nobles; ++i) {
    const int r = kRowNobles + i;
    if ((hit >> i) & 1) {
      copy_row(s, c.pnobles + i, r);
      s[(c.pnobles + i) * kCols + 5] = 0;
      zero_row(s, r);
    }
    s[r * kCols + 5] = 0;
  }
}

// env.py::step for seat 0 with chance collapsed, on the int32 board s; the
// branch of the action's kind only (w0, w1: the action's table words; a
// kind of -1 for an id outside [0, 409) passes).  Returns the seat advance.
__device__ int step_board(int* s, const Cfg& c, long long action, int kind,
                          int w0, int w1) {
  const int param = field(w0, 3, 4);
  int* pg = s + c.pgems * kCols;
  switch (kind) {
    case kBuy: {
      const int row = kRowCards + 2 * min(param, 11);
      pay_and_gain(s, c, row, row + 1);
      zero_row(s, row);
      zero_row(s, row + 1);
      break;
    }
    case kReserve:
    case kRsvg:
      do_reserve(s, c, min(param, 14));
      if (kind == kRsvg) {
        for (int k = 0; k < 5; ++k) {
          const int g = field(w1, 15 + 2 * k, 2);
          pg[k] -= g;
          s[k] += g;
        }
      }
      break;
    case kBuyReserve: {
      const int pr = min(param, 2);
      pay_and_gain(s, c, c.prsv + 2 * pr, c.prsv + 2 * pr + 1);
      // keep the other two reserved cards, in order, in the first rows
      for (int i = 0; i < 4; ++i) {
        const int from = i + 2 * (i / 2 >= pr);
        if (from != i) copy_row(s, c.prsv + i, c.prsv + from);
      }
      zero_row(s, c.prsv + 4);
      zero_row(s, c.prsv + 5);
      break;
    }
    case kGems:
      for (int k = 0; k < 5; ++k) {
        const int d = field(w0, 7 + 2 * k, 2) - field(w1, 15 + 2 * k, 2);
        pg[k] += d;
        s[k] -= d;
      }
      break;
    case kNoble:
      if (c.noble_select) take_noble(s, c, static_cast<int>(action) - kANoble);
      break;
    default:                                  // pass
      break;
  }
  int adv = 1;
  if (c.noble_select) {
    // a pending noble choice keeps the turn and defers the round tick
    int pend = 0;
    for (int i = 0; i < c.nobles; ++i) pend += s[(kRowNobles + i) * kCols + 5];
    adv = pend > 0 ? 0 : 1;
  }
  s[6] += adv;
  return adv;
}

// env.py::swap_players: the row of the swapped board that row r of the
// child comes from, seat q's rows taken from seat q + nb.
__device__ __forceinline__ int swap_src(int r, int nb, const Cfg& c) {
  const int start[4] = {c.pgems, c.pnobles, c.pcards, c.prsv};
  const int per[4] = {1, c.nobles, 1, 6};
  for (int k = 0; k < 4; ++k) {
    const int total = per[k] * c.players;
    if (r >= start[k] && r < start[k] + total)
      return start[k] + (r - start[k] + per[k] * nb) % total;
  }
  return r;
}

// what valid_moves reads of the swapped board, the same for every action
struct Board {
  int bank[5], gold, pg[5], pgold, pc[5];
  int tokens, allow1, allow2d, slot_free, rsv_gate, xclass, ex_gate, n_elig;
};

__device__ __forceinline__ Board board_scalars(const int* t, const Cfg& c) {
  Board k;
  const int* pg = t + c.pgems * kCols;
  const int* pc = t + c.pcards * kCols;
  int nz = 0;
  for (int i = 0; i < 5; ++i) {
    k.bank[i] = t[i];
    k.pg[i] = pg[i];
    k.pc[i] = pc[i];
    nz += t[i] != 0;
  }
  k.gold = t[5];
  k.pgold = pg[5];
  k.tokens = sum5(pg) + pg[5];
  k.allow1 = k.tokens == 9 || nz == 1;
  k.allow2d = k.tokens == 8 || nz == 2;
  k.slot_free = sum5(t + (c.prsv + 5) * kCols) == 0;
  k.rsv_gate = c.reserve && !(k.tokens == c.token_limit && k.gold > 0);
  k.xclass = k.tokens == c.token_limit - 2   ? kXcLm2
             : k.tokens == c.token_limit - 1 ? kXcLm1
                                             : kXcElse;
  k.ex_gate = k.tokens > 7 && c.giveback;
  k.n_elig = 0;
  if (c.noble_select)
    for (int i = 0; i < c.nobles; ++i)
      k.n_elig += t[(kRowNobles + i) * kCols + 5];
  return k;
}

// a card of the given cost row can be paid, and the row holds a card
__device__ __forceinline__ bool can_buy(const int* cost, const Board& k) {
  int missing = 0;
  for (int i = 0; i < 5; ++i) missing += max(cost[i] - k.pg[i] - k.pc[i], 0);
  return missing <= k.pgold && sum5(cost) != 0;
}

// reserve slot j (12 visible cards, then the three decks) holds a card and
// the mover has a free reserve row
__device__ __forceinline__ bool can_reserve(const int* t, int j,
                                            const Board& k) {
  const int row = j < 12 ? kRowCards + 2 * j : kRowDecks + 2 * (j - 12);
  return sum5(t + row * kCols) != 0 && k.slot_free;
}

// env.py::valid_moves for seat 0, one action a < 408 with its table words
// w0, w1 (the pass bit is the warp's vote over these)
__device__ __forceinline__ bool valid_action(const int* t, const Cfg& c,
                                             const Board& k, int a, int w0,
                                             int w1) {
  if (c.noble_select && k.n_elig > 0)
    return a >= kANoble && a - kANoble < k.n_elig;
  if (a < kAReserve) return can_buy(t + (kRowCards + 2 * a) * kCols, k);
  if (a < kABuyReserve) return can_reserve(t, a - kAReserve, k) && k.rsv_gate;
  if (a < kATake)
    return can_buy(t + (c.prsv + 2 * (a - kABuyReserve)) * kCols, k);
  if (a >= kANoble) return false;
  bool bank_ok = true, give_ok = true;
  for (int i = 0; i < 5; ++i) {
    bank_ok = bank_ok && k.bank[i] >= field(w1, 3 * i, 3);
    give_ok = give_ok && k.pg[i] >= field(w1, 15 + 2 * i, 2);
  }
  if (a < kAExchange) {
    bool ok = bank_ok && k.tokens + field(w1, 27, 2) <= c.token_limit;
    if (a < kATake + 5) ok = ok && k.allow1;
    else if (a < kATake + 15) ok = ok && k.allow2d;
    return ok;
  }
  bool ok = field(w1, 25, 2) == k.xclass && bank_ok && give_ok && k.ex_gate;
  if (a >= kARsvg && a < kAT3G3)
    ok = ok && can_reserve(t, field(w0, 3, 4), k) && k.gold > 0;
  return ok;
}

// env.py::check_end_game with judge, on the swapped board
__device__ void terminal(const int* t, const Cfg& c, float* out) {
  int score[4], cards[4], best = -(1 << 30);
  for (int p = 0; p < c.players; ++p) {
    const int* pc = t + (c.pcards + p) * kCols;
    score[p] = pc[6];
    for (int i = 0; i < c.nobles; ++i)
      score[p] += t[(c.pnobles + c.nobles * p + i) * kCols + 6];
    cards[p] = sum5(pc);
    best = max(best, score[p]);
  }
  const int rnd = t[6] & 0xFF;
  const bool over = best >= c.score_win || rnd >= c.max_moves;
  if (!(rnd % c.players == 0 && over)) {
    for (int p = 0; p < c.players; ++p) out[p] = 0.0f;
    return;
  }
  int ntop = 0;
  for (int p = 0; p < c.players; ++p) ntop += score[p] == best;
  if (ntop == 1) {
    for (int p = 0; p < c.players; ++p) out[p] = score[p] == best ? 1.0f : -1.0f;
    return;
  }
  // ties on score: fewest cards among the leaders; several give 0.01
  int least = 1 << 30, nleast = 0;
  for (int p = 0; p < c.players; ++p) {
    cards[p] = score[p] < best ? 999 : cards[p];
    least = min(least, cards[p]);
  }
  for (int p = 0; p < c.players; ++p) nleast += cards[p] == least;
  const float tie = nleast > 1 ? 0.01f : 1.0f;
  for (int p = 0; p < c.players; ++p) out[p] = cards[p] == least ? tie : -1.0f;
}

__global__ void __launch_bounds__(kBoards * kWarp)
env_step_kernel(const int8_t* __restrict__ states,
                const long long* __restrict__ actions, int B, Cfg c,
                const int* __restrict__ tab, int8_t* __restrict__ child,
                float* __restrict__ term, bool* __restrict__ valid,
                long long* __restrict__ adv_out) {
  __shared__ int work[kBoards][kMaxCells];
  __shared__ int swapped[kBoards][kMaxCells];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kBoards + warp;
  if (b >= B) return;
  int* s = work[warp];
  int* t = swapped[warp];
  const int n = c.rows * kCols;
  const long long off = static_cast<long long>(b) * n;
  // every table word the warp needs, requested before the board: none
  // depends on it, so their round trips overlap the board's and the step
  const long long action = actions[b];
  const bool known = action >= 0 && action < kActions;
  const int aw0 = known ? __ldg(tab + action) : 0;
  const int aw1 = known ? __ldg(tab + kActions + action) : 0;
  int w0[kPerLane], w1[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int a = lane + kWarp * j;
    w0[j] = a < kAPass ? __ldg(tab + a) : 0;
    w1[j] = a < kAPass ? __ldg(tab + kActions + a) : 0;
  }
  // the board's bytes: every load issued before the first store
  int cell[kCellsPerLane];
#pragma unroll
  for (int j = 0; j < kCellsPerLane; ++j) {
    const int i = lane + kWarp * j;
    cell[j] = i < n ? states[off + i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kCellsPerLane; ++j) {
    const int i = lane + kWarp * j;
    if (i < n) s[i] = cell[j];
  }
  __syncwarp();
  int adv = 0;
  if (lane == 0)
    adv = step_board(s, c, action, known ? field(aw0, 0, 3) : -1, aw0, aw1);
  __syncwarp();
  adv = __shfl_sync(kFull, adv, 0);
  const int nb = c.noble_select ? adv : 1;
  for (int i = lane; i < n; i += kWarp) {
    const int r = i / kCols, col = i % kCols;
    const int v = wrap8(s[swap_src(r, nb, c) * kCols + col]);
    t[i] = v;
    child[off + i] = static_cast<int8_t>(v);
  }
  __syncwarp();
  const Board k = board_scalars(t, c);
  bool* vrow = valid + static_cast<long long>(b) * kActions;
  bool any = false;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int a = lane + kWarp * j;
    if (a < kAPass) {
      const bool v = valid_action(t, c, k, a, w0[j], w1[j]);
      vrow[a] = v;
      any = any || v;
    }
  }
  any = __any_sync(kFull, any);
  if (lane == 0) {
    vrow[kAPass] = !any;
    adv_out[b] = adv;
    terminal(t, c, term + static_cast<long long>(b) * c.players);
  }
}

}  // namespace

// The launch.  states: [B, rows, 7] int8 with rows = 32 + 10 P + P * P;
// actions: [B] int64; tables: [2, 409] int32 (ops/env_step.py::
// pack_tables); child [B, rows, 7] int8, term [B, P] float32, valid
// [B, 409] bool, adv [B] int64.  Returns the CUDA error code
// (cudaErrorInvalidValue for a player count outside 2-4).
extern "C" int env_step_launch(const int8_t* states, const long long* actions,
                               int B, int players, int token_limit,
                               int reserve, int giveback, int noble_select,
                               int score_win, const int* tables,
                               int8_t* child, float* term, bool* valid,
                               long long* adv, void* stream) {
  if (B <= 0) return 0;
  if (players < 2 || players > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Cfg c;
  c.players = players;
  c.nobles = players + 1;
  c.pgems = kRowNobles + c.nobles;
  c.pnobles = c.pgems + players;
  c.pcards = c.pnobles + players * c.nobles;
  c.prsv = c.pcards + players;
  c.rows = c.prsv + 6 * players;
  c.token_limit = token_limit;
  c.reserve = reserve;
  c.giveback = giveback;
  c.noble_select = noble_select;
  c.score_win = score_win;
  c.max_moves = 62 * players;
  const int blocks = (B + kBoards - 1) / kBoards;
  env_step_kernel<<<blocks, kBoards * kWarp, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      states, actions, B, c, tables, child, term, valid, adv);
  return static_cast<int>(cudaGetLastError());
}
