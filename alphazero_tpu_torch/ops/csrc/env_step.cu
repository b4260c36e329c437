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
// actions [B] int64, and the packed tables that ops/env_step.py::
// packed_tables builds from tables.py (int32 words, uploaded once per
// device):
//   [0, 818)      the step and mask words of the 409 actions, in id order
//                 (this kernel reads the same words in slot order below);
//   [818, 1650)   two words (8 bytes, one load) for each of the mask's 416
//                 slots (13 passes of 32 lanes; slot s holds id s for the
//                 30 card ids, id + 2 for the others: ops/env_step.py::
//                 mask_slots): its action's level word and its condition
//                 word (zeros in an unused slot);
//   [1650, 1914)  uint16 [3 player counts][88 rows][2 advances]: where each
//                 row of the stepped board goes in the child (bits 0-6)
//                 and that child row's owner (bits 8-9) when it is a row
//                 of a player's cards (bit 10) or nobles (bit 11).
// The id-ordered step word holds the kind (bits 0-2), the parameter (a
// card or reserve slot, 3-6) and the gems of colour c taken (7 + 2c); the
// mask word the bank's minimum of colour c for the take (3c), the gems of
// colour c given back (15 + 2c), the exchange class (25) and the gems taken
// in all (27).  A slot's level word asks what the action needs of the
// counts, as level bits, so that one mask test checks every colour: bit c
// for at least one gem of colour c in the bank, 5 + c for four (the
// minimum is 0, 1 or 4), 10 + 3c + t (t < g) for g of the mover's gems of
// colour c given back; above them the kind (bits 25-27) and the parameter
// (28-31).  It is all the step needs too: the gems taken of colour c are 2
// where the bank needs four, else what it needs (0 or 1), and the gems
// given back count the colour's level bits.  The condition word asks the
// rest as bits of the board's condition word (the kBit* constants below),
// so that a take, exchange or noble id's mask bit is two mask tests.
// Outputs, per board: the child [R, 7] int8 in the next seat's frame, the
// terminal vector [P] float32, the valid mask [409] bool and the seat
// advance (int64: 1, or 0 on a pending noble-select ply that keeps the
// turn): what the plain version returns.  The game's switches (players,
// token_limit, enable_reserve, enable_giveback, enable_noble_select,
// score_win) are kernel arguments.
//
// Exactness.  All arithmetic is int32 on the board's values, as the plain
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
// device time of an empty kernel (~0.9 us).  So the launch and the warp's
// chain of dependent steps bound it, not bytes.
//
// Design.  One warp per board, four boards per block, no shared memory:
// lane l holds rows l, l + 32 and l + 64 of the board in registers (as
// int32), loaded straight from device memory, with its 13 mask slots'
// table words and its rows' swap destinations, all requested before the
// first use.  The action's step word comes from the lane whose slot holds
// it (a shuffle, not a second round trip), made warp-uniform by one
// reduction, so the branch on its kind is uniform.  The whole warp applies
// that branch: the rows it reads (the card, the mover's gems and cards, a
// reserve row, a noble) are broadcast by shuffles, every lane computes the
// per-colour payment from them and updates the rows it holds; noble
// eligibility, the first empty reserve row and the pending flags come from
// warp votes and reductions.  Each lane then stores its rows, wrapped to
// int8, at the child rows the host-built table gives (the seat swap, with
// no arithmetic).  The mask's scalars are computed once: the mover's rows
// are broadcast, the rows' holders vote on what is buyable and which slots
// hold a card, and the board's level and condition bits are formed.  The
// mask's slots are ordered so that the first pass holds the 30 card ids
// and the other twelve the take, exchange and noble ids, consecutive ids
// in consecutive lanes: one code path per pass, coalesced stores; a take,
// exchange or noble bit is two mask tests of its slot's words against the
// board's bits.  The players' scores and card counts come from one warp
// reduction per player.  No block-wide barrier: a warp past the last board
// leaves at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kActions = 409;
constexpr int kCols = 7;
constexpr int kWarp = 32;
constexpr int kBoards = 4;                   // boards (warps) per block
constexpr int kSlots = 3;                    // rows a lane holds
constexpr int kMaxRows = 88;                 // the board of 4 players
constexpr int kPasses = 13;                  // mask slots: 13 x 32 lanes
constexpr unsigned kFull = 0xffffffffu;

// the packed tables, in int32 words (ops/env_step.py::TABLE_OFFSETS)
constexpr int kSlotWords = 2 * kActions;
constexpr int kSwap = kSlotWords + 2 * kPasses * kWarp;
static_assert(kSlotWords % 2 == 0, "the slot words' loads are 8 bytes");
// the board's condition bits (ops/env_step.py::COND_BITS): allow1, allow2d,
// tokens + t <= the limit (t = 1-3), the exchange class x (1-3), the
// exchange gate, reserve slot j holds a card (j < 15), a free reserve row
// and gold in the bank, no pending noble, noble choice k open (k < 3), no
// negative bank count, no negative count of the mover's gems
constexpr int kBitAllow1 = 0, kBitAllow2d = 1, kBitFit = 1, kBitXclass = 4,
              kBitExGate = 8, kBitHeld = 9, kBitRsvg = 24, kBitNoPend = 25,
              kBitNoble = 26, kBitBankNonneg = 29, kBitGemsNonneg = 30;

// action kinds, action ranges and exchange classes (tables.py)
constexpr int kBuy = 0, kReserve = 1, kBuyReserve = 2, kGems = 3, kRsvg = 4,
              kNoble = 5, kPass = 6;
// a level word's kind and parameter, and the levels it can ask for
constexpr int kKindShift = 25, kParamShift = 28, kLevelBits = 0x1FFFFFF;
constexpr int kATake = 30, kAPass = 408;
constexpr int kXcLm2 = 1, kXcLm1 = 2, kXcElse = 3;
// fixed rows of the board
constexpr int kRowCards = 1, kRowDecks = 25, kRowNobles = 31;

// The seat rows of P players, and where they fall among the lanes' slots:
// the noble rows (31-35) sit in slot 0 of lane 31 and slot 1 of lanes 0-3,
// seat 0's noble rows in slot 1, seat 0's six reserve rows in one slot.
constexpr int row_pgems(int p) { return kRowNobles + p + 1; }
constexpr int row_pnobles(int p) { return row_pgems(p) + p; }
constexpr int row_pcards(int p) { return row_pnobles(p) + p * (p + 1); }
constexpr int row_prsv(int p) { return row_pcards(p) + p; }
constexpr bool layout_fits(int p) {
  return kRowNobles + p + 1 <= 2 * kWarp && row_pgems(p) >= kWarp &&
         row_pnobles(p) + p + 1 <= 2 * kWarp &&
         row_prsv(p) % kWarp + 6 <= kWarp &&
         row_prsv(p) + 6 * p <= kMaxRows && kMaxRows <= kSlots * kWarp;
}
static_assert(layout_fits(2) && layout_fits(3) && layout_fits(4),
              "the board's rows do not fall in the slots the kernel assumes");

struct Cfg {
  int players, nobles, rows;
  int pgems, pnobles, pcards, prsv;          // seat 0's first rows
  int token_limit, reserve, giveback, noble_select, score_win, max_moves;
  int round_mul;        // ceil(65536 / players): r / players is
                        // (r * round_mul) >> 16 for a round r < 256
};

using Rows = int[kSlots][kCols];

__device__ __forceinline__ int wrap8(int x) { return ((x + 128) & 0xFF) - 128; }

__device__ __forceinline__ int field(int w, int shift, int bits) {
  return (w >> shift) & ((1 << bits) - 1);
}

// column col of the lane's row in slot k (k the same in every lane)
__device__ __forceinline__ int at(const Rows& v, int k, int col) {
  return k == 0 ? v[0][col] : k == 1 ? v[1][col] : v[2][col];
}

// the first n columns of the row in slot k (the same in every lane) of
// lane src (each lane's own)
template <int n = kCols>
__device__ __forceinline__ void shfl_row(const Rows& v, int k, int src,
                                         int (&out)[kCols]) {
#pragma unroll
  for (int col = 0; col < n; ++col)
    out[col] = __shfl_sync(kFull, at(v, k, col), src & (kWarp - 1));
}

// row r (the same in every lane), broadcast
template <int n = kCols>
__device__ __forceinline__ void bcast_row(const Rows& v, int r,
                                          int (&out)[kCols]) {
  shfl_row<n>(v, r / kWarp, r % kWarp, out);
}

__device__ __forceinline__ int sum5(const int* row) {
  return row[0] + row[1] + row[2] + row[3] + row[4];
}

__device__ __forceinline__ void set_row(int* row, const int (&from)[kCols]) {
#pragma unroll
  for (int col = 0; col < kCols; ++col) row[col] = from[col];
}

__device__ __forceinline__ void zero_row(int* row) {
#pragma unroll
  for (int col = 0; col < kCols; ++col) row[col] = 0;
}

// bit r of a set of rows held as one vote per slot
__device__ __forceinline__ int row_bit(const unsigned (&bits)[kSlots], int r) {
  const unsigned w = r < kWarp ? bits[0] : r < 2 * kWarp ? bits[1] : bits[2];
  return (w >> (r % kWarp)) & 1;
}

// the noble held in slot k of this lane, or -1
__device__ __forceinline__ int noble_at(const Cfg& c, int lane, int k) {
  const int i = lane + kWarp * k - kRowNobles;
  return i >= 0 && i < c.nobles ? i : -1;
}

// The nobles of `bits` go to seat 0's noble rows (clear_flag: with their
// flag column 0) and their own rows are zeroed.  Noble 0 is slot 0 of lane
// 31, noble i >= 1 slot 1 of lane i - 1; seat 0's noble rows lie in slot 1.
__device__ __forceinline__ void move_nobles(Rows& v, const Cfg& c, int lane,
                                            unsigned bits, bool clear_flag) {
  int n0[kCols], n1[kCols];
  const int i = lane + kWarp - c.pnobles;     // seat 0's noble in slot 1
  shfl_row(v, 0, kRowNobles, n0);
  shfl_row(v, 1, i - 1, n1);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = noble_at(c, lane, k);
    if (j >= 0 && ((bits >> j) & 1)) zero_row(v[k]);
  }
  if (i >= 0 && i < c.nobles && ((bits >> i) & 1)) {
#pragma unroll
    for (int col = 0; col < kCols; ++col)
      v[1][col] = i == 0 ? n0[col] : n1[col];
    if (clear_flag) v[1][5] = 0;
  }
}

// env.py::_award_nobles for seat 0 with its cards pc: every noble whose
// requirement they meet goes to the seat's noble rows; with noble select,
// two or more eligible nobles set the pending flags (column 5 of the noble
// rows) instead.
__device__ __forceinline__ void award_nobles(Rows& v, const Cfg& c, int lane,
                                             const int (&pc)[kCols]) {
  unsigned vote[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    bool meets = noble_at(c, lane, k) >= 0 && sum5(v[k]) > 0;
#pragma unroll
    for (int col = 0; col < 5; ++col) meets = meets && pc[col] >= v[k][col];
    vote[k] = __ballot_sync(kFull, meets);
  }
  // noble i is row 31 + i: bit 31 of slot 0's vote, then slot 1's bits
  const unsigned elig =
      ((vote[0] >> (kWarp - 1)) | (vote[1] << 1)) & ((1u << c.nobles) - 1);
  const bool pend = c.noble_select && __popc(elig) >= 2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = noble_at(c, lane, k);
    if (pend && j >= 0) v[k][5] = (elig >> j) & 1;
  }
  move_nobles(v, c, lane, pend ? 0u : elig, false);
}

// env.py::_pay_and_gain for seat 0: pay the card of rows (crow, crow + 1),
// gold covering what the gems and cards miss, add its gain row, award
// nobles.  Every lane computes the payment from the broadcast rows.
__device__ __forceinline__ void pay_and_gain(Rows& v, const Cfg& c, int lane,
                                             int crow) {
  int cost[kCols], gain[kCols], pg[kCols], pc[kCols];
  bcast_row<5>(v, crow, cost);
  bcast_row(v, crow + 1, gain);
  bcast_row<6>(v, c.pgems, pg);
  bcast_row<5>(v, c.pcards, pc);
  int missing = 0, paid[5];
#pragma unroll
  for (int col = 0; col < 5; ++col) {
    missing += max(cost[col] - pg[col] - pc[col], 0);
    paid[col] = min(max(cost[col] - pc[col], 0), pg[col]);
    pc[col] += gain[col];
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = lane + kWarp * k;
    if (r == 0) {
#pragma unroll
      for (int col = 0; col < 5; ++col) v[k][col] += paid[col];
      v[k][5] += missing;
    }
    if (r == c.pgems) {
#pragma unroll
      for (int col = 0; col < 5; ++col) v[k][col] -= paid[col];
      v[k][5] -= missing;
    }
    if (r == c.pcards) {
#pragma unroll
      for (int col = 0; col < kCols; ++col) v[k][col] += gain[col];
    }
  }
  award_nobles(v, c, lane, pc);
}

// env.py::_do_reserve, deterministic: a visible card moves to the first
// empty reserve row of seat 0 (the first reserve row when none is empty)
// and its slot is cleared; a deck's card stays hidden.  Then one gold
// token, if the bank has one.
__device__ __forceinline__ void do_reserve(Rows& v, const Cfg& c, int lane,
                                           int slot15) {
  const int kr = c.prsv / kWarp, base = c.prsv % kWarp, j = lane - base;
  int s = 0;
#pragma unroll
  for (int col = 0; col < 5; ++col) s += at(v, kr, col);
  const unsigned empty =
      __ballot_sync(kFull, j >= 0 && j < 6 && (j & 1) == 0 && s == 0);
  const int er = c.prsv + (empty ? __ffs(empty) - 1 - base : 0);
  if (slot15 < 12) {
    const int row = kRowCards + 2 * slot15;
    int cost[kCols], gain[kCols];
    bcast_row(v, row, cost);
    bcast_row(v, row + 1, gain);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int r = lane + kWarp * k;
      if (r == er) set_row(v[k], cost);
      if (r == er + 1) set_row(v[k], gain);
      if (r == row || r == row + 1) zero_row(v[k]);
    }
  }
  const int gold = __shfl_sync(kFull, v[0][5], 0);
  if (gold > 0) {
    if (lane == 0) v[0][5] -= 1;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (lane + kWarp * k == c.pgems) v[k][5] += 1;
  }
}

// the gems of colour col an action takes and gives back, from its level
// word
__device__ __forceinline__ int taken(int w, int col) {
  return field(w, 5 + col, 1) ? 2 : field(w, col, 1);
}
__device__ __forceinline__ int given(int w, int col) {
  return __popc(field(w, 10 + 3 * col, 3));
}

// the gems moved between the bank and seat 0: d[col] to the seat
__device__ __forceinline__ void move_gems(Rows& v, const Cfg& c, int lane,
                                          const int (&d)[5]) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = lane + kWarp * k;
#pragma unroll
    for (int col = 0; col < 5; ++col) {
      if (r == 0) v[k][col] -= d[col];
      if (r == c.pgems) v[k][col] += d[col];
    }
  }
}

// env.py::step for seat 0 with chance collapsed, on the rows the lanes
// hold: the branch of the action's kind only (w: the action's level word,
// the same in every lane).  Returns the seat advance.
__device__ __forceinline__ int step_board(Rows& v, const Cfg& c, int lane,
                                          int w) {
  const int kind = field(w, kKindShift, 3), param = field(w, kParamShift, 4);
  int d[5];
  switch (kind) {
    case kBuy: {
      const int row = kRowCards + 2 * min(param, 11);
      pay_and_gain(v, c, lane, row);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int r = lane + kWarp * k;
        if (r == row || r == row + 1) zero_row(v[k]);
      }
      break;
    }
    case kReserve:
    case kRsvg:
      do_reserve(v, c, lane, min(param, 14));
      if (kind == kRsvg) {
#pragma unroll
        for (int col = 0; col < 5; ++col) d[col] = -given(w, col);
        move_gems(v, c, lane, d);
      }
      break;
    case kBuyReserve: {
      // keep the other two reserved cards, in order, in the first rows:
      // row i of the six takes row from(i), read before any change
      const int pr = min(param, 2), kr = c.prsv / kWarp;
      const int i = lane - c.prsv % kWarp;
      const int from = i + 2 * (i / 2 >= pr);
      int kept[kCols];
      shfl_row(v, kr, c.prsv + from, kept);
      pay_and_gain(v, c, lane, c.prsv + 2 * pr);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int ri = lane + kWarp * k - c.prsv;
        if (ri >= 0 && ri < 4 && from != ri) set_row(v[k], kept);
        if (ri == 4 || ri == 5) zero_row(v[k]);
      }
      break;
    }
    case kGems:
#pragma unroll
      for (int col = 0; col < 5; ++col)
        d[col] = taken(w, col) - given(w, col);
      move_gems(v, c, lane, d);
      break;
    case kNoble:
      if (c.noble_select) {
        // env.py::_take_noble: award the (k + 1)-th flagged noble (k the
        // parameter of noble id 405 + k), clear every pending flag; the
        // flags broadcast, the running count in every lane
        const int want = param + 1;
        int cum = 0;
        unsigned hit = 0;
        for (int n = 0; n < c.nobles; ++n) {
          const int f = n == 0 ? __shfl_sync(kFull, v[0][5], kRowNobles)
                               : __shfl_sync(kFull, v[1][5], n - 1);
          cum += f;
          hit |= unsigned(f > 0 && cum == want) << n;
        }
        move_nobles(v, c, lane, hit, true);
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (noble_at(c, lane, k) >= 0) v[k][5] = 0;
      }
      break;
    default:                                  // pass
      break;
  }
  int adv = 1;
  if (c.noble_select) {
    // a pending noble choice keeps the turn and defers the round tick
    int pend = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (noble_at(c, lane, k) >= 0) pend += v[k][5];
    adv = static_cast<int>(__reduce_add_sync(kFull, unsigned(pend))) > 0 ? 0
                                                                         : 1;
  }
  if (lane == 0) v[0][6] += adv;
  return adv;
}

// what valid_moves and the end check read of the child, the same for
// every action
struct Board {
  int round, slot_free, rsv_gate, pending;
  int rsv;        // the child's first reserve row, as a row of the stepped
                  // board
  // the level bits and the condition bits (but reserve slots' holdings)
  // this child has: a slot's words ask no more than these
  int levels, cond;
  unsigned buyable[kSlots], holds[kSlots];
};

__device__ __forceinline__ Board board_scalars(const Rows& v, const Cfg& c,
                                               int lane, int adv) {
  Board k;
  // seat 0 of the child is seat adv of the stepped board
  const int gs = c.pgems + adv, cs = c.pcards + adv;
  k.rsv = c.prsv + 6 * adv;
  int bank[kCols], pg[kCols], pc[kCols];
  bcast_row(v, 0, bank);
  bcast_row<6>(v, gs, pg);
  bcast_row<5>(v, cs, pc);
  k.round = bank[6] & 0xFF;
  int nz = 0, bank_nonneg = 1, gems_nonneg = 1, tokens = pg[5];
  k.levels = ~kLevelBits;          // (the kind and parameter bits)
#pragma unroll
  for (int col = 0; col < 5; ++col) {
    nz += bank[col] != 0;
    tokens += pg[col];
    k.levels |= (bank[col] >= 1) << col | (bank[col] >= 4) << (5 + col) |
                (pg[col] >= 1) << (10 + 3 * col) |
                (pg[col] >= 2) << (11 + 3 * col) |
                (pg[col] >= 3) << (12 + 3 * col);
    bank_nonneg &= bank[col] >= 0;
    gems_nonneg &= pg[col] >= 0;
  }
  int s5[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    s5[s] = sum5(v[s]);
    // a card the mover can pay for (what the cost rows read)
    int missing = 0;
#pragma unroll
    for (int col = 0; col < 5; ++col)
      missing += max(v[s][col] - pg[col] - pc[col], 0);
    k.buyable[s] = __ballot_sync(kFull, missing <= pg[5] && s5[s] != 0);
    k.holds[s] = __ballot_sync(kFull, s5[s] != 0);
  }
  const int r5 = k.rsv + 5;
  k.slot_free = !row_bit(k.holds, r5);
  k.rsv_gate = c.reserve && !(tokens == c.token_limit && bank[5] > 0);
  const int xclass = tokens == c.token_limit - 2   ? kXcLm2
                     : tokens == c.token_limit - 1 ? kXcLm1
                                                   : kXcElse;
  int n_elig = 0;
  if (c.noble_select) {
    int f = 0;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (noble_at(c, lane, s) >= 0) f += v[s][5];
    n_elig = static_cast<int>(__reduce_add_sync(kFull, unsigned(f)));
  }
  k.pending = n_elig > 0;
  k.cond = (tokens == 9 || nz == 1) << kBitAllow1 |
           (tokens == 8 || nz == 2) << kBitAllow2d |
           (tokens + 1 <= c.token_limit) << (kBitFit + 1) |
           (tokens + 2 <= c.token_limit) << (kBitFit + 2) |
           (tokens + 3 <= c.token_limit) << (kBitFit + 3) |
           1 << (kBitXclass + xclass) |
           (tokens > 7 && c.giveback) << kBitExGate |
           (k.slot_free && bank[5] > 0) << kBitRsvg |
           !k.pending << kBitNoPend |
           (k.pending && n_elig > 0) << kBitNoble |
           (k.pending && n_elig > 1) << (kBitNoble + 1) |
           (k.pending && n_elig > 2) << (kBitNoble + 2) |
           bank_nonneg << kBitBankNonneg | gems_nonneg << kBitGemsNonneg;
  return k;
}

// reserve slot j (12 visible cards, then the three decks): its cost row
__device__ __forceinline__ int slot_row(int j) {
  return j < 12 ? kRowCards + 2 * j : kRowDecks + 2 * (j - 12);
}

// a card id's bit (buy, reserve, buy a reserved card) from the slot's kind
// and parameter, without branches
__device__ __forceinline__ bool valid_card(const Board& k, int kind,
                                           int param) {
  const bool buy = row_bit(k.buyable, kind == kBuy ? kRowCards + 2 * param
                                                   : k.rsv + 2 * param);
  const bool reserve =
      row_bit(k.holds, slot_row(param)) & k.slot_free & k.rsv_gate;
  return !k.pending & (kind == kReserve ? reserve : buy);
}

__global__ void __launch_bounds__(kBoards * kWarp)
env_step_kernel(const int8_t* __restrict__ states,
                const long long* __restrict__ actions, int B, Cfg c,
                const int* __restrict__ tab, int8_t* __restrict__ child,
                float* __restrict__ term, bool* __restrict__ valid,
                long long* __restrict__ adv_out) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kBoards + warp;
  if (b >= B) return;
  const long long off = static_cast<long long>(b) * c.rows * kCols;
  // every load before the first use: the action, the lane's mask slots'
  // words (level, condition), its rows' swap entries (both advances) and
  // its rows
  const long long action = actions[b];
  int levels[kPasses], cond[kPasses];
  const int2* slots = reinterpret_cast<const int2*>(tab + kSlotWords);
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int2 w = __ldg(slots + kWarp * j + lane);
    levels[j] = w.x;
    cond[j] = w.y;
  }
  const unsigned* swap = reinterpret_cast<const unsigned*>(tab + kSwap) +
                         (c.players - 2) * kMaxRows;
  unsigned entry[kSlots];
  Rows v;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = lane + kWarp * k;
    const bool in = r < c.rows;
    entry[k] = in ? __ldg(swap + r) : 0u;
#pragma unroll
    for (int col = 0; col < kCols; ++col)
      v[k][col] = in ? states[off + r * kCols + col] : 0;
  }
  // the action's level word, from the lane whose slot holds its id
  const bool known = action >= 0 && action < kActions;
  const int slot = known ? static_cast<int>(action) + 2 * (action >= kATake)
                         : 0;
  // (every pass's word shuffled, then picked: a pick by the pass index
  // before the shuffle would index the array, and move it to memory); an
  // id outside [0, 409) takes the pass's kind.  The warp reduction gives
  // the word in a register the compiler knows is the same in every lane,
  // so the branch on its kind is uniform and its shuffles need no
  // divergence handling.
  int aw = 0;
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int x = __shfl_sync(kFull, levels[j], slot % kWarp);
    aw = slot / kWarp == j ? x : aw;
  }
  aw = static_cast<int>(
      __reduce_or_sync(kFull, known ? aw : kPass << kKindShift));
  // phase: step
  const int adv = step_board(v, c, lane, aw);
  // phase: store
  int8_t* out = child + off;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = lane + kWarp * k;
#pragma unroll
    for (int col = 0; col < kCols; ++col) v[k][col] = wrap8(v[k][col]);
    entry[k] = adv ? entry[k] >> 16 : entry[k] & 0xFFFF;
    if (r < c.rows) {
      const int d = field(entry[k], 0, 7);
#pragma unroll
      for (int col = 0; col < kCols; ++col)
        out[d * kCols + col] = static_cast<int8_t>(v[k][col]);
    }
  }
  // phase: scalars
  const Board k = board_scalars(v, c, lane, adv);
  // phase: mask
  bool* vrow = valid + static_cast<long long>(b) * kActions;
  // pass 0: the card ids (lane = id), then the board's condition bits of
  // the reserve slots that hold a card
  const int kind0 = field(levels[0], kKindShift, 3);
  const int param0 = field(levels[0], kParamShift, 4);
  const bool card = lane < kATake && valid_card(k, kind0, param0);
  const bool held = row_bit(k.holds, slot_row(param0));
  const int cond_k = k.cond | static_cast<int>(__reduce_or_sync(
      kFull, lane < kATake && kind0 == kReserve && held
                 ? 1u << (kBitHeld + param0) : 0u));
  if (lane < kATake) vrow[lane] = card;
  bool any = card;
  // passes 1-12: the take, exchange and noble ids (id = slot - 2): a bit is
  // set when the board has every level and condition its words ask for
#pragma unroll
  for (int j = 1; j < kPasses; ++j) {
    const int id = kWarp * j + lane - 2;
    const bool ok = (id < kAPass) & ((levels[j] & ~k.levels) == 0) &
                    ((cond[j] & ~cond_k) == 0);
    if (id < kAPass) vrow[id] = ok;
    any |= ok;
  }
  any = __any_sync(kFull, any);
  // phase: terminal
  // each player's score and card count: (score << 16) + cards summed over
  // the child rows of its cards and nobles (|cards| < 2^15), whose owners
  // the swap entries give
  int part[4] = {0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = static_cast<int>(entry[s]), q = field(e, 8, 2);
    const int val = field(e, 10, 1) ? v[s][6] * 65536 + sum5(v[s])
                    : field(e, 11, 1) ? v[s][6] * 65536
                                      : 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) part[p] += q == p ? val : 0;
  }
  // (all four reductions, each lane's own player picked from their
  // results: no branch between them, no array indexed by the lane)
  int score[4], cards[4], best = -(1 << 30), mine = 0, mine_cards = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int tot =
        static_cast<int>(__reduce_add_sync(kFull, unsigned(part[p])));
    cards[p] = static_cast<int16_t>(tot & 0xFFFF);
    score[p] = (tot - cards[p]) / 65536;
    best = p < c.players ? max(best, score[p]) : best;
    mine = p == lane ? score[p] : mine;
    mine_cards = p == lane ? cards[p] : mine_cards;
  }
  // ties on score: fewest cards among the leaders; several give 0.01
  int ntop = 0, least = 1 << 30, nleast = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    cards[p] = score[p] < best ? 999 : cards[p];
    ntop += p < c.players && score[p] == best;
    least = p < c.players ? min(least, cards[p]) : least;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) nleast += p < c.players && cards[p] == least;
  mine_cards = mine < best ? 999 : mine_cards;
  const int rnd = k.round;
  const bool ends = rnd == c.players * ((rnd * c.round_mul) >> 16) &&
                    (best >= c.score_win || rnd >= c.max_moves);
  const float tie = mine_cards == least ? (nleast > 1 ? 0.01f : 1.0f) : -1.0f;
  const float lead = mine == best ? 1.0f : -1.0f;
  if (lane < c.players)
    term[static_cast<long long>(b) * c.players + lane] =
        ends ? (ntop == 1 ? lead : tie) : 0.0f;
  if (lane == 0) {
    vrow[kAPass] = !any;
    adv_out[b] = adv;
  }
  // phase: end
}

}  // namespace

// The launch.  states: [B, rows, 7] int8 with rows = 32 + 10 P + P * P;
// actions: [B] int64; tables: ops/env_step.py::packed_tables (int32);
// child [B, rows, 7] int8, term [B, P] float32, valid [B, 409] bool, adv
// [B] int64.  Returns the CUDA error code (cudaErrorInvalidValue for a
// player count outside 2-4).
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
  c.pgems = row_pgems(players);
  c.pnobles = row_pnobles(players);
  c.pcards = row_pcards(players);
  c.prsv = row_prsv(players);
  c.rows = c.prsv + 6 * players;
  c.token_limit = token_limit;
  c.reserve = reserve;
  c.giveback = giveback;
  c.noble_select = noble_select;
  c.score_win = score_win;
  c.max_moves = 62 * players;
  c.round_mul = (65536 + players - 1) / players;
  const int blocks = (B + kBoards - 1) / kBoards;
  env_step_kernel<<<blocks, kBoards * kWarp, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      states, actions, B, c, tables, child, term, valid, adv);
  return static_cast<int>(cudaGetLastError());
}
