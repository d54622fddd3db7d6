// Whole-rollout kernel of the single-blind sim engine (K4), for Hopper (sm_90a).
//
// Replaces: balatro_gym_tpu/ops/fused_rollout.py:_kernel, the Pallas TPU
// kernel behind rollout_fused. Same semantics, op for op where floats are
// involved: an 8-card hand, actions 0-9 that play or discard a prefix of
// 1..5 cards, sim-path hand evaluation and scoring from per-env joker
// coefficients (balatro_gym_tpu_torch/ops/fused_rollout.py:
// joker_coefficients), the arithmetic fixture deck, and autoreset.
//
// What bounds it on this card: integer work an env-step, one long dependent
// chain a thread. Counted from the algorithm as stated here, at the bench
// jokers (sampled, no Four Fingers, Shortcut, Misprint or Bloodstone: one
// hash a step), a C operator, compare, select, shared load or conversion
// counting one:
//
//   stage                                            ops
//   hash (75) and uniform action                      83
//   decode and the selection                           8
//   of a kind (4 shifted compares of the rank word)   69
//   flush (two suit candidates)                       31
//   present ranks                                     25
//   straight (windows, wheel, scoring cards)          63
//   hand type and scoring mask                        18
//   score (5 rank terms, 4 suit terms)               105
//   mult terms (Half, Queens, Kings, Spade-or-Club)   39
//   exponents and powers                              34
//   score product                                      5
//   outcome                                           14
//   refill from the deck window                       13
//   autoreset                                         10
//   loop                                               3
//   total                                            520
//
// (benchmark/harness/int_yardstick.py's SIM_STEP_OPS is this table.)
// Memory traffic is the 576 B an env of coefficient rows read once, the fed
// actions (4 B an env-step) and 100 B an env of outputs: far below the
// operations.
//
// What the design does about it:
// - Every env of the 131072-env shape resident at once: 128-thread blocks,
//   at least 8 an SM (__launch_bounds__(128, 8): at most 64 registers), so
//   1,024 threads an SM hide each other's dependent chains.
// - The per-env tables that a step reads by index are staged once in shared
//   memory, one column per thread (conflict-free), 45 words (180 B) an env:
//   each word a pair of 16-bit halves (chips | mult << 16, money | mult-if-
//   suit << 16, x2 | x3 exponent << 16). Every staged value is a
//   non-negative integer below 2,000 (joker_coefficients' rows: at most 5
//   copies of a joker), so a pair is added as one 32-bit word without a
//   carry from one half into the other, and the flat chips and mult, the
//   base chips and mult of the hand type, the base chips of a card's rank
//   and the flat x3 exponent are folded into the table words at staging.
//   The score's chips and mult are then integer sums: the float32 version
//   adds the same integers, every partial sum below 2**24 and so exact, and
//   converts them to the same floats.
// - The hand lives in two registers, its ranks and its suits, each in 4-bit
//   fields, card c at field c; a set of cards is a word with bit 4c set for
//   card c. Removing a prefix of k cards is a shift of both; the k refilled
//   cards are the low fields of a deck window read from shared memory (45
//   windows, one a deck count, built by the block).
// - Only the first five cards can be selected, and evaluation and scoring
//   work on whole words: the rank word xor itself shifted by d cards has a
//   zero field where a card equals the one d later, so four such compares
//   give the number of equal pairs (0, 1, 2, 3, 4, 6 or 10 for high card,
//   pair, two pair, trips, full house, quads, five of a kind) and the
//   cards in one; a flush needs 4 of 5 cards of a suit, so card 0's or card
//   1's, found the same way on the suit word, as are the Queens, Kings,
//   Hearts and Spade-or-Club cards; without Shortcut the straight is the
//   highest window of req present ranks (and the wheel a prefix of
//   A,2,3,4,5), with it the reference's scan; the ordering of straight
//   cards only drops the last card when one more than req is in the run.
//   The suit terms are added suit by suit, count times word.
// - 3**e3 and 1.5**e15 are tables of the chains' own float32 products (entry
//   i: the product after i multiplies), in shared memory, since envs index
//   them differently and the constant cache serialises such reads.
// The integer results of the reference are kept exactly; every float
// operation (2**e2, the x-mult product, the score, the reward and its sum)
// is the reference's, in its order. Data is [rows, B] with envs contiguous,
// so every global load and store coalesces. Any n_envs is accepted; the
// ragged last block is masked.
//
// Sampled mode draws with Threefry-2x32 (the hash of jax.random and of
// ops/kernel_rng.py, shared with the full-env kernel in csrc/threefry.cuh):
// key = seed_key(seed) (passed in as two words), env child =
// split_child(key, env), draw = random_bits32(child, step*10+slot) with
// slot 0 the action, 1 Misprint, 2..9 the Bloodstone coin of cards 0..7.
// The plain PyTorch version draws the same words, so the two agree bit for
// bit. Build without --use_fast_math: the reward's division by 100 must
// stay IEEE.

#ifndef FULL_ROLLOUT_HOST_SHIM
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kCards = 8;
constexpr int kBlock = 128;
constexpr int kMinBlocks = 8;  // 1,024 threads an SM

// Rows of the per-env scalar coefficient array (ops/fused_rollout.py S_*).
enum {
  S_CHIPS_FLAT = 0, S_MULT_CONST, S_HALF20, S_MISPRINT, S_TRIB, S_BLOOD,
  S_SEEING, S_BLACKB, S_FLOWER, S_E3_CONST, S_BARON, S_STM13, S_FF,
  S_SHORTCUT, S_BLIND, S_MONEY0
};

// Words of an env's staged column; word j of thread t at tab[j * kBlock + t].
constexpr int T_RANK = 0;    // by rank 2..14: (card chips + ICR) | IMR << 16
constexpr int T_SUIT = 13;   // by suit: ICS | IMS << 16
constexpr int T_MONEY = 17;  // by suit: money a scoring card | mult if the suit scores << 16
constexpr int T_HAND = 21;   // by hand type: chips | mult << 16, base + hand + flat each
constexpr int T_HX = 33;     // by hand type: x2 exponent | (x3 exponent + flat x3) << 16
constexpr int kTab = 45;

constexpr int kWindows = 45;  // deck windows of deck counts 0..44
constexpr int kPow3 = 13, kPow15 = 21;

// A hand is two words of eight 4-bit fields, card c at bits 4c..4c+3: its
// ranks and its suits. A set of cards is a word with bit 4c set for card c.
constexpr uint32_t kLow = 0x11111111u;         // bit 0 of every field
constexpr uint32_t kResetRanks = 0x789ABCDEu;  // A K Q J 10 9 8 7, card 0 lowest
constexpr uint32_t kResetSuits = 0x33333333u;  // all Spades
constexpr int kResetDeck = 44;

__constant__ int c_base_chips[12] = {5, 10, 20, 30, 30, 35, 40, 60, 100, 120, 140, 160};
__constant__ int c_base_mult[12] = {1, 2, 2, 3, 4, 4, 4, 7, 8, 12, 14, 16};
// Entry i: the reference's chain of float32 multiplies after i steps.
__constant__ float c_pow3[kPow3] = {1.f, 3.f, 9.f, 27.f, 81.f, 243.f, 729.f, 2187.f, 6561.f,
                                    19683.f, 59049.f, 177147.f, 531441.f};
__constant__ float c_pow15[kPow15] = {
    0x1.0p+0f, 0x1.8p+0f, 0x1.2p+1f, 0x1.bp+1f, 0x1.44p+2f, 0x1.e6p+2f, 0x1.6c8p+3f,
    0x1.116p+4f, 0x1.9a1p+4f, 0x1.338cp+5f, 0x1.cd52p+5f, 0x1.59fd8p+6f, 0x1.037e2p+7f,
    0x1.853d3p+7f, 0x1.23ede4p+8f, 0x1.b5e4d6p+8f, 0x1.486bap+9f, 0x1.eca17p+9f,
    0x1.717914p+10f, 0x1.151adp+11f, 0x1.9fa838p+11f};

// Rank and suit fields of eight cards.
struct __align__(8) Window {
  uint32_t rank, suit;
};

struct RolloutSmem {
  uint32_t tab[kTab * kBlock];
  Window win[kWindows];
  float pow3[kPow3], pow15[kPow15];
};

// Fixture-deck slot -> (rank, suit): rank 2 + src % 13, suit blocks H D C S.
// The slot is clamped to the deck, as the engine's refill clips it: legal
// scripts never leave it, and an illegal one (discards past the limit)
// then still yields valid cards instead of out-of-range ranks.
__device__ __forceinline__ void deck_card(int src, int& r, int& s) {
  src = src < 0 ? 0 : (src > 51 ? 51 : src);
  const int b = (src >= 13) + (src >= 26) + (src >= 39);
  r = src - 13 * b + 2;
  s = b == 0 ? 2 : (b == 1 ? 1 : (b == 2 ? 0 : 3));
}

// The cards a refill at deck count d draws: field j holds deck slot d - 1 - j.
__device__ __forceinline__ Window deck_window(int d) {
  Window w = {0u, 0u};
  for (int j = 0; j < kCards; ++j) {
    int r, s;
    deck_card(d - 1 - j, r, s);
    w.rank |= (uint32_t)r << (4 * j);
    w.suit |= (uint32_t)s << (4 * j);
  }
  return w;
}

__device__ __forceinline__ uint32_t row_u(const float* rows, int row, size_t B, int e) {
  return (uint32_t)(int)rows[row * B + e];
}

__device__ __forceinline__ uint32_t pair16(uint32_t lo, uint32_t hi) { return lo | hi << 16; }

// The cards (bit 4c) of the set m whose field of x is 0.
__device__ __forceinline__ uint32_t zero_fields(uint32_t x, uint32_t m) {
  return ~(x | (x >> 1) | (x >> 2) | (x >> 3)) & m;
}

__device__ __forceinline__ uint32_t field(uint32_t w, int c) { return (w >> (4 * c)) & 15u; }

// evaluate_sim on the selected cards sel (k <= 5 of them: cards 0..k-1) of
// the hand (rw, sw): the top hand type and the scoring cards.
struct Eval {
  int ht;
  uint32_t smask;
};

__device__ __forceinline__ Eval evaluate5(uint32_t rw, uint32_t sw, uint32_t sel, int k,
                                          int req, bool can_skip) {
  // Of a kind: the pairs of selected cards d apart with equal ranks, and
  // the cards in one.
  int pairs = 0;
  uint32_t matched = 0u;
#pragma unroll
  for (int d = 1; d < 5; ++d) {
    const uint32_t eq = zero_fields(rw ^ (rw >> (4 * d)), sel >> (4 * d));
    pairs += __popc(eq);
    matched |= eq | (eq << (4 * d));
  }
  // pairs 0, 1, 2, 3, 4, 6, 10 -> high card, pair, two pair, three, full
  // house, four, five of a kind
  const int kind = pairs == 10 ? 9 : (int)((0x7063210u >> (4 * pairs)) & 15u);
  const bool size_ok = k >= req;

  // Flush: req >= 4 of k <= 5 cards share a suit, so card 0's or card 1's,
  // and that suit is the first argmax.
  const uint32_t f0 = zero_fields(sw ^ (field(sw, 0) * kLow), sel);
  const uint32_t f1 = zero_fields(sw ^ (field(sw, 1) * kLow), sel);
  const bool flush0 = __popc(f0) >= req;
  const uint32_t flush_m = flush0 ? f0 : f1;
  const bool has_flush = size_ok && (flush0 || __popc(f1) >= req);

  uint32_t present = 0u;
#pragma unroll
  for (int c = 0; c < 5; ++c)
    if (c < k) present |= 1u << field(rw, c);

  // Straight: descending scan 14..2 with one optional skip (Shortcut),
  // frozen at the first run of req ranks; then the wheel A-2-3-4-5,
  // which inherits the scan's used skip. Without Shortcut the scan's run
  // is the highest window of req present ranks, and the wheel a present
  // prefix of A,2,3,4(,5).
  uint32_t tmask, wmask;
  bool found, w_found;
  if (can_skip) {
    tmask = 0u;
    int run = 0;
    bool skipped = false;
    found = false;
#pragma unroll
    for (int rr = 14; rr >= 2; --rr) {
      if (!found) {
        if ((present >> rr) & 1u) { ++run; tmask |= 1u << rr; }
        else if (!skipped) { skipped = true; }
        else { run = 0; tmask = 0u; skipped = false; }
        found = run >= req;
      }
    }
    int wl = 0;
    bool dead = false;
    wmask = 0u;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int rr = i == 0 ? 14 : i + 1;
      if (!dead) {
        if ((present >> rr) & 1u) { ++wl; wmask |= 1u << rr; }
        else if (!skipped) { skipped = true; }
        else { dead = true; }
      }
    }
    w_found = wl >= req;
  } else {
    uint32_t win = present & (present >> 1) & (present >> 2) & (present >> 3);
    if (req == 5) win &= present >> 4;
    found = win != 0u;
    tmask = found ? ((1u << req) - 1u) << (31 - __clz(win)) : 0u;
    w_found = (present & 0x401Cu) == 0x401Cu && (req == 4 || ((present >> 5) & 1u));
    wmask = present & 0x403Cu;
  }
  const bool has_straight = size_ok && (found || w_found);
  const bool use_wheel = !found && w_found;
  const uint32_t run_mask = use_wheel ? wmask : tmask;
  // Straight scoring cards: the first req run members ordered by
  // (descending rank | wheel order A,2,3,4,5), then position. At most
  // one more than req can be in the run: the last one in that order drops.
  uint32_t straight_m = 0u;
#pragma unroll
  for (int c = 0; c < 5; ++c) straight_m |= ((run_mask >> field(rw, c)) & 1u) << (4 * c);
  straight_m &= sel;
  if (__popc(straight_m) > req) {
    int last = -1, drop = 0;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const int r = (int)field(rw, c);
      const int key = (use_wheel ? (r == 14 ? 0 : r - 1) : 14 - r) * kCards + c;
      if (((straight_m >> (4 * c)) & 1u) && key > last) { last = key; drop = c; }
    }
    straight_m &= ~(1u << (4 * drop));
  }

  // Top hand type: the highest type whose condition holds.
  int ht = max(kind, has_flush ? (has_straight ? 8 : 5) : (has_straight ? 4 : 0));
  if (has_flush && pairs == 4) ht = max(ht, 10);
  if (has_flush && pairs == 10) ht = 11;

  // Scoring cards of the top type.
  uint32_t smask = matched;
  if (ht == 0) smask = sel;
  if (ht == 4) smask = straight_m;
  if (ht == 5) smask = flush_m;
  if (ht == 8) smask = flush_m | straight_m;
  return {ht, smask};
}

// Phase 1: the block's windows and power tables, and thread t's column.
__device__ __forceinline__ void rollout_stage(RolloutSmem& sm, const float* __restrict__ scal,
                                              const float* __restrict__ ranktab,
                                              const float* __restrict__ suittab,
                                              const float* __restrict__ handtab, int t,
                                              int base, int n_envs) {
  if (t < kWindows) sm.win[t] = deck_window(t);
  if (t < kPow3) sm.pow3[t] = c_pow3[t];
  if (t < kPow15) sm.pow15[t] = c_pow15[t];
  const int e = base + t;
  if (e >= n_envs) return;
  const size_t B = (size_t)n_envs;
  uint32_t* col = sm.tab + t;
#pragma unroll
  for (int i = 0; i < 13; ++i) {
    const uint32_t r = 2 + i, card_chips = (r < 10 ? r : 10) + (r == 14);  // A=11, faces 10
    col[(T_RANK + i) * kBlock] = pair16(card_chips + row_u(ranktab, r, B, e),
                                        row_u(ranktab, 16 + r, B, e));
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    col[(T_SUIT + s) * kBlock] = pair16(row_u(suittab, s, B, e), row_u(suittab, 8 + s, B, e));
    col[(T_MONEY + s) * kBlock] = pair16(row_u(suittab, 16 + s, B, e),
                                         row_u(suittab, 24 + s, B, e));
  }
  const uint32_t chips_flat = row_u(scal, S_CHIPS_FLAT, B, e);
  const uint32_t mult_const = row_u(scal, S_MULT_CONST, B, e);
  const uint32_t e3_const = row_u(scal, S_E3_CONST, B, e);
#pragma unroll 2  // fewer loads in flight: no register spills at 64
  for (int h = 0; h < 12; ++h) {
    col[(T_HAND + h) * kBlock] =
        pair16(c_base_chips[h] + row_u(handtab, h, B, e) + chips_flat,
               c_base_mult[h] + row_u(handtab, 16 + h, B, e) + mult_const);
    col[(T_HX + h) * kBlock] = pair16(row_u(handtab, 32 + h, B, e),
                                      row_u(handtab, 48 + h, B, e) + e3_const);
  }
}

// Phase 2: thread t's env runs all n_steps and writes its outputs.
__device__ __forceinline__ void rollout_run(const RolloutSmem& sm, const float* __restrict__ scal,
                                            const int* __restrict__ actions,
                                            int* __restrict__ ranks_out,
                                            int* __restrict__ suits_out,
                                            int* __restrict__ stats_out,
                                            float* __restrict__ reward_out, int t, int base,
                                            int n_envs, int n_steps, int use_actions,
                                            uint32_t key0, uint32_t key1) {
  const int e = base + t;
  if (e >= n_envs) return;
  const size_t B = (size_t)n_envs;
  const uint32_t* col = sm.tab + t;
#define TAB(j) col[(j) * kBlock]

  // Small joker counts, 4 bits each, and the two mult terms, 16 bits each.
  const uint32_t counts = row_u(scal, S_TRIB, B, e) | row_u(scal, S_SEEING, B, e) << 4 |
                          row_u(scal, S_BLACKB, B, e) << 8 | row_u(scal, S_FLOWER, B, e) << 12 |
                          row_u(scal, S_BARON, B, e) << 16 | row_u(scal, S_MISPRINT, B, e) << 20 |
                          row_u(scal, S_BLOOD, B, e) << 24;
  const uint32_t mterms = pair16(row_u(scal, S_HALF20, B, e), row_u(scal, S_STM13, B, e));
  const int req = scal[S_FF * B + e] > 0.f ? 4 : 5;  // flush/straight size
  const bool can_skip = scal[S_SHORTCUT * B + e] > 0.f;
  const int blind = (int)scal[S_BLIND * B + e];
  const int money0 = (int)scal[S_MONEY0 * B + e];

  uint32_t ck0 = 0u, ck1 = 0u;  // this env's child key (sampled mode)
  if (!use_actions) threefry2x32(key0, key1, 0u, (uint32_t)e, ck0, ck1);

  uint32_t rw = kResetRanks, sw = kResetSuits;
  int deck_n = kResetDeck, money = money0, hands_left = 4, discards_left = 3, score = 0;
  int episodes = 0;
  float tot_reward = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const uint32_t ctr = (uint32_t)step * 10u;

    // ---- action ----
    int action;
    if (use_actions) {
      action = actions[(size_t)step * B + e];
    } else {
      const uint32_t bits = random_bits32(ck0, ck1, ctr);
      const float n_legal = discards_left > 0 ? 10.f : 5.f;
      const float u = (float)(bits >> 8) * 5.9604644775390625e-08f;  // * 2**-24
      action = (int)(u * n_legal);
    }
    const bool is_disc = action >= 5;
    const int k = (is_disc ? action - 5 : action) + 1;  // prefix length 1..5

    const uint32_t sel = ((1u << (4 * k)) - 1u) & kLow;

    const Eval ev = evaluate5(rw, sw, sel, k, req, can_skip);
    const int ht = ev.ht;
    const uint32_t smask = ev.smask;

    // ---- score: (chips | mult << 16) sums of exact integers ----
    uint32_t acc = TAB(T_HAND + ht);
#pragma unroll
    for (int c = 0; c < 5; ++c)
      if ((smask >> (4 * c)) & 1u) acc += TAB(T_RANK + field(rw, c) - 2);
    // by suit: the scoring cards of suit q add its chips, mult and money
    // each, and its mult-if-scoring once
    uint32_t money_d = 0u;
    int mult_suits = 0, present_cats = 0;
    bool club_scores = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t n = __popc(zero_fields(sw ^ (q * kLow), smask));
      const uint32_t mw = TAB(T_MONEY + q);
      acc += n * TAB(T_SUIT + q);
      money_d += n * (mw & 0xFFFFu);
      if (n > 0) {
        mult_suits += (int)(mw >> 16);
        ++present_cats;
        if (q == 0) club_scores = true;
      }
    }
    const int chips = (int)(acc & 0xFFFFu);
    int mult = (int)(acc >> 16) + mult_suits;
    if (__popc(smask) <= 3) mult += (int)(mterms & 0xFFFFu);
    const uint32_t queens = zero_fields(rw ^ 0xCCCCCCCCu, sel);
    const uint32_t kings = zero_fields(rw ^ 0xDDDDDDDDu, sel);
    const int n_qk = __popc((queens | kings) & smask);
    // every selected card a Spade (3) or a Club (0): both bits of its suit equal
    const bool all_sc = ((sw ^ (sw >> 1)) & sel) == 0u;
    mult += (int)(mterms >> 16) * __popc(queens);
    const int misprint = (int)((counts >> 20) & 15u);
    if (!use_actions && misprint > 0)  // +randint(0, 23) per copy
      mult += misprint * (int)(random_bits32(ck0, ck1, ctr + 1u) % 24u);

    // x-mult exponents of the exact bases 2, 3 and 1.5.
    const uint32_t hx = TAB(T_HX + ht);
    int e2 = (int)(counts & 15u) * n_qk + (int)(hx & 0xFFFFu);
    if (club_scores && present_cats > 1) e2 += (int)((counts >> 4) & 15u);
    const int blood = (int)((counts >> 24) & 15u);
    if (!use_actions && blood > 0) {  // 50% x2 per scoring Heart
      const uint32_t hearts = zero_fields(sw ^ (2u * kLow), smask);
      int coins = 0;
#pragma unroll
      for (int c = 0; c < 5; ++c)
        if ((hearts >> (4 * c)) & 1u)
          coins += (int)(random_bits32(ck0, ck1, ctr + 2u + c) & 1u);
      e2 += blood * coins;
    }
    int e3 = (int)(hx >> 16);
    if (all_sc) e3 += (int)((counts >> 8) & 15u);
    if (present_cats == 4) e3 += (int)((counts >> 12) & 15u);
    const int e15 = (int)((counts >> 16) & 15u) * __popc(kings);
    float x = __int_as_float((e2 + 127) << 23);  // 2**e2, exactly
    x = x * sm.pow3[min(e3, kPow3 - 1)] * sm.pow15[min(e15, kPow15 - 1)];
    const int delta = (int)((float)chips * ((float)mult * x));  // truncating cast

    // ---- step outcome ----
    const int new_score = score + delta;
    const bool beat = new_score >= blind;
    const float play_reward = (float)delta / 100.f + (beat ? 100.f : 0.f);
    const float reward = is_disc ? -1.f : play_reward;
    if (is_disc) {
      discards_left -= 1;
    } else {
      score = new_score;
      money += (int)money_d;
      hands_left = beat ? 0 : hands_left - 1;
    }

    // ---- remove the prefix, refill from the deck top ----
    const Window w = sm.win[min(max(deck_n, 0), kWindows - 1)];
    rw = (rw >> (4 * k)) | (w.rank << (32 - 4 * k));
    sw = (sw >> (4 * k)) | (w.suit << (32 - 4 * k));
    deck_n -= k;

    // ---- episode end + in-place reset ----
    const bool done = hands_left <= 0;
    episodes += done;
    tot_reward += reward;
    if (done) {
      rw = kResetRanks;
      sw = kResetSuits;
      deck_n = kResetDeck;
      money = money0;
      hands_left = 4;
      discards_left = 3;
      score = 0;
    }
  }
#undef TAB

#pragma unroll
  for (int c = 0; c < kCards; ++c) {
    ranks_out[c * B + e] = (int)field(rw, c);
    suits_out[c * B + e] = (int)field(sw, c);
  }
  stats_out[0 * B + e] = deck_n;
  stats_out[1 * B + e] = money;
  stats_out[2 * B + e] = hands_left;
  stats_out[3 * B + e] = discards_left;
  stats_out[4 * B + e] = score;
  stats_out[5 * B + e] = episodes;
  stats_out[6 * B + e] = hands_left <= 0;  // always 0 after autoreset
  stats_out[7 * B + e] = 0;                // spare
  reward_out[e] = tot_reward;
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
fused_rollout_kernel(const float* __restrict__ scal, const float* __restrict__ ranktab,
                     const float* __restrict__ suittab, const float* __restrict__ handtab,
                     const int* __restrict__ actions, int* __restrict__ ranks_out,
                     int* __restrict__ suits_out, int* __restrict__ stats_out,
                     float* __restrict__ reward_out, int n_envs, int n_steps,
                     int use_actions, uint32_t key0, uint32_t key1) {
  __shared__ RolloutSmem sm;
  const int base = blockIdx.x * kBlock;
  rollout_stage(sm, scal, ranktab, suittab, handtab, threadIdx.x, base, n_envs);
  __syncthreads();
  rollout_run(sm, scal, actions, ranks_out, suits_out, stats_out, reward_out, threadIdx.x,
              base, n_envs, n_steps, use_actions, key0, key1);
}

}  // namespace

#ifndef FULL_ROLLOUT_HOST_SHIM
// Launches the rollout on ``stream``. Inputs are [rows, n_envs] f32
// coefficient arrays (scal 16, ranktab 32, suittab 32, handtab 64 rows, as
// joker_coefficients makes them: non-negative integers, at most 5 copies of
// a joker) and, when use_actions, [n_steps, n_envs] i32 actions; outputs
// are ranks/suits [8, n_envs] i32, stats [8, n_envs] i32 and reward
// [n_envs] f32, allocated by the caller. (key0, key1) = seed_key(seed).
// Returns the launch's cudaError_t.
extern "C" int fused_rollout_launch(const float* scal, const float* ranktab,
                                    const float* suittab, const float* handtab,
                                    const int* actions, int* ranks_out, int* suits_out,
                                    int* stats_out, float* reward_out, int n_envs,
                                    int n_steps, int use_actions, unsigned int key0,
                                    unsigned int key1, void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  const int grid = (n_envs + kBlock - 1) / kBlock;
  fused_rollout_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      scal, ranktab, suittab, handtab, actions, ranks_out, suits_out, stats_out,
      reward_out, n_envs, n_steps, use_actions, key0, key1);
  return (int)cudaGetLastError();
}

// K4's launch shape: block, shared bytes a block, registers and stack bytes
// a thread, as built for this card.
extern "C" int fused_rollout_info(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fused_rollout_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kBlock;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return (int)cudaSuccess;
}
#endif
