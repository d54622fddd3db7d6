// One step of the flagship full-game env for one env's thread, shared by the
// CUDA kernels of the port: the whole-rollout kernel (fused_full_rollout.cu,
// K2) and the policy-collection kernels (fused_policy_rollout.cu, K3a/K3b).
//
// It mirrors how the TPU policy kernel imports _load_state, _step and
// _store_rows from the whole-rollout kernel
// (balatro_gym_tpu/ops/fused_policy_rollout.py) instead of writing them
// again: the per-env State, load_state / store_state over the packed rows,
// legal(), sample_action() and step() with its helpers live here, once.
//
// Numerics: int32 state; int32 additions that can overflow wrap through
// uint32, as XLA's do; float -> int converts saturate (__float2int_rz), as
// XLA's do; every float multiply, add and divide is an _rn intrinsic, so
// the compiler cannot contract a multiply and an add into an FMA and the
// op order is the reference's. The float tables (powers of 1.5, 0.8 and
// 1.15, hand quality, ln 10) come in from the wrapper, made from the same
// float64 master tables as the plain version's.
//
// Every game draw uses the named streams: fold_in(fold_in(key, stream),
// counter), the stream's counter bumped per draw.
//
// The State is compact: the five card channels of the 64 deck slots and of
// the 8 hand positions are uint8_t, so it takes 888 B, not 1,960. Their
// ranges: rank 0-14 (0 for an empty slot), suit 0-3, enhancement 0-8,
// edition 0-4, seal 0-4; every hand write is masked with & 15, and every
// read promotes to int, so the arithmetic is the int32 program's. The
// packed rows stay int32. hidx stays int (it holds -1). K3a and K3b keep
// the State in shared memory, one slot an env; K2 in local memory, where
// the smaller State cut its stack and spills. The slot rule: sizeof(State)
// is an odd count of 8-byte units (888 B, padded), so 32 slots read at one
// field offset fall in 16 distinct banks: at most 2-way bank conflicts.
#pragma once

#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kDeck = 64, kHand = 8, kJok = 5, kCons = 5, kShop = 10, kLvl = 12;
constexpr int kCtr = 16, kJokers = 151;

// Packed ints rows (ops/fused_full_rollout.py).
enum {
  R_HIDX = 0, R_SEL = 10, R_FD = 18, R_JOK = 26, R_CONS = 31, R_STY = 36, R_SIT = 46,
  R_SCO = 56, R_LVL = 66, R_PC = 78,
  S_HN = 90, S_JN, S_GREEN, S_BUS, S_CN, S_VOU, S_JSLOTS, S_CSLOTS,
  S_ANTE, S_ROUND, S_PHASE, S_NEED, S_CAREER, S_RCHIPS, S_BEST,
  S_MONEY, S_HL, S_DL, S_HSIZE, S_SN, S_RBASE, S_RCOST,
  S_BACT, S_BID, S_BTYPES, S_BFIRST, S_BVERD, S_BPLO, S_BPHI,
  S_HPT, S_HPA, S_JSOLD, S_DONE, S_STEPC,
  R_HIGH = 124
};

// Named streams (core/rng.py STREAMS).
enum {
  ST_DECK = 0, ST_SHOP_GEN = 2, ST_SHOP_REROLL = 3, ST_JOKER_EFFECTS = 4,
  ST_BOSS = 9, ST_CARD_ENH = 11, ST_SEAL = 13, ST_CONSUMABLE = 14
};

enum { PH_PLAY = 0, PH_SHOP = 1, PH_BLIND = 2 };
enum { IT_PACK = 1, IT_CARD = 2, IT_JOKER = 3, IT_VOUCHER = 4 };
enum { HT_ONE_PAIR = 1, HT_TWO_PAIR, HT_THREE, HT_STRAIGHT, HT_FLUSH, HT_FULL_HOUSE,
       HT_FOUR, HT_STRAIGHT_FLUSH };
enum { ENH_BONUS = 1, ENH_STEEL = 5, ENH_STONE = 6, ENH_GOLD = 7, ENH_LUCKY = 8 };
enum { ED_FOIL = 1 };
enum { SEAL_GOLD = 1, SEAL_RED = 2, SEAL_BLUE = 3, SEAL_PURPLE = 4 };
enum {  // boss ids (ops/boss.py)
  B_HOOK = 1, B_WALL, B_WHEEL, B_HOUSE, B_MARK, B_FISH, B_PSYCHIC, B_GOAD, B_WATER,
  B_WINDOW, B_MANACLE, B_EYE, B_MOUTH, B_PLANT, B_SERPENT, B_PILLAR, B_NEEDLE,
  B_HEAD, B_CLUB, B_TOOTH, B_FLINT, B_OXIDE, B_ARM, B_VIOLET, B_VERDANT, N_BOSS = 29
};
enum {  // consumable ids (engine/consumable_logic.py)
  C_FOOL = 1, C_MAGICIAN, C_HIGH_PRIESTESS, C_EMPRESS, C_EMPEROR, C_HIEROPHANT,
  C_LOVERS, C_CHARIOT, C_STRENGTH, C_HERMIT, C_WHEEL, C_JUSTICE, C_HANGED_MAN,
  C_DEATH, C_TEMPERANCE, C_DEVIL, C_TOWER, C_STAR, C_MOON, C_SUN, C_JUDGEMENT,
  C_WORLD,
  C_PLANET_BASE = 30,
  C_FAMILIAR = 50, C_GRIM, C_INCANTATION, C_TALISMAN, C_AURA, C_WRAITH, C_SIGIL,
  C_OUIJA, C_ECTOPLASM, C_IMMOLATE, C_ANKH, C_DEJA_VU, C_HEX, C_TRANCE, C_MEDIUM,
  C_CRYPTID, C_THE_SOUL, C_BLACK_HOLE,
  C_ENUMNAME_OFFSET = 100
};

// Offsets of the float tables the wrapper passes in.
enum { T_P15 = 0, T_P08 = 96, T_P115 = 108, T_HQ = 208, T_LOG10 = 220, kFTab = 221 };

__constant__ int c_base_chips[12] = {5, 10, 20, 30, 30, 35, 40, 60, 100, 120, 140, 160};
__constant__ int c_base_mult[12] = {1, 2, 2, 3, 4, 4, 4, 7, 8, 12, 14, 16};
__constant__ int c_blind[24] = {300, 450, 600, 450, 675, 900, 600, 900, 1200,
                                900, 1350, 1800, 1350, 2025, 2700, 2100, 3150, 4200,
                                3300, 4950, 6600, 5250, 7875, 10500};
__constant__ int c_planet_obs[12] = {38, 30, 31, 32, 33, 34, 35, 36, 37, 39, 40, 41};
__constant__ int c_planet_hand[12] = {1, 2, 3, 4, 5, 6, 7, 8, 0, 9, 10, 11};
__constant__ int c_enh_tarot[23] = {0, 0, 8, 0, 2, 0, 1, 3, 5, 0, 0, 0, 4, 0, 0, 0, 7, 6,
                                    0, 0, 0, 0, 0};
__constant__ int c_enh_count[23] = {0, 0, 2, 0, 2, 0, 2, 1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1,
                                    0, 0, 0, 0, 0};
__constant__ int c_wraith[14] = {137, 138, 139, 140, 0, 142, 143, 144, 145, 146, 147, 148,
                                 149, 150};
__constant__ int c_soul[5] = {146, 147, 148, 149, 150};
__constant__ int c_editions3[3] = {1, 2, 3};
__constant__ int c_enh_pool7[7] = {1, 2, 3, 4, 5, 7, 8};
__constant__ int c_pack_costs[5] = {250, 500, 600, 900, 1300};
__constant__ int c_voucher_costs[2] = {600, 750};
// Shop base cost per joker id (0: legendary, never offered).
__constant__ int c_jcost[kJokers] = {
    0, 2, 5, 5, 5, 5, 3, 4, 4, 4, 4, 3, 4, 4, 4, 4, 5, 8, 7, 5, 1, 6, 5, 5, 6, 5,
    5, 4, 5, 5, 4, 8, 7, 4, 4, 4, 6, 5, 5, 4, 4, 4, 4, 5, 6, 5, 4, 6, 6, 5, 5, 8,
    3, 5, 6, 6, 5, 4, 4, 4, 4, 4, 6, 5, 7, 4, 6, 6, 7, 7, 7, 8, 8, 7, 6, 8, 7, 5,
    5, 6, 6, 6, 6, 4, 5, 4, 6, 4, 4, 6, 6, 6, 8, 6, 6, 6, 5, 5, 6, 8, 6, 4, 6, 6,
    4, 9, 5, 5, 6, 6, 4, 6, 6, 7, 6, 4, 7, 7, 7, 7, 6, 5, 6, 10, 8, 7, 4, 6, 6, 7,
    8, 8, 8, 8, 8, 8, 7, 8, 10, 6, 5, 7, 6, 8, 8, 7, 0, 0, 0, 0, 0};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// XLA's float -> int32 convert: truncate, saturate, NaN -> 0.
__device__ __forceinline__ int f2i(float x) { return __float2int_rz(x); }
// The reference's _trunc (floor) and convert.
__device__ __forceinline__ int fl(float x) { return __float2int_rz(floorf(x)); }
__device__ __forceinline__ int wadd(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ bool bit64(uint64_t m, int d) { return (m >> d) & 1ull; }

// One env's state. The card channels of the deck and the hand are bytes
// (see the note above); every other field is a 32- or 64-bit word.
struct State {
  uint8_t rk[kDeck], su[kDeck], en[kDeck], ed[kDeck], sl[kDeck];
  uint64_t al, ih, bp;                 // alive, in hand, boss-played slot sets
  int hidx[kHand];                     // deck slot of a hand position, -1 if empty
  uint8_t hrk[kHand], hsu[kHand], hen[kHand], hed[kHand], hsl[kHand];
  uint32_t sel, fd, high;              // hand-position masks (8 bits)
  int jok[kJok], cons[kCons], sty[kShop], sit[kShop], sco[kShop], lvl[kLvl], pc[kLvl];
  int hn, jn, green, bus, cn, vou, jslots, cslots, ante, round, phase, need, career;
  int rchips, best, money, hl, dl, hsize, sn, rbase, rcost, bid, btypes, bverd;
  int hpt, hpa, jsold, sc;
  bool bact, bfirst, done;
  TfKey key;
  uint32_t ctr[kCtr];
  uint32_t pad[2];                     // the slot rule (see the note above)
};
static_assert(sizeof(State) % 16 == 8, "an odd count of 8-byte units keeps bank conflicts 2-way");

// Next draw key of stream `sid`; bumps its counter.
__device__ __forceinline__ TfKey next_key(State& s, int sid) {
  const TfKey k = tf_fold_in(tf_fold_in(s.key, (uint32_t)sid), s.ctr[sid]);
  s.ctr[sid] += 1u;
  return k;
}

__device__ __forceinline__ int count_joker(const State& s, int j) {
  int n = 0;
  for (int i = 0; i < kJok; ++i) n += s.jok[i] == j;
  return n;
}

// Deck-slot set of the hand positions in `gate` (slots clamped to [0, 63]).
__device__ uint64_t slot_set(const State& s, uint32_t gate) {
  uint64_t m = 0;
  for (int p = 0; p < kHand; ++p)
    if (((gate >> p) & 1u) && s.hidx[p] >= 0) m |= 1ull << clampi(s.hidx[p], 0, kDeck - 1);
  return m;
}

__device__ __forceinline__ uint32_t present_mask(int hn) {
  return hn <= 0 ? 0u : (hn >= kHand ? 0xFFu : ((1u << hn) - 1u));
}

// First k set positions of a mask.
__device__ uint32_t first_k(uint32_t m, int k) {
  uint32_t out = 0;
  int c = 0;
  for (int p = 0; p < kHand; ++p)
    if ((m >> p) & 1u) {
      ++c;
      if (c <= k) out |= 1u << p;
    }
  return out;
}

// Stable removal of hand positions `rem` (list.remove order).
__device__ void remove_positions(State& s, uint32_t rem) {
  const uint32_t live = present_mask(s.hn);
  s.ih &= ~slot_set(s, rem & live);
  int pk[kHand];
  int n = 0;
  for (int p = 0; p < kHand; ++p)
    if (((live >> p) & 1u) && !((rem >> p) & 1u))
      pk[n++] = s.hrk[p] | (s.hsu[p] << 4) | (s.hen[p] << 8) | (s.hed[p] << 12) |
                (s.hsl[p] << 16) | ((s.hidx[p] > 0 ? s.hidx[p] : 0) << 20);
  for (int q = 0; q < kHand; ++q) {
    const bool got = q < n && pk[q] >= 0;
    const int w = q < n ? pk[q] : 0;
    s.hidx[q] = got ? w >> 20 : -1;
    s.hrk[q] = got ? w & 15 : 0;
    s.hsu[q] = got ? (w >> 4) & 15 : 0;
    s.hen[q] = got ? (w >> 8) & 15 : 0;
    s.hed[q] = got ? (w >> 12) & 15 : 0;
    s.hsl[q] = got ? (w >> 16) & 15 : 0;
  }
  s.hn = n;
}

// Top up the hand with the lowest available deck slots.
__device__ void draw_pass(State& s) {
  const int need = clampi(s.hsize - s.hn, 0, kHand);
  int cum = 0;
  for (int d = 0; d < kDeck && cum < need; ++d) {
    if (!bit64(s.al, d) || bit64(s.ih, d)) continue;
    ++cum;
    s.ih |= 1ull << d;
    const int p = s.hn + cum - 1;
    if (p < 0 || p >= kHand) continue;
    const int w = s.rk[d] | (s.su[d] << 4) | (s.en[d] << 8) | (s.ed[d] << 12) |
                  (s.sl[d] << 16) | (d << 20);
    if (w < 0) continue;
    s.hidx[p] = w >> 20;
    s.hrk[p] = w & 15;
    s.hsu[p] = (w >> 4) & 15;
    s.hen[p] = (w >> 8) & 15;
    s.hed[p] = (w >> 12) & 15;
    s.hsl[p] = (w >> 16) & 15;
  }
  s.hn += cum;
}

__device__ bool legal(const State& s, int a) {
  if (s.done || a < 0 || a >= 60) return false;
  if (s.phase == PH_PLAY) {
    const bool any_sel = s.sel != 0;
    if (a == 0) return any_sel;
    if (a == 1) return any_sel && s.dl > 0;
    if (a >= 2 && a < 10) return a - 2 < (s.hn < kHand ? s.hn : kHand);
    if (a >= 10 && a < 15) return a - 10 < s.cn;
    return false;
  }
  if (s.phase == PH_SHOP) {
    if (a >= 20 && a < 30) return a - 20 < s.sn && s.money >= s.sco[a - 20];
    if (a == 30) return s.money >= s.rcost;
    if (a == 31) return true;
    if (a >= 32 && a < 37) return a - 32 < s.jn;
    return false;
  }
  if (s.phase == PH_BLIND) return a >= 45 && a < 49;
  return false;
}

// Uniform over the legal set from 32 random bits (the TPU kernel's ladder).
__device__ int sample_action(const State& s, uint32_t bits) {
  const int cp = s.sel != 0;
  const int cd = (s.sel != 0) && s.dl > 0;
  const int ns = s.hn < kHand ? s.hn : kHand;
  int nb = 0;
  bool afford[kShop];
  for (int r = 0; r < kShop; ++r) {
    afford[r] = r < s.sn && s.money >= s.sco[r];
    nb += afford[r];
  }
  const int rr = s.money >= s.rcost;
  int T = 0;
  if (s.phase == PH_PLAY) T = cp + cd + ns + s.cn;
  else if (s.phase == PH_SHOP) T = nb + rr + 1 + s.jn;
  else if (s.phase == PH_BLIND) T = 4;
  if (T <= 0) return 59;
  const float u = fmul((float)(bits >> 8), 5.9604644775390625e-08f);  // 2**-24
  int t = f2i(fmul(u, (float)T));
  if (t > T - 1) t = T - 1;
  if (s.phase == PH_PLAY) {
    if (t < cp) return 0;
    if (t < cp + cd) return 1;
    if (t < cp + cd + ns) return 2 + (t - cp - cd);
    return 10 + (t - cp - cd - ns);
  }
  if (s.phase == PH_SHOP) {
    if (t < nb) {
      int cum = 0, a = 0;
      for (int r = 0; r < kShop; ++r) {
        if (afford[r] && cum == t) a = 20 + r;
        cum += afford[r];
      }
      return a;
    }
    if (t < nb + rr) return 30;
    if (t < nb + rr + 1) return 31;
    return 32 + (t - nb - rr - 1);
  }
  return t < 3 ? 45 + t : 48;
}

// Hand type of the union of the played selection and the stale highlights,
// read from deck slots 0-7 (the reference classifies game.deck[i] for i in
// highlighted_indexes). Ranks are clamped to [2, 14]: the plain version
// asserts that they lie there.
__device__ int classify(const State& s, uint32_t uni) {
  int rc[13] = {0};
  int sc[4] = {0};
  int n_union = 0;
  for (int p = 0; p < kHand; ++p) {
    if (!((uni >> p) & 1u)) continue;
    ++n_union;
    rc[clampi(s.rk[p], 2, 14) - 2] += 1;
    const int su = s.su[p] & 7;
    if (su < 4) sc[su] += 1;
  }
  int max_c = 0, max2 = 0, first = -1;
  for (int r = 0; r < 13; ++r)
    if (rc[r] > max_c) { max_c = rc[r]; first = r; }
  for (int r = 0; r < 13; ++r)
    if (r != first && rc[r] > max2) max2 = rc[r];
  const int n_suits = (sc[0] > 0) + (sc[1] > 0) + (sc[2] > 0) + (sc[3] > 0);
  const bool five = n_union >= 5;
  const bool is_flush = n_suits == 1 && five;
  uint32_t pm = 0;
  for (int r = 0; r < 13; ++r) pm |= (uint32_t)(rc[r] > 0) << r;
  bool any_win = false;
  for (int r0 = 0; r0 < 9; ++r0) any_win |= ((pm >> r0) & 31u) == 31u;
  const bool ace_low = (pm & 0x100Fu) == 0x100Fu;
  const bool is_straight = __popc(pm) >= 5 && (any_win || ace_low);
  int ht = 0;
  if (max_c == 2) ht = HT_ONE_PAIR;
  if (max_c == 2 && max2 == 2) ht = HT_TWO_PAIR;
  if (max_c == 3) ht = HT_THREE;
  if (is_straight && five) ht = HT_STRAIGHT;
  if (is_flush) ht = HT_FLUSH;
  if (max_c == 3 && max2 == 2) ht = HT_FULL_HOUSE;
  if (max_c == 4) ht = HT_FOUR;
  if (is_straight && is_flush) ht = HT_STRAIGHT_FLUSH;
  return ht;
}

enum { PLAY_BLOCKED, PLAY_CONT, PLAY_BEAT, PLAY_FAIL };

// The play action up to the round advance. Returns its outcome; sets the
// reward and the boss key the refreshed hand's effects draw from.
__device__ int play(State& s, const float* ft, float& reward, TfKey& k_boss) {
  const uint32_t sel = s.sel & present_mask(s.hn);
  const uint32_t uni = s.high | sel;
  const int n_played = __popc(sel);
  const int ht = classify(s, uni);
  const int level = s.lvl[ht] < 15 ? s.lvl[ht] : 15;
  const int base_c0 = c_base_chips[ht] + (level - 1) * 10;
  const int base_m0 = c_base_mult[ht] + (level - 1);

  // boss play restriction: a blocked play only highlights
  const int ht_bit = (s.btypes >> ht) & 1;
  const bool boss_ok = !s.bact ||
      ((s.bid != B_PSYCHIC || n_played == 5) && (s.bid != B_EYE || ht_bit == 0) &&
       (s.bid != B_MOUTH || s.btypes == 0 || ht_bit == 1) &&
       (s.bid != B_VERDANT || n_played >= s.bverd));
  if (!boss_ok) {
    s.high = uni;
    reward = -1.f;
    return PLAY_BLOCKED;
  }
  const TfKey k_eff = next_key(s, ST_CARD_ENH);
  next_key(s, ST_JOKER_EFFECTS);   // drawn, never consumed
  k_boss = next_key(s, ST_BOSS);

  int chips = base_c0, extra_money = 0, n_blue = 0, n_red = 0, n_steel = 0;
  int n_face = 0, n_face13 = 0, pillar = 0;
  for (int p = 0; p < kHand; ++p) {
    const bool on = (sel >> p) & 1u;
    const int r = s.hrk[p], e = s.hen[p];
    if (on) {
      chips += (r < 10 ? r : 10) + (r == 14) + (e == ENH_BONUS ? 30 : (e == ENH_STONE ? 50 : 0))
               + (s.hed[p] == ED_FOIL ? 50 : 0);
      if (e == ENH_LUCKY) {
        const TfKey pk = tf_fold_in(k_eff, (uint32_t)p);
        if (tf_uniform_f32(tf_bits32(pk, 2u)) < 0.0667f) extra_money += 20;
      }
      extra_money += s.hsl[p] == SEAL_GOLD ? 3 : 0;
      n_blue += s.hsl[p] == SEAL_BLUE;
      n_red += s.hsl[p] == SEAL_RED;
      n_face += r >= 11;
      n_face13 += r >= 11 && r <= 13;
      pillar += bit64(s.bp, clampi(s.hidx[p], 0, kDeck - 1));
    } else if (p < s.hn && e == ENH_STEEL) {
      ++n_steel;
    }
  }
  const int base_score = fl(fmul((float)chips, (float)base_m0));
  int final_ = fl(fmul((float)base_score, ft[T_P15 + clampi(n_steel, 0, 95)]));

  // boss scoring ratio
  int c = base_c0, m = base_m0;
  if (s.bid == B_FLINT) { c >>= 1; m >>= 1; }
  if (s.bid == B_OXIDE) c = 0;
  if (s.bid == B_ARM) { c = fl(fmul((float)c, 0.75f)); m = fl(fmul((float)m, 0.75f)); }
  const int nd = s.bid == B_PLANT ? n_face13 : (s.bid == B_VIOLET ? n_played
                                                : (s.bid == B_PILLAR ? pillar : 0));
  if (nd > 0) {
    const float pen = ft[T_P08 + clampi(nd, 0, 11)];
    c = fl(fmul((float)c, pen));
    m = fl(fmul((float)m, pen));
  }
  float ratio = fmul(fdiv((float)c, (float)(base_c0 > 1 ? base_c0 : 1)),
                     fdiv((float)m, (float)(base_m0 > 1 ? base_m0 : 1)));
  if (!(s.bact && base_c0 > 0 && base_m0 > 0)) ratio = 1.f;
  final_ = fl(fmul((float)final_, ratio));
  final_ = fl(fmul((float)final_, fadd(1.f, fmul(0.5f, (float)n_red))));

  const float need_f = (float)(s.need > 1 ? s.need : 1);
  const float old_prog = fminf(1.f, fdiv((float)s.rchips, need_f));
  const int round2 = wadd(s.rchips, final_);
  const float new_prog = fminf(1.f, fdiv((float)round2, need_f));

  // shaped reward (from the pre-play state)
  const float milestone =
      (old_prog < 0.25f && new_prog >= 0.25f) ? 5.f
      : (old_prog < 0.5f && new_prog >= 0.5f) ? 10.f
      : (old_prog < 0.75f && new_prog >= 0.75f) ? 15.f
      : (old_prog < 1.f && new_prog >= 1.f) ? 25.f : 0.f;
  const float score_reward = s.ante <= 3
      ? fminf(10.f, fdiv((float)final_, 100.f))
      : fminf(10.f, fdiv(fmul(3.f, logf((float)(final_ > 1 ? final_ : 1))), ft[T_LOG10]));
  const float efficiency = (ht >= HT_THREE && n_played <= 3) ? 2.f
      : (ht >= HT_FLUSH && n_played == 5) ? 1.f
      : (n_played <= 4 && s.hl <= 2) ? 1.5f : 0.f;
  const bool flush_syn = count_joker(s, 18) + count_joker(s, 69) + count_joker(s, 113) > 0;
  const bool pair_syn = count_joker(s, 40) + count_joker(s, 39) + count_joker(s, 6) +
                        count_joker(s, 7) > 0;
  const bool face_syn = count_joker(s, 33) + count_joker(s, 104) + count_joker(s, 42) > 0;
  float synergy = (ht == HT_FLUSH && flush_syn) ? 2.f : 0.f;
  const bool pairish = ht == HT_ONE_PAIR || ht == HT_TWO_PAIR || ht == HT_THREE;
  synergy = fadd(synergy, (pairish && pair_syn) ? 1.5f : 0.f);
  synergy = fadd(synergy, (n_face > 0 && face_syn) ? fmul(0.5f, (float)n_face) : 0.f);
  const float strategy = (new_prog > 0.7f && s.hl >= 3) ? 2.f
      : (new_prog < 0.3f && ht >= HT_FLUSH) ? 3.f : 0.f;
  const float ante_bonus = s.ante >= 4 ? fminf(5.f, fmul((float)(s.ante - 3), 0.5f)) : 0.f;
  reward = fadd(fmul(15.f, new_prog), milestone);
  reward = fadd(reward, score_reward);
  reward = fadd(reward, fmul(ft[T_HQ + ht], 2.f));
  reward = fadd(reward, fmul(efficiency, 1.5f));
  reward = fadd(reward, fmul(synergy, 3.f));
  reward = fadd(reward, fmul(strategy, 2.f));
  reward = fadd(reward, ante_bonus);
  reward = fminf(reward, 100.f);
  const bool beat = round2 >= s.need;
  const bool fail = !beat && s.hl <= 1;
  if (beat) reward = fadd(reward, fminf(50.f, fadd(25.f, fmul(10.f, (float)s.ante))));
  if (fail) reward = fadd(reward, fmul(-50.f, fsub(1.f, new_prog)));

  // state update
  const int n_create = min(n_blue, clampi(s.cslots - s.cn, 0, kCons));
  for (int c5 = 0; c5 < kCons; ++c5)
    if (c5 >= s.cn && c5 < s.cn + n_create) s.cons[c5] = c_planet_obs[ht];
  s.cn += n_create;
  s.money += extra_money;
  s.rchips = round2;
  s.career = wadd(s.career, final_);
  s.hpt += 1;
  s.hpa += 1;
  s.best = s.best > final_ ? s.best : final_;
  s.pc[ht] += 1;
  s.green += 1;
  s.sel = 0;
  s.high = uni;
  s.bus = n_face13 > 0 ? 0 : s.bus + 1;
  if (s.bact) {
    s.btypes |= 1 << ht;
    s.bp |= slot_set(s, sel);
    if (s.bid == B_VERDANT) s.bverd = s.bverd + 1 < 7 ? s.bverd + 1 : 7;
  }
  s.bfirst = s.bfirst && !s.bact;
  if (beat) return PLAY_BEAT;
  if (fail) return PLAY_FAIL;
  s.hl -= 1;
  return PLAY_CONT;
}

// The discard action, up to the refill. Returns the reward.
__device__ float discard(State& s) {
  const uint32_t sel = s.sel & present_mask(s.hn);
  const TfKey k_seal = next_key(s, ST_SEAL);
  int n_purple = 0, n_face = 0;
  for (int p = 0; p < kHand; ++p) {
    if (!((sel >> p) & 1u)) continue;
    n_purple += s.hsl[p] == SEAL_PURPLE;
    n_face += s.hrk[p] >= 11 && s.hrk[p] <= 13;
  }
  const int n_tarot = min(n_purple, clampi(s.cslots - s.cn, 0, kCons));
  for (int c5 = 0; c5 < kCons; ++c5)
    if (c5 >= s.cn && c5 < s.cn + n_tarot)
      s.cons[c5] = tf_randint(tf_fold_in(k_seal, (uint32_t)c5), 1, 23, 0u);
  const bool trading = count_joker(s, 95) > 0 && s.dl == 3 && __popc(sel) == 1;
  const bool faceless = count_joker(s, 57) > 0 && n_face >= 3;
  const int money_disc = (trading ? 3 : 0) + (faceless ? 5 : 0);
  const int n_syn = count_joker(s, 57) + count_joker(s, 130) + count_joker(s, 82) +
                    count_joker(s, 77);
  const float progress = fdiv((float)s.rchips, (float)(s.need > 1 ? s.need : 1));
  const int dl_post = s.dl - 1;
  float reward = fadd(fadd(0.2f, fmul(0.5f, (float)n_syn)), fdiv((float)money_disc, 5.f));
  reward = fadd(reward, (progress < 0.5f && dl_post > 1) ? 0.5f
                        : (progress > 0.8f && dl_post > 1) ? -0.3f : 0.f);
  const uint32_t rem = (sel | s.high) & present_mask(s.hn);
  s.money += money_disc;
  s.cn += n_tarot;
  s.green = s.green - 1 > 0 ? s.green - 1 : 0;
  s.dl -= 1;
  s.sel = 0;
  s.high = 0;
  remove_positions(s, rem);
  return reward;
}

__device__ __forceinline__ void append5(State& s, int val, bool gate) {
  if (gate && s.cn < kCons) {
    s.cons[s.cn] = val;
    s.cn += 1;
  }
}

// Fill the highest free deck slots with up to 4 new cards; clears stale
// Pillar marks on the reused slots.
__device__ void create_cards(State& s, int n, const int* rk4, const int* su4, const int* en4) {
  int csum = 0;
  uint64_t take = 0;
  for (int d = kDeck - 1; d >= 0; --d)
    if (!bit64(s.al, d)) {
      ++csum;
      if (csum <= n) take |= 1ull << d;
    }
  int k = 0;
  for (int d = 0; d < kDeck; ++d) {
    if (!bit64(take, d)) continue;
    const int w = k < 4 ? rk4[k] | (su4[k] << 4) | (en4[k] << 8) : 0;
    s.rk[d] = w & 15;
    s.su[d] = (w >> 4) & 15;
    s.en[d] = (w >> 8) & 15;
    s.ed[d] = 0;
    s.sl[d] = 0;
    ++k;
  }
  s.al |= take;
  s.bp &= ~take;
}

// Use of consumable slot a - 10. Returns the reward.
__device__ float use_consumable(State& s, int a) {
  const int idx = clampi(a - 10, 0, kCons - 1);
  const int raw = s.cons[idx];
  const int cid = raw >= C_ENUMNAME_OFFSET ? raw - C_ENUMNAME_OFFSET : raw;
  const uint32_t sel = s.sel & present_mask(s.hn);
  const int n_sel = __popc(sel);
  const TfKey key = next_key(s, ST_CONSUMABLE);
  const TfKey k1 = tf_split_child(key, 0), k2 = tf_split_child(key, 1);
  const TfKey k3 = tf_split_child(key, 2), k4 = tf_split_child(key, 3);
  const int cn0 = s.cn, cslots0 = s.cslots;
  const uint32_t tgt1 = first_k(sel, 1), tgt2 = first_k(sel, 2);

  float reward = 0.f;
  bool success = false;
  int pending = 0, pend0 = 0, pend1 = 0;
  uint64_t kill = 0;
  int cr_n = 0, cr_rk[4] = {0}, cr_su[4] = {0}, cr_en[4] = {0};

  const uint64_t t164 = slot_set(s, tgt1);   // deck slot of the first selected card
  bool destroy = false;
  auto set_edition = [&](int v) {
    if (t164) s.ed[__ffsll(t164) - 1] = v;
    s.hed[__ffs(tgt1) - 1] = v;
  };

  if (cid >= 1 && cid <= 22 && c_enh_tarot[cid] > 0) {          // enhancement tarots
    if (n_sel >= 1) {
      const uint32_t tgt = first_k(sel, c_enh_count[cid]);
      const uint64_t slots = slot_set(s, tgt);
      for (int d = 0; d < kDeck; ++d)
        if (bit64(slots, d)) s.en[d] = c_enh_tarot[cid];
      for (int p = 0; p < kHand; ++p)
        if ((tgt >> p) & 1u) s.hen[p] = c_enh_tarot[cid];
      reward = fadd(reward, fmul(2.f, (float)__popc(tgt)));
      success = true;
    }
  } else if (cid == C_TALISMAN || cid == C_DEJA_VU || cid == C_TRANCE || cid == C_MEDIUM) {
    if (n_sel >= 1) {                                          // seal spectrals
      const int v = cid == C_TALISMAN ? SEAL_BLUE : cid == C_DEJA_VU ? SEAL_GOLD
                    : cid == C_TRANCE ? SEAL_RED : SEAL_PURPLE;
      if (t164) s.sl[__ffsll(t164) - 1] = v;
      s.hsl[__ffs(tgt1) - 1] = v;
      reward = fadd(reward, 2.f);
      success = true;
    }
  } else if (cid == C_AURA) {
    if (n_sel >= 1) {
      set_edition(c_editions3[tf_randint(k1, 0, 3, 0u)]);
      reward = fadd(reward, 2.f);
      success = true;
    }
  } else if (cid == C_WHEEL) {
    if (n_sel >= 1 && tf_uniform_f32(tf_bits32(k1, 0u)) < 0.25f) {
      set_edition(c_editions3[tf_randint(k2, 0, 3, 0u)]);
      reward = fadd(reward, 2.f);
      success = true;
    }
  } else if (cid == C_STRENGTH) {
    if (n_sel >= 1) {
      int n = 0;
      for (int p = 0; p < kHand; ++p) n += ((tgt2 >> p) & 1u) && s.hrk[p] < 14;
      reward = fadd(reward, fmul(2.f, (float)n));
      success = true;
    }
  } else if (cid == C_DEATH) {
    if (n_sel >= 2) {
      reward = fadd(reward, 4.f);
      success = true;
    }
  } else if (cid == C_STAR || cid == C_MOON || cid == C_SUN || cid == C_WORLD) {
    if (n_sel >= 1) {
      reward = fadd(reward, fmul(2.f, (float)(n_sel < 3 ? n_sel : 3)));
      success = true;
    }
  } else if (cid == C_HERMIT || cid == C_TEMPERANCE) {
    const int gain = cid == C_HERMIT ? clampi(s.money, 0, 20)
                                     : (5 * s.jn < 50 ? 5 * s.jn : 50);
    s.money += gain;
    reward = fadd(reward, fdiv((float)gain, 10.f));
    success = true;
  } else if (cid >= C_PLANET_BASE && cid < C_PLANET_BASE + 12) {
    s.lvl[c_planet_hand[cid - C_PLANET_BASE]] += 1;
    reward = fadd(reward, 10.f);
    success = true;
  } else if (cid == C_HIGH_PRIESTESS || cid == C_EMPEROR || cid == C_JUDGEMENT ||
             (cid == C_FOOL && cn0 > 0)) {
    // consumable-creating tarots; the reference appends their items twice
    const int p9_0 = C_PLANET_BASE + tf_randint(k2, 0, 9, 0u);
    const int p9_1 = C_PLANET_BASE + tf_randint(k2, 0, 9, 1u);
    const bool gate1 = cn0 < cslots0, gate2 = cn0 + 1 < cslots0;
    if (cid == C_FOOL) {
      const int fi = tf_randint(k2, 0, cn0 > 1 ? cn0 : 1, 0u);
      const int pick = fi >= 0 && fi < kCons ? s.cons[fi] : 0;
      const int n0 = s.cn;
      append5(s, pick, true);
      pending = s.cn - n0;
      pend0 = pick;
      pend1 = p9_1;
    } else {
      int v0 = p9_0, v1 = p9_1;
      const int n0 = s.cn;
      if (cid == C_JUDGEMENT) {
        append5(s, p9_0, gate1);
      } else {
        if (cid == C_EMPEROR) {
          v0 = C_ENUMNAME_OFFSET + 1 + tf_randint(k2, 0, 22, 0u);
          v1 = C_ENUMNAME_OFFSET + 1 + tf_randint(k2, 0, 22, 1u);
        }
        append5(s, v0, gate1);
        const int n1 = s.cn;
        append5(s, v1, gate2 && n1 > n0);
      }
      pending = s.cn - n0;
      pend0 = v0;
      pend1 = v1;
    }
    reward = fadd(reward, fmul(5.f, (float)pending));
    success = true;
  } else if (cid == C_WRAITH || cid == C_THE_SOUL) {
    if (s.jn < s.jslots) {
      const int jid = cid == C_THE_SOUL ? c_soul[tf_randint(k3, 0, 5, 0u)]
                                        : c_wraith[tf_randint(k3, 0, 14, 0u)];
      if (jid > 0) {
        s.jok[clampi(s.jn, 0, kJok - 1)] = jid;
        s.jn += 1;
      }
      if (cid == C_WRAITH) s.hsize -= 1;
      reward = fadd(reward, 15.f);
      success = true;
    }
  } else if (cid == C_ECTOPLASM || cid == C_ANKH || cid == C_HEX) {
    if (s.jn > 0) {
      if (cid == C_ECTOPLASM) s.hsize -= 1;
      if (cid == C_ANKH) reward = fadd(reward, 15.f);
      success = true;
    }
  } else if (cid == C_BLACK_HOLE) {
    success = true;
  } else if (cid == C_HANGED_MAN) {
    if (n_sel >= 1) {
      kill = slot_set(s, tgt2);
      destroy = true;
      reward = fadd(reward, fmul(2.f, (float)__popc(tgt2)));
      success = true;
    }
  } else if (cid == C_FAMILIAR || cid == C_GRIM || cid == C_INCANTATION) {
    if (n_sel >= 1) {
      kill = t164;
      destroy = true;
      cr_n = cid == C_FAMILIAR ? 3 : (cid == C_GRIM ? 2 : 4);
      const TfKey k9 = tf_fold_in(k4, 9u), k10 = tf_fold_in(k4, 10u);
      for (int k = 0; k < 4; ++k) {
        const TfKey ck = tf_split_child(k4, (uint32_t)k);
        cr_rk[k] = cid == C_FAMILIAR ? 11 + tf_randint(ck, 0, 3, 0u)
                   : cid == C_GRIM ? 14 : 2 + tf_randint(ck, 0, 9, 0u);
        cr_su[k] = tf_randint(k9, 0, 4, (uint32_t)k);
        cr_en[k] = c_enh_pool7[tf_randint(k10, 0, 7, (uint32_t)k)];
      }
      reward = fadd(reward, fadd(fmul(3.f, (float)cr_n), 1.f));
      success = true;
    }
  } else if (cid == C_IMMOLATE) {
    // top 5 of the packed words key25 | 127 - slot over the alive slots
    uint32_t r[5] = {0u, 0u, 0u, 0u, 0u};
    for (int d = 0; d < kDeck; ++d) {
      if (!bit64(s.al, d)) continue;
      uint32_t t = (tf_bits32(k3, (uint32_t)d) & 0xFFFFFF80u) | (uint32_t)(127 - d);
      for (int i = 0; i < 4; ++i) {
        const uint32_t lo = r[i] < t ? r[i] : t;
        r[i] = r[i] > t ? r[i] : t;
        t = lo;
      }
      r[4] = r[4] > t ? r[4] : t;
    }
    const int n_kill = min(5, __popcll(s.al));
    for (int i = 0; i < n_kill; ++i) kill |= 1ull << (127 - (int)(r[i] & 127u));
    s.money += 20;
    destroy = true;
    reward = fadd(reward, fadd((float)n_kill, 2.f));
    success = true;
  } else if (cid == C_CRYPTID) {
    if (n_sel >= 1) {
      const int p = __ffs(tgt1) - 1;
      cr_n = 2;
      for (int k = 0; k < 4; ++k) {
        cr_rk[k] = s.hrk[p];
        cr_su[k] = s.hsu[p];
        cr_en[k] = s.hen[p];
      }
      reward = fadd(reward, 6.f);
      success = true;
    }
  } else if (cid == C_SIGIL || cid == C_OUIJA) {
    if (s.hn > 0) {
      const int conv_suit = tf_randint(k3, 0, 4, 0u);
      const int conv_rank = 2 + tf_randint(k3, 0, 13, 0u);
      for (int d = 0; d < kDeck; ++d)
        if (bit64(s.ih, d)) {
          if (cid == C_SIGIL) s.su[d] = conv_suit;
          else s.rk[d] = conv_rank;
        }
      for (int p = 0; p < kHand && p < s.hn; ++p) {
        if (cid == C_SIGIL) s.hsu[p] = conv_suit;
        else s.hrk[p] = conv_rank;
      }
      if (cid == C_OUIJA) s.hsize -= 1;
      reward = fadd(reward, fmul(2.f, (float)s.hn));
      success = true;
    }
  }

  // one destroy, then one create, as the reference merges them
  uint32_t rem = 0;
  s.al &= ~kill;
  for (int p = 0; p < kHand; ++p)
    if (s.hidx[p] >= 0 && bit64(kill, clampi(s.hidx[p], 0, kDeck - 1))) rem |= 1u << p;
  if (cr_n > 0) create_cards(s, cr_n, cr_rk, cr_su, cr_en);

  // consume on success: pop slot idx, then the reference re-appends
  if (success) {
    int popped[kCons];
    for (int c5 = 0; c5 < kCons; ++c5) {
      const int nxt = c5 + 1 < kCons ? s.cons[c5 + 1] : 0;
      popped[c5] = c5 >= s.cn - 1 ? 0 : (c5 < idx ? s.cons[c5] : nxt);
    }
    for (int c5 = 0; c5 < kCons; ++c5) s.cons[c5] = popped[c5];
    s.cn -= 1;
  }
  append5(s, pend0, pending >= 1 && s.cn < cslots0);
  append5(s, pend1, pending >= 2 && s.cn < cslots0);
  s.sel = 0;
  if (destroy) remove_positions(s, rem);
  return success ? reward : -1.f;
}

// Shop cost multiplier 1.15**(ante-1) (0 past the table), x0.9 with Magic Trick.
__device__ __forceinline__ float cost_mult(const State& s, int ante, const float* ft) {
  const float m = (ante >= 1 && ante <= 100) ? ft[T_P115 + ante - 1] : 0.f;
  return fmul(m, (s.vou & 1) ? 0.9f : 1.f);
}

// A fresh inventory into the shop rows.
__device__ void shop_gen(State& s, TfKey key, float mult) {
  const TfKey k_pack = tf_split_child(key, 0), k_jok = tf_split_child(key, 1);
  const TfKey k_vouch = tf_split_child(key, 2), k_cards = tf_split_child(key, 3);
  const int third = tf_randint(k_pack, 2, 5, 0u);
  // three distinct unowned jokers: the top 3 packed words key20 | cost4 | 255-id
  uint32_t r1 = 0, r2 = 0, r3 = 0;
  for (int j = 0; j < kJokers; ++j) {
    if (c_jcost[j] <= 0) continue;
    bool owned = false;
    for (int i = 0; i < kJok; ++i) owned |= s.jok[i] == j;
    if (owned) continue;
    const uint32_t k = (tf_bits32(k_jok, (uint32_t)j) & 0xFFF00000u) |
                       ((uint32_t)c_jcost[j] << 8) | (uint32_t)(255 - j);
    const uint32_t t1 = r1 < k ? r1 : k;
    r1 = r1 > k ? r1 : k;
    const uint32_t t2 = r2 < t1 ? r2 : t1;
    r2 = r2 > t1 ? r2 : t1;
    r3 = r3 > t2 ? r3 : t2;
  }
  const uint32_t rs[3] = {r1, r2, r3};
  const int vid = tf_randint(k_vouch, 0, 2, 0u);
  const int types[kShop] = {IT_PACK, IT_PACK, IT_PACK, IT_JOKER, IT_JOKER, IT_JOKER,
                            IT_VOUCHER, IT_CARD, IT_CARD, 0};
  const int base[7] = {c_pack_costs[0], c_pack_costs[1], c_pack_costs[third],
                       (int)((r1 >> 8) & 15u), (int)((r2 >> 8) & 15u), (int)((r3 >> 8) & 15u),
                       c_voucher_costs[vid]};
  for (int r = 0; r < kShop; ++r) s.sty[r] = types[r];
  s.sit[0] = 0;
  s.sit[1] = 1;   // PACK_JOKER
  s.sit[2] = third;
  for (int i = 0; i < 3; ++i) s.sit[3 + i] = 255 - (int)(rs[i] & 255u);
  s.sit[6] = vid;
  s.sit[7] = tf_randint(k_cards, 0, 52, 0u);
  s.sit[8] = tf_randint(k_cards, 0, 52, 1u);
  s.sit[9] = 0;
  for (int i = 0; i < 7; ++i) s.sco[i] = fl(fmul((float)base[i], mult));
  s.sco[7] = s.sco[8] = 40;
  s.sco[9] = 0;
  s.sn = 9;
}

// A shop generation that step has still to run: its key and cost
// multiplier (see ShopJoin in step).
struct PendingShop {
  bool on;
  TfKey key;
  float mult;
};

// Beat or skip a blind: gold-card and boss money, ante/round, round money,
// fresh hands and shop (frozen past ante 100). kJoin: the shop generation
// is left in `later` for step to run; no field it writes is read or
// written by the rest of advance.
template <bool kJoin = false>
__device__ void advance(State& s, const float* ft, PendingShop* later = nullptr) {
  int gold = 0;
  for (int p = 0; p < kHand && p < s.hn; ++p) gold += s.hen[p] == ENH_GOLD;
  s.money += gold * 3 + (s.bact ? 5 : 0);
  const int new_ante = s.round == 3 ? s.ante + 1 : s.ante;
  const int new_round = s.round == 3 ? 1 : s.round + 1;
  const bool over = new_ante > 100;
  if (!over) s.money += 25 * new_round + (new_round == 3 ? 10 : 0);
  s.ante = new_ante;
  s.round = new_round;
  s.rchips = s.best = s.hpa = 0;
  s.bact = false;
  s.bid = -1;
  s.btypes = 0;
  s.bfirst = true;
  s.bverd = 5;
  s.bp = 0;
  s.fd = 0;
  if (over) return;
  const float mult = cost_mult(s, new_ante, ft);
  if constexpr (kJoin) *later = {true, next_key(s, ST_SHOP_GEN), mult};
  else shop_gen(s, next_key(s, ST_SHOP_GEN), mult);
  s.hl = 4;
  s.dl = 3;
  s.phase = PH_SHOP;
  s.rbase = 50;
  s.rcost = fl(fmul(50.f, mult));
}

__device__ float shop_buy(State& s, int a) {
  const int idx = clampi(a - 20, 0, kShop - 1);
  const int itype = s.sty[idx], item = s.sit[idx], cost = s.sco[idx];
  const bool full = s.jn >= s.jslots;
  const float reward = (itype == IT_JOKER && full) ? -1.f
      : itype == IT_PACK ? 5.f : itype == IT_JOKER ? 15.f : itype == IT_CARD ? 3.f
      : itype == IT_VOUCHER ? 10.f : -1.f;
  if (itype == IT_JOKER && !full) {
    s.jok[clampi(s.jn, 0, kJok - 1)] = item;
    s.jn += 1;
  }
  if (itype == IT_VOUCHER) s.vou |= item == 0 ? 1 : 2;
  s.money -= cost;
  for (int r = 0; r < kShop; ++r) {
    const bool keep = r < s.sn - 1;
    const bool shift = r >= idx && r + 1 < kShop;
    s.sty[r] = keep ? (r < idx ? s.sty[r] : (shift ? s.sty[r + 1] : 0)) : 0;
    s.sit[r] = keep ? (r < idx ? s.sit[r] : (shift ? s.sit[r + 1] : 0)) : 0;
    s.sco[r] = keep ? (r < idx ? s.sco[r] : (shift ? s.sco[r + 1] : 0)) : 0;
  }
  s.sn -= 1;
  return reward;
}

__device__ float sell(State& s, int a) {
  const int idx = clampi(a - 32, 0, kJok - 1);
  const int jid = s.jok[idx];
  int value = 3;
  if (jid >= 1 && jid < kJokers && c_jcost[jid] / 2 > 3) value = c_jcost[jid] / 2;
  for (int i = 0; i < kJok; ++i) {
    const int nxt = i + 1 < kJok ? s.jok[i + 1] : 0;
    s.jok[i] = i >= s.jn - 1 ? 0 : (i < idx ? s.jok[i] : nxt);
  }
  s.jn -= 1;
  s.money += value;
  s.jsold += 1;
  return fdiv((float)value, 5.f);
}

__device__ float select_blind(State& s, int a, const float* ft) {
  // bt and is_boss are read from the action id directly: nvcc 12.9 -O3
  // evaluated `clampi(a - 45, 0, 2) == 2` as true for a = 45 and 46 here.
  const int bt = a <= 45 ? 0 : (a == 46 ? 1 : 2);
  const int base = c_blind[(clampi(s.ante, 1, 8) - 1) * 3 + bt];
  const int extra = s.ante - 8 > 0 ? s.ante - 8 : 0;
  const float p15 = (extra >= 1 && extra <= 92) ? ft[T_P15 + extra] : 1.f;
  int chips = f2i(fmul((float)base, p15));
  const bool is_boss = a >= 47;
  const int bid = tf_randint(next_key(s, ST_BOSS), 1, N_BOSS, 0u);
  if (is_boss) {
    chips = fl(fmul((float)chips, bid == B_WALL ? 2.f : 1.f));
    if (bid == B_WATER) s.dl = 0;
    if (bid == B_MANACLE) s.hsize -= 1;
    if (bid == B_NEEDLE) s.hl = 1;
  }
  s.round = bt + 1;
  s.need = chips;
  s.bact = is_boss;
  s.bid = is_boss ? bid : -1;
  s.btypes = 0;
  s.bfirst = true;
  s.bverd = 5;
  s.bp = 0;
  s.phase = PH_PLAY;
  return is_boss ? 10.f : 0.f;
}

// Boss on-hand-drawn effects for the refreshed hand after a play.
__device__ void boss_on_drawn(State& s, TfKey k_boss) {
  TfKey k_hook, k_wheel;
  tf_split2(k_boss, k_hook, k_wheel);
  const uint32_t present = present_mask(s.hn);
  uint32_t face = 0;
  for (int p = 0; p < kHand; ++p) {
    if (!((present >> p) & 1u)) continue;
    bool f = false;
    if (s.bid == B_WHEEL) f = tf_uniform_f32(tf_bits32(k_wheel, (uint32_t)p)) < 0.142857149f;
    else if (s.bid == B_HOUSE) f = s.bfirst;
    else if (s.bid == B_MARK) f = s.hrk[p] >= 11 && s.hrk[p] <= 13;
    else if (s.bid == B_FISH) f = !s.bfirst;
    face |= (uint32_t)f << p;
  }
  s.fd = face;
  if (s.bid != B_HOOK) return;
  // The Hook discards the two present cards with the largest draws
  if (__popc(present) < 2) {
    remove_positions(s, 0u);
    return;
  }
  uint32_t keys[kHand];
  for (int p = 0; p < kHand; ++p)
    keys[p] = ((present >> p) & 1u) ? tf_bits32(k_hook, (uint32_t)p) : 0u;
  uint32_t hook = 0;
  for (int pick = 0; pick < 2; ++pick) {
    uint32_t best = 0;
    int bp = 0;
    for (int p = 0; p < kHand; ++p)
      if (keys[p] > best) { best = keys[p]; bp = p; }
    hook |= 1u << bp;
    keys[bp] = 0;
  }
  remove_positions(s, hook & present);
}

// One stage (p, k) of Batcher's odd-even merge sort of the 64 words v, its
// loops unrolled over compile-time bounds, so every comparator's slots are
// constants and v stays in registers; then the stages after it, in order.
template <int P, int K>
__device__ __forceinline__ void merge_stages(uint32_t* v) {
#pragma unroll
  for (int j = K % P; j < kDeck - K; j += 2 * K)
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int x = i + j, y = i + j + K;
      if (y < kDeck && x / (P * 2) == y / (P * 2)) {
        const uint32_t lo = min(v[x], v[y]);
        v[y] = max(v[x], v[y]);
        v[x] = lo;
      }
    }
  if constexpr (K > 1) merge_stages<P, K / 2>(v);
  else if constexpr (P * 2 < kDeck) merge_stages<P * 2, P * 2>(v);
}

// Card c's priority word: its draw, with suit and rank in the low 6 bits.
__device__ __forceinline__ uint32_t deck_word(TfKey dk, int c) {
  return (tf_bits32(dk, (uint32_t)c) & 0xFFFFFFC0u) | (uint32_t)(((c / 13) << 4) | (c % 13));
}

// Deck slot d holds the card of sorted word w (pads past 52 stay empty).
__device__ __forceinline__ void deal(State& s, int d, uint32_t w) {
  s.rk[d] = d < 52 ? (int)(w & 15u) + 2 : 0;
  s.su[d] = d < 52 ? (int)((w >> 4) & 3u) : 0;
  s.en[d] = s.ed[d] = s.sl[d] = 0;
}

// Every field of a fresh episode but the key and the deck's card channels:
// the 52 dealt slots alive, the rest of the game at its start. Both
// shuffles end with it: reset_state's and the engine's (reset_deal).
__device__ __forceinline__ void reset_fields(State& s) {
  s.al = (1ull << 52) - 1;
  s.ih = s.bp = 0;
  for (int p = 0; p < kHand; ++p) {
    s.hidx[p] = -1;
    s.hrk[p] = s.hsu[p] = s.hen[p] = s.hed[p] = s.hsl[p] = 0;
  }
  s.sel = s.fd = s.high = 0;
  for (int i = 0; i < kJok; ++i) s.jok[i] = 0;
  for (int i = 0; i < kCons; ++i) s.cons[i] = 0;
  for (int r = 0; r < kShop; ++r) s.sty[r] = s.sit[r] = s.sco[r] = 0;
  for (int h = 0; h < kLvl; ++h) { s.lvl[h] = 1; s.pc[h] = 0; }
  for (int k = 0; k < kCtr; ++k) s.ctr[k] = 0u;
  s.ctr[ST_DECK] = 1u;
  s.hn = s.jn = s.bus = s.cn = s.vou = 0;
  s.green = 1;
  s.jslots = 5;
  s.cslots = 2;
  s.ante = s.round = 1;
  s.phase = PH_BLIND;
  s.need = 300;
  s.career = s.rchips = s.best = 0;
  s.money = 4;
  s.hl = 4;
  s.dl = 3;
  s.hsize = 8;
  s.sn = 0;
  s.rbase = 50;
  s.rcost = 5;
  s.bact = false;
  s.bid = -1;
  s.btypes = 0;
  s.bfirst = true;
  s.bverd = 5;
  s.hpt = s.hpa = s.jsold = 0;
  s.done = false;
  s.sc = 0;
}

// Fresh episode: key folded with the step count, the deck shuffled by
// sorting 52 packed priority words with Batcher's odd-even merge network.
// kUnrolled sorts in registers (merge_stages): K3a's form, since a launch
// lasts as long as its slowest warp, and the loops below over a local v
// made a K3a launch in which any env resets ~100 us longer on an H100
// (PERF.md). K2 keeps the loops: at its 64 registers the unrolled form
// made its 131072-env rollout 3% slower there. This is the kernels' own
// shuffle (PARITY #B8, #B16), not the engine's: see engine_shuffle_key.
template <bool kUnrolled>
__device__ void reset_state(State& s) {
  s.key = tf_fold_in(s.key, (uint32_t)s.sc);
  const TfKey dk = tf_fold_in(tf_fold_in(s.key, (uint32_t)ST_DECK), 0u);
  uint32_t v[kDeck];
  if constexpr (kUnrolled) {
#pragma unroll
    for (int c = 0; c < kDeck; ++c) v[c] = c < 52 ? deck_word(dk, c) : 0xFFFFFFFFu;
    merge_stages<1, 1>(v);
#pragma unroll
    for (int d = 0; d < kDeck; ++d) deal(s, d, v[d]);
  } else {
    for (int c = 0; c < 52; ++c) v[c] = deck_word(dk, c);
    for (int c = 52; c < kDeck; ++c) v[c] = 0xFFFFFFFFu;
#pragma unroll 1
    for (int p = 1; p < kDeck; p *= 2)
#pragma unroll 1
      for (int k = p; k >= 1; k /= 2)
#pragma unroll 1
        for (int j = k % p; j < kDeck - k; j += 2 * k)
#pragma unroll 1
          for (int i = 0; i < k && i < kDeck - j - k; ++i) {
            const int x = i + j, y = i + j + k;
            if (x / (p * 2) == y / (p * 2) && v[x] > v[y]) {
              const uint32_t t = v[x];
              v[x] = v[y];
              v[y] = t;
            }
          }
    for (int d = 0; d < kDeck; ++d) deal(s, d, v[d]);
  }
  reset_fields(s);
}

// The engine's shuffle (the port's full_env.reset): permutation(fold_in(
// stream_key(key, deck_shuffle), 0), 52), as jax.random.permutation draws
// it for 52 cards, one round: split that key, take child 1, draw its 32-bit
// words 0-51, and sort the cards stably by word. Deck slot d gets the d-th
// card in that order, card c being rank c % 13 + 2 and suit c / 13.
// Child 1 of the split of the shuffle key: the key the 52 words come from.
__device__ __forceinline__ TfKey engine_shuffle_key(TfKey key) {
  return tf_split_child(tf_fold_in(tf_fold_in(key, (uint32_t)ST_DECK), 0u), 1u);
}

// The sort key of slot i of the 64 that a warp sorts: card i's word above
// its index, so that equal words keep index order (a stable sort of the
// words); the 12 pads sort last.
__device__ __forceinline__ uint64_t engine_deck_key(TfKey sub, int i) {
  return i < 52 ? ((uint64_t)tf_bits32(sub, (uint32_t)i) << 32) | (uint32_t)i : ~0ull;
}

// Compare-exchange l of stage (k, j) of the bitonic sort of 64 keys in v:
// the pair (i, i + j), i the l-th index with bit j clear, ascending where
// bit k of i is clear. Each of a stage's 32 pairs is one lane's.
__device__ __forceinline__ void bitonic_pair(uint64_t* v, int l, int k, int j) {
  const int i = ((l & ~(j - 1)) << 1) | (l & (j - 1));
  const uint64_t a = v[i], b = v[i + j];
  if ((a > b) == ((i & k) == 0)) {
    v[i] = b;
    v[i + j] = a;
  }
}

// The bitonic sort of the 64 keys in v, ascending: its 21 stages in order,
// each run by lanes(f), which calls f(l) for every lane l of the warp and
// returns when all have run (one lane and a __syncwarp on the card, all 32
// in turn on the host).
template <typename Lanes>
__device__ __forceinline__ void sort64(uint64_t* v, Lanes&& lanes) {
  for (int k = 2; k <= kDeck; k *= 2)
    for (int j = k / 2; j >= 1; j /= 2) lanes([=](int l) { bitonic_pair(v, l, k, j); });
}

// Lane l's deck slots of the engine's shuffle, l and l + 32, from the
// sorted keys: the card of the slot's key, in deal's word form.
__device__ __forceinline__ void reset_deal(State& s, const uint64_t* v, int l) {
  for (int d = l; d < kDeck; d += 32) {
    const uint32_t c = (uint32_t)v[d];
    deal(s, d, ((c / 13u) << 4) | (c % 13u));
  }
}

// The branches of step: an env's branch class is the branch its action
// takes there, from its phase, the action, its legality and the over flags,
// by step's own tests. env_step_kernel steps a block's envs in class order,
// so that a warp runs few branches, not the union of its envs' branches.
// The order puts the long branches first and the cheapest last (their
// times by class: PERF.md).
enum {
  BC_PLAY, BC_REROLL, BC_SKIP, BC_CONSUMABLE, BC_BLIND, BC_DISCARD, BC_END, BC_BUY,
  BC_SELL, BC_SELECT, BC_IDLE, kBranchClasses
};

// The branch groups: play; the other classes that generate a shop (reroll,
// skip); the consumables; the rest. A warp of env_step_kernel runs one
// group.
constexpr int kBranchGroups = 4;
__device__ __forceinline__ int branch_group(int c) {
  return c == BC_PLAY ? 0 : (c <= BC_SKIP ? 1 : (c == BC_CONSUMABLE ? 2 : 3));
}

__device__ __forceinline__ int branch_class(const State& s, int a) {
  const bool over = s.ante > 100 || s.career > 1000000000 || s.done;
  if (over || !legal(s, a)) return BC_IDLE;
  if (s.phase == PH_PLAY)
    return a == 0 ? BC_PLAY : (a == 1 ? BC_DISCARD : (a < 10 ? BC_SELECT : BC_CONSUMABLE));
  if (s.phase == PH_SHOP)
    return a < 30 ? BC_BUY : (a == 30 ? BC_REROLL : (a == 31 ? BC_END : BC_SELL));
  return a < 48 ? BC_BLIND : BC_SKIP;
}

// One step_autoreset. Returns the reward; sets done. kUnrolledReset: the
// reset's form (see reset_state). kAutoreset false: the engine's own step,
// whose done envs keep their final state (done set, step count advanced)
// for the caller to reset. kJoinShop: the three branches that generate a
// shop (a play that beats the blind, a skip, a reroll) leave it pending
// and one call after the branches runs it, so that a warp whose lanes took
// different ones of them runs the shop generation once, not once a branch
// (the engine's step kernel; K2 and K3a keep the calls in their branches).
template <bool kUnrolledReset, bool kAutoreset = true, bool kJoinShop = false>
__device__ float step(State& s, int a, const float* ft, bool& done) {
  const bool over = s.ante > 100 || s.career > 1000000000 || s.done;
  float reward = over ? 0.f : -1.f;
  bool term = false;
  PendingShop shop = {false, {0u, 0u}, 0.f};
  if (!over && legal(s, a)) {
    if (s.phase == PH_PLAY) {
      if (a == 0) {
        TfKey k_boss = {0u, 0u};
        const int outcome = play(s, ft, reward, k_boss);
        term = outcome == PLAY_FAIL;
        if (outcome == PLAY_BEAT) advance<kJoinShop>(s, ft, &shop);
        if (outcome == PLAY_CONT) {
          draw_pass(s);
          if (s.bact) boss_on_drawn(s, k_boss);
        }
      } else if (a == 1) {
        reward = discard(s);
        draw_pass(s);
      } else if (a < 10) {
        s.sel ^= 1u << (a - 2);
        reward = 0.f;
      } else {
        reward = use_consumable(s, a);
      }
    } else if (s.phase == PH_SHOP) {
      if (a < 30) {
        reward = shop_buy(s, a);
      } else if (a == 30) {
        const TfKey k_rr = next_key(s, ST_SHOP_REROLL);
        const float mult = cost_mult(s, s.ante, ft);
        const int cost = fl(fmul((float)s.rbase, mult));
        const bool afford = s.money >= cost;
        if (afford) {
          s.money -= cost;
          s.rbase = fl(fmul((float)s.rbase, 1.35000002f));
          if constexpr (kJoinShop) shop = {true, k_rr, mult};
          else shop_gen(s, k_rr, mult);
        }
        reward = afford ? 0.f : -1.f;
      } else if (a == 31) {
        s.phase = PH_PLAY;
        draw_pass(s);
        reward = 0.f;
      } else {
        reward = sell(s, a);
      }
    } else {
      if (a < 48) {
        reward = select_blind(s, a, ft);
        draw_pass(s);
      } else {
        advance<kJoinShop>(s, ft, &shop);
        reward = -5.f;
      }
    }
  }
  if constexpr (kJoinShop) {
    if (shop.on) shop_gen(s, shop.key, shop.mult);
  }
  done = over || term;
  s.done = done;
  s.sc += 1;
  if constexpr (kAutoreset) {
    if (done) reset_state<kUnrolledReset>(s);
  }
  return reward;
}

// Env e's packed rows (cards [384, B], ints [132, B], rng [18, B], envs
// contiguous) into a State; the hand channels are materialised from the
// deck, with the in-hand slot set.
__device__ void load_state(State& s, const int* __restrict__ cards_in,
                           const int* __restrict__ ints_in,
                           const uint32_t* __restrict__ rng_in, int e, size_t B) {
#define IN(r) ints_in[(size_t)(r) * B + e]
  for (int d = 0; d < kDeck; ++d) {
    s.rk[d] = cards_in[(size_t)(0 * kDeck + d) * B + e];
    s.su[d] = cards_in[(size_t)(1 * kDeck + d) * B + e];
    s.en[d] = cards_in[(size_t)(2 * kDeck + d) * B + e];
    s.ed[d] = cards_in[(size_t)(3 * kDeck + d) * B + e];
    s.sl[d] = cards_in[(size_t)(4 * kDeck + d) * B + e];
  }
  s.al = 0;
  for (int d = 0; d < kDeck; ++d)
    if (cards_in[(size_t)(5 * kDeck + d) * B + e] != 0) s.al |= 1ull << d;
  s.sel = s.fd = s.high = 0;
  for (int p = 0; p < kHand; ++p) {
    s.hidx[p] = IN(R_HIDX + p);
    s.sel |= (uint32_t)(IN(R_SEL + p) != 0) << p;
    s.fd |= (uint32_t)(IN(R_FD + p) != 0) << p;
    s.high |= (uint32_t)(IN(R_HIGH + p) != 0) << p;
  }
  for (int i = 0; i < kJok; ++i) s.jok[i] = IN(R_JOK + i);
  for (int i = 0; i < kCons; ++i) s.cons[i] = IN(R_CONS + i);
  for (int r = 0; r < kShop; ++r) {
    s.sty[r] = IN(R_STY + r);
    s.sit[r] = IN(R_SIT + r);
    s.sco[r] = IN(R_SCO + r);
  }
  for (int h = 0; h < kLvl; ++h) {
    s.lvl[h] = IN(R_LVL + h);
    s.pc[h] = IN(R_PC + h);
  }
  s.hn = IN(S_HN); s.jn = IN(S_JN); s.green = IN(S_GREEN); s.bus = IN(S_BUS);
  s.cn = IN(S_CN); s.vou = IN(S_VOU); s.jslots = IN(S_JSLOTS); s.cslots = IN(S_CSLOTS);
  s.ante = IN(S_ANTE); s.round = IN(S_ROUND); s.phase = IN(S_PHASE); s.need = IN(S_NEED);
  s.career = IN(S_CAREER); s.rchips = IN(S_RCHIPS); s.best = IN(S_BEST);
  s.money = IN(S_MONEY); s.hl = IN(S_HL); s.dl = IN(S_DL); s.hsize = IN(S_HSIZE);
  s.sn = IN(S_SN); s.rbase = IN(S_RBASE); s.rcost = IN(S_RCOST); s.bid = IN(S_BID);
  s.btypes = IN(S_BTYPES); s.bverd = IN(S_BVERD); s.hpt = IN(S_HPT); s.hpa = IN(S_HPA);
  s.jsold = IN(S_JSOLD); s.sc = IN(S_STEPC);
  s.bact = IN(S_BACT) != 0;
  s.bfirst = IN(S_BFIRST) != 0;
  s.done = IN(S_DONE) != 0;
  s.bp = (uint64_t)(uint32_t)IN(S_BPLO) | ((uint64_t)(uint32_t)IN(S_BPHI) << 32);
#undef IN
  s.key.k0 = rng_in[e];
  s.key.k1 = rng_in[B + e];
  for (int k = 0; k < kCtr; ++k) s.ctr[k] = rng_in[(size_t)(2 + k) * B + e];
  s.ih = 0;
  for (int p = 0; p < kHand; ++p) {
    const int h = s.hidx[p];
    const bool held = p < s.hn && h >= 0;
    const bool in_deck = held && h < kDeck;
    s.hrk[p] = in_deck ? s.rk[h] : 0;
    s.hsu[p] = in_deck ? s.su[h] : 0;
    s.hen[p] = in_deck ? s.en[h] : 0;
    s.hed[p] = in_deck ? s.ed[h] : 0;
    s.hsl[p] = in_deck ? s.sl[h] : 0;
    if (held) s.ih |= 1ull << clampi(h, 0, kDeck - 1);
  }
}

// A State into env e's packed rows, in three pieces: the card rows of deck
// slots d0 to d1 - 1 (store_cards), the int rows with hand rows 8-9
// written as -1 (store_ints), the rng rows (store_rng). store_state
// stores them all; the engine's reset stores kStoreParts parts of a
// block's envs, a part a warp (store_part).
__device__ __forceinline__ void store_cards(const State& s, int* __restrict__ cards_out, int e,
                                            size_t B, int d0, int d1) {
  for (int d = d0; d < d1; ++d) {
    cards_out[(size_t)(0 * kDeck + d) * B + e] = s.rk[d];
    cards_out[(size_t)(1 * kDeck + d) * B + e] = s.su[d];
    cards_out[(size_t)(2 * kDeck + d) * B + e] = s.en[d];
    cards_out[(size_t)(3 * kDeck + d) * B + e] = s.ed[d];
    cards_out[(size_t)(4 * kDeck + d) * B + e] = s.sl[d];
    cards_out[(size_t)(5 * kDeck + d) * B + e] = bit64(s.al, d);
  }
}

__device__ __forceinline__ void store_ints(const State& s, int* __restrict__ ints_out, int e,
                                           size_t B) {
#define OUT(r) ints_out[(size_t)(r) * B + e]
  for (int p = 0; p < kHand; ++p) {
    OUT(R_HIDX + p) = s.hidx[p];
    OUT(R_SEL + p) = (s.sel >> p) & 1u;
    OUT(R_FD + p) = (s.fd >> p) & 1u;
    OUT(R_HIGH + p) = (s.high >> p) & 1u;
  }
  OUT(R_HIDX + 8) = -1;
  OUT(R_HIDX + 9) = -1;
  for (int i = 0; i < kJok; ++i) OUT(R_JOK + i) = s.jok[i];
  for (int i = 0; i < kCons; ++i) OUT(R_CONS + i) = s.cons[i];
  for (int r = 0; r < kShop; ++r) {
    OUT(R_STY + r) = s.sty[r];
    OUT(R_SIT + r) = s.sit[r];
    OUT(R_SCO + r) = s.sco[r];
  }
  for (int h = 0; h < kLvl; ++h) {
    OUT(R_LVL + h) = s.lvl[h];
    OUT(R_PC + h) = s.pc[h];
  }
  OUT(S_HN) = s.hn; OUT(S_JN) = s.jn; OUT(S_GREEN) = s.green; OUT(S_BUS) = s.bus;
  OUT(S_CN) = s.cn; OUT(S_VOU) = s.vou; OUT(S_JSLOTS) = s.jslots; OUT(S_CSLOTS) = s.cslots;
  OUT(S_ANTE) = s.ante; OUT(S_ROUND) = s.round; OUT(S_PHASE) = s.phase;
  OUT(S_NEED) = s.need; OUT(S_CAREER) = s.career; OUT(S_RCHIPS) = s.rchips;
  OUT(S_BEST) = s.best; OUT(S_MONEY) = s.money; OUT(S_HL) = s.hl; OUT(S_DL) = s.dl;
  OUT(S_HSIZE) = s.hsize; OUT(S_SN) = s.sn; OUT(S_RBASE) = s.rbase;
  OUT(S_RCOST) = s.rcost; OUT(S_BACT) = s.bact; OUT(S_BID) = s.bid;
  OUT(S_BTYPES) = s.btypes; OUT(S_BFIRST) = s.bfirst; OUT(S_BVERD) = s.bverd;
  OUT(S_BPLO) = (int)(uint32_t)s.bp; OUT(S_BPHI) = (int)(uint32_t)(s.bp >> 32);
  OUT(S_HPT) = s.hpt; OUT(S_HPA) = s.hpa; OUT(S_JSOLD) = s.jsold;
  OUT(S_DONE) = s.done; OUT(S_STEPC) = s.sc;
#undef OUT
}

__device__ __forceinline__ void store_rng(const State& s, uint32_t* __restrict__ rng_out, int e,
                                          size_t B) {
  rng_out[e] = s.key.k0;
  rng_out[B + e] = s.key.k1;
  for (int k = 0; k < kCtr; ++k) rng_out[(size_t)(2 + k) * B + e] = s.ctr[k];
}

__device__ void store_state(const State& s, int* __restrict__ cards_out,
                            int* __restrict__ ints_out, uint32_t* __restrict__ rng_out,
                            int e, size_t B) {
  store_cards(s, cards_out, e, B, 0, kDeck);
  store_ints(s, ints_out, e, B);
  store_rng(s, rng_out, e, B);
}

// The parts: the card rows of a quarter of the deck's slots each (96
// rows), then the int rows (132), then the rng rows (18).
constexpr int kStoreParts = 6;

__device__ __forceinline__ void store_part(const State& s, int part, int* __restrict__ cards_out,
                                           int* __restrict__ ints_out,
                                           uint32_t* __restrict__ rng_out, int e, size_t B) {
  if (part < 4)
    store_cards(s, cards_out, e, B, part * (kDeck / 4), (part + 1) * (kDeck / 4));
  else if (part == 4)
    store_ints(s, ints_out, e, B);
  else
    store_rng(s, rng_out, e, B);
}

}  // namespace
