"""Joker effects as dense numpy tables indexed by joker id.

Port of ``balatro_gym_tpu/ops/joker_tables.py``: the scoring tables, the
shop base costs and the joker ids the sim and flagship paths read. Row 0 is
the empty slot and is all zero, so a multi-hot count vector over the 151 ids
times a table gives the summed effect of a joker hand with no gathers. Hand-type tables are baked from the
sim path's hand-name strings, bugs included (see the reference module).
tests/test_torch_scoring.py and tests/test_torch_full_tables.py assert that
every table and id equals the reference's.
"""
from __future__ import annotations

import numpy as np

from .constants import SIM_HAND_NAMES

NUM_JOKERS = 151  # ids 1..150; 0 = empty slot

J_JOKER = 1
J_GREEDY, J_LUSTY, J_WRATHFUL, J_GLUTTONOUS = 2, 3, 4, 5
J_JOLLY, J_ZANY, J_MAD, J_CRAZY, J_DROLL = 6, 7, 8, 9, 10
J_SLY, J_WILY, J_CLEVER, J_DEVIOUS, J_CRAFTY = 11, 12, 13, 14, 15
J_HALF = 16
J_FOUR_FINGERS = 18
J_BANNER = 22
J_MYSTIC_SUMMIT = 23
J_MISPRINT = 27
J_FIBONACCI = 31
J_SCARY_FACE = 33
J_ABSTRACT = 34
J_GROS_MICHEL = 38
J_EVEN_STEVEN = 39
J_ODD_TODD = 40
J_SCHOLAR = 41
J_EGG = 46
J_BLACKBOARD = 48
J_ICE_CREAM = 50
J_BLUE_JOKER = 53
J_FACELESS = 57
J_CAVENDISH = 61
J_SHORTCUT = 69
J_BARON = 72
J_LUCHADOR = 77
J_GIFT_CARD = 79
J_TRADING_CARD = 95
J_POPCORN = 97
J_WALKIE_TALKIE = 101
J_SMILEY_FACE = 104
J_ACROBAT = 108
J_SWASHBUCKLER = 110
J_ROUGH_GEM = 116
J_BLOODSTONE = 117
J_ARROWHEAD = 118
J_ONYX_AGATE = 119
J_FLOWER_POT = 122
J_WEE_JOKER = 124
J_SEEING_DOUBLE = 128
J_THE_DUO = 131
J_THE_TRIO = 132
J_THE_FAMILY = 133
J_THE_ORDER = 134
J_THE_TRIBE = 135
J_STUNTMAN = 136
J_SHOOT_THE_MOON = 140
J_TRIBOULET = 147

_C, _D, _H, _S = 0, 1, 2, 3      # canonical suits
STONE_SUIT = 4                   # scoring-view category for Stone cards
NUM_SUIT_CATS = 5

# ---- individual scoring (per scoring card) ----
_ind_chip_rank = np.zeros((NUM_JOKERS, 15), np.int32)
_ind_mult_rank = np.zeros((NUM_JOKERS, 15), np.int32)
_ind_chip_suit = np.zeros((NUM_JOKERS, NUM_SUIT_CATS), np.int32)
_ind_mult_suit = np.zeros((NUM_JOKERS, NUM_SUIT_CATS), np.int32)
_ind_money_suit = np.zeros((NUM_JOKERS, NUM_SUIT_CATS), np.int32)

_ind_mult_rank[J_FIBONACCI, [2, 3, 5, 8, 14]] = 8
_ind_mult_rank[J_EVEN_STEVEN, [2, 4, 6, 8, 10]] = 4
_ind_chip_rank[J_ODD_TODD, [3, 5, 7, 9, 14]] = 31
_ind_chip_rank[J_SCHOLAR, 14] = 20
_ind_mult_rank[J_SCHOLAR, 14] = 4
_ind_chip_rank[J_WALKIE_TALKIE, [4, 10]] = 10
_ind_mult_rank[J_WALKIE_TALKIE, [4, 10]] = 4
_ind_chip_rank[J_WEE_JOKER, 2] = 8
_ind_chip_rank[J_SCARY_FACE, [11, 12, 13]] = 30
_ind_mult_rank[J_SMILEY_FACE, [11, 12, 13]] = 5
_ind_chip_suit[J_ARROWHEAD, _S] = 50
_ind_mult_suit[J_ONYX_AGATE, _C] = 7
_ind_money_suit[J_ROUGH_GEM, _D] = 1

# ---- main scoring ----
_chips_flat = np.zeros(NUM_JOKERS, np.int32)
_mult_flat = np.zeros(NUM_JOKERS, np.int32)
_mult_flat[J_JOKER] = 4
_chips_flat[J_STUNTMAN] = 250
_mult_flat[J_GROS_MICHEL] = 15
_mult_flat[J_POPCORN] = 20
_chips_flat[J_ICE_CREAM] = 100
_x3_flat = np.zeros(NUM_JOKERS, np.int32)
_x3_flat[J_CAVENDISH] = 1        # Cavendish x3

# "+3 mult if any scoring card has suit".
_mult_if_suit = np.zeros((NUM_JOKERS, NUM_SUIT_CATS), np.int32)
_mult_if_suit[J_GREEDY, _D] = 3
_mult_if_suit[J_LUSTY, _H] = 3
_mult_if_suit[J_WRATHFUL, _S] = 3
_mult_if_suit[J_GLUTTONOUS, _C] = 3

# Hand-type conditioned jokers: (condition string, chips, mult, x2 exp, x3 exp).
_HAND_JOKERS = {
    J_JOLLY: ("Pair", 0, 8, 0, 0),
    J_ZANY: ("Three of a Kind", 0, 12, 0, 0),
    J_MAD: ("Two Pair", 0, 10, 0, 0),
    J_CRAZY: ("Straight", 0, 12, 0, 0),
    J_DROLL: ("Flush", 0, 10, 0, 0),
    J_SLY: ("Pair", 50, 0, 0, 0),
    J_WILY: ("Three of a Kind", 100, 0, 0, 0),
    J_CLEVER: ("Two Pair", 80, 0, 0, 0),
    J_DEVIOUS: ("Straight", 100, 0, 0, 0),
    J_CRAFTY: ("Flush", 80, 0, 0, 0),
    J_THE_DUO: ("Pair", 0, 0, 1, 0),            # x2
    J_THE_TRIO: ("Three of a Kind", 0, 0, 0, 1),  # x3
    J_THE_FAMILY: ("Four of a Kind", 0, 0, 2, 0),  # x4
    J_THE_ORDER: ("Straight", 0, 0, 0, 1),      # x3
    J_THE_TRIBE: ("Flush", 0, 0, 1, 0),         # x2
}


def _hand_tables(names):
    out = [np.zeros((NUM_JOKERS, len(names)), np.int32) for _ in range(4)]
    for j, (cond, *vals) in _HAND_JOKERS.items():
        for ht, name in enumerate(names):
            if name == cond:
                for tab, v in zip(out, vals):
                    tab[j, ht] = v
    return out


(_chips_hand_sim, _mult_hand_sim,
 _x2_hand_sim, _x3_hand_sim) = _hand_tables(SIM_HAND_NAMES)


_TABLES = None


# Shop base cost per joker id; 0 marks a legendary, which the shop never
# offers.
JOKER_BASE_COST_NP = np.zeros(NUM_JOKERS, np.int32)
for _id, _c in {
    1: 2, 2: 5, 3: 5, 4: 5, 5: 5, 6: 3, 7: 4, 8: 4, 9: 4, 10: 4, 11: 3,
    12: 4, 13: 4, 14: 4, 15: 4, 16: 5, 17: 8, 18: 7, 19: 5, 20: 1, 21: 6,
    22: 5, 23: 5, 24: 6, 25: 5, 26: 5, 27: 4, 28: 5, 29: 5, 30: 4, 31: 8,
    32: 7, 33: 4, 34: 4, 35: 4, 36: 6, 37: 5, 38: 5, 39: 4, 40: 4, 41: 4,
    42: 4, 43: 5, 44: 6, 45: 5, 46: 4, 47: 6, 48: 6, 49: 5, 50: 5, 51: 8,
    52: 3, 53: 5, 54: 6, 55: 6, 56: 5, 57: 4, 58: 4, 59: 4, 60: 4, 61: 4,
    62: 6, 63: 5, 64: 7, 65: 4, 66: 6, 67: 6, 68: 7, 69: 7, 70: 7, 71: 8,
    72: 8, 73: 7, 74: 6, 75: 8, 76: 7, 77: 5, 78: 5, 79: 6, 80: 6, 81: 6,
    82: 6, 83: 4, 84: 5, 85: 4, 86: 6, 87: 4, 88: 4, 89: 6, 90: 6, 91: 6,
    92: 8, 93: 6, 94: 6, 95: 6, 96: 5, 97: 5, 98: 6, 99: 8, 100: 6, 101: 4,
    102: 6, 103: 6, 104: 4, 105: 9, 106: 5, 107: 5, 108: 6, 109: 6, 110: 4,
    111: 6, 112: 6, 113: 7, 114: 6, 115: 4, 116: 7, 117: 7, 118: 7, 119: 7,
    120: 6, 121: 5, 122: 6, 123: 10, 124: 8, 125: 7, 126: 4, 127: 6, 128: 6,
    129: 7, 130: 8, 131: 8, 132: 8, 133: 8, 134: 8, 135: 8, 136: 7, 137: 8,
    138: 10, 139: 6, 140: 5, 141: 7, 142: 6, 143: 8, 144: 8, 145: 7,
}.items():
    JOKER_BASE_COST_NP[_id] = _c
