"""Game constants: phases, the flat action space, hand types, blind tables.

Port of ``balatro_gym_tpu/core/constants.py``: the phases and the flat
Discrete(60) action ids the flagship env reads, hand types and their base
values, the planet -> hand-type map and the blind chip table.
"""
from __future__ import annotations

from enum import IntEnum, unique

import numpy as np


@unique
class Phase(IntEnum):
    PLAY = 0
    SHOP = 1
    BLIND_SELECT = 2
    PACK_OPEN = 3


class Action:
    """Ids of the flat Discrete(60) action space."""
    PLAY_HAND = 0
    DISCARD = 1
    SELECT_CARD_BASE = 2          # 2-9
    USE_CONSUMABLE_BASE = 10      # 10-14
    SHOP_BUY_BASE = 20            # 20-29
    SHOP_REROLL = 30
    SHOP_END = 31
    SELL_JOKER_BASE = 32          # 32-36
    SELECT_BLIND_BASE = 45        # 45-47
    SKIP_BLIND = 48
    SELECT_FROM_PACK_BASE = 50    # 50-54
    SKIP_PACK = 55
    ACTION_SPACE_SIZE = 60


@unique
class HandType(IntEnum):
    HIGH_CARD = 0
    ONE_PAIR = 1
    TWO_PAIR = 2
    THREE_KIND = 3
    STRAIGHT = 4
    FLUSH = 5
    FULL_HOUSE = 6
    FOUR_KIND = 7
    STRAIGHT_FLUSH = 8
    FIVE_KIND = 9
    FLUSH_HOUSE = 10
    FLUSH_FIVE = 11


NUM_HAND_TYPES = 12

# Base (chips, mult) per hand type.
BASE_HAND_CHIPS = np.array([5, 10, 20, 30, 30, 35, 40, 60, 100, 120, 140, 160],
                           dtype=np.int32)
BASE_HAND_MULT = np.array([1, 2, 2, 3, 4, 4, 4, 7, 8, 12, 14, 16],
                          dtype=np.int32)

# Hand names on the sim path: joker hand-type conditions compare against
# these strings (ops/joker_tables.py bakes them into its tables).
SIM_HAND_NAMES = (
    "High Card", "Pair", "Two Pair", "Three of a Kind", "Straight", "Flush",
    "Full House", "Four of a Kind", "Straight Flush", "Five of a Kind",
    "Flush House", "Flush Five",
)

# Planet id 0..11 -> its name and the hand type it levels.
PLANET_NAMES = (
    "Mercury", "Venus", "Earth", "Mars", "Jupiter", "Saturn", "Uranus",
    "Neptune", "Pluto", "Planet X", "Ceres", "Eris",
)
PLANET_HAND = np.array([
    HandType.ONE_PAIR, HandType.TWO_PAIR, HandType.THREE_KIND,
    HandType.STRAIGHT, HandType.FLUSH, HandType.FULL_HOUSE,
    HandType.FOUR_KIND, HandType.STRAIGHT_FLUSH, HandType.HIGH_CARD,
    HandType.FIVE_KIND, HandType.FLUSH_HOUSE, HandType.FLUSH_FIVE,
], dtype=np.int32)

# Blind chip requirement per ante 1..8 and blind (small, big, boss).
_blind_chips = np.array([
    [300, 450, 600],
    [450, 675, 900],
    [600, 900, 1200],
    [900, 1350, 1800],
    [1350, 2025, 2700],
    [2100, 3150, 4200],
    [3300, 4950, 6600],
    [5250, 7875, 10500],
], dtype=np.int64)
