"""Card primitives: suit/modifier enums and static effect tables.

Port of ``balatro_gym_tpu/core/cards.py``. A card is a (rank, suit)
pair of integers plus modifier channels; ranks are 2..14 (11=J .. 14=A, 0 =
no card) and suits follow the canonical order CLUBS=0, DIAMONDS=1, HEARTS=2,
SPADES=3. Tables are numpy; callers move them to a device with
``core.device.const``.
"""
from __future__ import annotations

from enum import IntEnum, unique

import numpy as np


@unique
class Suit(IntEnum):
    CLUBS = 0
    DIAMONDS = 1
    HEARTS = 2
    SPADES = 3


@unique
class Enhancement(IntEnum):
    NONE = 0
    BONUS = 1   # +30 chips
    MULT = 2    # +4 mult
    WILD = 3    # any suit
    GLASS = 4   # x2 mult, 1/4 destroy
    STEEL = 5   # x1.5 mult while held
    STONE = 6   # +50 chips, no rank/suit
    GOLD = 7    # $3 held at end of round
    LUCKY = 8   # 1/5 +20 mult, 1/15 $20


@unique
class Edition(IntEnum):
    NONE = 0
    FOIL = 1          # +50 chips
    HOLOGRAPHIC = 2   # +10 mult
    POLYCHROME = 3    # x1.5 mult
    NEGATIVE = 4      # +1 joker slot


@unique
class Seal(IntEnum):
    NONE = 0
    GOLD = 1    # $3 when played & scored
    RED = 2     # retrigger
    BLUE = 3    # planet on play
    PURPLE = 4  # tarot on discard


NUM_RANKS = 13          # ranks 2..14
NO_CARD = 0             # rank sentinel for empty slots

SUIT_SYMBOLS = "\u2663\u2666\u2665\u2660"  # clubs, diamonds, hearts, spades
SUIT_NAMES = ("Clubs", "Diamonds", "Hearts", "Spades")
RANK_SHORT = {10: "T", 11: "J", 12: "Q", 13: "K", 14: "A"}

# Base chip value per rank: 2-10 face value, J/Q/K = 10, A = 11.
RANK_CHIPS = np.array([0, 0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 10, 10, 10, 11],
                      dtype=np.int32)
# Enhancement chip bonus (BONUS +30, STONE +50) and mult bonus (MULT +4).
ENH_CHIPS = np.array([0, 30, 0, 0, 0, 0, 50, 0, 0], dtype=np.int32)
ENH_MULT = np.array([0, 0, 4, 0, 0, 0, 0, 0, 0], dtype=np.int32)
# Enhancement x-mult when scored (GLASS x2).
ENH_XMULT = np.array([1, 1, 1, 1, 2, 1, 1, 1, 1], dtype=np.float32)
STEEL_IN_HAND_XMULT = 1.5

# Edition chip bonus (FOIL +50), mult bonus (HOLO +10), x-mult (POLY x1.5).
ED_CHIPS = np.array([0, 50, 0, 0, 0], dtype=np.int32)
ED_MULT = np.array([0, 0, 10, 0, 0], dtype=np.int32)
ED_XMULT = np.array([1.0, 1.0, 1.0, 1.5, 1.0], dtype=np.float32)

# Seal money when played (GOLD seal $3).
SEAL_MONEY = np.array([0, 3, 0, 0, 0], dtype=np.int32)

GOLD_CARD_MONEY = 3        # $ per Gold card held at the end of a round
LUCKY_MONEY_P = 0.0667     # chance of a Lucky card's $20


def standard_deck_arrays():
    """The ordered 52-card deck as (ranks, suits) int8 arrays: for suit in
    (C, D, H, S), for rank in 2..14."""
    ranks = np.tile(np.arange(2, 15, dtype=np.int8), 4)
    suits = np.repeat(np.arange(4, dtype=np.int8), 13)
    return ranks, suits
