"""Boss blind ids and names, as the flagship env reads them.

Port of the ids and names of ``balatro_gym_tpu/ops/boss.py`` (the
reference enum's values 1..28). Every boss pays $5 when beaten. The boss
functions (selection, play restrictions, scoring ratios, on-hand-drawn
effects) are inlined in the step of ``ops/fused_full_rollout.py``, which
the engine's ``step`` runs too.
"""
from __future__ import annotations

N_BOSS = 29  # ids 1..28; 0 unused

(HOOK, WALL, WHEEL, HOUSE, MARK, FISH, PSYCHIC, GOAD, WATER, WINDOW, MANACLE,
 EYE, MOUTH, PLANT, SERPENT, PILLAR, NEEDLE, HEAD, CLUB, TOOTH, FLINT, OXIDE,
 ARM, VIOLET, VERDANT, AMBER, CRIMSON, CERULEAN) = range(1, 29)

BOSS_MONEY_REWARD = 5

BOSS_NAMES = (
    "", "The Hook", "The Wall", "The Wheel", "The House", "The Mark",
    "The Fish", "The Psychic", "The Goad", "The Water", "The Window",
    "The Manacle", "The Eye", "The Mouth", "The Plant", "The Serpent",
    "The Pillar", "The Needle", "The Head", "The Club", "The Tooth",
    "The Flint", "The Oxide", "The Arm", "The Violet", "The Verdant",
    "The Amber", "The Crimson", "The Cerulean",
)
