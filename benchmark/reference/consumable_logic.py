"""Consumable ids and tables of the flagship env.

Port of the constants of ``balatro_gym_tpu/engine/consumable_logic.py``
(see its docstring for the reference quirks they encode: enhancement
tarots, the cross-enum seal values of the seal spectrals, Wraith's
misspelled joker, Emperor's enum-name tarots at id + 100). The consumable
effects themselves run inside ``ops/fused_full_rollout.py``.
"""
from __future__ import annotations

import numpy as np

from . import cards as C

# Consumable obs ids.
TAROT_BASE, NUM_TAROT = 1, 22
PLANET_BASE, NUM_PLANET = 30, 12
SPECTRAL_BASE, NUM_SPECTRAL = 50, 18
ENUMNAME_OFFSET = 100  # +100: enum-name form, observes as 0

(FOOL, MAGICIAN, HIGH_PRIESTESS, EMPRESS, EMPEROR, HIEROPHANT, LOVERS,
 CHARIOT, STRENGTH, HERMIT, WHEEL, JUSTICE, HANGED_MAN, DEATH, TEMPERANCE,
 DEVIL, TOWER, STAR, MOON, SUN, JUDGEMENT, WORLD) = range(1, 23)

(FAMILIAR, GRIM, INCANTATION, TALISMAN, AURA, WRAITH, SIGIL, OUIJA,
 ECTOPLASM, IMMOLATE, ANKH, DEJA_VU, HEX, TRANCE, MEDIUM, CRYPTID,
 THE_SOUL, BLACK_HOLE) = range(50, 68)

# Enhancement a tarot applies to its first K selected cards (0: none).
ENH_TAROT = np.zeros(23, np.int32)
ENH_COUNT = np.zeros(23, np.int32)
for _t, _e, _k in [
    (MAGICIAN, C.Enhancement.LUCKY, 2), (EMPRESS, C.Enhancement.MULT, 2),
    (HIEROPHANT, C.Enhancement.BONUS, 2), (LOVERS, C.Enhancement.WILD, 1),
    (CHARIOT, C.Enhancement.STEEL, 1), (JUSTICE, C.Enhancement.GLASS, 1),
    (DEVIL, C.Enhancement.GOLD, 1), (TOWER, C.Enhancement.STONE, 1),
]:
    ENH_TAROT[_t] = _e
    ENH_COUNT[_t] = _k

# Seal value a seal spectral writes: the raw int of the reference's own
# consumable Seal enum, read back through the card Seal enum.
SEAL_SPEC = np.zeros(68, np.int32)
for _s, _v in [(TALISMAN, C.Seal.BLUE), (DEJA_VU, C.Seal.GOLD),
               (TRANCE, C.Seal.RED), (MEDIUM, C.Seal.PURPLE)]:
    SEAL_SPEC[_s] = _v

# Wraith's rare jokers (0: the misspelled name that matches nothing) and
# The Soul's legendaries.
WRAITH_JOKERS = np.array(
    [137, 138, 139, 140, 0, 142, 143, 144, 145, 146, 147, 148, 149, 150], np.int32)
SOUL_JOKERS = np.array([146, 147, 148, 149, 150], np.int32)

EDITIONS3 = np.array([C.Edition.FOIL, C.Edition.HOLOGRAPHIC, C.Edition.POLYCHROME],
                     np.int32)
# Enhancements of the cards Familiar, Grim and Incantation create.
ENH_POOL7 = np.array([C.Enhancement.BONUS, C.Enhancement.MULT, C.Enhancement.WILD,
                      C.Enhancement.GLASS, C.Enhancement.STEEL, C.Enhancement.GOLD,
                      C.Enhancement.LUCKY], np.int32)
