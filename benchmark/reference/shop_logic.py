"""Shop inventory and economy of the flagship env, on batched tensors.

Port of ``balatro_gym_tpu/engine/shop_logic.py``. An inventory is 3 packs
(Standard, Joker, one of Tarot/Planet/Spectral), 3 distinct unowned jokers,
1 voucher and 2 single cards (cost 40, not scaled by ante); item costs are
``int(base * 1.15**(ante-1))``, x0.9 with Magic Trick; a reroll charges
``int(base * mult)`` and grows the base by 1.35.

Every function takes a batch of shops: ``[B]`` scalars and ``[B, 10]``
slot rows, int32, keys as ``[B, 2]`` Threefry words. The fused full-env
rollout carries its own copy of the generator in its ``[10, B]`` layout
(``ops/fused_full_rollout._shop_gen``); tests/test_torch_macro_env.py holds
the two against each other on the same keys.
"""
from __future__ import annotations

import numpy as np
import torch

from . import pow_tables as PT
from .joker_tables import JOKER_BASE_COST_NP, NUM_JOKERS

SHOP_SLOTS = 10
N_ITEMS = 9  # 3 packs + 3 jokers + 1 voucher + 2 cards

# Item type codes; 0 = empty slot.
IT_EMPTY, IT_PACK, IT_CARD, IT_JOKER, IT_VOUCHER = 0, 1, 2, 3, 4

# Pack kinds (the shop_item payload of IT_PACK).
PACK_STANDARD, PACK_JOKER, PACK_TAROT, PACK_PLANET, PACK_SPECTRAL = 0, 1, 2, 3, 4
PACK_COSTS = np.array([250, 500, 600, 900, 1300], dtype=np.int32)

# Voucher ids (bit positions in the voucher bitset).
V_MAGIC_TRICK, V_MINIMALIST = 0, 1
VOUCHER_COSTS = np.array([600, 750], dtype=np.int32)
VOUCHER_NAMES = ("Magic Trick", "Minimalist")

CARD_COST = 40
REROLL_BASE = 50
REROLL_GROWTH = 1.35
ANTE_COST_MULT = 1.15

_I32 = torch.int32
_F32 = torch.float32
_ELIGIBLE = JOKER_BASE_COST_NP > 0          # base_cost > 0: sold in the shop
# the low 12 bits of a joker's priority word: base_cost4 << 8 | 255 - id
_JPAYLOAD = (JOKER_BASE_COST_NP.astype(np.int64) << 8) | (255 - np.arange(NUM_JOKERS))
_F09 = float(np.float32(0.9))
_F135 = float(np.float32(REROLL_GROWTH))


def _trunc_i32(x):
    """``jnp.trunc(x).astype(int32)`` of non-negative float32 costs, which
    XLA saturates at the int32 maximum (a cost past ante ~100)."""
    t = torch.trunc(x)
    big = t >= 2.0 ** 31
    return torch.where(big, torch.iinfo(_I32).max, torch.where(big, 0.0, t).to(_I32))


def cost_mult(ante, vouchers):
    """``[B]`` float32: 1.15**(ante-1) from the float64 table rounded once,
    x0.9 with Magic Trick."""
    m = PT.pow115(ante - 1, _F32)
    magic = ((vouchers >> V_MAGIC_TRICK) & 1) == 1
    return m * torch.where(magic, _F09, 1.0)
