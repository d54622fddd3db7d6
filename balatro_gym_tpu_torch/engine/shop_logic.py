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

from balatro_gym_tpu_torch.core import pow_tables as PT
from balatro_gym_tpu_torch.core import rng as R
from balatro_gym_tpu_torch.core.device import const
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.ops.joker_tables import JOKER_BASE_COST_NP, NUM_JOKERS

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


def generate_inventory(keys, ante, owned_jokers, vouchers):
    """A fresh 9-item inventory per env: (types, items, costs ``[B, 10]``
    int32, n ``[B]`` int32).

    keys: ``[B, 2]`` Threefry words, split 4 ways into the pack, joker,
    voucher and card keys. The three jokers are the top 3 of packed
    priority words ``key20 | base_cost4 | 255 - id`` over the shop-eligible
    ids not in ``owned_jokers`` (``[B, J]``, 0 = empty), all distinct, so
    the order is the reference's iterated argmax."""
    keys = keys.to(torch.int64)
    dev, B = keys.device, keys.shape[0]
    k_pack, k_jok, k_vouch, k_cards = (KR.split_child(keys[:, 0], keys[:, 1], i)
                                       for i in range(4))
    mult = cost_mult(ante, vouchers)

    third = KR.randint(*k_pack, PACK_TAROT, PACK_SPECTRAL + 1).to(_I32)
    ids = torch.arange(NUM_JOKERS, device=dev)
    owned = (ids[None, :, None] == owned_jokers.clamp(0, NUM_JOKERS - 1)[:, None, :]).any(-1)
    eligible = const(_ELIGIBLE, torch.bool, dev)[None, :] & ~owned
    bits = KR.random_bits32(k_jok[0][:, None], k_jok[1][:, None], ids[None, :])
    words = (bits & 0xFFF00000) | const(_JPAYLOAD, torch.int64, dev)[None, :]
    top3 = R.sort_key_i32(words, eligible).topk(3, dim=1).values.to(torch.int64)
    jids = (255 - (top3 & 255)).to(_I32)          # the sign flip leaves the low bits
    jcost = const(JOKER_BASE_COST_NP, _F32, dev)[jids.long()]

    vid = KR.randint(*k_vouch, 0, 2).to(_I32)
    cards = torch.stack([KR.randint(*k_cards, 0, 52, i) for i in range(2)], 1).to(_I32)

    z = torch.zeros(B, 1, dtype=_I32, device=dev)
    pack_kind = torch.cat([z + PACK_STANDARD, z + PACK_JOKER, third[:, None]], 1)
    types = torch.tensor([IT_PACK] * 3 + [IT_JOKER] * 3 + [IT_VOUCHER] + [IT_CARD] * 2
                         + [IT_EMPTY], dtype=_I32, device=dev).expand(B, -1).contiguous()
    items = torch.cat([pack_kind, jids, vid[:, None], cards, z], 1)
    base = torch.cat([const(PACK_COSTS, _F32, dev)[pack_kind.long()], jcost,
                      const(VOUCHER_COSTS, _F32, dev)[vid.long()][:, None]], 1)
    costs = torch.cat([_trunc_i32(base * mult[:, None]), z + CARD_COST, z + CARD_COST, z], 1)
    return types, items, costs, torch.full((B,), N_ITEMS, dtype=_I32, device=dev)


def pop_item(types, items, costs, n, idx):
    """Remove item ``idx`` (``[B]``) from each shop, shifting the tail left
    and zeroing past the new end (``list.pop``)."""
    slots = torch.arange(SHOP_SLOTS, device=types.device)
    nxt = (slots + 1).clamp(max=SHOP_SLOTS - 1)

    def take(a):
        out = torch.where(slots < idx[:, None], a, a[:, nxt])
        return torch.where(slots < (n - 1)[:, None], out, 0)

    return take(types), take(items), take(costs), n - 1


def reroll_charge(reroll_base, ante, vouchers):
    """(the cost to charge now, the next base), ``[B]`` int32 each."""
    mult = cost_mult(ante, vouchers)
    base = reroll_base.to(_F32)
    return _trunc_i32(base * mult), _trunc_i32(base * _F135)


def displayed_reroll_cost(ante, vouchers):
    """``int(50 * mult)``: the reroll cost the state shows from a shop's
    generation on, not updated after rerolls (the reference's stale value
    that the action mask reads)."""
    return _trunc_i32(float(REROLL_BASE) * cost_mult(ante, vouchers))
