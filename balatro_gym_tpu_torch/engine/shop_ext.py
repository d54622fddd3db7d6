"""The modular shop handler's semantics, opt-in, on batched tensors.

Port of ``balatro_gym_tpu/engine/shop_ext.py`` (reference:
envs/phase_handlers/shop_phase.py:20-325, dead code in the reference; see
PARITY.md #B14). The flagship engine's shop has none of these effects;
they are here for a caller that wants the handler's documented rules:

* selling joker slot j fails with -1 if the slot is eternal (a ``[B, 5]``
  position mask, shifted with the slots on a sale);
* sell values ``max(3, base_cost // 2)``, Egg 5, Gift Card 0 (the sale
  still goes through);
* sale effects: Luchador sets a "boss disabled" flag; Swashbuckler pays
  ``jokers_sold`` counted after this sale;
* the sell reward ``sell_value / 10``; per-type purchase rewards (pack 5,
  joker 15, card 3, voucher 10);
* the 16-voucher table: descriptive in the reference (only the text is
  ever read), kept as (kind, magnitude) data beside the descriptions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from balatro_gym_tpu_torch.core.device import const
from balatro_gym_tpu_torch.engine.shop_logic import IT_CARD, IT_JOKER, IT_PACK, IT_VOUCHER
from balatro_gym_tpu_torch.ops.joker_tables import (
    J_EGG, J_GIFT_CARD, J_LUCHADOR, J_SWASHBUCKLER, JOKER_BASE_COST_NP)

MAX_JOKERS = 5
_I32 = torch.int32

# Sell values (shop_phase.py:273-287)
SELL_VALUE = np.maximum(3, JOKER_BASE_COST_NP.astype(np.int64) // 2).astype(np.int32)
SELL_VALUE[0] = 0                # id 0 = empty slot
SELL_VALUE[J_EGG] = 5            # "Egg gains value over time"
SELL_VALUE[J_GIFT_CARD] = 0      # "Gift cards can't be sold"

# Purchase rewards (shop_phase.py:151-158), by shop_logic item type
PURCHASE_REWARD = np.zeros(8, np.float32)
PURCHASE_REWARD[[IT_PACK, IT_JOKER, IT_CARD, IT_VOUCHER]] = (5.0, 15.0, 3.0, 10.0)


def sell_value(joker_id):
    """The sell value of joker ids (a tensor), Egg and Gift Card special."""
    return const(SELL_VALUE, _I32, joker_id.device)[joker_id.long().clamp(0, len(SELL_VALUE) - 1)]


def purchase_reward(item_type):
    """The modular handler's fixed buy reward of item types (a tensor)."""
    return const(PURCHASE_REWARD, torch.float32, item_type.device)[item_type.long().clamp(0, 7)]


class SellResult(NamedTuple):
    jokers: torch.Tensor         # [B, 5] i32 after the sale (shifted down)
    joker_n: torch.Tensor        # [B] i32
    eternal: torch.Tensor        # [B, 5] bool, shifted with the slots
    money: torch.Tensor          # [B] i32 after the sale
    jokers_sold: torch.Tensor    # [B] i32, + 1 on a sale
    reward: torch.Tensor         # [B] f32: sell_value / 10, or -1 blocked or invalid
    sold_id: torch.Tensor        # [B] i32, 0 if nothing sold
    boss_disabled: torch.Tensor  # [B] bool: Luchador's sale effect fired
    swash_bonus: torch.Tensor    # [B] i32: Swashbuckler's bonus money


def sell_joker(jokers, joker_n, eternal, money, jokers_sold, idx) -> SellResult:
    """One SELL_JOKER action of every env under the modular handler's rules
    (``jokers`` ``[B, 5]`` ids, ``eternal`` ``[B, 5]`` bool, ``idx`` ``[B]``
    the slot to sell)."""
    slots = torch.arange(MAX_JOKERS, device=jokers.device)
    at = idx.long().clamp(0, MAX_JOKERS - 1)[:, None]
    valid = (idx >= 0) & (idx < joker_n)
    ok = valid & ~eternal.gather(1, at)[:, 0]

    sold_id = torch.where(ok, jokers.gather(1, at)[:, 0], 0)
    value = torch.where(ok, sell_value(sold_id), 0)

    # shift the sold slot out: the jokers and the eternal mask move together
    nxt = (slots + 1).clamp(max=MAX_JOKERS - 1)
    before = slots < idx[:, None]
    tail = slots >= (joker_n - 1)[:, None]
    new_jok = torch.where(tail, 0, torch.where(before, jokers, jokers[:, nxt]))
    new_et = torch.where(tail, False, torch.where(before, eternal, eternal[:, nxt]))
    jokers = torch.where(ok[:, None], new_jok, jokers)
    eternal = torch.where(ok[:, None], new_et, eternal)

    # jokers_sold counts this sale before the sale effects, so a
    # Swashbuckler's bonus includes itself
    jokers_sold = jokers_sold + ok.to(_I32)
    swash_bonus = torch.where(ok & (sold_id == J_SWASHBUCKLER), jokers_sold, 0)
    reward = torch.where(ok, value.to(torch.float32) / torch.full_like(value, 10,
                                                                      dtype=torch.float32), -1.0)
    return SellResult(jokers, joker_n - ok.to(_I32), eternal, money + value + swash_bonus,
                      jokers_sold, reward, sold_id, ok & (sold_id == J_LUCHADOR), swash_bonus)


# The voucher table (shop_phase.py:300-321): effect kinds
(VE_SHOP_SLOT, VE_DISCOUNT_PCT, VE_EDITION_RATE, VE_REROLL_DISCOUNT,
 VE_CONS_SLOT, VE_TELESCOPE, VE_EXTRA_HAND, VE_PACK_RATE, VE_HAND_SIZE,
 VE_EXTRA_DISCARD, VE_TAROT_RATE, VE_PLANET_RATE, VE_INTEREST) = range(13)

# name -> (effect kind, magnitude, the reference's description verbatim)
VOUCHER_EFFECTS = {
    "Overstock": (VE_SHOP_SLOT, 1, "+1 card slot in shop"),
    "Clearance Sale": (VE_DISCOUNT_PCT, 25, "All items in shop are 25% off"),
    "Hone": (VE_EDITION_RATE, 2,
             "Foil, Holographic, and Polychrome cards appear 2X more often"),
    "Reroll Surplus": (VE_REROLL_DISCOUNT, 2, "Rerolls cost $2 less"),
    "Crystal Ball": (VE_CONS_SLOT, 1, "+1 consumable slot"),
    "Telescope": (VE_TELESCOPE, 1,
                  "Celestial Packs always contain your most used poker hand's Planet card"),
    "Grabber": (VE_EXTRA_HAND, 1, "+1 hand per round"),
    "Dusk": (VE_PACK_RATE, 2, "Tarot and Planet cards appear 2X more often in the shop"),
    "Retcon": (VE_REROLL_DISCOUNT, 2, "Rerolls cost $2 less (again)"),
    "Paint Brush": (VE_HAND_SIZE, 1, "+1 hand size"),
    "Overstock Plus": (VE_SHOP_SLOT, 1, "+1 card slot in shop (again)"),
    "Liquidation": (VE_DISCOUNT_PCT, 50, "All items in shop are 50% off"),
    "Wasteful": (VE_EXTRA_DISCARD, 1, "Permanently gain +1 discard every round"),
    "Tarot Merchant": (VE_TAROT_RATE, 2, "Tarot cards appear 2X more often in the shop"),
    "Planet Merchant": (VE_PLANET_RATE, 2, "Planet cards appear 2X more often in the shop"),
    "Seed Money": (VE_INTEREST, 5,
                   "Gain $1 interest for every $5 you have at the end of the round"),
}
VOUCHER_NAMES_16 = tuple(VOUCHER_EFFECTS)
# dense [16] tables, indexed by position in VOUCHER_NAMES_16
VOUCHER_KIND = np.array([VOUCHER_EFFECTS[n][0] for n in VOUCHER_NAMES_16], np.int32)
VOUCHER_MAG = np.array([VOUCHER_EFFECTS[n][1] for n in VOUCHER_NAMES_16], np.int32)


def voucher_effect(name: str) -> str:
    """The reference's description lookup, with its fallback string."""
    eff = VOUCHER_EFFECTS.get(name)
    return eff[2] if eff else "Unknown voucher effect"
