"""Frozen copy of the flagship env's state and its reset in torch.

Copied from the port's ``engine/full_env.py``: the batched
:class:`FullEnvState`, :func:`reset_reference` (the engine's permutation
shuffle) and :func:`where_envs`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cards as C
from . import rng as R
from .constants import NUM_HAND_TYPES, HandType, Phase
from .device import const
from . import shop_logic as SL
from . import kernel_rng as KR

MAX_DECK = 64     # 52 base cards + slots for created cards
MAX_HAND = 10     # hand positions; hand_size starts at 8 and never grows
SEL = 8           # selection actions cover hand positions 0-7
MAX_JOKERS = 5
MAX_CONS = 5

# Shaped-reward quality per hand type.
HAND_QUALITY = np.zeros(NUM_HAND_TYPES, np.float64)
for _h, _v in [(HandType.HIGH_CARD, 0.1), (HandType.ONE_PAIR, 0.5),
               (HandType.TWO_PAIR, 1.0), (HandType.THREE_KIND, 2.0),
               (HandType.STRAIGHT, 2.5), (HandType.FLUSH, 2.5),
               (HandType.FULL_HOUSE, 3.5), (HandType.FOUR_KIND, 5.0),
               (HandType.STRAIGHT_FLUSH, 7.0), (HandType.FIVE_KIND, 10.0)]:
    HAND_QUALITY[_h] = _v

# Blue-seal planet: consumable obs id per hand type (Mercury=30 .. Eris=41).
PLANET_OBS_OF_HAND = np.zeros(NUM_HAND_TYPES, np.int32)
for _p, _h in enumerate([HandType.ONE_PAIR, HandType.TWO_PAIR, HandType.THREE_KIND,
                         HandType.STRAIGHT, HandType.FLUSH, HandType.FULL_HOUSE,
                         HandType.FOUR_KIND, HandType.STRAIGHT_FLUSH, HandType.HIGH_CARD,
                         HandType.FIVE_KIND, HandType.FLUSH_HOUSE, HandType.FLUSH_FIVE]):
    PLANET_OBS_OF_HAND[_h] = 30 + _p


@dataclasses.dataclass
class FullEnvState:
    """A batch of flagship-env states; field names and meanings as in the
    reference's ``FullEnvState``."""
    card_rank: torch.Tensor           # [B, 64] i32 (2..14; 0 = slot unused)
    card_suit: torch.Tensor           # [B, 64] i32
    card_enh: torch.Tensor            # [B, 64] i32
    card_ed: torch.Tensor             # [B, 64] i32
    card_seal: torch.Tensor           # [B, 64] i32
    card_alive: torch.Tensor          # [B, 64] bool
    hand_idx: torch.Tensor            # [B, 10] i32 deck slots, -1 empty
    hand_n: torch.Tensor              # [B] i32
    selected: torch.Tensor            # [B, 8] bool
    face_down: torch.Tensor           # [B, 8] bool
    highlighted: torch.Tensor         # [B, 8] bool
    jokers: torch.Tensor              # [B, 5] i32 ids, 0 empty
    joker_n: torch.Tensor
    green_mult: torch.Tensor
    bus_mult: torch.Tensor
    cons: torch.Tensor                # [B, 5] i32 consumable obs ids
    cons_n: torch.Tensor
    vouchers: torch.Tensor            # [B] i32 bitset
    joker_slots: torch.Tensor
    cons_slots: torch.Tensor
    ante: torch.Tensor
    round: torch.Tensor
    phase: torch.Tensor
    chips_needed: torch.Tensor
    chips_scored: torch.Tensor
    round_chips_scored: torch.Tensor
    money: torch.Tensor
    hands_left: torch.Tensor
    discards_left: torch.Tensor
    hand_size: torch.Tensor
    hand_levels: torch.Tensor         # [B, 12] i32
    hand_play_counts: torch.Tensor    # [B, 12] i32
    shop_type: torch.Tensor           # [B, 10] i32
    shop_item: torch.Tensor
    shop_cost: torch.Tensor
    shop_n: torch.Tensor
    reroll_base: torch.Tensor
    shop_reroll_cost: torch.Tensor
    boss_active: torch.Tensor         # [B] bool
    boss_id: torch.Tensor             # [B] i32, -1 none
    boss_played_types: torch.Tensor   # [B] i32 bitset
    boss_first_hand: torch.Tensor     # [B] bool
    boss_verdant_req: torch.Tensor
    boss_played_slots: torch.Tensor   # [B, 64] bool
    hands_played_total: torch.Tensor
    hands_played_ante: torch.Tensor
    best_hand_this_ante: torch.Tensor
    jokers_sold: torch.Tensor
    key: torch.Tensor                 # [B, 2] int64 Threefry words (hi, lo)
    rng_counters: torch.Tensor        # [B, 16] int64 32-bit counters
    done: torch.Tensor                # [B] bool
    step_count: torch.Tensor          # [B] i32


def reset_reference(keys) -> FullEnvState:
    """Fresh episodes, one per key (``keys``: ``[B, 2]`` Threefry words):
    the 52-card deck shuffled by ``permutation(fold_in(stream_key(key,
    'deck_shuffle'), 0), 52)``, phase BLIND_SELECT, money 4, blind 300."""
    keys = keys.to(torch.int64)
    dev, B = keys.device, keys.shape[0]
    k1, k2 = keys[:, 0], keys[:, 1]
    counters = R.init_counters(B, dev)
    counters[R.STREAM_ID["deck_shuffle"]] += 1
    perm = KR.permutation(*KR.fold_in(*R.stream_key(k1, k2, "deck_shuffle"), 0), 52)
    base_rank, base_suit = C.standard_deck_arrays()
    i32 = torch.int32

    def full(shape, v, dtype=i32):
        return torch.full((B, *shape), v, dtype=dtype, device=dev)

    rank, suit, alive = full((MAX_DECK,), 0), full((MAX_DECK,), 0), full((MAX_DECK,), False, torch.bool)
    rank[:, :52] = const(base_rank, i32, dev)[perm]
    suit[:, :52] = const(base_suit, i32, dev)[perm]
    alive[:, :52] = True
    zero = full((), 0)
    return FullEnvState(
        card_rank=rank, card_suit=suit, card_enh=full((MAX_DECK,), 0),
        card_ed=full((MAX_DECK,), 0), card_seal=full((MAX_DECK,), 0), card_alive=alive,
        hand_idx=full((MAX_HAND,), -1), hand_n=zero,
        selected=full((SEL,), False, torch.bool), face_down=full((SEL,), False, torch.bool),
        highlighted=full((SEL,), False, torch.bool),
        jokers=full((MAX_JOKERS,), 0), joker_n=zero.clone(),
        green_mult=full((), 1), bus_mult=zero.clone(),
        cons=full((MAX_CONS,), 0), cons_n=zero.clone(), vouchers=zero.clone(),
        joker_slots=full((), 5), cons_slots=full((), 2),
        ante=full((), 1), round=full((), 1), phase=full((), int(Phase.BLIND_SELECT)),
        chips_needed=full((), 300), chips_scored=zero.clone(),
        round_chips_scored=zero.clone(), money=full((), 4),
        hands_left=full((), 4), discards_left=full((), 3), hand_size=full((), 8),
        hand_levels=full((NUM_HAND_TYPES,), 1), hand_play_counts=full((NUM_HAND_TYPES,), 0),
        shop_type=full((SL.SHOP_SLOTS,), 0), shop_item=full((SL.SHOP_SLOTS,), 0),
        shop_cost=full((SL.SHOP_SLOTS,), 0), shop_n=zero.clone(),
        reroll_base=full((), SL.REROLL_BASE), shop_reroll_cost=full((), 5),
        boss_active=full((), False, torch.bool), boss_id=full((), -1),
        boss_played_types=zero.clone(), boss_first_hand=full((), True, torch.bool),
        boss_verdant_req=full((), 5), boss_played_slots=full((MAX_DECK,), False, torch.bool),
        hands_played_total=zero.clone(), hands_played_ante=zero.clone(),
        best_hand_this_ante=zero.clone(), jokers_sold=zero.clone(),
        key=keys.clone(), rng_counters=counters.T.contiguous(),
        done=full((), False, torch.bool), step_count=zero.clone(),
    )


def where_envs(p, a, b):
    """Per env, ``a`` where ``p`` (``[B]`` bool), else ``b``: two tensors
    with the env axis first, or two dataclasses of such tensors or of such
    dataclasses (a :class:`FullEnvState`, a shaped state around one)."""
    if torch.is_tensor(a):
        return torch.where(p.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return type(a)(**{f.name: where_envs(p, getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})
