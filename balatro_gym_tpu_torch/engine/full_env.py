"""The flagship full-game environment: state, reset, step and observations.

Port of ``balatro_gym_tpu/engine/full_env.py``. A state
(:class:`FullEnvState`) holds every env of a batch: ``[B]`` or ``[B, n]``
tensors, int32 and bool at the production widths (the x64-off
configuration of the reference), with the Threefry key and the stream
counters as int64 tensors of 32-bit words (``ops/kernel_rng.py``). Every
function runs on the device its state lies on.

* :func:`reset` starts episodes from keys; :func:`step` is the engine's
  step of every env, :func:`step_autoreset` the same with done envs
  replaced by :func:`reset` of ``fold_in(key, step_count)``.
* The step's arithmetic is the fused full-env rollout's
  (``ops/fused_full_rollout.py``) without its autoreset: :func:`step`
  packs the state into rows, runs ``ops.fused_policy_rollout.
  env_step_fused`` (``env_step_kernel`` on a card, the plain rows with the
  state on the CPU) and unpacks. On a card :func:`reset`,
  :func:`autoreset` and :func:`step_autoreset` write fresh episodes with
  ``env_reset_fused`` (``env_reset_kernel``, the engine's permutation
  shuffle) on packed rows; on the CPU they run :func:`reset_reference`,
  the same reset in torch.
* :func:`observe_vector` and :func:`action_mask` are the batched policy
  inputs: K3b (``observe_fused``) on a card, its plain rows on the CPU.
  :func:`observe` is the reference's Dict observation, batched, in torch.

Spans (``utils/profiling.py``): ``engine.step_autoreset`` (a pack, the
step and reset kernels' launches as ``engine.kernels``, an unpack),
``engine.reset``, ``engine.autoreset`` and ``engine.observe`` (a pack and
K3b as ``engine.k3b``, for :func:`observe_vector` and :func:`action_mask`
alike), with the packed-row conversions inside them as ``engine.pack`` and
``engine.unpack``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from balatro_gym_tpu_torch.core import cards as C
from balatro_gym_tpu_torch.core import rng as R
from balatro_gym_tpu_torch.core.constants import NUM_HAND_TYPES, HandType, Phase
from balatro_gym_tpu_torch.core.device import const
from balatro_gym_tpu_torch.engine import consumable_logic as CL
from balatro_gym_tpu_torch.engine import shop_logic as SL
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.utils import profiling as P

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


def reset(keys) -> FullEnvState:
    """Fresh episodes, one per key (``keys``: ``[B, 2]`` Threefry words):
    the 52-card deck shuffled by ``permutation(fold_in(stream_key(key,
    'deck_shuffle'), 0), 52)``, phase BLIND_SELECT, money 4, blind 300.
    On a card ``env_reset_kernel`` writes every env's rows; with the keys
    on the CPU it is :func:`reset_reference`."""
    with P.span("engine.reset"):
        if keys.device.type == "cpu":
            return reset_reference(keys)
        from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
        from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
        B, dev = keys.shape[0], keys.device
        rows = {"cards": torch.empty(6, MAX_DECK, B, dtype=torch.int32, device=dev),
                "ints": torch.empty(FF.NI, B, dtype=torch.int32, device=dev),
                "rng": torch.empty(FF.NR, B, dtype=torch.int32, device=dev)}
        every = torch.ones(B, dtype=torch.bool, device=dev)
        return _unpack(FP.env_reset_fused(rows, every, keys, device=dev))


def reset_reference(keys) -> FullEnvState:
    """:func:`reset` in torch, on the keys' device: the plain version of
    ``env_reset_kernel``."""
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


def autoreset(state: FullEnvState, done) -> FullEnvState:
    """``state`` with each ``done`` env replaced by ``reset(fold_in(key,
    step_count))``: on a card ``env_reset_kernel`` on the packed state, on
    the CPU :func:`reset_reference` merged where done."""
    with P.span("engine.autoreset"):
        if state.ante.device.type != "cpu":
            from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
            packed = FP.env_reset_fused(_pack(state), done, device=state.ante.device)
            return _unpack(packed)
        k1, k2 = KR.fold_in(state.key[:, 0], state.key[:, 1], state.step_count.to(torch.int64))
        return where_envs(done, reset_reference(torch.stack([k1, k2], -1)), state)


def _hand_card_view(state: FullEnvState):
    """The card channels of the 8 selectable hand positions: (ranks, suits,
    enh, ed, seal) ``[B, 8]`` int32, zero where no card is, and present
    ``[B, 8]`` bool."""
    hidx = state.hand_idx[:, :SEL]
    present = (torch.arange(SEL, device=hidx.device) < state.hand_n[:, None]) & (hidx >= 0)
    slot = hidx.clamp(0, MAX_DECK - 1).long()
    return (*(torch.where(present, ch.gather(1, slot), 0)
              for ch in (state.card_rank, state.card_suit, state.card_enh, state.card_ed,
                         state.card_seal)), present)


# The kernels' modules import this one, so functions import them when called.
def _pack(state: FullEnvState):
    from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
    with P.span("engine.pack"):
        return FF.pack_full_state(state)


def _unpack(packed) -> FullEnvState:
    from balatro_gym_tpu_torch.ops import fused_full_rollout as FF
    with P.span("engine.unpack"):
        return FF.unpack_full_state(packed)


def _policy_inputs(state: FullEnvState):
    from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
    with P.span("engine.observe"):
        rows = _pack(state)
        with P.span("engine.k3b"):
            return FP.observe_fused(rows, device=state.ante.device)


def observe_vector(state: FullEnvState) -> torch.Tensor:
    """``[B, 189]`` float32: the reference's ``observe_vector`` of every env
    (hand rank and suit one-hots, jokers, levels, shop, phase, scalars)."""
    return _policy_inputs(state)[0]


def action_mask(state: FullEnvState) -> torch.Tensor:
    """``[B, 60]`` bool: the reference's ``action_mask`` of every env."""
    return _policy_inputs(state)[1]


def step(state: FullEnvState, actions):
    """One engine step of every env (``actions``: ``[B]`` ids): (state,
    reward ``[B]`` float32, done ``[B]`` bool). A done env keeps its final
    state, done set; an illegal action costs -1 and changes nothing but the
    step count; an env already over (done, ante past 100 or a career past
    1e9) gets 0."""
    from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
    packed, reward, done = FP.env_step_fused(_pack(state), actions, device=state.ante.device)
    return _unpack(packed), reward, done


def step_autoreset(state: FullEnvState, actions):
    """:func:`step`, with each done env replaced by ``reset(fold_in(key,
    step_count))`` of its post-step state: on a card pack,
    ``env_step_kernel``, ``env_reset_kernel`` on the done envs, unpack."""
    dev = state.ante.device
    with P.span("engine.step_autoreset"):
        if dev.type == "cpu":
            st, reward, done = step(state, actions)
            return autoreset(st, done), reward, done
        from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
        rows = _pack(state)
        with P.span("engine.kernels"):
            packed, reward, done = FP.env_step_fused(rows, actions, device=dev)
            FP.env_reset_fused(packed, done, device=dev)
        return _unpack(packed), reward, done


def observe(state: FullEnvState) -> dict:
    """The reference's Dict observation of every env: its keys, each a
    ``[B]`` or ``[B, n]`` int32 or float32 tensor on the state's device (the
    Gym shell casts them to the reference's numpy dtypes)."""
    i32, dev = torch.int32, state.ante.device
    hidx = state.hand_idx[:, :SEL]
    present = (torch.arange(SEL, device=dev) < state.hand_n[:, None]) & (hidx >= 0)
    slot = hidx.clamp(0, MAX_DECK - 1).long()
    rank, suit = state.card_rank.gather(1, slot), state.card_suit.gather(1, slot)
    in_shop = (state.phase == int(Phase.SHOP))[:, None]
    progress = (state.round_chips_scored.to(torch.float32)
                / state.chips_needed.clamp(min=1).to(torch.float32)).clamp(max=2.0)
    return {
        "hand": torch.where(present, (rank - 2) * 4 + suit, -1),
        "hand_size": state.hand_n,
        "deck_size": state.card_alive.sum(1, dtype=i32),
        "selected_cards": state.selected.to(i32),
        "chips_scored": state.chips_scored,
        "round_chips_scored": state.round_chips_scored,
        "progress_ratio": progress,
        "mult": torch.ones_like(state.ante),
        "chips_needed": state.chips_needed,
        "money": state.money,
        "ante": state.ante,
        "round": state.round,
        "hands_left": state.hands_left,
        "discards_left": state.discards_left,
        "joker_count": state.joker_n,
        "joker_ids": torch.cat([state.jokers, torch.zeros_like(state.jokers)], 1),
        "joker_slots": state.joker_slots,
        "consumable_count": state.cons_n,
        # enum-name entries (+100) observe as id 0, as in the reference
        "consumables": torch.where(state.cons >= CL.ENUMNAME_OFFSET, 0, state.cons),
        "consumable_slots": state.cons_slots,
        "shop_items": torch.where(in_shop, state.shop_type, 0),
        "shop_costs": torch.where(in_shop, state.shop_cost, 0),
        "shop_rerolls": state.shop_reroll_cost,
        "hand_levels": state.hand_levels,
        "phase": state.phase,
        "action_mask": action_mask(state).to(i32),
        "hands_played": state.hands_played_total,
        "best_hand_this_ante": state.best_hand_this_ante,
        "boss_blind_active": state.boss_active.to(i32),
        "boss_blind_type": torch.where(state.boss_active, state.boss_id, 0),
        "face_down_cards": state.face_down.to(i32),
    }
