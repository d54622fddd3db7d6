"""Pack opening: the modular handler's semantics, opt-in, on batched states.

Port of ``balatro_gym_tpu/engine/pack_logic.py`` (reference:
envs/phase_handlers/pack_open.py:31-252, dead code in the reference; see
PARITY.md #B12). The flagship engine never opens a pack; these functions
run on its ``FullEnvState`` for a caller that wants the handler's
documented semantics:

* the contents are the caller's (five slots of kind, id and card
  modifiers); a pack allows 1 pick, a Mega pack 2;
* a pick applies its item with the reference's rewards: a playing card +3
  (+2 with an enhancement, +3 with an edition, +2 with a seal) and joins
  the deck in the highest free slot; a consumable +8 planet / +5 tarot /
  +10 spectral, or -1 with its slots full; a joker +15, or -1 with its
  slots full (the unreachable rarity bonus is left out);
* a repeated or out-of-range pick, or a pick from a closed pack, is -1;
* SKIP pays -1 per pick left; the last pick or SKIP returns to the shop.

Every function takes a batch (``[B]`` and ``[B, n]`` tensors) and selects
per env.
"""
from __future__ import annotations

import dataclasses

import torch

from balatro_gym_tpu_torch.core.constants import Action, Phase
from balatro_gym_tpu_torch.engine import consumable_logic as CL

PACK_SIZE = 5

# item_kind channel values
K_CARD = 0
K_CONSUMABLE = 1
K_JOKER = 2

# pick counts: 1, Mega packs 2 (pack_open.py:143-158)
PICKS_BASE = 1
PICKS_MEGA = 2

_I32 = torch.int32
_F32 = torch.float32


@dataclasses.dataclass
class PackState:
    """The contents of one opened pack per env (five slots) and the
    selection's progress."""

    item_kind: torch.Tensor   # [B, 5] i32: K_CARD / K_CONSUMABLE / K_JOKER
    item_id: torch.Tensor     # [B, 5] i32: card 0-51 / consumable obs id / joker id
    item_enh: torch.Tensor    # [B, 5] i32 (cards only)
    item_ed: torch.Tensor     # [B, 5] i32
    item_seal: torch.Tensor   # [B, 5] i32
    picked: torch.Tensor      # [B, 5] bool
    picks_left: torch.Tensor  # [B] i32
    active: torch.Tensor      # [B] bool


def open_pack(st, item_kind, item_id, item_enh=None, item_ed=None, item_seal=None,
              mega: bool = False):
    """Enter the pack phase with the caller's contents (``[B, 5]`` each;
    absent modifiers are 0). Returns (state, PackState)."""
    dev = st.phase.device
    kind = torch.as_tensor(item_kind, device=dev).to(_I32)
    z5 = torch.zeros_like(kind)

    def ch(x):
        return z5 if x is None else torch.as_tensor(x, device=dev).to(_I32).expand_as(kind)

    pack = PackState(
        item_kind=kind, item_id=ch(item_id), item_enh=ch(item_enh), item_ed=ch(item_ed),
        item_seal=ch(item_seal), picked=torch.zeros_like(kind, dtype=torch.bool),
        picks_left=torch.full_like(st.phase, PICKS_MEGA if mega else PICKS_BASE),
        active=torch.ones_like(st.phase, dtype=torch.bool))
    return dataclasses.replace(st, phase=torch.full_like(st.phase, int(Phase.PACK_OPEN))), pack


def _at(x, onehot5):
    """The entry of ``[B, 5]`` ``x`` at each env's picked slot."""
    return torch.where(onehot5, x, 0).sum(1, dtype=_I32)


def _apply_card(st, pack, onehot5):
    """A playing card joins the deck in the highest free slot."""
    free = ~st.card_alive
    rev_cum = free.flip(1).to(_I32).cumsum(1).flip(1)
    take = free & (rev_cum == 1)
    cid, enh, ed, seal = (_at(x, onehot5) for x in (pack.item_id, pack.item_enh,
                                                    pack.item_ed, pack.item_seal))
    any_free = free.any(1)

    def put(old, v):
        return torch.where(take, v[:, None], old)

    upd = {"card_rank": put(st.card_rank, cid % 13 + 2), "card_suit": put(st.card_suit, cid // 13),
           "card_enh": put(st.card_enh, enh), "card_ed": put(st.card_ed, ed),
           "card_seal": put(st.card_seal, seal), "card_alive": st.card_alive | take}
    reward = torch.where(any_free, 3.0 + torch.where(enh > 0, 2.0, 0.0)
                         + torch.where(ed > 0, 3.0, 0.0) + torch.where(seal > 0, 2.0, 0.0), -1.0)
    return upd, reward


def _apply_consumable(st, pack, onehot5):
    """A consumable joins the inventory if a slot is free."""
    cid = _at(pack.item_id, onehot5)
    ok = st.cons_n < st.cons_slots
    slots = torch.arange(st.cons.shape[1], device=cid.device)
    upd = {"cons": torch.where(ok[:, None] & (slots == st.cons_n[:, None]), cid[:, None], st.cons),
           "cons_n": st.cons_n + ok.to(_I32)}
    is_planet = (cid >= CL.PLANET_BASE) & (cid < CL.PLANET_BASE + CL.NUM_PLANET)
    is_tarot = (cid >= CL.TAROT_BASE) & (cid < CL.TAROT_BASE + CL.NUM_TAROT)
    reward = torch.where(ok, torch.where(is_planet, 8.0, torch.where(is_tarot, 5.0, 10.0)), -1.0)
    return upd, reward


def _apply_joker(st, pack, onehot5):
    """A joker joins the collection if a slot is free."""
    jid = _at(pack.item_id, onehot5)
    ok = st.joker_n < st.joker_slots
    slots = torch.arange(st.jokers.shape[1], device=jid.device)
    upd = {"jokers": torch.where(ok[:, None] & (slots == st.joker_n[:, None]), jid[:, None],
                                 st.jokers),
           "joker_n": st.joker_n + ok.to(_I32)}
    return upd, torch.where(ok, 15.0, -1.0)


def step_pack(st, pack: PackState, action):
    """One pack-phase action of every env (``action``: ``[B]`` ids).
    Returns (state, PackState, reward ``[B]`` float32)."""
    action = action.to(_I32)
    slots = torch.arange(PACK_SIZE, device=action.device)
    idx = (action - Action.SELECT_FROM_PACK_BASE).clamp(0, PACK_SIZE - 1)
    onehot5 = slots == idx[:, None]
    in_range = ((action >= Action.SELECT_FROM_PACK_BASE)
                & (action < Action.SELECT_FROM_PACK_BASE + PACK_SIZE))
    is_skip = action == Action.SKIP_PACK
    kind = _at(pack.item_kind, onehot5)
    already = (pack.picked & onehot5).any(1)
    can_pick = in_range & pack.active & ~already & (pack.picks_left > 0)

    upd, rewards = {}, {}
    for k, apply in ((K_CARD, _apply_card), (K_CONSUMABLE, _apply_consumable),
                     (K_JOKER, _apply_joker)):
        new, rewards[k] = apply(st, pack, onehot5)
        pick = can_pick & (kind == k)
        for name, v in new.items():
            p = pick.reshape((-1,) + (1,) * (v.dim() - 1))
            upd[name] = torch.where(p, v, getattr(st, name))
    # any other kind is paid as a joker but changes nothing, as in the reference
    reward = torch.where(can_pick, torch.where(
        kind == K_CARD, rewards[K_CARD],
        torch.where(kind == K_CONSUMABLE, rewards[K_CONSUMABLE], rewards[K_JOKER])), -1.0)

    picked = pack.picked | (onehot5 & can_pick[:, None])
    left = pack.picks_left - can_pick.to(_I32)
    # skip: -1 per pick left (pack_open.py:108-119)
    skip = is_skip & pack.active
    reward = torch.where(skip, -1.0 * pack.picks_left.to(_F32), reward)
    close = skip | (can_pick & (left <= 0))
    upd["phase"] = torch.where(close, int(Phase.SHOP), st.phase)
    return (dataclasses.replace(st, **upd),
            dataclasses.replace(pack, picked=picked, picks_left=left,
                                active=pack.active & ~close),
            reward)
