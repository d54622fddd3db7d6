"""Macro-action env (``BalatroEnvComplete``) on batched tensors.

Port of ``balatro_gym_tpu/envs/macro_env.py`` (reference:
balatro_gym/balatro_env_v2.py:60-400). ``Discrete(70)``:

* 0-5 play strategies (``ops.hand_eval.macro_select``: best detected,
  first 5, pair, two pair, trips, flush, each falling back to the first k
  cards), scored by the sim pipeline (``ops.scoring.score_sim``);
* 6-8 discard the first 1 / 3 / all cards: a fresh 8-card deal;
* 10-69 shop actions in the reference's ``ShopAction`` ids (SKIP 10,
  REROLL 11, BUY_PACK 12+, BUY_JOKER 20+, BUY_CARD 40+, BUY_VOUCHER 60+)
  indexed by inventory slot, with the reference's id soup kept: the mask
  offers ``BUY_PACK + i`` for every affordable slot, so any item is bought
  through the pack verb; slot 8's id 20 decodes as a joker-verb buy; an
  unaffordable joker is still appended (not charged or popped); jokers are
  appended up to 16 slots and the first 5 are what the shop excludes.

A round is 4 hands; when they run out the ante advances, the blind pays
``min(ante + 2, 10) + ante`` and a shop opens; the episode ends past ante
8. Hands are dealt 8 at a time from a shuffled 52 (a fresh shuffle when
fewer than 8 remain); every deal splits the key, shuffle or not.

A state holds a batch of envs (``[B]`` and ``[B, n]`` tensors) at the
reference's production widths: ``score_total`` int32, rewards float32, the
voucher bitset int32, the key as ``[B, 2]`` Threefry words. Each function
computes every branch for every env and selects per env, as the
reference's jitted step does. Every entry point runs on its state's
device; ``reset`` and the Gym shell on the card unless given ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from balatro_gym_tpu_torch.core import cards as C
from balatro_gym_tpu_torch.core.device import const, run_device
from balatro_gym_tpu_torch.engine import shop_logic as SL
from balatro_gym_tpu_torch.engine.full_env import where_envs
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.ops.hand_eval import macro_select, rank_counts
from balatro_gym_tpu_torch.ops.joker_tables import J_FACELESS
from balatro_gym_tpu_torch.ops.scoring import score_sim

HAND = 8
JOKER_CAP = 16
ACTION_SPACE_SIZE = 70
PHASE_PLAY, PHASE_SHOP = 0, 1

# ShopAction ids (shop.py:44-68)
A_SKIP, A_REROLL = 10, 11
A_PACK, A_JOKER, A_CARD, A_VOUCHER = 12, 20, 40, 60

_I32 = torch.int32
_F32 = torch.float32
# XLA's jit multiplies a play's float32 score by the float32 reciprocal of 100
_RECIP100 = float(np.float32(1.0 / 100.0))
_RANKS, _SUITS = C.standard_deck_arrays()


@dataclasses.dataclass
class MacroEnvState:
    deck_rank: torch.Tensor       # [B, 52] i32
    deck_suit: torch.Tensor       # [B, 52] i32
    deck_ptr: torch.Tensor        # [B] i32: the next card to deal
    hand_rank: torch.Tensor       # [B, 8] i32
    hand_suit: torch.Tensor       # [B, 8] i32
    chips: torch.Tensor           # [B] i32 money ("player.chips")
    score_total: torch.Tensor     # [B] i32
    ante: torch.Tensor
    hands_left: torch.Tensor
    discards_left: torch.Tensor
    jokers: torch.Tensor          # [B, 16] i32 ids, appended in order
    joker_n: torch.Tensor
    purchased_cards: torch.Tensor  # [B] i32: the purchased deck's length
    vouchers: torch.Tensor        # [B] i32 bitset
    phase: torch.Tensor
    shop_type: torch.Tensor       # [B, 10] i32
    shop_item: torch.Tensor
    shop_cost: torch.Tensor
    shop_n: torch.Tensor
    reroll_base: torch.Tensor
    key: torch.Tensor             # [B, 2] int64 Threefry words (hi, lo)
    done: torch.Tensor            # [B] bool


def _split(key):
    """``jax.random.split(key)`` of ``[B, 2]`` keys: two ``[B, 2]`` keys."""
    return tuple(torch.stack(KR.split_child(key[:, 0], key[:, 1], i), -1) for i in (0, 1))


def _shuffled_deck(key):
    perm = KR.permutation(key[:, 0], key[:, 1], 52)
    dev = key.device
    return const(_RANKS, _I32, dev)[perm], const(_SUITS, _I32, dev)[perm]


def _deal(st: MacroEnvState) -> MacroEnvState:
    """A fresh 8-card hand; the deck is reshuffled when it runs dry."""
    key, k_shuf = _split(st.key)
    need = st.deck_ptr + HAND > 52
    new_rank, new_suit = _shuffled_deck(k_shuf)
    deck_rank = torch.where(need[:, None], new_rank, st.deck_rank)
    deck_suit = torch.where(need[:, None], new_suit, st.deck_suit)
    ptr = torch.where(need, 0, st.deck_ptr)
    at = ptr.clamp(0, 52 - HAND).long()[:, None] + torch.arange(HAND, device=ptr.device)
    return dataclasses.replace(st, deck_rank=deck_rank, deck_suit=deck_suit,
                               hand_rank=deck_rank.gather(1, at),
                               hand_suit=deck_suit.gather(1, at), deck_ptr=ptr + HAND, key=key)


def reset(keys) -> MacroEnvState:
    """Fresh episodes, one per key (``keys``: ``[B, 2]`` Threefry words):
    ``k_deck, key = split(key)``, the deck shuffled by ``k_deck``, money
    100, ante 1, the first hand dealt."""
    keys = keys.to(torch.int64)
    dev, B = keys.device, keys.shape[0]
    k_deck, key = _split(keys)
    dr, ds = _shuffled_deck(k_deck)

    def full(shape, v, dtype=_I32):
        return torch.full((B, *shape), v, dtype=dtype, device=dev)

    st = MacroEnvState(
        deck_rank=dr, deck_suit=ds, deck_ptr=full((), 0),
        hand_rank=full((HAND,), 0), hand_suit=full((HAND,), 0),
        chips=full((), 100), score_total=full((), 0), ante=full((), 1),
        hands_left=full((), 4), discards_left=full((), 3),
        jokers=full((JOKER_CAP,), 0), joker_n=full((), 0), purchased_cards=full((), 0),
        vouchers=full((), 0), phase=full((), PHASE_PLAY),
        shop_type=full((SL.SHOP_SLOTS,), 0), shop_item=full((SL.SHOP_SLOTS,), 0),
        shop_cost=full((SL.SHOP_SLOTS,), 0), shop_n=full((), 0),
        reroll_base=full((), SL.REROLL_BASE), key=key, done=full((), False, torch.bool))
    return _deal(st)


def _end_round(st: MacroEnvState) -> MacroEnvState:
    """The round is over: ante + 1, the blind's money (of the new ante),
    a fresh shop."""
    ante = st.ante + 1
    key, k_shop = _split(st.key)
    types, items, costs, n = SL.generate_inventory(k_shop, ante, st.jokers[:, :5], st.vouchers)
    return dataclasses.replace(
        st, ante=ante, chips=st.chips + (ante + 2).clamp(max=10) + ante,
        phase=torch.full_like(ante, PHASE_SHOP), shop_type=types, shop_item=items,
        shop_cost=costs, shop_n=n, reroll_base=torch.full_like(ante, SL.REROLL_BASE),
        key=key, done=ante > 8)


def _step_play(st: MacroEnvState, action):
    dev = st.hand_rank.device
    valid = torch.ones_like(st.hand_rank, dtype=torch.bool)
    # play macros 0-5
    sel = macro_select(st.hand_rank, st.hand_suit, valid, action.clamp(0, 5))
    key, k_score = _split(st.key)
    base_value = const(C.RANK_CHIPS, _I32, dev)[st.hand_rank.long()]
    zeros = torch.zeros_like(st.hand_rank)
    score, money_d, _, _ = score_sim(st.hand_rank, st.hand_suit, sel, zeros, zeros, zeros,
                                     base_value, st.jokers, st.hands_left, st.discards_left,
                                     st.purchased_cards, k_score, x64=False)
    # the reference adds the score to chips, then overwrites chips with the
    # scoring state's money: only the money of scoring effects lands
    played = dataclasses.replace(st, chips=st.chips + money_d.to(_I32),
                                 score_total=st.score_total + score,
                                 hands_left=st.hands_left - 1, key=key)
    played = where_envs(played.hands_left <= 0, _end_round(played), _deal(played))
    r_play = score.to(_F32) * _RECIP100

    # discards 6-8: the sim's joker context pays Faceless Joker only (>= 3
    # face cards among the discarded -> $5)
    can_discard = st.discards_left > 0
    k = torch.where(action == 6, 1, torch.where(action == 7, 3, 8)).clamp(0, HAND)
    disc = torch.arange(HAND, device=dev) < k[:, None]
    n_face = (disc & (st.hand_rank >= 11) & (st.hand_rank <= 13)).sum(1)
    faceless = (st.jokers == J_FACELESS).any(1) & (n_face >= 3)
    discarded = _deal(dataclasses.replace(st, discards_left=st.discards_left - 1,
                                          chips=st.chips + 5 * faceless.to(_I32)))
    r_disc = torch.where(can_discard, -0.1, -1.0)
    discarded = where_envs(can_discard, discarded, st)

    # the reference has no else branch: any other action is a no-op worth 0
    is_play, is_disc = action <= 5, (action >= 6) & (action <= 8)
    st2 = where_envs(is_play, played, where_envs(is_disc, discarded, st))
    return st2, torch.where(is_play, r_play, torch.where(is_disc, r_disc, 0.0))


def _step_shop(st: MacroEnvState, action):
    dev = st.chips.device
    # skip: back to play with fresh hands, discards and deal
    ended = _deal(dataclasses.replace(
        st, phase=torch.full_like(st.phase, PHASE_PLAY),
        hands_left=torch.full_like(st.hands_left, 4),
        discards_left=torch.full_like(st.discards_left, 3)))

    # reroll
    cost, next_base = SL.reroll_charge(st.reroll_base, st.ante, st.vouchers)
    afford = st.chips >= cost
    key, k_shop = _split(st.key)
    t2, i2, c2, n2 = SL.generate_inventory(k_shop, st.ante, st.jokers[:, :5], st.vouchers)
    rerolled = where_envs(afford, dataclasses.replace(
        st, chips=st.chips - cost, reroll_base=next_base, shop_type=t2, shop_item=i2,
        shop_cost=c2, shop_n=n2, key=key), st)
    r_reroll = torch.where(afford, 0.0, -1.0)

    # buys: verb and slot from the id soup (shop.py:56-68)
    is_pack_verb = (action >= A_PACK) & (action < A_JOKER)
    is_joker_verb = (action >= A_JOKER) & (action < A_CARD)
    is_card_verb = (action >= A_CARD) & (action < A_VOUCHER)
    idx = torch.where(is_pack_verb, action - A_PACK,
                      torch.where(is_joker_verb, action - A_JOKER,
                                  torch.where(is_card_verb, action - A_CARD,
                                              action - A_VOUCHER)))
    idx = idx.clamp(0, SL.SHOP_SLOTS - 1)
    at = idx.long()[:, None]
    itype, item, cost_i = (x.gather(1, at)[:, 0]
                           for x in (st.shop_type, st.shop_item, st.shop_cost))
    ok = (idx < st.shop_n) & (st.chips >= cost_i)
    t3, i3, c3, n3 = SL.pop_item(st.shop_type, st.shop_item, st.shop_cost, st.shop_n, idx)

    # cards entering the purchased deck: a pack-verb buy of any item opens
    # it (3 cards for a Standard pack, else 1); a card-verb buy adds one
    std_pack = (itype == SL.IT_PACK) & (item == SL.PACK_STANDARD)
    new_cards = torch.where(is_pack_verb, torch.where(std_pack, 3, 1),
                            torch.where(is_card_verb, 1, 0)).to(_I32)

    # jokers: a joker-verb buy under 5 jokers appends (duplicates too); any
    # other buy of a joker item appends it unless already held
    slots16 = torch.arange(JOKER_CAP, device=dev)
    dup = ((slots16 < st.joker_n[:, None]) & (st.jokers == item[:, None])).any(1)
    add_joker = (itype == SL.IT_JOKER) & ((is_joker_verb & (st.joker_n < 5)) | ~dup)
    at_j = slots16 == st.joker_n.clamp(0, JOKER_CAP - 1)[:, None]
    with_item = torch.where(at_j, item[:, None], st.jokers)
    can_add = add_joker & (st.joker_n < JOKER_CAP)
    # a voucher reaches the bitset only through the voucher verb
    add_voucher = (action >= A_VOUCHER) & (itype == SL.IT_VOUCHER)
    bought = dataclasses.replace(
        st, chips=st.chips - cost_i, shop_type=t3, shop_item=i3, shop_cost=c3, shop_n=n3,
        purchased_cards=st.purchased_cards + new_cards,
        jokers=torch.where(can_add[:, None], with_item, st.jokers),
        joker_n=st.joker_n + can_add.to(_I32),
        vouchers=torch.where(add_voucher, st.vouchers | (1 << item), st.vouchers))
    # an unaffordable buy of a joker slot is not charged or popped, but the
    # env layer still appends the joker unless held (#A43)
    bug_add = ((idx < st.shop_n) & ~(st.chips >= cost_i) & (itype == SL.IT_JOKER) & ~dup
               & (st.joker_n < JOKER_CAP))
    failed = dataclasses.replace(
        st, jokers=torch.where(bug_add[:, None], with_item, st.jokers),
        joker_n=st.joker_n + bug_add.to(_I32))
    bought = where_envs(ok, bought, failed)
    # the shop returns -1 for a joker-verb buy with 5+ jokers held (after charging)
    r_buy = torch.where(~ok | (is_joker_verb & (st.joker_n >= 5)), -1.0, 0.0)

    is_skip, is_reroll, is_buy = action == A_SKIP, action == A_REROLL, action >= A_PACK

    def pick(a, b, c, d):
        sel = where_envs if dataclasses.is_dataclass(a) else torch.where
        return sel(is_skip, a, sel(is_reroll, b, sel(is_buy, c, d)))

    return (pick(ended, rerolled, bought, st),
            pick(torch.zeros_like(r_buy), r_reroll, r_buy, torch.full_like(r_buy, -1.0)))


def step(st: MacroEnvState, action):
    """One step of every env (``action``: ``[B]`` ids): (state, reward
    ``[B]`` float32, done ``[B]`` bool). A play-phase action above 8 is a
    no-op worth 0; a shop-phase action below 10 (which crashes the
    reference) changes nothing and costs -1; a done env stays as it is and
    gets 0."""
    action = action.to(_I32)
    p_st, p_r = _step_play(st, action)
    s_st, s_r = _step_shop(st, action)
    in_play = st.phase == PHASE_PLAY
    valid = in_play | (action >= A_SKIP)
    nxt = where_envs(valid & ~st.done, where_envs(in_play, p_st, s_st), st)
    reward = torch.where(st.done, 0.0, torch.where(valid, torch.where(in_play, p_r, s_r), -1.0))
    return nxt, reward, nxt.done


def action_mask(st: MacroEnvState):
    """``[B, 70]`` bool (v2._mask): play 0-5, discards 6-8 while any are
    left; in the shop SKIP, REROLL and ``BUY_PACK + i`` for every
    affordable slot whatever its item (slot 8's id is 20)."""
    dev = st.chips.device
    ids = torch.arange(ACTION_SPACE_SIZE, device=dev)
    play = (ids <= 5) | ((ids >= 6) & (ids <= 8) & (st.discards_left > 0)[:, None])
    slots = torch.arange(SL.SHOP_SLOTS, device=dev)
    afford = (slots < st.shop_n[:, None]) & (st.shop_cost <= st.chips[:, None])
    buy = torch.zeros_like(play)
    buy[:, A_PACK:A_PACK + SL.SHOP_SLOTS] = afford
    shop = buy | (ids == A_SKIP) | (ids == A_REROLL)
    return torch.where((st.phase == PHASE_PLAY)[:, None], play, shop) & ~st.done[:, None]


def observe(st: MacroEnvState):
    """The reference's observation dict (balatro_env_v2.py:79-93) of every
    env, int32 tensors: the hand as sim card codes and the hand flags of
    the 8 cards, which the reference computes only in the play phase (its
    flush and straight detection gives up past 5 cards, so both are 0)."""
    rc = rank_counts(st.hand_rank, torch.ones_like(st.hand_rank, dtype=torch.bool))
    in_play = st.phase == PHASE_PLAY
    n2, n3 = (rc == 2).sum(-1), (rc == 3).sum(-1)
    zero = torch.zeros_like(st.ante)

    def flag(x):
        return (in_play & x).to(_I32)

    slots5 = torch.arange(5, device=st.ante.device)
    return {
        "hand": C.encode_sim(st.hand_rank, st.hand_suit).to(_I32),
        "chips": st.chips,
        "phase": st.phase,
        "action_mask": action_mask(st).to(_I32),
        "ante": st.ante,
        "hands_left": st.hands_left,
        "discards_left": st.discards_left,
        "joker_slots": torch.where(slots5 < st.joker_n[:, None], st.jokers[:, :5], -1),
        "has_pair": flag((rc >= 2).any(-1)),
        "has_two_pair": flag((n2 == 2) | ((n3 == 1) & (n2 == 1))),
        "has_three_kind": flag((rc >= 3).any(-1)),
        "has_straight": zero,
        "has_flush": zero,
    }


class BalatroMacroGymEnv:
    """One macro env with the ``BalatroEnvComplete`` contract. device: where
    it steps (default: the card; it raises where there is none)."""

    metadata = {"render_modes": ["human"]}

    def __init__(self, *, seed: int = 0, render_mode: str | None = None, device=None):
        self.render_mode = render_mode
        self._seed = seed
        self.device = run_device((), device)
        self._st = None
        try:
            from gymnasium import spaces

            self.action_space = spaces.Discrete(ACTION_SPACE_SIZE)
        except ImportError:  # pragma: no cover
            self.action_space = None

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._seed = seed
        self._st = reset(torch.stack(KR.seed_key(self._seed, device=self.device))[None])
        return self._obs(), {}

    def step(self, action: int):
        a = torch.tensor([int(action)], dtype=_I32, device=self.device)
        self._st, r, done = step(self._st, a)
        return self._obs(), float(r[0]), bool(done[0]), False, {}

    def _obs(self):
        return {k: v[0].cpu().numpy() for k, v in observe(self._st).items()}

    def render(self):
        if self.render_mode != "human":
            return
        st = {f.name: getattr(self._st, f.name)[0].cpu().numpy()
              for f in dataclasses.fields(self._st)}
        hand = " ".join(C.card_str(int(r), int(s)) for r, s in zip(st["hand_rank"], st["hand_suit"]))
        print(f"[ante {int(st['ante'])} phase {int(st['phase'])}] ${int(st['chips'])} "
              f"hands {int(st['hands_left'])} | {hand}")

    def close(self):
        pass
