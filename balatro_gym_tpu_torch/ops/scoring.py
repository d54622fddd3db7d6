"""Scoring pipelines on batched tensors.

Port of ``balatro_gym_tpu/ops/scoring.py``: :func:`score_sim`
(``BalatroSimulator.calculate_score``) with its joker pass, and
:func:`score_env_unified` (``UnifiedScorer.score_hand``, the flagship env's
scorer, which the expert searches with). Inputs of :func:`score_sim` are
``[B, N]`` cards, ``[B, J]`` joker ids and a ``[B, 2]`` Threefry key. The
engine computes in int64/float64, as the x64 reference does: additive joker
effects are exact integer sums of table rows, and every x-mult is a product
of exact powers of 2, 3 and 1.5 taken from the float64 pow tables, so
``trunc(chips * (mult * x))`` lands on the reference's integer. The random
draws (Lucky money, Bloodstone coins, Misprint) follow the reference's key
splits through the ported Threefry, so they match ``jax.random`` bit for bit.
"""
from __future__ import annotations

import torch

from balatro_gym_tpu_torch.core import cards as C
from balatro_gym_tpu_torch.core import pow_tables as P
from balatro_gym_tpu_torch.core.device import const
from balatro_gym_tpu_torch.core.constants import BASE_HAND_CHIPS, BASE_HAND_MULT
from balatro_gym_tpu_torch.ops import joker_tables as JT
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.ops.hand_eval import classify_env, evaluate_sim

_F64 = torch.float64
_I64 = torch.int64


def _tab(table_np, device):
    return const(table_np, _I64, device)


def _hist(values, mask, n):
    """``[B, n]`` count of masked cards per value."""
    oh = values[..., :, None] == torch.arange(n, device=values.device)
    return (oh & mask[..., :, None]).sum(-2)


def _joker_flags(jokers):
    return ((jokers == JT.J_FOUR_FINGERS).any(-1),
            (jokers == JT.J_SHORTCUT).any(-1))


def _uniform(k1, k2, idx, x64):
    """``jax.random.uniform`` at the default float width: float64 from
    64-bit draws under x64, float32 from 32-bit draws in production."""
    if x64:
        return KR.uniform_f64(KR.random_bits64(k1, k2, idx))
    return KR.uniform_f32(KR.random_bits32(k1, k2, idx))


def _joker_chance(key, n_jok, n_cards, x64=True):
    """The joker pass's draws: the Bloodstone coin matrix ``[B, n_jok,
    n_cards]`` (uniform < 0.5) and Misprint's ``randint(0, 24)``, from
    ``split(key)`` as the reference draws them, at the default widths of
    x64 (64-bit draws) or of production (32-bit draws)."""
    (b1, b2), (m1, m2) = KR.split2(key[..., 0], key[..., 1])
    idx = torch.arange(n_jok * n_cards, device=key.device)
    coin = (_uniform(b1[..., None], b2[..., None], idx, x64) < 0.5).reshape(
        *key.shape[:-1], n_jok, n_cards)
    misprint = KR.randint(m1, m2, 0, 24, bits=64 if x64 else 32)
    return coin, misprint


def _joker_pass(t: JT.JokerTables, jokers, ranks, suits, smask, valid, ht,
                hand_table_chips, hand_table_mult, x2_hand, x3_hand,
                hands_left, discards_left, deck_size, key, x64=True):
    """Joker effects of the individual and main scoring phases.

    ``suits`` are categories 0..4 (4 = Stone). Returns (chips_add int64,
    mult_add int64, x_mult float64 (float32 without ``x64``), money int64),
    each ``[B]``.
    """
    dev = jokers.device
    jvalid = jokers > 0
    njok = jvalid.sum(-1)

    def jdot(table_np):          # sum of the held jokers' rows -> [B(, K)]
        rows = _tab(table_np, dev)[jokers]
        w = jvalid if rows.dim() == jokers.dim() else jvalid[..., None]
        return (rows * w).sum(jokers.dim() - 1)

    def cnt(jid):                # copies of joker ``jid`` held
        return ((jokers == jid) & jvalid).sum(-1)

    rank_hist = _hist(ranks, smask, 15)
    suit_hist = _hist(suits, smask, JT.NUM_SUIT_CATS)
    ht_oh = ht[..., None] == torch.arange(12, device=dev)

    def dot(hist, tab):
        return (hist * tab).sum(-1)

    chips = (dot(rank_hist, jdot(t.ind_chip_rank))
             + dot(suit_hist, jdot(t.ind_chip_suit)))
    mult = (dot(rank_hist, jdot(t.ind_mult_rank))
            + dot(suit_hist, jdot(t.ind_mult_suit)))
    money = dot(suit_hist, jdot(t.ind_money_suit))

    # Triboulet: x2 per scoring Q/K per copy.
    e2 = cnt(JT.J_TRIBOULET) * (rank_hist[..., 12] + rank_hist[..., 13])
    # Bloodstone: 50% x2 per (joker, scoring Heart) pair.
    coin, misprint = _joker_chance(key, jokers.shape[-1], ranks.shape[-1], x64)
    blood_j = (jokers == JT.J_BLOODSTONE) & jvalid
    hearts = smask & (suits == 2)
    e2 = e2 + (blood_j[..., :, None] & hearts[..., None, :] & coin).sum((-2, -1))

    n_scoring = smask.sum(-1)
    chips = (chips + jdot(t.chips_flat) + dot(ht_oh, jdot(hand_table_chips))
             + cnt(JT.J_BANNER) * 30 * discards_left
             + cnt(JT.J_BLUE_JOKER) * 2 * deck_size)

    present5 = suit_hist > 0
    nqueens = (valid & (ranks == 12)).sum(-1)
    nkings = (valid & (ranks == 13)).sum(-1)
    mult = (mult
            + jdot(t.mult_flat)
            + dot(ht_oh, jdot(hand_table_mult))
            + cnt(JT.J_ABSTRACT) * 3 * njok
            + cnt(JT.J_MYSTIC_SUMMIT) * torch.where(discards_left == 0, 15, 0)
            + cnt(JT.J_HALF) * torch.where(n_scoring <= 3, 20, 0)
            + cnt(JT.J_MISPRINT) * misprint
            + dot(present5, jdot(t.mult_if_suit))
            + cnt(JT.J_SHOOT_THE_MOON) * 13 * nqueens)

    all_spade_club = (~valid | (suits == 3) | (suits == 0)).all(-1)
    n_present = present5.sum(-1)
    seeing = present5[..., 0] & (n_present > 1)
    flower = n_present == 4
    e2 = e2 + dot(ht_oh, jdot(x2_hand)) + cnt(JT.J_SEEING_DOUBLE) * seeing
    e3 = (dot(ht_oh, jdot(x3_hand))
          + jdot(t.x3_flat)
          + cnt(JT.J_ACROBAT) * (hands_left == 1)
          + cnt(JT.J_BLACKBOARD) * all_spade_club
          + cnt(JT.J_FLOWER_POT) * flower)
    e15 = cnt(JT.J_BARON) * nkings
    fdt = _F64 if x64 else torch.float32
    x = P.pow2(e2, fdt) * P.pow3(e3, fdt) * P.pow15(e15, fdt)
    return chips, mult, x, money


def score_sim(ranks, suits, valid, enh, ed, seal, base_value, jokers,
              hands_left, discards_left, deck_size, key,
              tables: JT.JokerTables | None = None, x64: bool = True):
    """``BalatroSimulator.calculate_score`` on a batch.

    Args:
        ranks/suits/valid: ``[B, N]`` played cards (canonical suits 0..3).
        enh/ed/seal: ``[B, N]`` modifier channels (core.cards enums).
        base_value: ``[B, N]`` card chip values.
        jokers: ``[B, J]`` joker ids (0 = empty).
        deck_size: ``[B]`` purchased-card count (the sim path's "deck").
        key: ``[B, 2]`` Threefry key for Lucky, Bloodstone and Misprint.
        x64: the reference's x64 widths (64-bit draws, float64 products);
            False: its production widths (32-bit draws, float32 products,
            the score converted to int32 saturating, as XLA converts).

    Returns (score, money_delta int64, hand_type int64, scoring_mask bool
    ``[B, N]``); the score is int64, or int32 without ``x64``.
    """
    t = tables or JT.get_tables()
    dev = ranks.device
    ranks, suits = ranks.to(_I64), suits.to(_I64)
    enh, ed, seal = enh.to(_I64), ed.to(_I64), seal.to(_I64)
    jokers = jokers.to(_I64)
    ff, sc = _joker_flags(jokers)
    ht, smask = evaluate_sim(ranks, suits, valid, ff, sc)
    smask = smask & valid

    chips = _tab(BASE_HAND_CHIPS, dev)[ht]
    mult = _tab(BASE_HAND_MULT, dev)[ht]
    chips = chips + torch.where(smask, base_value.to(_I64), 0).sum(-1)

    # Card enhancements / editions / seals, applied BEFORE jokers.
    enh_hist = _hist(enh, smask, 9)
    ed_hist = _hist(ed, smask, 5)
    chips = chips + (enh_hist * _tab(C.ENH_CHIPS, dev)).sum(-1) \
        + (ed_hist * _tab(C.ED_CHIPS, dev)).sum(-1)
    add = (enh_hist * _tab(C.ENH_MULT, dev)).sum(-1) \
        + (ed_hist * _tab(C.ED_MULT, dev)).sum(-1)
    n_glass = enh_hist[..., C.Enhancement.GLASS]
    n_15 = enh_hist[..., C.Enhancement.STEEL] + ed_hist[..., C.Edition.POLYCHROME]
    fdt = _F64 if x64 else torch.float32
    x = P.pow2(n_glass, fdt) * P.pow15(n_15, fdt)
    n_gold_seal = (smask & (seal == C.Seal.GOLD)).sum(-1)
    money = 3 * (enh_hist[..., C.Enhancement.GOLD] + n_gold_seal)
    # Lucky: +$1 at 20% per scoring lucky card.
    (l1, l2), k_jok = KR.split2(key[..., 0], key[..., 1])
    idx = torch.arange(ranks.shape[-1], device=dev)
    lucky_roll = _uniform(l1[..., None], l2[..., None], idx, x64) < 0.2
    money = money + (smask & (enh == C.Enhancement.LUCKY) & lucky_roll).sum(-1)

    # The sim pipeline's joker context has no hands/discards keys, so
    # Acrobat and Mystic Summit always fire (hands_left=1, discards_left=0)
    # and Banner adds nothing; the real counts are accepted and unused.
    del hands_left, discards_left
    one = torch.ones_like(chips)
    jc, jm, jx, jmoney = _joker_pass(
        t, jokers, ranks, suits, smask, valid, ht,
        t.chips_hand_sim, t.mult_hand_sim, t.x2_hand_sim, t.x3_hand_sim,
        one, one * 0, torch.as_tensor(deck_size, dtype=_I64, device=dev),
        torch.stack(k_jok, -1), x64)
    chips = chips + jc
    add = add + jm
    x = x * jx
    money = money + jmoney

    final_mult = (mult + add).to(fdt) * x
    score = torch.trunc(chips.to(fdt) * final_mult)
    if x64:
        return score.to(_I64), money, ht, smask
    big = score >= 2.0 ** 31
    score = torch.where(big, 0.0, score).clamp(min=-2.0 ** 31).to(torch.int32)
    return torch.where(big, torch.iinfo(torch.int32).max, score), money, ht, smask


def score_env_unified(ranks, suits, valid, enh, ed, levels, jokers,
                      hands_left, discards_left, deck_size, key,
                      tables: JT.JokerTables | None = None, ht=None):
    """``UnifiedScorer.score_hand`` of the flagship env on a batch.

    Cards ``[..., N]`` (every selected card scores), ``levels`` ``[...,
    12]`` (the obs-visible hand levels). Kept faithful to the reference:

    * no joker fires (PARITY #A38: the scorer's joker loops never see a
      joker name), so ``jokers``, ``hands_left``, ``discards_left``,
      ``deck_size``, ``key`` and ``tables`` are accepted and unused, and
      nothing is drawn;
    * the level is clamped at 15 for scoring only (#A41: ``apply_planet``
      clamps the engine's level, not the observed one);
    * a passed-in ``ht`` overrides the classification of the selected cards
      (#A39/#A40: the env classifies from accumulated deck slots);
    * a card adds only its chip value, rank + enhancement + edition chips.

    The score is ``trunc(chips * mult)`` in float32, the reference's
    production width; chips and mult stay far below 2**24, so the product
    is exact and equals the float64 one. Returns (score int32, hand_type
    int64), each ``[...]``.
    """
    del jokers, hands_left, discards_left, deck_size, key, tables
    dev = ranks.device
    ranks, enh, ed = ranks.to(_I64), enh.to(_I64), ed.to(_I64)
    if ht is None:
        ht = classify_env(ranks, suits, valid)
    else:
        ht = torch.as_tensor(ht, dtype=_I64, device=dev).expand(ranks.shape[:-1])
    level = levels.to(_I64).gather(-1, ht[..., None])[..., 0].clamp(max=15)
    chips = _tab(BASE_HAND_CHIPS, dev)[ht] + (level - 1) * 10
    mult = _tab(BASE_HAND_MULT, dev)[ht] + (level - 1)
    card = _tab(C.RANK_CHIPS, dev)[ranks] + _tab(C.ENH_CHIPS, dev)[enh] + _tab(C.ED_CHIPS, dev)[ed]
    chips = chips + torch.where(valid, card, 0).sum(-1)
    f32 = torch.float32
    score = torch.trunc(chips.to(f32) * mult.to(f32)).to(torch.int32)
    return score, ht
