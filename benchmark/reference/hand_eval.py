"""The sim path's poker-hand evaluation on batched tensors (frozen copy of
the port's ``ops/hand_eval.py:evaluate_sim`` and its helpers).

``evaluate_sim`` gives the top hand type and the scoring-card mask, with
Four Fingers and Shortcut, as ``BalatroSimulator.evaluate_hand``. Cards are
``[..., N]`` tensors (any leading batch shape); everything is branch-free:
rank and suit histograms are masked one-hot sums, and the straight scan is a
13-step recurrence over ranks 14..2 that carries the used skip into the
wheel (A-2-3-4-5) check.
"""
from __future__ import annotations

import torch

from .constants import HandType
from .device import const


def _ranks15(like):
    return torch.arange(15, dtype=torch.int64, device=like.device)


def rank_counts(ranks, valid):
    """``[..., 15]`` histogram of ranks among valid cards."""
    oh = (ranks[..., :, None] == _ranks15(ranks)) & valid[..., :, None]
    return oh.sum(-2)


def suit_counts(suits, valid):
    """``[..., 4]`` histogram of suits among valid cards."""
    s4 = torch.arange(4, dtype=torch.int64, device=suits.device)
    oh = (suits[..., :, None] == s4) & valid[..., :, None]
    return oh.sum(-2)


def _top_rank_where(mask15):
    """Highest rank index where the mask is true; 0 if none."""
    return torch.where(mask15, _ranks15(mask15), 0).amax(-1)


def _straight_scan(present, can_skip, required):
    """Descending scan 14..2 with one optional skip, frozen at the first run
    of ``required`` ranks. Returns (found, rank_in_t [..., 15], skipped)."""
    batch = present.shape[:-1]
    run = torch.zeros(batch, dtype=torch.int64, device=present.device)
    skipped = torch.zeros(batch, dtype=torch.bool, device=present.device)
    found = torch.zeros_like(skipped)
    tmask = torch.zeros_like(present)
    r_oh = torch.eye(15, dtype=torch.bool, device=present.device)
    for r in range(14, 1, -1):
        pres = present[..., r]
        do_skip = can_skip & ~skipped
        new_run = torch.where(pres, run + 1, torch.where(do_skip, run, 0))
        new_t = torch.where(pres[..., None], tmask | r_oh[r],
                            tmask & do_skip[..., None])
        new_sk = torch.where(pres, skipped, do_skip)
        run = torch.where(found, run, new_run)
        tmask = torch.where(found[..., None], tmask, new_t)
        skipped = torch.where(found, skipped, new_sk)
        found = found | (new_run >= required)
    return found, tmask, skipped


def _wheel_scan(present, can_skip, skipped_in, required):
    """The wheel (A-2-3-4-5) check, continuing from the main scan's skip
    state. Returns (found, rank_in_t [..., 15])."""
    wl = torch.zeros(present.shape[:-1], dtype=torch.int64, device=present.device)
    wmask = torch.zeros_like(present)
    skipped = skipped_in
    dead = torch.zeros_like(skipped_in)
    for r in (14, 2, 3, 4, 5):
        pres = present[..., r] & ~dead
        wl = wl + pres.to(torch.int64)
        wmask[..., r] = pres
        absent = ~present[..., r] & ~dead
        do_skip = absent & can_skip & ~skipped
        skipped = skipped | do_skip
        dead = dead | (absent & ~do_skip)
    return wl >= required, wmask


_WHEEL_ORDER = [99, 99, 1, 2, 3, 4, 99, 99, 99, 99, 99, 99, 99, 99, 0]


def evaluate_sim(ranks, suits, valid, four_fingers=False, shortcut=False):
    """Top hand type and scoring-card mask, as ``BalatroSimulator
    .evaluate_hand``.

    Args:
        ranks, suits, valid: ``[..., N]`` cards (flush and straight engage
            only for 4..5 valid cards, as the reference bails out above 5).
        four_fingers, shortcut: bools or ``[...]`` bool tensors.

    Returns: (hand_type int64 ``[...]``, scoring_mask bool ``[..., N]``).
    """
    dev = ranks.device
    N = ranks.shape[-1]
    ranks = ranks.to(torch.int64)
    suits = suits.to(torch.int64)
    batch = ranks.shape[:-1]
    pos = torch.arange(N, dtype=torch.int64, device=dev)
    R = _ranks15(ranks)
    n = valid.sum(-1)
    rc = rank_counts(ranks, valid)
    sc = suit_counts(suits, valid)
    present = rc > 0

    def flag(x):
        if torch.is_tensor(x):
            return x.expand(batch)
        return torch.full(batch, bool(x), device=dev)

    four_fingers, shortcut = flag(four_fingers), flag(shortcut)

    e5, e4, e3, e2 = (rc == 5), (rc == 4), (rc == 3), (rc == 2)
    has5, has4, has3, has2 = (m.any(-1) for m in (e5, e4, e3, e2))
    top5, top4, top3 = (_top_rank_where(m) for m in (e5, e4, e3))
    p1 = _top_rank_where(e2)
    p2 = _top_rank_where(e2 & (R != p1[..., None]))
    num_pairs = e2.sum(-1)

    req = torch.where(four_fingers, 4, 5)
    size_ok = (n <= 5) & (n >= req)
    flush_suit = sc.argmax(-1)
    has_flush = size_ok & (sc.amax(-1) >= req)

    s_found, s_tmask, s_skipped = _straight_scan(present, shortcut, req)
    w_found, w_tmask = _wheel_scan(present, shortcut, s_skipped, req)
    has_straight = size_ok & (s_found | w_found)
    use_wheel = ~s_found & w_found

    # Straight scoring mask: the first ``req`` run cards ordered by
    # (descending rank | wheel order), then position.
    r_eq = ranks[..., :, None] == R
    in_main = (r_eq & s_tmask[..., None, :]).any(-1) & valid
    in_wheel = (r_eq & w_tmask[..., None, :]).any(-1) & valid
    in_t = torch.where(use_wheel[..., None], in_wheel, in_main)
    wheel_order = const(_WHEEL_ORDER, torch.int64, dev)
    key_main = (14 - ranks) * N + pos
    key_wheel = torch.where(r_eq, wheel_order, 0).sum(-1) * N + pos
    key = torch.where(use_wheel[..., None], key_wheel, key_main)
    key = torch.where(in_t, key, 10_000)
    order = (key[..., :, None] > key[..., None, :]).sum(-1)
    straight_mask = in_t & (order < req[..., None])

    flush_mask = (suits == flush_suit[..., None]) & valid

    HT = HandType
    two_pair_ok = (num_pairs == 2) | ((e3.sum(-1) == 1) & (num_pairs == 1))
    ht = torch.full(batch, int(HT.HIGH_CARD), dtype=torch.int64, device=dev)
    for cond, v in (
        (has2, HT.ONE_PAIR), (two_pair_ok, HT.TWO_PAIR),
        (has3, HT.THREE_KIND), (has_straight, HT.STRAIGHT),
        (has_flush, HT.FLUSH), (has3 & has2, HT.FULL_HOUSE),
        (has4, HT.FOUR_KIND), (has_flush & has_straight, HT.STRAIGHT_FLUSH),
        (has5, HT.FIVE_KIND), (has3 & has2 & has_flush, HT.FLUSH_HOUSE),
        (has5 & has_flush, HT.FLUSH_FIVE),
    ):
        ht = torch.where(cond, int(v), ht)

    def of_rank(*rs):
        m = torch.zeros_like(valid)
        for r in rs:
            m = m | (ranks == r[..., None])
        return m & valid

    m_house = of_rank(top3, p1)
    mask = valid                                  # High Card: all played
    for v, m in (
        (HT.ONE_PAIR, of_rank(p1)), (HT.TWO_PAIR, of_rank(p1, p2)),
        (HT.THREE_KIND, of_rank(top3)), (HT.STRAIGHT, straight_mask),
        (HT.FLUSH, flush_mask), (HT.FULL_HOUSE, m_house),
        (HT.FOUR_KIND, of_rank(top4)),
        (HT.STRAIGHT_FLUSH, flush_mask | straight_mask),
        (HT.FIVE_KIND, of_rank(top5)), (HT.FLUSH_HOUSE, m_house),
        (HT.FLUSH_FIVE, of_rank(top5)),
    ):
        mask = torch.where((ht == int(v))[..., None], m, mask)
    return ht, mask
