"""The single-blind sim engine's whole rollout for chosen envs of chosen
calls, on the frozen copy (the semantics of the port's
``ops/fused_rollout.py:rollout_fused_reference``).

A rollout steps every env through the sim engine's rollout-reachable
subspace: an 8-card hand, actions 0-9 that play (0-4) or discard (5-9) a
prefix of 1..5 cards, sim scoring from per-env joker coefficients, the
arithmetic fixture deck (slot ``i`` holds rank ``2 + i % 13`` of the suit
block (H, D, C, S)[i // 13], drawn from the top down), blind 300, money 4,
and autoreset to A K Q J 10 9 8 7 of Spades with 44 cards left.

Draws. Env ``e`` of a call with seed ``s`` takes the child key
``split_child(seed_key(s), e)``; its step ``t`` reads ``random_bits32(child,
10 t + slot)``: slot 0 the action (uniform over the legal set), 1 Misprint's
mult, 2..9 Bloodstone's coin for cards 0..7. Each env's path depends on its
own key alone, so any set of (seed, env) pairs runs as one batch. Fed
actions replay a script and leave Misprint and Bloodstone unfired.

Float arithmetic follows the port op for op: every additive term is an exact
integer in float32, ``2**e2`` is an exponent-field bitcast, ``3**e3`` and
``1.5**e15`` are bounded multiply chains, the score is a truncating cast of
``chips * (mult * x)``, and the reward ``delta / 100 + 100 * beat`` (or -1 a
discard) is summed in step order.
"""
from __future__ import annotations

import numpy as np
import torch

from . import joker_tables as JT
from . import kernel_rng as KR
from .constants import BASE_HAND_CHIPS, BASE_HAND_MULT
from .device import const
from .hand_eval import evaluate_sim

N_CARDS = 8
N_SLOTS = 10            # Threefry counters an env-step: action, Misprint, 8 coins
BLIND = 300
MONEY0 = 4
RESET_RANKS = np.array([14, 13, 12, 11, 10, 9, 8, 7], np.int32)
RESET_SUIT = 3          # Spades
RESET_DECK_N = 44
BLOCK_SUIT = np.array([2, 1, 0, 3], np.int32)       # suit of deck blocks H, D, C, S
_I32, _F32 = torch.int32, torch.float32


def _pad_rows(x, rows):
    """``x`` ``[B, k]`` as ``[rows, B]``, zero below its ``k`` rows."""
    out = torch.zeros(rows, x.shape[0], dtype=_F32, device=x.device)
    out[: x.shape[1]] = x.T
    return out


def joker_coefficients(jokers):
    """Per-env float32 coefficients of ``[n, 5]`` joker ids (0 an empty
    slot): a dict of ``[n]`` scalars and the tables ``ranktab`` ``[32, n]``
    (chips by rank, mult by rank), ``suittab`` ``[32, n]`` (chips, mult,
    money by suit; mult if a scoring card has the suit) and ``handtab``
    ``[64, n]`` (chips, mult, x2 and x3 exponents by hand type). The sim
    context: Mystic Summit and Acrobat always fire, Banner and Blue Joker
    add nothing, Abstract gives 3 a joker held."""
    torch.backends.cuda.matmul.allow_tf32 = False    # the products below are exact
    torch.backends.cudnn.allow_tf32 = False          # in float32, not in TF32
    jok = jokers.to(torch.int64)
    dev = jok.device
    held = jok > 0
    counts = ((jok[:, :, None] == torch.arange(JT.NUM_JOKERS, device=dev))
              & held[:, :, None]).sum(1).to(_F32)                      # [n, 151]

    def dot(table):
        return counts @ const(table, _F32, dev)

    def cnt(jid):
        return counts[:, jid]

    c = {"chips_flat": dot(JT._chips_flat),
         "mult_const": (dot(JT._mult_flat) + 15.0 * cnt(JT.J_MYSTIC_SUMMIT)
                        + 3.0 * held.sum(1).to(_F32) * cnt(JT.J_ABSTRACT)),
         "half20": 20.0 * cnt(JT.J_HALF), "misprint": cnt(JT.J_MISPRINT),
         "trib": cnt(JT.J_TRIBOULET), "blood": cnt(JT.J_BLOODSTONE),
         "seeing": cnt(JT.J_SEEING_DOUBLE), "blackb": cnt(JT.J_BLACKBOARD),
         "flower": cnt(JT.J_FLOWER_POT), "e3_const": dot(JT._x3_flat) + cnt(JT.J_ACROBAT),
         "baron": cnt(JT.J_BARON), "stm13": 13.0 * cnt(JT.J_SHOOT_THE_MOON),
         "four_fingers": cnt(JT.J_FOUR_FINGERS) > 0, "shortcut": cnt(JT.J_SHORTCUT) > 0}
    c["ranktab"] = torch.cat([_pad_rows(dot(JT._ind_chip_rank), 16),
                              _pad_rows(dot(JT._ind_mult_rank), 16)])
    c["suittab"] = torch.cat([_pad_rows(dot(JT._ind_chip_suit), 8),
                              _pad_rows(dot(JT._ind_mult_suit), 8),
                              _pad_rows(dot(JT._ind_money_suit), 8),
                              _pad_rows(dot(JT._mult_if_suit), 8)])
    c["handtab"] = torch.cat([_pad_rows(dot(JT._chips_hand_sim), 16),
                              _pad_rows(dot(JT._mult_hand_sim), 16),
                              _pad_rows(dot(JT._x2_hand_sim), 16),
                              _pad_rows(dot(JT._x3_hand_sim), 16)])
    return c


def deck_card(src):
    """(rank, suit) of fixture-deck slot ``src``, clamped to the deck."""
    src = src.clamp(0, 51)
    block = src // 13
    return (src - 13 * block + 2).to(_I32), const(BLOCK_SUIT, _I32, src.device)[block.long()]


def start_state(n, device, reward_dtype=torch.float32):
    """A fresh episode for ``n`` envs."""
    full = lambda v: torch.full((n,), v, dtype=_I32, device=device)     # noqa: E731
    return {"rank": const(RESET_RANKS, _I32, device)[:, None].repeat(1, n),
            "suit": torch.full((N_CARDS, n), RESET_SUIT, dtype=_I32, device=device),
            "deck_n": full(RESET_DECK_N), "money": full(MONEY0), "hands_left": full(4),
            "discards_left": full(3), "score": full(0), "episodes": full(0),
            "tot_reward": torch.zeros(n, dtype=reward_dtype, device=device)}


def step(st, c, action, draws=None):
    """One env-step of every env of ``st`` (rows as :func:`start_state`
    makes them), in place; ``draws`` ``[N_SLOTS, n]`` in sampled mode."""
    dev = action.device
    rank, suit = st["rank"], st["suit"]
    ranktab, suittab, handtab = c["ranktab"], c["suittab"], c["handtab"]
    is_disc = action >= 5
    k = torch.where(is_disc, action - 5, action) + 1
    sel = torch.arange(N_CARDS, device=dev)[:, None] < k                # [8, n]

    ht, smask = evaluate_sim(rank.T, suit.T, sel.T, c["four_fingers"], c["shortcut"])
    smask = smask.T & sel
    sm = smask.to(_F32)

    chips = const(BASE_HAND_CHIPS, _F32, dev)[ht] + handtab.gather(0, ht[None])[0]
    mult = const(BASE_HAND_MULT, _F32, dev)[ht] + handtab.gather(0, 16 + ht[None])[0]
    card_chips = (rank.clamp(max=10) + (rank == 14).to(_I32)).to(_F32)  # A 11, faces 10
    chips = chips + (sm * (card_chips + ranktab.gather(0, rank.long()))).sum(0)
    mult = mult + (sm * ranktab.gather(0, 16 + rank.long())).sum(0)
    chips = chips + (sm * suittab.gather(0, suit.long())).sum(0)
    mult = mult + (sm * suittab.gather(0, 8 + suit.long())).sum(0)
    money = (sm * suittab.gather(0, 16 + suit.long())).sum(0)
    by_suit = torch.stack([(smask & (suit == s)).sum(0) for s in range(4)])   # [4, n]
    suit_on = (by_suit > 0).to(_F32)
    chips = chips + c["chips_flat"]
    mult = mult + c["mult_const"]
    mult = mult + torch.where(smask.sum(0) <= 3, c["half20"], 0.0)
    mult = mult + (suit_on * suittab[24:28]).sum(0)
    queens = (sel & (rank == 12)).sum(0).to(_F32)
    kings = (sel & (rank == 13)).sum(0).to(_F32)
    mult = mult + c["stm13"] * queens
    if draws is not None:
        mult = mult + c["misprint"] * (draws[1] % 24).to(_F32)

    faces = (smask & ((rank == 12) | (rank == 13))).sum(0).to(_F32)
    e2 = c["trib"] * faces
    cats = suit_on.sum(0)
    e2 = e2 + c["seeing"] * ((by_suit[0] > 0) & (cats > 1)).to(_F32)
    if draws is not None:
        coins = (smask & (suit == 2)).to(_F32) * (draws[2:] & 1).to(_F32)
        e2 = e2 + c["blood"] * coins.sum(0)
    dark = (~sel | (suit == 3) | (suit == 0)).all(0)
    e3 = c["e3_const"] + c["blackb"] * dark.to(_F32)
    e3 = e3 + c["flower"] * (cats == 4).to(_F32)
    e15 = c["baron"] * kings
    e2 = e2 + handtab.gather(0, 32 + ht[None])[0]
    e3 = e3 + handtab.gather(0, 48 + ht[None])[0]
    x = ((e2.to(_I32) + 127) << 23).view(_F32)                          # 2**e2
    p3 = torch.ones_like(x)
    for i in range(1, 13):
        p3 = torch.where(e3 >= i, p3 * 3.0, p3)
    p15 = torch.ones_like(x)
    for i in range(1, 21):
        p15 = torch.where(e15 >= i, p15 * 1.5, p15)
    x = x * p3 * p15
    delta = (chips * (mult * x)).to(_I32)

    score = st["score"] + delta
    beat = score >= BLIND
    # an IEEE division (a CUDA division by a host scalar is a reciprocal multiply)
    reward = delta.to(_F32) / torch.full_like(x, 100.0) + torch.where(beat, 100.0, 0.0)
    reward = torch.where(is_disc, -1.0, reward)
    st["score"] = torch.where(is_disc, st["score"], score)
    st["money"] = torch.where(is_disc, st["money"], st["money"] + money.to(_I32))
    st["hands_left"] = torch.where(
        is_disc, st["hands_left"], torch.where(beat, 0, st["hands_left"] - 1)).to(_I32)
    st["discards_left"] = torch.where(is_disc, st["discards_left"] - 1, st["discards_left"])

    # the played or discarded prefix leaves; the rest move up; the deck refills
    new_rank, new_suit = torch.zeros_like(rank), torch.zeros_like(suit)
    for i in range(N_CARDS):
        for s in range(1, 6):
            if i + s < N_CARDS:
                r, u = rank[i + s], suit[i + s]
            else:
                r, u = deck_card(st["deck_n"] + (N_CARDS - 1) - s - i)
            new_rank[i] = torch.where(k == s, r, new_rank[i])
            new_suit[i] = torch.where(k == s, u, new_suit[i])
    st["deck_n"] = st["deck_n"] - k

    done = st["hands_left"] <= 0
    st["episodes"] = st["episodes"] + done.to(_I32)
    st["tot_reward"] = st["tot_reward"] + reward.to(st["tot_reward"].dtype)
    st["rank"] = torch.where(done, const(RESET_RANKS, _I32, dev)[:, None], new_rank)
    st["suit"] = torch.where(done, RESET_SUIT, new_suit).to(_I32)
    st["deck_n"] = torch.where(done, RESET_DECK_N, st["deck_n"]).to(_I32)
    st["money"] = torch.where(done, MONEY0, st["money"]).to(_I32)
    st["hands_left"] = torch.where(done, 4, st["hands_left"]).to(_I32)
    st["discards_left"] = torch.where(done, 3, st["discards_left"]).to(_I32)
    st["score"] = torch.where(done, 0, st["score"]).to(_I32)


def uniform_action(bits, discards_left):
    """``int(u * n_legal)``, ``u = (bits >> 8) 2**-24``; 10 legal actions,
    or the 5 plays once no discard is left."""
    n_legal = torch.where(discards_left > 0, 10.0, 5.0).to(_F32)
    return ((bits >> 8).to(_F32) * 2.0 ** -24 * n_legal).to(_I32)


def sampled_rollout(seeds, envs, n_steps: int, jokers, actions=None,
                    reward_dtype=torch.float32) -> dict:
    """``seeds``, ``envs``: ``[n]`` int64 (a call's seed and an env index of
    it, per env); ``jokers``: ``[5]`` (every env's) or ``[n, 5]`` ids;
    ``actions``: None (sampled) or ``[n_steps, n]`` ids to replay. Returns
    the final ``rows`` (``rank``, ``suit`` ``[8, n]``; ``counters`` ``[5,
    n]``: cards left in the deck, money, hands and discards left, score),
    ``episodes`` ``[n]`` int32 and ``total_reward`` ``[n]`` (summed in
    ``reward_dtype``, returned as float32)."""
    n, dev = envs.shape[0], envs.device
    jokers = torch.as_tensor(jokers, device=dev)
    c = joker_coefficients(jokers.expand(n, 5) if jokers.dim() == 1 else jokers)
    st = start_state(n, dev, reward_dtype)
    child = KR.split_child(*KR.seed_key(seeds), envs)
    slots = torch.arange(N_SLOTS, device=dev)[:, None]
    for t in range(n_steps):
        if actions is None:
            draws = KR.random_bits32(child[0][None], child[1][None], t * N_SLOTS + slots)
            step(st, c, uniform_action(draws[0], st["discards_left"]), draws)
        else:
            step(st, c, actions[t].to(_I32), None)
    counters = torch.stack([st[k] for k in ("deck_n", "money", "hands_left",
                                            "discards_left", "score")])
    return {"rows": {"rank": st["rank"], "suit": st["suit"], "counters": counters},
            "episodes": st["episodes"], "total_reward": st["tot_reward"].float()}
