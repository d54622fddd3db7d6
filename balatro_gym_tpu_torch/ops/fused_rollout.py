"""Whole-rollout sim-engine kernel (CUDA) and its plain PyTorch version.

Port of ``balatro_gym_tpu/ops/fused_rollout.py``. One call runs an n-step
rollout of the single-blind sim engine's rollout-reachable subspace for
every env: an 8-card hand, actions 0-9 that play or discard a prefix of
1..5 cards, sim scoring from per-env joker coefficients, the arithmetic
fixture deck (card ``i`` has rank ``2 + i % 13`` and suit block (H, D, C,
S)[i // 13]) and autoreset. It returns the final hands, counters and the
per-env reward sum, in int32/float32 as the TPU kernel computes.

* ``rollout_fused`` is the entry point. It runs on the card unless called
  with ``device="cpu"``, where it runs the plain version; on a card it
  launches ``csrc/fused_rollout.cu`` (built with nvcc on first use) or
  raises. It counts its launches in
  ``rollout_fused.launches``; ``rollout_kernel_shape`` reads the kernel's
  launch shape from the built library. A call is the span ``sim.call``
  (``utils/profiling.py``), holding ``sim.coef`` (the joker coefficients
  and the actions, ``_prepare``) and ``sim.launch`` (the outputs' allocation
  and the kernel's enqueue, or the plain version).
* ``rollout_fused_reference`` is the plain version: batched tensor ops over
  ``[B]`` rows with a Python loop over steps, on any device. Its float
  arithmetic follows the kernel op for op (all additive terms are exact
  integers in float32; ``2**e2`` is an exponent-field bitcast; ``3**e3``
  and ``1.5**e15`` are the same bounded multiply chains; the score is a
  truncating cast of ``chips * (mult * x)``; the reward is
  ``delta / 100 + 100 * beat`` summed in step order), so the two agree bit
  for bit. Hand evaluation is the engine's ``evaluate_sim``, whose integer
  results do not depend on how they are computed.

Two modes: fed ``actions`` ([n_steps, B] legal action ids) replay a script
with no randomness; the random jokers Misprint and Bloodstone then do not
fire, as in the TPU kernel, so fed-mode parity with the engine holds for
joker sets without them. With ``actions=None`` actions are drawn uniformly
over the legal set and Misprint and Bloodstone roll, all from Threefry:
env ``e``'s child key ``split_child(seed_key(seed), e)`` gives draw
``random_bits32(child, step * 10 + slot)``, slot 0 the action, 1 Misprint,
2..9 the Bloodstone coin of cards 0..7.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from balatro_gym_tpu_torch.core.constants import BASE_HAND_CHIPS, BASE_HAND_MULT
from balatro_gym_tpu_torch.core.device import check_arg, const, run_device
from balatro_gym_tpu_torch.ops import cuda_build
from balatro_gym_tpu_torch.ops import joker_tables as JT
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.ops.hand_eval import evaluate_sim
from balatro_gym_tpu_torch.utils import profiling as P

N_CARDS = 8
MAX_JOKERS = 5

# Rows of the per-env scalar coefficient array.
S_CHIPS_FLAT = 0   # sum of flat joker chips
S_MULT_CONST = 1   # flat mult + Mystic Summit (sim ctx: always) + Abstract
S_HALF20 = 2       # 20 * #Half Joker (fires when <=3 scoring cards)
S_MISPRINT = 3     # #Misprint (random +randint(0,23) mult)
S_TRIB = 4         # #Triboulet (x2 per scoring Q/K)
S_BLOOD = 5        # #Bloodstone (50% x2 per scoring Heart)
S_SEEING = 6       # #Seeing Double (x2 if Club + another suit scoring)
S_BLACKB = 7       # #Blackboard (x3 if all played cards Spade/Club)
S_FLOWER = 8       # #Flower Pot (x3 if exactly 4 scoring suit cats)
S_E3_CONST = 9     # flat x3 exponents + Acrobat (sim ctx: always fires)
S_BARON = 10       # #Baron (x1.5 per King among played)
S_STM13 = 11       # 13 * #Shoot the Moon (per Queen among played)
S_FF = 12          # Four Fingers held (0/1)
S_SHORTCUT = 13    # Shortcut held (0/1)
S_BLIND = 14       # blind requirement
S_MONEY0 = 15      # initial money
N_SCAL = 16

# Fresh-episode hand: A K Q J 10 9 8 7 of Spades, 44 cards left.
_RESET_RANKS = np.array([14, 13, 12, 11, 10, 9, 8, 7], np.int32)
_RESET_SUIT = 3
_RESET_DECK_N = 44
N_SLOTS = 10       # Threefry counters per env-step: action, Misprint, 8 coins

_I32, _F32 = torch.int32, torch.float32
_PIN_MAX_BYTES = 1 << 16


def _to_device(x, dtype, device=None):
    """``x`` as a ``dtype`` tensor on ``device`` (default: where it is).
    Small host data bound for a card (a joker set) goes through pinned memory
    without blocking: a pageable copy makes the host wait for the card's
    queue to drain, so the card would idle while the host enqueues the next
    call. Large arrays (per-env jokers, fed actions) are not worth pinning."""
    t = x.to(dtype) if torch.is_tensor(x) else torch.as_tensor(np.array(x), dtype=dtype)
    if device is None:
        return t
    device = torch.device(device)
    if (device.type == "cuda" and t.device.type == "cpu"
            and t.numel() * t.element_size() <= _PIN_MAX_BYTES):
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device)


def joker_coefficients(jokers, n_envs, device=None):
    """Reduce the joker tables to per-env float32 coefficient rows.

    jokers: ``[5]`` or ``[B, 5]`` ids. Returns (scal ``[16, B]``, ranktab
    ``[32, B]``, suittab ``[32, B]``, handtab ``[64, B]``), with the sim
    path's game-state quirks: Mystic Summit and Acrobat always fire, Banner
    and Blue Joker add nothing.
    """
    t = JT.get_tables()
    jok = _to_device(jokers, torch.int64, device)
    dev = jok.device
    if jok.shape not in ((MAX_JOKERS,), (n_envs, MAX_JOKERS)):
        raise ValueError(f"jokers: want shape ({MAX_JOKERS},) or ({n_envs}, "
                         f"{MAX_JOKERS}) for {n_envs} envs, got {tuple(jok.shape)}")
    if jok.dim() == 1:      # one set for all envs: reduce once, then broadcast
        return tuple(rows.expand(rows.shape[0], n_envs).contiguous()
                     for rows in joker_coefficients(jok[None], 1))
    jv = jok > 0
    j151 = ((jok[:, :, None] == torch.arange(JT.NUM_JOKERS, device=dev))
            & jv[:, :, None]).sum(1).to(_F32)                      # [B, 151]
    njok = jv.sum(1).to(_F32)

    def dot(tab):           # exact: small integers, products < 2**24
        return j151 @ const(tab, _F32, dev)

    def cnt(jid):
        return j151[:, jid]

    B = j151.shape[0]
    scal = torch.zeros(N_SCAL, B, dtype=_F32, device=dev)
    scal[S_CHIPS_FLAT] = dot(t.chips_flat)
    scal[S_MULT_CONST] = (dot(t.mult_flat) + 15.0 * cnt(JT.J_MYSTIC_SUMMIT)
                          + 3.0 * njok * cnt(JT.J_ABSTRACT))
    scal[S_HALF20] = 20.0 * cnt(JT.J_HALF)
    scal[S_MISPRINT] = cnt(JT.J_MISPRINT)
    scal[S_TRIB] = cnt(JT.J_TRIBOULET)
    scal[S_BLOOD] = cnt(JT.J_BLOODSTONE)
    scal[S_SEEING] = cnt(JT.J_SEEING_DOUBLE)
    scal[S_BLACKB] = cnt(JT.J_BLACKBOARD)
    scal[S_FLOWER] = cnt(JT.J_FLOWER_POT)
    scal[S_E3_CONST] = dot(t.x3_flat) + cnt(JT.J_ACROBAT)
    scal[S_BARON] = cnt(JT.J_BARON)
    scal[S_STM13] = 13.0 * cnt(JT.J_SHOOT_THE_MOON)
    scal[S_FF] = (cnt(JT.J_FOUR_FINGERS) > 0).to(_F32)
    scal[S_SHORTCUT] = (cnt(JT.J_SHORTCUT) > 0).to(_F32)
    scal[S_BLIND] = 300.0
    scal[S_MONEY0] = 4.0

    def pad_t(x, rows):
        out = torch.zeros(rows, B, dtype=_F32, device=dev)
        out[: x.shape[1]] = x.T
        return out

    ranktab = torch.cat([pad_t(dot(t.ind_chip_rank), 16), pad_t(dot(t.ind_mult_rank), 16)])
    suittab = torch.cat([pad_t(dot(t.ind_chip_suit), 8), pad_t(dot(t.ind_mult_suit), 8),
                         pad_t(dot(t.ind_money_suit), 8), pad_t(dot(t.mult_if_suit), 8)])
    handtab = torch.cat([pad_t(dot(t.chips_hand_sim), 16), pad_t(dot(t.mult_hand_sim), 16),
                         pad_t(dot(t.x2_hand_sim), 16), pad_t(dot(t.x3_hand_sim), 16)])
    return scal, ranktab, suittab, handtab


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------

def _deck_card(src):
    """(rank, suit) of fixture-deck slot ``src`` (arithmetic, no gather),
    the slot clamped to the deck as the kernel clamps it."""
    src = src.clamp(0, 51)
    b = (src >= 13).to(_I32) + (src >= 26).to(_I32) + (src >= 39).to(_I32)
    suit = torch.where(b == 0, 2, torch.where(b == 1, 1, torch.where(b == 2, 0, 3)))
    return src - 13 * b + 2, suit.to(_I32)


def sample_action(bits, discards_left):
    """Uniform legal action from 32 random bits: ``int(u01 * n_legal)`` with
    ``u01 = (bits >> 8) * 2**-24`` and n_legal 10, or 5 without discards."""
    n_legal = torch.where(discards_left > 0, 10.0, 5.0).to(_F32)
    u = (bits >> 8).to(_F32) * 2.0 ** -24
    return (u * n_legal).to(_I32)


def sampled_draws(child, step):
    """The Threefry words env-step ``step`` may use, ``[N_SLOTS, B]``:
    slot 0 the action, 1 Misprint, 2..9 the Bloodstone coins of cards 0..7."""
    ctr = step * N_SLOTS + torch.arange(N_SLOTS, device=child[0].device)[:, None]
    return KR.random_bits32(child[0][None], child[1][None], ctr)


def reference_step(st, coef, action, draws=None):
    """One env-step of every env; ``st`` is a dict of the kernel's state rows
    (``rank``/``suit`` ``[8, B]`` int32; ``deck_n``, ``money``,
    ``hands_left``, ``discards_left``, ``score``, ``episodes`` ``[B]``
    int32; ``tot_reward`` ``[B]`` float32), updated in place. ``draws``
    (sampled mode) feeds Misprint and Bloodstone."""
    scal, ranktab, suittab, handtab = coef
    dev = action.device
    rank, suit = st["rank"], st["suit"]
    is_disc = action >= 5
    k = torch.where(is_disc, action - 5, action) + 1
    cards = torch.arange(N_CARDS, device=dev)[:, None]
    sel = cards < k                                                  # [8, B]

    ht, smask = evaluate_sim(rank.T, suit.T, sel.T, scal[S_FF] > 0, scal[S_SHORTCUT] > 0)
    smask = smask.T & sel
    sm = smask.to(_F32)

    # ---- score: additive terms are exact integers in float32 ----
    chips = const(BASE_HAND_CHIPS, _F32, dev)[ht] + handtab.gather(0, ht[None])[0]
    mult = const(BASE_HAND_MULT, _F32, dev)[ht] + handtab.gather(0, 16 + ht[None])[0]
    bv = (rank.clamp(max=10) + (rank == 14).to(_I32)).to(_F32)   # A=11, faces 10
    chips = chips + (sm * (bv + ranktab.gather(0, rank.long()))).sum(0)
    mult = mult + (sm * ranktab.gather(0, 16 + rank.long())).sum(0)
    chips = chips + (sm * suittab.gather(0, suit.long())).sum(0)
    mult = mult + (sm * suittab.gather(0, 8 + suit.long())).sum(0)
    money_d = (sm * suittab.gather(0, 16 + suit.long())).sum(0)
    sh_s = torch.stack([(smask & (suit == s)).sum(0) for s in range(4)])  # [4, B]
    suit_on = (sh_s > 0).to(_F32)
    n_scoring = smask.sum(0)
    chips = chips + scal[S_CHIPS_FLAT]
    mult = mult + scal[S_MULT_CONST]
    mult = mult + torch.where(n_scoring <= 3, scal[S_HALF20], 0.0)
    mult = mult + (suit_on * suittab[24:28]).sum(0)
    nq = (sel & (rank == 12)).sum(0).to(_F32)
    nk = (sel & (rank == 13)).sum(0).to(_F32)
    mult = mult + scal[S_STM13] * nq
    if draws is not None:
        mult = mult + scal[S_MISPRINT] * (draws[1] % 24).to(_F32)

    # ---- x-mult exponents of the exact bases 2, 3 and 1.5 ----
    n_qk = (smask & ((rank == 12) | (rank == 13))).sum(0).to(_F32)
    e2 = scal[S_TRIB] * n_qk
    present_cats = suit_on.sum(0)
    e2 = e2 + scal[S_SEEING] * ((sh_s[0] > 0) & (present_cats > 1)).to(_F32)
    if draws is not None:
        coins = (smask & (suit == 2)).to(_F32) * (draws[2:] & 1).to(_F32)
        e2 = e2 + scal[S_BLOOD] * coins.sum(0)
    all_sc = (~sel | (suit == 3) | (suit == 0)).all(0)
    e3 = scal[S_E3_CONST] + scal[S_BLACKB] * all_sc.to(_F32)
    e3 = e3 + scal[S_FLOWER] * (present_cats == 4).to(_F32)
    e15 = scal[S_BARON] * nk
    e2 = e2 + handtab.gather(0, 32 + ht[None])[0]
    e3 = e3 + handtab.gather(0, 48 + ht[None])[0]
    x = ((e2.to(_I32) + 127) << 23).view(_F32)                      # 2**e2
    p3 = torch.ones_like(x)
    for i in range(1, 13):
        p3 = torch.where(e3 >= i, p3 * 3.0, p3)
    p15 = torch.ones_like(x)
    for i in range(1, 21):
        p15 = torch.where(e15 >= i, p15 * 1.5, p15)
    x = x * p3 * p15
    delta = (chips * (mult * x)).to(_I32)

    # ---- step outcome ----
    new_score = st["score"] + delta
    beat = new_score >= scal[S_BLIND].to(_I32)
    # A tensor divisor: PyTorch's CUDA division by a host scalar multiplies
    # by the reciprocal, which is not the kernel's IEEE division.
    play_reward = delta.to(_F32) / torch.full_like(x, 100.0) + torch.where(beat, 100.0, 0.0)
    reward = torch.where(is_disc, -1.0, play_reward)
    st["score"] = torch.where(is_disc, st["score"], new_score)
    st["money"] = torch.where(is_disc, st["money"], st["money"] + money_d.to(_I32))
    st["hands_left"] = torch.where(
        is_disc, st["hands_left"], torch.where(beat, 0, st["hands_left"] - 1)).to(_I32)
    st["discards_left"] = torch.where(is_disc, st["discards_left"] - 1, st["discards_left"])

    # ---- remove prefix k, refill from the deck top ----
    new_rank, new_suit = torch.zeros_like(rank), torch.zeros_like(suit)
    for c in range(N_CARDS):
        for s in range(1, 6):
            if c + s < N_CARDS:
                cand_r, cand_s = rank[c + s], suit[c + s]
            else:
                cand_r, cand_s = _deck_card(st["deck_n"] + (N_CARDS - 1) - s - c)
            is_s = k == s
            new_rank[c] = torch.where(is_s, cand_r, new_rank[c])
            new_suit[c] = torch.where(is_s, cand_s, new_suit[c])
    st["deck_n"] = st["deck_n"] - k

    # ---- episode end + in-place reset ----
    done = st["hands_left"] <= 0
    st["episodes"] = st["episodes"] + done.to(_I32)
    st["tot_reward"] = st["tot_reward"] + reward
    reset_rank = const(_RESET_RANKS, _I32, dev)[:, None]
    st["rank"] = torch.where(done, reset_rank, new_rank)
    st["suit"] = torch.where(done, _RESET_SUIT, new_suit).to(_I32)
    st["deck_n"] = torch.where(done, _RESET_DECK_N, st["deck_n"]).to(_I32)
    st["money"] = torch.where(done, scal[S_MONEY0].to(_I32), st["money"])
    st["hands_left"] = torch.where(done, 4, st["hands_left"]).to(_I32)
    st["discards_left"] = torch.where(done, 3, st["discards_left"]).to(_I32)
    st["score"] = torch.where(done, 0, st["score"]).to(_I32)


def _reference_rows(coef, seed, actions, n_steps):
    """Plain version on coefficient rows; returns the kernel's outputs
    (ranks, suits, stats ``[8, B]`` int32, reward ``[B]`` float32)."""
    scal = coef[0]
    B, dev = scal.shape[1], scal.device
    full = lambda v: torch.full((B,), v, dtype=_I32, device=dev)  # noqa: E731
    st = {"rank": const(_RESET_RANKS, _I32, dev)[:, None].repeat(1, B),
          "suit": torch.full((N_CARDS, B), _RESET_SUIT, dtype=_I32, device=dev),
          "deck_n": full(_RESET_DECK_N), "money": scal[S_MONEY0].to(_I32),
          "hands_left": full(4), "discards_left": full(3), "score": full(0),
          "episodes": full(0), "tot_reward": torch.zeros(B, dtype=_F32, device=dev)}
    if actions is None:
        k1, k2 = KR.seed_key(seed, device=dev)
        child = KR.split_child(k1, k2, torch.arange(B, device=dev))
    for t in range(n_steps):
        if actions is None:
            draws = sampled_draws(child, t)
            action = sample_action(draws[0], st["discards_left"])
        else:
            draws, action = None, actions[t]
        reference_step(st, coef, action, draws)
    stats = torch.stack([st["deck_n"], st["money"], st["hands_left"],
                         st["discards_left"], st["score"], st["episodes"],
                         (st["hands_left"] <= 0).to(_I32), full(0)])
    return st["rank"], st["suit"], stats, st["tot_reward"]


# --------------------------------------------------------------------------
# CUDA kernel
# --------------------------------------------------------------------------

_C_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2 + [ctypes.c_void_p]


def _kernel_lib():
    lib = cuda_build.load("fused_rollout.cu")
    lib.fused_rollout_launch.argtypes = _C_ARGS
    lib.fused_rollout_info.argtypes = [ctypes.c_void_p]
    lib.fused_rollout_launch.restype = lib.fused_rollout_info.restype = ctypes.c_int
    return lib


def rollout_kernel_shape():
    """K4's launch shape and what the compiler gave it, on the current
    card: {"block": threads a block, "shared_bytes": shared memory a block,
    "registers": a thread, "stack_bytes": local memory a thread}."""
    out = (ctypes.c_int * 4)()
    err = _kernel_lib().fused_rollout_info(out)
    if err != 0:
        raise RuntimeError(f"fused_rollout_info failed: cudaError_t {err}")
    return dict(zip(("block", "shared_bytes", "registers", "stack_bytes"), out))


def _kernel_rows(coef, seed, actions, n_steps):
    """Launches csrc/fused_rollout.cu on the coefficient rows' card. The
    rows are ``joker_coefficients``' (non-negative integers, at most 5
    copies of a joker): the kernel packs them into 16-bit halves and 4-bit
    fields."""
    scal = coef[0]
    dev, B = scal.device, scal.shape[1]
    for t, name, rows in zip(coef, ("scal", "ranktab", "suittab", "handtab"),
                             (N_SCAL, 32, 32, 64)):
        check_arg(t, name, _F32, (rows, B), dev)
    if actions is not None:
        check_arg(actions, "actions", _I32, (n_steps, B), dev)
    lib = _kernel_lib()
    ranks = torch.empty(N_CARDS, B, dtype=_I32, device=dev)
    suits = torch.empty(N_CARDS, B, dtype=_I32, device=dev)
    stats = torch.empty(8, B, dtype=_I32, device=dev)
    reward = torch.empty(B, dtype=_F32, device=dev)
    key0, key1 = 0, int(seed) & 0xFFFFFFFF                  # seed_key(seed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_rollout_launch(
            *(t.data_ptr() for t in coef),
            actions.data_ptr() if actions is not None else None,
            ranks.data_ptr(), suits.data_ptr(), stats.data_ptr(), reward.data_ptr(),
            B, n_steps, int(actions is not None), key0, key1, stream)
    if err != 0:
        raise RuntimeError(f"fused_rollout kernel launch failed: cudaError_t {err}")
    rollout_fused.launches += 1
    return ranks, suits, stats, reward


def _prepare(n_envs, n_steps, jokers, actions, device):
    device = run_device((jokers, actions), device)
    coef = joker_coefficients(jokers, n_envs, device=device)
    if actions is not None:
        actions = _to_device(actions, _I32, device)
        if actions.dim() == 1:
            actions = actions[:, None].expand(actions.shape[0], n_envs)
        actions = actions.reshape(n_steps, n_envs).contiguous()
    return coef, actions


def _as_dict(ranks, suits, stats, reward):
    return {"hand_rank": ranks.T, "hand_suit": suits.T,
            "deck_n": stats[0], "money": stats[1], "hands_left": stats[2],
            "discards_left": stats[3], "score": stats[4], "episodes": stats[5],
            "total_reward": reward}


def rollout_fused(seed, n_envs: int, n_steps: int, jokers=(0, 0, 0, 0, 0), *,
                  actions=None, device=None):
    """Fused rollout. Returns final per-env state (``hand_rank``/``hand_suit``
    ``[B, 8]``, ``deck_n``, ``money``, ``hands_left``, ``discards_left``,
    ``score``, ``episodes``) and ``total_reward`` ``[B]``.

    actions: optional ``[n_steps, n_envs]`` (or ``[n_steps]``, broadcast)
    action ids 0-9 to replay; None samples uniformly over the legal set.
    device: where to run (default: the device of a ``jokers`` or
    ``actions`` tensor off the host, else the card, raising where there is
    none); it must agree with such a tensor, and tensors on two devices
    raise. With ``device="cpu"`` this is the plain version; on a card it is
    the CUDA kernel.
    """
    with P.span("sim.call"):
        with P.span("sim.coef"):
            coef, actions = _prepare(n_envs, n_steps, jokers, actions, device)
        dev = coef[0].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"rollout_fused: no kernel for device {dev}")
        with P.span("sim.launch"):
            run = _reference_rows if dev.type == "cpu" else _kernel_rows
            out = run(coef, seed, actions, n_steps)
        return _as_dict(*out)


rollout_fused.launches = 0


def rollout_fused_reference(seed, n_envs: int, n_steps: int, jokers=(0, 0, 0, 0, 0), *,
                            actions=None, device=None):
    """The plain PyTorch version of :func:`rollout_fused`, on any device."""
    coef, actions = _prepare(n_envs, n_steps, jokers, actions, device)
    return _as_dict(*_reference_rows(coef, seed, actions, n_steps))
