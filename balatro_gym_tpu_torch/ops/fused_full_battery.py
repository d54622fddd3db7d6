"""Scenario battery for checking the fused full-env rollout: state surgery,
coverage-biased legal action scripts, the autoreset batches of a step, and
the step's branch classes with batches that take one each.

Numpy twin of ``scripts/fused_full_common.py`` (the reference's validators
use it), for machines without JAX: from the same state and the same numpy
generator, :func:`surgery` makes the same state and :func:`sample_legal`
the same actions (tests/test_torch_full_rollout.py holds them equal). The
surgery plants jokers, enhanced, sealed and edition cards, consumables,
acting bosses, Pillar marks, shop money and near-beat chip counts, so that
fed actions reach every branch of the step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from balatro_gym_tpu_torch.engine import consumable_logic as CL
from balatro_gym_tpu_torch.engine.full_env import FullEnvState
from balatro_gym_tpu_torch.ops import boss as BB
from balatro_gym_tpu_torch.ops import fused_full_rollout as F
from balatro_gym_tpu_torch.ops.fused_full_rollout import S_ANTE

# Consumable ids covering every sub-path of the consumable branch.
CONS_IDS = [
    CL.MAGICIAN, CL.HIGH_PRIESTESS, CL.EMPEROR, CL.JUDGEMENT, CL.FOOL,
    CL.HERMIT, CL.TEMPERANCE, CL.HANGED_MAN, CL.STRENGTH, CL.DEATH,
    CL.STAR, CL.WHEEL, CL.AURA, CL.HIEROPHANT, CL.LOVERS, CL.CHARIOT,
    CL.JUSTICE, CL.DEVIL, CL.TOWER,
    CL.PLANET_BASE, CL.PLANET_BASE + 5, CL.PLANET_BASE + 11,
    CL.FAMILIAR, CL.GRIM, CL.INCANTATION, CL.WRAITH, CL.SIGIL, CL.OUIJA,
    CL.ECTOPLASM, CL.IMMOLATE, CL.ANKH, CL.HEX, CL.CRYPTID, CL.THE_SOUL,
    CL.BLACK_HOLE, CL.TALISMAN, CL.DEJA_VU, CL.TRANCE, CL.MEDIUM,
    CL.ENUMNAME_OFFSET + CL.TAROT_BASE + 3,  # an Emperor-made enum-name tarot
]

# Joker sets, in rotation over the envs.
JOKER_SETS = [
    (0, 0, 0, 0, 0),
    (1, 31, 34, 48, 72),
    (6, 7, 131, 135, 0),
    (18, 69, 16, 23, 108),
    (116, 118, 119, 2, 3),
    (147, 140, 128, 122, 61),
    (62, 63, 64, 65, 93),
    (33, 37, 44, 115, 70),
]

BOSS_IDS = [BB.PSYCHIC, BB.EYE, BB.MOUTH, BB.VERDANT, BB.FLINT, BB.OXIDE,
            BB.ARM, BB.PLANT, BB.VIOLET, BB.PILLAR, BB.WHEEL, BB.HOUSE,
            BB.MARK, BB.FISH, BB.HOOK, BB.WALL, BB.WATER, BB.MANACLE,
            BB.NEEDLE, BB.TOOTH]

# Action weights of the coverage-biased legal policy.
WEIGHTS = np.ones(60, np.float64)
WEIGHTS[0] = 5.0                    # play
WEIGHTS[1] = 3.0                    # discard
WEIGHTS[10:15] = 8.0                # use consumable
WEIGHTS[20:30] = 3.0                # buy
WEIGHTS[30] = 3.0                   # reroll
WEIGHTS[32:37] = 3.0                # sell
WEIGHTS[45:48] = 2.0                # blinds
WEIGHTS[48] = 1.0                   # skip

ACTION_CLASSES = (("play", 0, 1), ("discard", 1, 2), ("select", 2, 10),
                  ("consumable", 10, 15), ("buy", 20, 30), ("reroll", 30, 31),
                  ("end", 31, 32), ("sell", 32, 37), ("blind", 45, 48),
                  ("skip", 48, 49))


def surgery(st: FullEnvState, rng: np.random.Generator) -> FullEnvState:
    """Diversify a batch (see the module docstring); draws from ``rng`` in
    the order the reference's script does."""
    g = {f.name: getattr(st, f.name).cpu().numpy().copy() for f in dataclasses.fields(st)}
    B = g["ante"].shape[0]
    env = np.arange(B)
    enh_vals = rng.integers(1, 9, (B, 64)).astype(np.int32)
    ed_vals = rng.integers(1, 5, (B, 64)).astype(np.int32)
    seal_vals = rng.integers(1, 5, (B, 64)).astype(np.int32)
    g["card_enh"] = np.where(rng.random((B, 64)) < 0.30, enh_vals, g["card_enh"])
    g["card_ed"] = np.where(rng.random((B, 64)) < 0.15, ed_vals, g["card_ed"])
    g["card_seal"] = np.where(rng.random((B, 64)) < 0.25, seal_vals, g["card_seal"])

    sets = np.asarray(JOKER_SETS, np.int32)[env % len(JOKER_SETS)]
    g["jokers"][:] = sets
    g["joker_n"][:] = (sets > 0).sum(1)

    cids = np.asarray(CONS_IDS, np.int32)
    g["cons"][:, 0] = cids[env % len(cids)]
    g["cons"][:, 1] = cids[(env + 7) % len(cids)]
    g["cons_n"][:] = 2
    g["cons_slots"][:] = np.where(env % 3 == 0, 2, 4)

    g["money"][:] = np.where(env % 4 == 0, 3, 60)
    phase = g["phase"]
    near = (env % 4 == 1) & (phase == 0)
    g["round_chips_scored"] = np.where(near, np.maximum(g["chips_needed"] - 40, 0),
                                       g["round_chips_scored"])

    on = (env % 2 == 0) & (phase == 0)
    g["boss_active"] = g["boss_active"] | on
    bids = np.asarray(BOSS_IDS, np.int32)[env % len(BOSS_IDS)]
    g["boss_id"] = np.where(on, bids, g["boss_id"])
    g["boss_played_slots"] = g["boss_played_slots"] | (rng.random((B, 64)) < 0.2)
    g["hand_levels"][env % 5 == 0] += 2

    dev = st.ante.device
    return FullEnvState(**{k: torch.as_tensor(v, dtype=getattr(st, k).dtype, device=dev)
                           for k, v in g.items()})


def sample_legal(mask, rng: np.random.Generator):
    """One coverage-biased legal action per env from a ``[B, 60]`` mask; an
    env with no legal action (a finished one) gets the no-op id 59."""
    w = np.asarray(mask) * WEIGHTS
    none = w.sum(1) == 0
    w[none, 59] = 1.0
    cum = np.cumsum(w, axis=1)
    u = rng.random((w.shape[0], 1)) * cum[:, -1:]
    return np.argmax(cum > u, axis=1).astype(np.int32)


def coverage(acts):
    """Count of the actions of each class in an action script."""
    hist = np.bincount(np.asarray(acts).reshape(-1), minlength=60)
    return {name: int(hist[a0:a1].sum()) for name, a0, a1 in ACTION_CLASSES}


def _takes(packed):
    """``[60, B]`` bool: the actions whose branch each env's step takes,
    the legal ones of an env that is not over."""
    s = F._load(packed)
    live = (s["ante"] <= 100) & (s["career"] <= 1_000_000_000) & ~s["done"]
    return F._legal_rows(s) & live


# The step's branch classes, in the order of csrc/full_step.cuh's enum
# (branch_class): the class of ACTION_CLASSES that an env's action takes,
# "idle" for an illegal action or an env that is over.
BRANCH_CLASSES = ("play", "reroll", "skip", "consumable", "blind", "discard", "end", "buy",
                  "sell", "select", "idle")


def branch_classes(packed, actions):
    """``[B]`` int64: each env's branch class in a fed-step batch, as an
    index of ``BRANCH_CLASSES``."""
    a = torch.as_tensor(actions).to(packed["ints"].device).long()
    taken = _takes(packed).gather(0, a[None])[0]
    out = torch.full_like(a, BRANCH_CLASSES.index("idle"))
    for name, a0, a1 in ACTION_CLASSES:
        out = torch.where(taken & (a >= a0) & (a < a1), BRANCH_CLASSES.index(name), out)
    return out


def class_histogram(packed, actions):
    """Envs of a fed-step batch by branch class (those with any)."""
    counts = torch.bincount(branch_classes(packed, actions), minlength=len(BRANCH_CLASSES))
    return {name: int(c) for name, c in zip(BRANCH_CLASSES, counts.tolist()) if c}


def class_batches(states, n, rng: np.random.Generator):
    """For each class of ``ACTION_CLASSES``, a fed-step batch ``(packed,
    actions)`` of ``n`` envs that all take it: columns of the packed states
    ``states`` (a list of packed dicts on one device) at envs whose step
    takes an action of the class (legal, the env not over), drawn with ``rng`` (with replacement where
    there are fewer than ``n``), each with a legal action of the class drawn
    uniformly. A class taken nowhere is left out."""
    masks = np.stack([_takes(p).T.cpu().numpy() for p in states])
    stacked = {k: torch.stack([p[k] for p in states]) for k in states[0]}
    dev = stacked["ints"].device
    out = {}
    for name, a0, a1 in ACTION_CLASSES:
        ti, ei = np.nonzero(masks[:, :, a0:a1].any(2))
        if len(ti) == 0:
            continue
        pick = rng.choice(len(ti), n, replace=len(ti) < n)
        ti, ei = ti[pick], ei[pick]
        w = masks[ti, ei, a0:a1].astype(np.float64)
        cum = np.cumsum(w, axis=1)
        u = rng.random((n, 1)) * cum[:, -1:]
        actions = (a0 + np.argmax(cum > u, axis=1)).astype(np.int32)
        t, e = torch.as_tensor(ti, device=dev), torch.as_tensor(ei, device=dev)
        packed = {"cards": stacked["cards"][t, :, :, e].permute(1, 2, 0).contiguous(),
                  "ints": stacked["ints"][t, :, e].T.contiguous(),
                  "rng": stacked["rng"][t, :, e].T.contiguous()}
        out[name] = (packed, torch.as_tensor(actions, device=dev))
    return out


def reset_batches(packed):
    """Two fed-step batches ``(packed, actions)`` from a packed state: the
    no-op action 59 everywhere, so no env ends, and the same with ante 101
    in every env, so every env takes the step's game-over branch and resets."""
    ints = packed["ints"]
    noop = torch.full((ints.shape[1],), 59, dtype=torch.int32, device=ints.device)
    over = {k: v.clone() for k, v in packed.items()}
    over["ints"][S_ANTE] = 101
    return (packed, noop), (over, noop)
