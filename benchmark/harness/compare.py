"""The numbers that decide ``correct``, each against its limit.

Training: each compared step's loss as a relative gap; the first update's
gradient, as Adam's first moment after it, and the parameters' change
after the compared updates as gaps of norms taken by the worst leaf. A
leaf's gap is ``| |prog| - |ref| |`` over the larger of ``|ref|`` and the
median leaf's ``|ref|``. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out of
the change.

Answers (the rollout): each sampled env's final packed state, episode count
and reward total against the reference's, exactly.
"""
from __future__ import annotations

import statistics

import torch


def _norms(leaves):
    return [float(torch.linalg.vector_norm(x.double())) for x in leaves]


def norm_gap(prog, ref, keep=None) -> float:
    """The worst leaf's gap of norms (see the module's note)."""
    p, r = _norms(prog), _norms(ref)
    floor = statistics.median(r)
    idx = range(len(r)) if keep is None else keep
    return max(abs(p[i] - r[i]) / max(r[i], floor, 1e-30) for i in idx)


def moving_leaves(ref_grad) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    r = _norms(ref_grad)
    floor = 1e-3 * statistics.median(r)
    return [i for i, v in enumerate(r) if v >= floor]


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (one a compared update),
    ``grad`` (Adam's first moment after the first update, a leaf a
    parameter), ``start`` and ``end`` (the parameters before the first and
    after the last compared update)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    dp = [e - s for e, s in zip(prog["end"], prog["start"])]
    dr = [e - s for e, s in zip(ref["end"], ref["start"])]
    return {"loss_gap": loss, "grad_gap": norm_gap(prog["grad"], ref["grad"]),
            "change_gap": norm_gap(dp, dr, moving_leaves(ref["grad"]))}


def answer_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``rows`` (packed ``[rows, n]`` int32
    tensors, one entry a part of the state), ``episodes`` and
    ``total_reward`` of the same ``n`` sampled envs."""
    bad = torch.zeros_like(ref["episodes"], dtype=torch.bool)
    for k, r in ref["rows"].items():
        p = prog["rows"][k].reshape(-1, r.shape[-1])
        bad |= (p != r.reshape(-1, r.shape[-1])).any(0)
    pr, rr = prog["total_reward"].double(), ref["total_reward"].double()
    return {"state_mismatch": int(bad.sum()),
            "episode_mismatch": int((prog["episodes"] != ref["episodes"]).sum()),
            "reward_gap": float((pr - rr).abs().max())}
