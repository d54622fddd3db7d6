"""The card's INT32 ceiling and the sim engine's work, for the roofline of
an integer-bound kernel (``harness/yardstick.py`` has the byte and FLOP
peaks).

Ceiling: K6 (``ops/alu_ceiling.py``, a chain of dependent int32 adds,
shifts, xors, compares and selects over every SM) measured 3.7e13 int32
source ops/s on the H100 at 700 W, 2.2x the data sheet's 1.673e13 (132 SMs
x 64 INT32 lanes x 1.98 GHz): the compiler spreads integer work over the
FMA pipe as IMAD and VIADD, so the data sheet's rate is no ceiling.

Work of one env-step of the single-blind sim engine at the configuration's
jokers (sampled actions; no Four Fingers, Shortcut, Misprint or Bloodstone,
so one Threefry hash a step), counted from the algorithm stage by stage: a
C operator, compare, select, table load or conversion counts one. A
Threefry-2x32 hash is 75: 20 rounds of (add, rotate, xor), 5 key injections
of 2 adds, 4 set-up ops and the final xor. The count is the game's, not any
one kernel's way of computing it, and it is loose (the work every env must
do, nothing for spills or the launch).
"""
from __future__ import annotations

from benchmark.harness.yardstick import HBM_BYTES

INT32_OPS = 3.7e13               # int32 source ops/s, K6's measured rate
THREEFRY_OPS = 75

SIM_STEP_OPS = {
    # the draws: one hash, then a uniform legal action from its top 24 bits
    "draws: hash and uniform action": THREEFRY_OPS + 8,
    # hand evaluation of the played or discarded prefix
    "evaluation: decode and the selection": 8,
    "evaluation: of a kind (4 shifted compares of the rank word)": 69,
    "evaluation: flush (two suit candidates)": 31,
    "evaluation: present ranks": 25,
    "evaluation: straight (windows, wheel, scoring cards)": 63,
    "evaluation: hand type and scoring mask": 18,
    # scoring from the joker coefficients
    "scoring: chips (5 rank terms, 4 suit terms)": 105,
    "scoring: mult terms (Half, Queens, Kings, Spade-or-Club)": 39,
    "scoring: exponents and powers": 34,
    "scoring: score product": 5,
    # the step's outcome
    "step: outcome": 14,
    "step: refill from the deck": 13,
    "step: autoreset": 10,
    "step: loop": 3,
}
STEP_OPS = sum(SIM_STEP_OPS.values())        # 520 an env-step

# K4 (fused_rollout_kernel) reads each env's coefficient rows (16 scalars,
# 32 rank, 32 suit and 64 hand-type floats) and writes its final hand (8
# ranks, 8 suits), 8 counters and the reward total.
K4_BYTES = (16 + 32 + 32 + 64) * 4 + (8 + 8 + 8) * 4 + 4    # 676 B an env


def k4_ops(n_envs: int, n_steps: int) -> int:
    """Integer ops of a call: every env-step, and each env's key split."""
    return n_envs * (n_steps * STEP_OPS + THREEFRY_OPS)


def k4_roofline_pct(n_envs: int, n_steps: int, seconds) -> float | None:
    """K4's bound, the larger of its bytes over the HBM rate and its ops
    over :data:`INT32_OPS`, as a share of a measured time, in %; None
    without a time."""
    if not seconds or seconds <= 0:
        return None
    bound = max(n_envs * K4_BYTES / HBM_BYTES, k4_ops(n_envs, n_steps) / INT32_OPS)
    return 100.0 * bound / seconds
