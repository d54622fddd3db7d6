"""Integer-exponent power tables, minted once in numpy float64.

Port of ``balatro_gym_tpu/core/pow_tables.py``. Every x-mult the engines
apply is a power of an exact base with a small integer exponent; taking the
value from a correctly rounded float64 table (instead of a runtime ``pow``)
keeps the product bit-identical on every device. ``pow2/pow3/pow15/pow115`` look
the value up at ``clamp(int(e), 0, len - 1)``, as the reference's one-hot dot
does.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import const

POW2_NP = np.float64(2.0) ** np.arange(64)
POW3_NP = np.float64(3.0) ** np.arange(16)
POW15_NP = np.float64(1.5) ** np.arange(96)
POW08_NP = np.float64(0.8) ** np.arange(12)
POW115_NP = np.float64(1.15) ** np.arange(100)


def _gather(table_np, e, dtype):
    """table[clamp(int(e), 0, len - 1)] in ``dtype``, on ``e``'s device."""
    table = const(table_np, dtype, e.device)
    idx = e.to(torch.int64).clamp(0, len(table_np) - 1)
    return table[idx]


def pow2(e, dtype=torch.float32):
    return _gather(POW2_NP, e, dtype)


def pow3(e, dtype=torch.float32):
    return _gather(POW3_NP, e, dtype)


def pow15(e, dtype=torch.float32):
    return _gather(POW15_NP, e, dtype)


def pow115(e, dtype=torch.float32):
    return _gather(POW115_NP, e, dtype)
