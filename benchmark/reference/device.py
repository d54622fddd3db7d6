"""Static numpy tables as device tensors, copied once per device (frozen
copy of the port's ``core/device.py:const``).

A host-to-device copy from pageable memory blocks the host until the device
has drained its stream, so a per-step ``torch.as_tensor(table, device=...)``
would serialise the engine with the card. Every module reads its static
tables through :func:`const` instead.
"""
from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def const(table, dtype, device) -> torch.Tensor:
    """``table`` (a module-level numpy array or list) as a ``dtype`` tensor
    on ``device``; the copy is made on first use and reused after."""
    device = torch.device(device)
    key = (id(table), dtype, device)
    hit = _CACHE.get(key)
    if hit is None:
        hit = (table, torch.as_tensor(np.asarray(table), dtype=dtype, device=device))
        _CACHE[key] = hit
    return hit[1]
