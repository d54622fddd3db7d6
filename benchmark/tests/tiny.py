"""Cells at a size the CPU tests can hold: the manifest's cells with the
traffic merged with their driver's ``TINY`` (fewer envs, steps and
samples); widths, recipe and limits as the manifest has them."""
import copy

import torch

from benchmark.harness import manifest as M

CPU = torch.device("cpu")


def _merge(into: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict):
            _merge(into.setdefault(k, {}), v)
        else:
            into[k] = v


def spec(name: str) -> dict:
    s = copy.deepcopy(M.cell(M.load(), name))
    _merge(s["traffic"], M.driver(s["traffic"]["driver"]).TINY)
    return s


CELLS = [w["name"] for w in M.load()["workloads"]]
# Each cell with each fault that its driver can have.
FAULT_CASES = [(c, f) for c in CELLS for f in M.driver(spec(c)["traffic"]["driver"]).FAULTS]
