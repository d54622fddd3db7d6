"""Integer-ALU ceiling probe of the card (a CUDA kernel) and its plain
PyTorch version.

Port of ``scripts/vpu_ceiling.py``, the TPU's vector-unit probe: every
element of ``x [n_tiles, 8, 8, 128]`` int32 runs ``rounds`` rounds of the
dependent chain ``v += 0x9E3779B9; v ^= v << 13; v = v > 0 ? v : v + 7``
(int32 with wrap-around), the op mix of the env kernels' hashes and
selects. The reference's kernel reads ``x_ref[r]`` of a ``[1, 8, 8, 128]``
block, so each of its 8 rows is the whole block and every element's chain
runs on its own value; its run is ``K / (4 * 8) = 128`` rounds.

* ``alu_chains`` launches ``csrc/alu_ceiling.cu`` on a card (one thread per
  ``(tile, sub, lane)``, its 8 row chains in 8 registers) and counts its
  launches in ``alu_chains.launches``; ``device="cpu"`` runs the plain
  version ``alu_chains_reference``.
* ``measure`` times back-to-back launches with CUDA events and returns the
  rate in the script's unit, 6 source operations a chain-round;
  ``sass_loop`` reads the SASS of the kernel's loop body (``cuobjdump``),
  to say what one round costs in machine instructions.
* ``main`` prints one JSON line: the measured int32 operations per second
  at the reference's shape (64 tiles, 65,536 threads) and at a shape that
  fills every SM's thread slots several times over.

    python -m balatro_gym_tpu_torch.ops.alu_ceiling [--rounds 128] [--reps 200]
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import json
import subprocess

import torch

from balatro_gym_tpu_torch.core.device import check_arg, run_device
from balatro_gym_tpu_torch.ops import cuda_build

ROWS, SUB, LANES = 8, 8, 128
ROUNDS = 4096 // (4 * ROWS)          # the reference's K / (4 * ROWS)
OPS_PER_ROUND = 6                    # add, shift, xor, compare, select, add
REFERENCE_TILES = 64
SATURATING_TILES = 4 * 2 * 132       # 4 x (2,048 threads x 132 SMs) / 1,024 a tile
_M32 = 0xFFFFFFFF
_SOURCE = "alu_ceiling.cu"
_ROUNDS_PER_ITER = 4                 # the kernel's main loop runs 4 rounds an iteration


def alu_chains_reference(x, rounds: int):
    """``rounds`` rounds of the chain on every int32 element of ``x``."""
    v = x.to(torch.int64) & _M32
    for _ in range(rounds):
        v = (v + 0x9E3779B9) & _M32
        v = v ^ ((v << 13) & _M32)
        v = torch.where((v > 0) & (v < 2 ** 31), v, (v + 7) & _M32)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


@functools.cache
def _kernel_lib():
    lib = cuda_build.load(_SOURCE)
    lib.alu_chains_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.alu_chains_launch.restype = ctypes.c_int
    return lib


def alu_chains(x, rounds: int = ROUNDS, *, device=None):
    """The chains of ``x [n_tiles, 8, 8, 128]`` int32: the kernel on a card,
    the plain version with ``device="cpu"``."""
    if x.dim() != 4 or tuple(x.shape[1:]) != (ROWS, SUB, LANES):
        raise ValueError(f"x: want [n_tiles, {ROWS}, {SUB}, {LANES}], got {tuple(x.shape)}")
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    dev = run_device((x,), device)
    x = x.to(dev)
    if dev.type == "cpu":
        return alu_chains_reference(x, rounds)
    if dev.type != "cuda":
        raise ValueError(f"alu_chains: no kernel for device {dev}")
    n_tiles = x.shape[0]
    check_arg(x, "x", torch.int32, (n_tiles, ROWS, SUB, LANES), dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = _kernel_lib().alu_chains_launch(x.data_ptr(), out.data_ptr(), n_tiles, rounds,
                                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alu_chains kernel launch failed: cudaError_t {err}")
    alu_chains.launches += 1
    return out


alu_chains.launches = 0


def source_ops(n_tiles: int, rounds: int) -> int:
    """Source operations of one call, in the reference script's unit."""
    return n_tiles * ROWS * SUB * LANES * rounds * OPS_PER_ROUND


def probe_input(n_tiles: int, device):
    """The probe's input: ``arange`` over ``[n_tiles, 8, 8, 128]`` int32."""
    return torch.arange(n_tiles * ROWS * SUB * LANES, dtype=torch.int32,
                        device=device).view(n_tiles, ROWS, SUB, LANES)


def measure(n_tiles: int, rounds: int = ROUNDS, reps: int = 200, best_of: int = 3,
            device="cuda"):
    """(best seconds a launch, int32 source operations per second) of
    ``reps`` back-to-back launches on :func:`probe_input` between two CUDA
    events, best of ``best_of``, after a warm-up launch."""
    dev = run_device((), device)
    if dev.type != "cuda":
        raise ValueError("measure times the kernel on a card")
    x = probe_input(n_tiles, dev)
    alu_chains(x, rounds)
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(best_of):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            alu_chains(x, rounds)
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) / 1e3 / reps)
    return best, source_ops(n_tiles, rounds) / best


def sass_loop():
    """The SASS of the kernel's main loop (4 rounds of 8 chains an
    iteration), from ``cuobjdump -sass`` of the built library:
    ``{"instructions": n, "per_chain_round": n / 32, "opcodes": {...}}``.
    The loop is the longest backward branch's body, branch included."""
    _kernel_lib()
    ops = cuda_build.sass_loop(cuda_build.build_log[_SOURCE]["path"], "alu_chains_kernel")
    per = _ROUNDS_PER_ITER * ROWS
    return {"instructions": len(ops), "per_chain_round": len(ops) / per,
            "opcodes": dict(collections.Counter(ops).most_common())}


def card_name():
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.splitlines()[0].strip()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="int32 ALU ceiling of the card")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--reps", type=int, default=200)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("alu_ceiling: torch sees no CUDA card")
    rates = {}
    for name, tiles in (("reference_shape", REFERENCE_TILES), ("saturating", SATURATING_TILES)):
        sec, rate = measure(tiles, args.rounds, args.reps)
        rates[name] = {"n_tiles": tiles, "threads": tiles * SUB * LANES,
                       "ms_per_launch": sec * 1e3, "int32_ops_per_s": rate}
    sass = sass_loop()
    out = {"int32_ops_per_s": {k: v["int32_ops_per_s"] for k, v in rates.items()},
           "shapes": rates, "rounds": args.rounds, "reps": args.reps, "best_of": 3,
           "unit": f"one op = one int32 source operation ({OPS_PER_ROUND} a chain-round: add, "
                   "shift, xor, compare, select, add)",
           "sass_loop": sass,
           "sass_per_s": rates["saturating"]["int32_ops_per_s"] / OPS_PER_ROUND
           * sass["per_chain_round"],
           "device": torch.cuda.get_device_name(0), "gpu": card_name()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
