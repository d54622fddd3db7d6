"""Masked hand histograms (a CUDA kernel) and their plain PyTorch version.

Port of ``balatro_gym_tpu/ops/pallas_kernels.py``: per env of a batch, the
rank histogram ``[B, 16]``, the suit histogram ``[B, 8]`` and the chip sum
``[B, 1]`` (rank histogram . ``[RANK_CHIPS, 0]``) of 8 cards under a mask,
float32. Ranks outside [0, 16) and suits outside [0, 8) count in no bin.
The reference keeps this primitive as a kernel template beside the jnp
formulation that its scoring uses.

* ``hand_histograms`` launches ``csrc/hand_histograms.cu`` on a card (one
  thread per env, the block's rows staged in shared memory and stored
  whole) and counts its launches in ``hand_histograms.launches``; with
  ``device="cpu"`` it runs the plain version. ``kernel_shape`` reads the
  kernel's launch shape from the built library.
* ``hand_histograms_reference`` is the plain version, on any device.

Every term is a small integer, so the sums are exact: kernel, plain version
and reference agree bit for bit. As the reference requires, ``B`` is a
multiple of ``TILE_B``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from balatro_gym_tpu_torch.core.cards import RANK_CHIPS
from balatro_gym_tpu_torch.core.device import check_arg, const, run_device
from balatro_gym_tpu_torch.ops import cuda_build

TILE_B = 256
N_CARDS = 8
R_PAD = 16  # ranks 0..14, padded
S_PAD = 8   # suits 0..4, padded
CHIP_TABLE = np.concatenate([RANK_CHIPS.astype(np.float32), np.zeros(1, np.float32)])


def hand_histograms_reference(ranks, suits, mask):
    """(rank_hist ``[B, 16]``, suit_hist ``[B, 8]``, chip_sum ``[B, 1]``),
    float32, of ranks/suits ``[B, 8]`` int and mask ``[B, 8]`` bool."""
    dev = ranks.device
    m = mask.to(torch.float32)[:, :, None]
    rhist = ((ranks[:, :, None] == torch.arange(R_PAD, device=dev)).to(torch.float32) * m).sum(1)
    shist = ((suits[:, :, None] == torch.arange(S_PAD, device=dev)).to(torch.float32) * m).sum(1)
    chips = rhist @ const(CHIP_TABLE, torch.float32, dev)[:, None]
    return rhist, shist, chips


@functools.cache
def _kernel_lib():
    lib = cuda_build.load("hand_histograms.cu")
    lib.hand_histograms_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
    lib.hand_histograms_info.argtypes = [ctypes.c_void_p]
    lib.hand_histograms_launch.restype = lib.hand_histograms_info.restype = ctypes.c_int
    return lib


def kernel_shape():
    """K5's launch shape and what the compiler gave it, on the current card:
    {"block": threads a block, "shared_bytes": shared memory a block,
    "registers": a thread, "stack_bytes": local memory a thread}."""
    out = (ctypes.c_int * 4)()
    err = _kernel_lib().hand_histograms_info(out)
    if err != 0:
        raise RuntimeError(f"hand_histograms_info failed: cudaError_t {err}")
    return dict(zip(("block", "shared_bytes", "registers", "stack_bytes"), out))


def _aligned(t, n_bytes):
    """``t``, or a copy of it where its data does not start on ``n_bytes``:
    the kernel reads a row as vectors of that size."""
    return t if t.data_ptr() % n_bytes == 0 else t.clone()


def hand_histograms(ranks, suits, mask, *, device=None):
    """Masked histograms of ``[B, 8]`` cards: the kernel on a card, the plain
    version with ``device="cpu"``. ``B`` must be a multiple of ``TILE_B``."""
    n = ranks.shape[0]
    if n % TILE_B:
        raise ValueError(f"B={n} must be a multiple of {TILE_B}")
    dev = run_device((ranks, suits, mask), device)
    ranks, suits = (torch.as_tensor(x).to(device=dev, dtype=torch.int32).contiguous()
                    for x in (ranks, suits))
    mask = torch.as_tensor(mask).to(device=dev, dtype=torch.bool).contiguous()
    if dev.type == "cpu":
        return hand_histograms_reference(ranks, suits, mask)
    if dev.type != "cuda":
        raise ValueError(f"hand_histograms: no kernel for device {dev}")
    for name, t, dt in (("ranks", ranks, torch.int32), ("suits", suits, torch.int32),
                        ("mask", mask, torch.bool)):
        check_arg(t, name, dt, (n, N_CARDS), dev)
    ranks, suits, mask = _aligned(ranks, 16), _aligned(suits, 16), _aligned(mask, 8)
    rhist = torch.empty(n, R_PAD, device=dev)
    shist = torch.empty(n, S_PAD, device=dev)
    chips = torch.empty(n, 1, device=dev)
    with torch.cuda.device(dev):
        err = _kernel_lib().hand_histograms_launch(
            ranks.data_ptr(), suits.data_ptr(), mask.data_ptr(),
            const(CHIP_TABLE, torch.float32, dev).data_ptr(), rhist.data_ptr(),
            shist.data_ptr(), chips.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hand_histograms kernel launch failed: cudaError_t {err}")
    hand_histograms.launches += 1
    return rhist, shist, chips


hand_histograms.launches = 0
