"""Named-stream RNG over the port's Threefry, on batched key words.

Port of ``balatro_gym_tpu/core/rng.py``. An env's randomness is split into
16 named streams: stream key = ``fold_in(master, stream_id)``, draw key =
``fold_in(stream_key, counter)``, and the stream's counter is bumped by one
per draw. Keys are pairs of ``[B]`` int64 tensors of 32-bit words (hi, lo),
as ``ops/kernel_rng.py`` holds them; the counters are a ``[16, B]`` int64
tensor of 32-bit words, one row per stream.
"""
from __future__ import annotations

import torch

from . import kernel_rng as KR

STREAMS = (
    "deck_shuffle", "card_draw", "shop_generation", "shop_reroll",
    "joker_effects", "blind_selection", "skip_rewards", "pack_opening",
    "voucher_appearance", "boss_abilities", "random_events",
    "card_enhancement", "edition_rolls", "seal_applications",
    "consumable_effects", "score_variance",
)
NUM_STREAMS = len(STREAMS)
STREAM_ID = {name: i for i, name in enumerate(STREAMS)}
I32_MIN = -(2 ** 31)


def init_counters(n_envs, device=None):
    """Fresh per-stream draw counters, ``[16, n_envs]``."""
    return torch.zeros(NUM_STREAMS, n_envs, dtype=torch.int64, device=device)


def _sid(stream):
    return STREAM_ID[stream] if isinstance(stream, str) else int(stream)


def stream_key(k1, k2, stream):
    """The key of ``stream`` under the master key (k1, k2)."""
    return KR.fold_in(k1, k2, _sid(stream))


def next_key(k1, k2, counters, stream):
    """The next draw key of ``stream``; returns ((k1, k2), new counters).
    ``counters`` is not modified."""
    sid = _sid(stream)
    key = KR.fold_in(*stream_key(k1, k2, sid), counters[sid])
    counters = counters.clone()
    counters[sid] = (counters[sid] + 1) & 0xFFFFFFFF
    return key, counters


def sort_key_i32(bits, mask):
    """Flip the sign bit of 32-bit draw words so that their unsigned order
    becomes int32 order; masked-out entries become I32_MIN, below any draw.
    ``bits`` holds the words in int64; returns int32."""
    flipped = (bits ^ 0x80000000) & 0xFFFFFFFF
    flipped = (flipped - ((flipped >> 31) << 32)).to(torch.int32)
    return torch.where(mask, flipped, torch.full_like(flipped, I32_MIN))
