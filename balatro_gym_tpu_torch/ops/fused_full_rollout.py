"""Whole-rollout kernel of the flagship full-game env (CUDA) and its plain
PyTorch version.

Port of ``balatro_gym_tpu/ops/fused_full_rollout.py``. One call runs an
n-step rollout of the Discrete(60) flagship env for every env: play with
scoring, discard, card selection, 40 consumables, shop buy/reroll/sell/end,
blind selection and the 20 acting bosses, with autoreset. State goes in and
out packed as the TPU kernel packs it: ``cards`` ``[6, 64, B]`` int32 (rank,
suit, enhancement, edition, seal, alive per deck slot), ``ints`` ``[132, B]``
int32 (row map below) and ``rng`` ``[18, B]`` (key hi, key lo, 16 stream
counters; 32-bit words held as int32 bit patterns). Arithmetic is the
x64-off production configuration: int32 state, float32 transients in the
reference's op order.

* ``rollout_full_fused`` is the entry point. It runs on the card unless
  called with ``device="cpu"``, where it runs the plain version; on a card
  it launches ``csrc/fused_full_rollout.cu`` (built with nvcc on first use)
  or raises. It counts its launches in
  ``rollout_full_fused.launches``. A call is the span ``rollout.call``
  (``utils/profiling.py``), holding ``rollout.reset`` (the default reset),
  ``rollout.pack``, ``rollout.launch`` (the kernel's enqueue, or the plain
  version) and ``rollout.unpack``. :func:`pack_full_state` and
  :func:`unpack_full_state` open ``pack.scalars``, ``unpack.rows`` and
  ``unpack.scalars`` for their later parts, so that no span holds more
  host ops than a profile's gap labeller looks back over (256).
* ``rollout_full_rows_reference`` is the plain version: batched tensor ops
  over ``[rows, B]`` tensors, branch-free as the TPU program is (every
  branch is computed for every env and merged with ``torch.where``), on any
  device. It mirrors ``_load_state -> _step -> _store_rows`` of the
  reference, so it is held bit for bit against ``rollout_full_rows`` there
  (tests/test_torch_full_rollout.py) and against the kernel here.

Randomness. Every game draw uses the engine's named streams: draw key =
``fold_in(fold_in(key, stream_id), counter)`` with the stream's counter
bumped per draw, exactly as the reference's fed mode. Fed mode takes
``actions`` ``[n_steps, B]``. Sampled mode (``actions=None``) draws the
action uniformly over the legal set, and only the action, from Threefry:
env ``e`` at step ``t`` of the call takes ``u = random_bits32(
split_child(seed_key(seed), e), t)`` and maps it through the TPU kernel's
legal ladder (``_sample_action``). The TPU kernel's sampled mode takes its
draws from the TPU's hardware generator, which no other device reproduces;
here both modes share one RNG path, so kernel and plain version agree bit
for bit in both.

Autoreset shuffles the deck as the TPU kernel does: 52 priority words
``random_bits32(fold_in(fold_in(fold_in(key, step_count), 0), 0), c)``,
payload ``(prio & ~63) | (suit << 4 | rank - 2)``, sorted ascending; only
the engine's own reset uses ``jax.random.permutation`` (``engine.full_env``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from balatro_gym_tpu_torch.core import cards as C
from balatro_gym_tpu_torch.core import pow_tables as PWT
from balatro_gym_tpu_torch.core import rng as R
from balatro_gym_tpu_torch.core.constants import (
    BASE_HAND_CHIPS, BASE_HAND_MULT, PLANET_HAND, Action, HandType, Phase, _blind_chips)
from balatro_gym_tpu_torch.core.device import check_arg, const, run_device
from balatro_gym_tpu_torch.engine import consumable_logic as CL
from balatro_gym_tpu_torch.engine import full_env as FE
from balatro_gym_tpu_torch.engine import shop_logic as SL
from balatro_gym_tpu_torch.ops import boss as B
from balatro_gym_tpu_torch.ops import cuda_build
from balatro_gym_tpu_torch.ops import joker_tables as JT
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.utils import profiling as P

N_DECK = 64
N_HAND = 8    # hand positions the step touches; packed rows 8-9 stay -1
N_JOK = 5
N_CONS = 5
N_SHOP = 10
N_LVL = 12
N_CTR = 16

# cards pack [6, 64, B] channel order:
CH_RANK, CH_SUIT, CH_ENH, CH_ED, CH_SEAL, CH_ALIVE = range(6)

# ints pack [NI, B] rows:
R_HIDX = 0              # 10 rows (hand_idx; rows 8-9 always -1)
R_SEL = 10              # 8
R_FD = 18               # 8
R_JOK = 26              # 5
R_CONS = 31             # 5
R_STY = 36              # 10
R_SIT = 46              # 10
R_SCO = 56              # 10
R_LVL = 66              # 12
R_PC = 78               # 12
S_HN, S_JN, S_GREEN, S_BUS, S_CN, S_VOU, S_JSLOTS, S_CSLOTS = range(90, 98)
S_ANTE, S_ROUND, S_PHASE, S_NEED, S_CAREER, S_RCHIPS, S_BEST = range(98, 105)
S_MONEY, S_HL, S_DL, S_HSIZE, S_SN, S_RBASE, S_RCOST = range(105, 112)
S_BACT, S_BID, S_BTYPES, S_BFIRST, S_BVERD, S_BPLO, S_BPHI = range(112, 119)
S_HPT, S_HPA, S_JSOLD, S_DONE, S_STEPC = range(119, 124)
R_HIGH = 124            # 8 rows: highlighted mask
NI = 132
NR = 2 + N_CTR          # rng pack rows: key hi, key lo, 16 counters

_I32, _I64, _F32 = torch.int32, torch.int64, torch.float32
_M32 = 0xFFFFFFFF
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1

# Scalar state rows, by the names the step uses.
_SCALARS = (("hn", S_HN), ("jn", S_JN), ("green", S_GREEN), ("bus", S_BUS),
            ("cn", S_CN), ("vou", S_VOU), ("jslots", S_JSLOTS), ("cslots", S_CSLOTS),
            ("ante", S_ANTE), ("round", S_ROUND), ("phase", S_PHASE),
            ("need", S_NEED), ("career", S_CAREER), ("rchips", S_RCHIPS),
            ("best", S_BEST), ("money", S_MONEY), ("hl", S_HL), ("dl", S_DL),
            ("hsize", S_HSIZE), ("sn", S_SN), ("rbase", S_RBASE), ("rcost", S_RCOST),
            ("bid", S_BID), ("btypes", S_BTYPES), ("bverd", S_BVERD), ("hpt", S_HPT),
            ("hpa", S_HPA), ("jsold", S_JSOLD), ("sc", S_STEPC))
_BOOL_SCALARS = (("bact", S_BACT), ("bfirst", S_BFIRST), ("done", S_DONE))
_ROW_BLOCKS = (("jok", R_JOK, N_JOK), ("cons", R_CONS, N_CONS), ("sty", R_STY, N_SHOP),
               ("sit", R_SIT, N_SHOP), ("sco", R_SCO, N_SHOP), ("lvl", R_LVL, N_LVL),
               ("pc", R_PC, N_LVL))
_DECK_CH = ("rk", "su", "en", "edt", "slc")      # cards channels 0-4
_HAND_CH = ("hrk", "hsu", "hen", "hed", "hsl")   # the same, per hand position

# Joker ids whose counts the step reads (reward synergy, discard money).
_CNT_IDS = sorted({JT.J_FOUR_FINGERS, JT.J_SHORTCUT, JT.J_TRADING_CARD,
                   JT.J_FACELESS, 130, 82, JT.J_LUCHADOR, 113, 42,
                   JT.J_ODD_TODD, JT.J_EVEN_STEVEN, JT.J_JOLLY, JT.J_ZANY,
                   JT.J_SCARY_FACE, JT.J_SMILEY_FACE})

# Static tables, as the step reads them.
_P15_F32 = PWT.POW15_NP.astype(np.float32)
_P08_F32 = PWT.POW08_NP.astype(np.float32)
_P115_F32 = PWT.POW115_NP.astype(np.float32)
_HQ_F32 = FE.HAND_QUALITY.astype(np.float32)
_SELL_VALUE = np.maximum(3, JT.JOKER_BASE_COST_NP // 2).astype(np.int32)
_SELL_VALUE[0] = 3
_ELIGIBLE = np.nonzero(JT.JOKER_BASE_COST_NP > 0)[0]
# Shop joker priority payload: base_cost << 8 | (255 - id).
_JPAYLOAD = ((JT.JOKER_BASE_COST_NP.astype(np.int64) << 8)
             | (255 - np.arange(JT.NUM_JOKERS)))[_ELIGIBLE]


def _f(x):
    """A python float constant rounded to float32, as the reference's
    weakly typed constants are."""
    return float(np.float32(x))


_LOG10_F32 = _f(np.log(10.0))
_FTAB = np.concatenate([_P15_F32, _P08_F32, _P115_F32, _HQ_F32, [_LOG10_F32]]).astype(np.float32)


# ---------------------------------------------------------------------------
# Word and conversion helpers
# ---------------------------------------------------------------------------


def _i2w(x):
    """int32 bit patterns -> int64 32-bit words."""
    return x.to(_I64) & _M32


def _w2i(x):
    """int64 32-bit words -> int32 bit patterns."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(_I32)


def _sortable(u):
    """32-bit word -> int32 with the same order as the unsigned word (sign
    bit flipped), as the reference orders its priority words."""
    return (u - 2 ** 31).to(_I32)


def _f2i(x):
    """float32 -> int32 as XLA converts: truncate toward zero, saturate,
    NaN -> 0 (a plain cast of an out-of-range float is undefined)."""
    t = torch.where(torch.isnan(x), 0.0, x).clamp(-2147483648.0, 2147483520.0)
    return torch.where(x >= 2147483648.0, I32_MAX, t.to(_I32)).to(_I32)


def _fl(x):
    """The reference's ``_trunc``: floor, then the saturating convert."""
    return _f2i(torch.floor(x))


def _div(a, b):
    """float32 ``a / b`` by IEEE division. A torch divisor that is a python
    number makes CUDA multiply by its reciprocal, so it becomes a tensor."""
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b


def _check(ok, what):
    """Invariant of the reference's encoding; the kernel clamps instead."""
    if not bool(ok.all()):
        raise AssertionError(f"fused_full_rollout invariant violated: {what}")


# ---------------------------------------------------------------------------
# Host-side pack / unpack
# ---------------------------------------------------------------------------


def pack_full_state(st: FE.FullEnvState):
    """FullEnvState -> dict(cards [6, 64, B] i32, ints [NI, B] i32, rng
    [NR, B] i32 bit patterns of 32-bit words)."""
    dev, B_ = st.ante.device, st.ante.shape[0]
    cards = torch.stack([st.card_rank.T, st.card_suit.T, st.card_enh.T, st.card_ed.T,
                         st.card_seal.T, st.card_alive.T]).to(_I32)
    ints = torch.zeros(NI, B_, dtype=_I32, device=dev)
    ints[R_HIDX:R_HIDX + 10] = st.hand_idx.T
    ints[R_SEL:R_SEL + 8] = st.selected.T
    ints[R_FD:R_FD + 8] = st.face_down.T
    ints[R_HIGH:R_HIGH + 8] = st.highlighted.T
    for field, row, n in (("jokers", R_JOK, N_JOK), ("cons", R_CONS, N_CONS),
                          ("shop_type", R_STY, N_SHOP), ("shop_item", R_SIT, N_SHOP),
                          ("shop_cost", R_SCO, N_SHOP), ("hand_levels", R_LVL, N_LVL),
                          ("hand_play_counts", R_PC, N_LVL)):
        ints[row:row + n] = getattr(st, field).T
    with P.span("pack.scalars"):
        return {"cards": cards, "ints": _pack_scalars(st, ints), "rng": _w2i(
            torch.cat([st.key.T, st.rng_counters.T]))}


def _pack_scalars(st: FE.FullEnvState, ints):
    """``ints`` with the state's per-env scalar rows written."""
    dev = ints.device
    weights = torch.tensor(1, dtype=_I64, device=dev) << torch.arange(32, device=dev)
    bp = st.boss_played_slots.to(_I64)
    for row, val in (
            (S_HN, st.hand_n), (S_JN, st.joker_n), (S_GREEN, st.green_mult),
            (S_BUS, st.bus_mult), (S_CN, st.cons_n), (S_VOU, st.vouchers),
            (S_JSLOTS, st.joker_slots), (S_CSLOTS, st.cons_slots),
            (S_ANTE, st.ante), (S_ROUND, st.round), (S_PHASE, st.phase),
            (S_NEED, st.chips_needed), (S_CAREER, st.chips_scored),
            (S_RCHIPS, st.round_chips_scored), (S_BEST, st.best_hand_this_ante),
            (S_MONEY, st.money), (S_HL, st.hands_left), (S_DL, st.discards_left),
            (S_HSIZE, st.hand_size), (S_SN, st.shop_n), (S_RBASE, st.reroll_base),
            (S_RCOST, st.shop_reroll_cost), (S_BACT, st.boss_active),
            (S_BID, st.boss_id), (S_BTYPES, st.boss_played_types),
            (S_BFIRST, st.boss_first_hand), (S_BVERD, st.boss_verdant_req),
            (S_BPLO, _w2i((bp[:, :32] * weights).sum(1))),
            (S_BPHI, _w2i((bp[:, 32:] * weights).sum(1))),
            (S_HPT, st.hands_played_total), (S_HPA, st.hands_played_ante),
            (S_JSOLD, st.jokers_sold), (S_DONE, st.done), (S_STEPC, st.step_count)):
        ints[row] = val
    return ints


def unpack_full_state(packed) -> FE.FullEnvState:
    """Inverse of :func:`pack_full_state`."""
    cards, ints, rng = packed["cards"], packed["ints"], packed["rng"]
    dev = ints.device

    def rows(base, n):
        return ints[base:base + n].T.contiguous()

    bits = torch.arange(32, device=dev)
    bp = torch.cat([(_i2w(ints[S_BPLO])[:, None] >> bits) & 1,
                    (_i2w(ints[S_BPHI])[:, None] >> bits) & 1], 1).bool()
    ch = [cards[c].T.contiguous() for c in range(6)]
    with P.span("unpack.rows"):
        wide = dict(
            hand_idx=rows(R_HIDX, 10), selected=rows(R_SEL, 8).bool(),
            face_down=rows(R_FD, 8).bool(), highlighted=rows(R_HIGH, 8).bool(),
            jokers=rows(R_JOK, 5), cons=rows(R_CONS, 5),
            hand_levels=rows(R_LVL, 12), hand_play_counts=rows(R_PC, 12),
            shop_type=rows(R_STY, 10), shop_item=rows(R_SIT, 10), shop_cost=rows(R_SCO, 10),
            key=_i2w(rng[:2]).T.contiguous(), rng_counters=_i2w(rng[2:]).T.contiguous())
    with P.span("unpack.scalars"):
        return FE.FullEnvState(
            card_rank=ch[CH_RANK], card_suit=ch[CH_SUIT], card_enh=ch[CH_ENH],
            card_ed=ch[CH_ED], card_seal=ch[CH_SEAL], card_alive=ch[CH_ALIVE].bool(),
            boss_played_slots=bp, **wide, **{f: ints[row].clone() for f, row in _SCALAR_ROWS},
            **{f: ints[row].bool() for f, row in _BOOL_ROWS})


# The per-env scalar fields of a FullEnvState and their rows in ``ints``.
_SCALAR_ROWS = (
    ("hand_n", S_HN), ("joker_n", S_JN), ("green_mult", S_GREEN), ("bus_mult", S_BUS),
    ("cons_n", S_CN), ("vouchers", S_VOU), ("joker_slots", S_JSLOTS),
    ("cons_slots", S_CSLOTS), ("ante", S_ANTE), ("round", S_ROUND), ("phase", S_PHASE),
    ("chips_needed", S_NEED), ("chips_scored", S_CAREER), ("round_chips_scored", S_RCHIPS),
    ("money", S_MONEY), ("hands_left", S_HL), ("discards_left", S_DL),
    ("hand_size", S_HSIZE), ("shop_n", S_SN), ("reroll_base", S_RBASE),
    ("shop_reroll_cost", S_RCOST), ("boss_id", S_BID), ("boss_played_types", S_BTYPES),
    ("boss_verdant_req", S_BVERD), ("hands_played_total", S_HPT),
    ("hands_played_ante", S_HPA), ("best_hand_this_ante", S_BEST),
    ("jokers_sold", S_JSOLD), ("step_count", S_STEPC))
_BOOL_ROWS = (("boss_active", S_BACT), ("boss_first_hand", S_BFIRST), ("done", S_DONE))


def state_from_packed(cards, ints, rng, device=None) -> FE.FullEnvState:
    """A state from the reference's packed numpy arrays (``cards`` [6, 64, B]
    int32, ``ints`` [NI, B] int32, ``rng`` [NR, B] uint32)."""
    return unpack_full_state({
        "cards": torch.as_tensor(np.asarray(cards, np.int32), device=device),
        "ints": torch.as_tensor(np.asarray(ints, np.int32), device=device),
        "rng": torch.as_tensor(np.asarray(rng).astype(np.uint32).view(np.int32),
                               device=device)})


def states_equal(a: FE.FullEnvState, b: FE.FullEnvState):
    """Names of the fields in which two states differ (empty if none)."""
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


# ---------------------------------------------------------------------------
# Plain version: packed rows <-> step state
# ---------------------------------------------------------------------------
#
# The step state is a dict of tensors: deck channels ``rk su en edt slc``
# [64, B] i32 and ``al`` [64, B] bool; hand positions ``hidx`` and the hand
# channels ``hrk hsu hen hed hsl`` [8, B] i32, ``sel fd high`` [8, B] bool;
# row blocks ``jok cons sty sit sco lvl pc``; [B] scalars; the boss-played
# and in-hand slot sets ``bp``/``ih`` [64, B] bool (bitsets in the kernel);
# key words ``k1 k2`` [B] and counters ``ctr`` [16, B] as int64 words.


def _slot_set(hidx, gate):
    """[64, B] bool: the deck slots ``clamp(hidx[p], 0, 63)`` of positions p
    with ``gate[p] & hidx[p] >= 0``."""
    ok = gate & (hidx >= 0)
    d = torch.arange(N_DECK, device=hidx.device)[:, None, None]
    return ((hidx.clamp(0, N_DECK - 1)[None] == d) & ok[None]).any(1)


def _positions(s):
    return torch.arange(N_HAND, device=s["hn"].device)[:, None]


def _load(packed):
    cards, ints, rng = packed["cards"], packed["ints"], packed["rng"]
    s = {name: cards[c].clone() for c, name in enumerate(_DECK_CH)}
    s["al"] = cards[CH_ALIVE] != 0
    s["hidx"] = ints[R_HIDX:R_HIDX + N_HAND].clone()
    s["sel"] = ints[R_SEL:R_SEL + N_HAND] != 0
    s["fd"] = ints[R_FD:R_FD + N_HAND] != 0
    s["high"] = ints[R_HIGH:R_HIGH + N_HAND] != 0
    for name, row, n in _ROW_BLOCKS:
        s[name] = ints[row:row + n].clone()
    for name, row in _SCALARS:
        s[name] = ints[row].clone()
    for name, row in _BOOL_SCALARS:
        s[name] = ints[row] != 0
    bits = torch.arange(32, device=ints.device)[:, None]
    s["bp"] = torch.cat([(_i2w(ints[S_BPLO]) >> bits) & 1,
                         (_i2w(ints[S_BPHI]) >> bits) & 1]).bool()
    words = _i2w(rng)
    s["k1"], s["k2"], s["ctr"] = words[0], words[1], words[2:]
    # Hand channels materialised from the deck channels (once per call).
    held = (_positions(s) < s["hn"]) & (s["hidx"] >= 0)
    idx = s["hidx"].clamp(0, N_DECK - 1).long()
    for h, d in zip(_HAND_CH, _DECK_CH):
        s[h] = torch.where(held & (s["hidx"] < N_DECK), s[d].gather(0, idx), 0)
    s["ih"] = _slot_set(s["hidx"], _positions(s) < s["hn"])
    return s


def _store(s):
    dev, B_ = s["hn"].device, s["hn"].shape[0]
    cards = torch.stack([s[c] for c in _DECK_CH] + [s["al"].to(_I32)])
    ints = torch.zeros(NI, B_, dtype=_I32, device=dev)
    ints[R_HIDX:R_HIDX + N_HAND] = s["hidx"]
    ints[R_HIDX + N_HAND:R_HIDX + 10] = -1
    ints[R_SEL:R_SEL + N_HAND] = s["sel"]
    ints[R_FD:R_FD + N_HAND] = s["fd"]
    ints[R_HIGH:R_HIGH + N_HAND] = s["high"]
    for name, row, n in _ROW_BLOCKS:
        ints[row:row + n] = s[name]
    for name, row in _SCALARS + _BOOL_SCALARS:
        ints[row] = s[name]
    w = torch.tensor(1, dtype=_I64, device=dev) << torch.arange(32, device=dev)[:, None]
    bp = s["bp"].to(_I64)
    ints[S_BPLO] = _w2i((bp[:32] * w).sum(0))
    ints[S_BPHI] = _w2i((bp[32:] * w).sum(0))
    rng = _w2i(torch.cat([s["k1"][None], s["k2"][None], s["ctr"]]))
    return {"cards": cards, "ints": ints, "rng": rng}


def _merge(p, upd, base):
    """``base`` with the fields of ``upd`` taken where ``p`` ([B] bool)."""
    out = dict(base)
    for k, v in upd.items():
        out[k] = torch.where(p, v, base[k])
    return out


def _stream(s, name, ctr=None):
    """Next key of stream ``name``; returns ((k1, k2), new counters)."""
    return R.next_key(s["k1"], s["k2"], s["ctr"] if ctr is None else ctr, name)


# ---------------------------------------------------------------------------
# Hand plumbing
# ---------------------------------------------------------------------------


def _remove_positions(s, rem):
    """Stable removal of hand positions ``rem`` ([8, B] bool); returns the
    update of the hand rows, ``hn`` and ``ih``."""
    p = _positions(s)
    keep = (p < s["hn"]) & ~rem
    cum = keep.to(_I32).cumsum(0, dtype=_I32)
    pk = (s["hrk"] | (s["hsu"] << 4) | (s["hen"] << 8) | (s["hed"] << 12)
          | (s["hsl"] << 16) | (s["hidx"].clamp(min=0) << 20))
    route = torch.where(keep, cum - 1, -1)
    hit = route[None] == p[:, :, None]                          # [q, p, B]
    acc = torch.where(hit.any(1), torch.where(hit, pk[None], 0).sum(1, dtype=_I32), -1)
    got = acc >= 0
    upd = {"hidx": torch.where(got, acc >> 20, -1), "hn": cum[-1]}
    for i, h in enumerate(_HAND_CH):
        upd[h] = torch.where(got, (acc >> (4 * i)) & 15, 0)
    upd["ih"] = s["ih"] & ~_slot_set(s["hidx"], rem & (p < s["hn"]))
    return upd


def _draw_pass(s, do):
    """Top up the hand with the lowest available deck slots where ``do``."""
    need = (s["hsize"] - s["hn"]).clamp(0, N_HAND) * do.to(_I32)
    avail = s["al"] & ~s["ih"]
    cum = avail.to(_I32).cumsum(0, dtype=_I32)
    chosen = avail & (cum <= need)
    d = torch.arange(N_DECK, device=avail.device, dtype=_I32)[:, None]
    pk = (s["rk"] | (s["su"] << 4) | (s["en"] << 8) | (s["edt"] << 12)
          | (s["slc"] << 16) | (d << 20))
    route = torch.where(chosen, s["hn"] + cum - 1, -1)
    hit = route[None] == _positions(s)[:, :, None]              # [p, d, B]
    acc = torch.where(hit.any(1), torch.where(hit, pk[None], 0).sum(1, dtype=_I32), -1)
    drawn = acc >= 0
    upd = {"hidx": torch.where(drawn, acc >> 20, s["hidx"]),
           "hn": s["hn"] + chosen.sum(0, dtype=_I32), "ih": s["ih"] | chosen}
    for i, h in enumerate(_HAND_CH):
        upd[h] = torch.where(drawn, (acc >> (4 * i)) & 15, s[h])
    return upd


def _first_k(sel, k):
    return sel & (sel.to(_I32).cumsum(0, dtype=_I32) <= k)


def _count(s, j):
    return (s["jok"] == j).sum(0, dtype=_I32)


def _gather_rows(rows, idx):
    """rows[idx[b], b] for in-range idx."""
    return rows.gather(0, idx.long()[None])[0]


# ---------------------------------------------------------------------------
# Legality and sampling
# ---------------------------------------------------------------------------


def _legal_rows(s):
    """[60, B] bool: the engine's action mask."""
    dev = s["hn"].device
    a = torch.arange(Action.ACTION_SPACE_SIZE, device=dev)[:, None]
    in_play = s["phase"] == int(Phase.PLAY)
    in_shop = s["phase"] == int(Phase.SHOP)
    in_blind = s["phase"] == int(Phase.BLIND_SELECT)
    any_sel = s["sel"].any(0)
    n_selectable = s["hn"].clamp(max=N_HAND)
    buy = (a >= 20) & (a < 30)
    cost_a = s["sco"].gather(0, (a - 20).clamp(0, N_SHOP - 1).expand(-1, s["hn"].shape[0]))
    legal = in_play & (a == Action.PLAY_HAND) & any_sel
    legal |= in_play & (a == Action.DISCARD) & any_sel & (s["dl"] > 0)
    legal |= in_play & (a >= 2) & (a < 10) & ((a - 2) < n_selectable)
    legal |= in_play & (a >= 10) & (a < 15) & ((a - 10) < s["cn"])
    legal |= in_shop & buy & ((a - 20) < s["sn"]) & (s["money"] >= cost_a)
    legal |= in_shop & (a == 30) & (s["money"] >= s["rcost"])
    legal |= in_shop & (a == 31)
    legal |= in_shop & (a >= 32) & (a < 37) & ((a - 32) < s["jn"])
    legal |= in_blind & (a >= 45) & (a < 49)
    return legal & ~s["done"]


def legal_mask(state: FE.FullEnvState):
    """``[B, 60]`` bool legal-action mask of a state (the engine's
    ``action_mask``, as the rollout reads it)."""
    return _legal_rows(_load(pack_full_state(state))).T.contiguous()


def _sample_action(s, bits):
    """Uniform over the legal set from 32 random bits per env (int64
    words): ``t = min(int(u * T), T - 1)`` with ``u = (bits >> 8) * 2**-24``
    and T the number of legal actions, mapped through the legal ladder."""
    any_sel = s["sel"].any(0)
    cp = any_sel.to(_I32)
    cd = (any_sel & (s["dl"] > 0)).to(_I32)
    ns = s["hn"].clamp(max=N_HAND)
    play_t = cp + cd + ns + s["cn"]
    r = torch.arange(N_SHOP, device=bits.device)[:, None]
    afford = (r < s["sn"]) & (s["money"] >= s["sco"])
    nb = afford.sum(0, dtype=_I32)
    rr = (s["money"] >= s["rcost"]).to(_I32)
    shop_t = nb + rr + 1 + s["jn"]
    in_play = s["phase"] == int(Phase.PLAY)
    in_shop = s["phase"] == int(Phase.SHOP)
    in_blind = s["phase"] == int(Phase.BLIND_SELECT)
    T = torch.where(in_play, play_t, torch.where(in_shop, shop_t, torch.where(in_blind, 4, 0)))
    u = (bits >> 8).to(_F32) * 2.0 ** -24
    t = torch.minimum(_f2i(u * T.to(_F32)), T - 1)
    a_play = torch.where(t < cp, Action.PLAY_HAND, torch.where(
        t < cp + cd, Action.DISCARD, torch.where(
            t < cp + cd + ns, 2 + (t - cp - cd), 10 + (t - cp - cd - ns))))
    before = afford.to(_I32).cumsum(0, dtype=_I32) - afford.to(_I32)
    a_buy = torch.where(afford & (before == t), 20 + r, 0).max(0).values.to(_I32)
    a_shop = torch.where(t < nb, a_buy, torch.where(
        t < nb + rr, Action.SHOP_REROLL, torch.where(
            t < nb + rr + 1, Action.SHOP_END, 32 + (t - nb - rr - 1))))
    a_blind = torch.where(t < 3, 45 + t, Action.SKIP_BLIND)
    a = torch.where(in_play, a_play, torch.where(in_shop, a_shop,
                                                 torch.where(in_blind, a_blind, 59)))
    return torch.where(T > 0, a, 59).to(_I32)


# ---------------------------------------------------------------------------
# Play and discard branches
# ---------------------------------------------------------------------------


def _tab(table, idx, dtype=_I32):
    """table[idx] on idx's device (idx in range)."""
    return const(table, dtype, idx.device)[idx.long()]


def _classify(s, sel):
    """Hand type of the union of the played selection and the stale
    highlights, read from DECK slots 0-7 (the reference classifies
    ``game.deck[i] for i in highlighted_indexes``)."""
    uni = s["high"] | sel
    crk, csu = s["rk"][:N_HAND], s["su"][:N_HAND]
    _check(((crk >= 2) & (crk <= 14)) | ~uni, "rank outside [2, 14] in deck slots 0-7")
    n_union = uni.sum(0, dtype=_I32)
    r = torch.arange(2, 15, device=crk.device, dtype=_I32)[:, None, None]
    rc = ((crk[None] == r) & uni[None]).sum(1, dtype=_I32)          # [13, B]
    top2 = rc.topk(2, dim=0).values
    max_c, max2 = top2[0], top2[1]
    su = torch.arange(4, device=crk.device, dtype=_I32)[:, None, None]
    sc = (((csu & 7)[None] == su) & uni[None]).sum(1, dtype=_I32)
    n_suits = (sc > 0).sum(0, dtype=_I32)
    is_flush = (n_suits == 1) & (n_union >= 5)
    pr = rc > 0
    n_distinct = pr.sum(0, dtype=_I32)
    any_win = torch.stack([pr[r0:r0 + 5].all(0) for r0 in range(9)]).any(0)
    ace_low = pr[12] & pr[0] & pr[1] & pr[2] & pr[3]
    is_straight = (n_distinct >= 5) & (any_win | ace_low)
    HT = HandType
    five = n_union >= 5
    ht = torch.full_like(n_union, int(HT.HIGH_CARD))
    ht = torch.where(max_c == 2, int(HT.ONE_PAIR), ht)
    ht = torch.where((max_c == 2) & (max2 == 2), int(HT.TWO_PAIR), ht)
    ht = torch.where(max_c == 3, int(HT.THREE_KIND), ht)
    ht = torch.where(is_straight & five, int(HT.STRAIGHT), ht)
    ht = torch.where(is_flush & five, int(HT.FLUSH), ht)
    ht = torch.where((max_c == 3) & (max2 == 2), int(HT.FULL_HOUSE), ht)
    ht = torch.where(max_c == 4, int(HT.FOUR_KIND), ht)
    ht = torch.where(is_straight & is_flush & five, int(HT.STRAIGHT_FLUSH), ht)
    return ht.to(_I32), uni


def _play_branch(s, view):
    """The play action up to the round advance. Returns (update, reward,
    beat, fail, boss_ok, k_boss)."""
    ranks, suits, enh, ed, seal, present = view
    k_eff, ctr = _stream(s, "card_enhancement")
    _, ctr = _stream(s, "joker_effects", ctr)        # drawn, never consumed
    k_boss, ctr = _stream(s, "boss_abilities", ctr)

    sel = s["sel"] & present
    n_played = sel.sum(0, dtype=_I32)
    ht, uni = _classify(s, sel)
    level = _gather_rows(s["lvl"], ht).clamp(max=15)
    base_c0 = _tab(BASE_HAND_CHIPS, ht) + (level - 1) * 10
    base_m0 = _tab(BASE_HAND_MULT, ht) + (level - 1)
    rv = ranks.clamp(max=10) + (ranks == 14).to(_I32)
    ev = torch.where(enh == int(C.Enhancement.BONUS), 30,
                     torch.where(enh == int(C.Enhancement.STONE), 50, 0))
    dv = torch.where(ed == int(C.Edition.FOIL), 50, 0)
    chips = base_c0 + torch.where(sel, rv + ev + dv, 0).sum(0, dtype=_I32)
    base_score = _fl(chips.to(_F32) * base_m0.to(_F32))

    # boss play restriction
    ht_bit = (s["btypes"] >> ht) & 1
    bid = s["bid"]
    boss_ok = ~s["bact"] | (((bid != B.PSYCHIC) | (n_played == 5))
                            & ((bid != B.EYE) | (ht_bit == 0))
                            & ((bid != B.MOUTH) | (s["btypes"] == 0) | (ht_bit == 1))
                            & ((bid != B.VERDANT) | (n_played >= s["bverd"])))

    # Lucky $20 rolls, gold seals, blue-seal planets
    p = _positions(s)
    pk1, pk2 = KR.fold_in(k_eff[0][None], k_eff[1][None], p)
    roll = KR.uniform_f32(KR.random_bits32(pk1, pk2, 2))
    lucky = sel & (enh == int(C.Enhancement.LUCKY)) & (roll < _f(C.LUCKY_MONEY_P))
    extra_money = (torch.where(lucky, 20, 0).sum(0, dtype=_I32)
                   + torch.where(sel & (seal == int(C.Seal.GOLD)), 3, 0).sum(0, dtype=_I32))
    n_blue = (sel & (seal == int(C.Seal.BLUE))).sum(0, dtype=_I32)
    n_red = (sel & (seal == int(C.Seal.RED))).sum(0, dtype=_I32)
    planet_id = _tab(FE.PLANET_OBS_OF_HAND, ht)
    n_create = torch.minimum(n_blue, (s["cslots"] - s["cn"]).clamp(0, N_CONS))
    c5 = torch.arange(N_CONS, device=ht.device)[:, None]
    new_cons = torch.where((c5 >= s["cn"]) & (c5 < s["cn"] + n_create), planet_id, s["cons"])

    # steel held in hand x1.5 per card
    n_steel = (present & ~sel & (enh == int(C.Enhancement.STEEL))).sum(0, dtype=_I32)
    final = _fl(base_score.to(_F32) * _tab(_P15_F32, n_steel.clamp(0, 95), _F32))

    # boss scoring ratio
    c, m = base_c0, base_m0
    c = torch.where(bid == B.FLINT, c // 2, c)
    m = torch.where(bid == B.FLINT, m // 2, m)
    c = torch.where(bid == B.OXIDE, 0, c)
    c = torch.where(bid == B.ARM, _fl(c.to(_F32) * 0.75), c)
    m = torch.where(bid == B.ARM, _fl(m.to(_F32) * 0.75), m)
    face = sel & (ranks >= 11) & (ranks <= 13)
    pillar = sel & s["bp"].gather(0, s["hidx"].clamp(0, N_DECK - 1).long())
    nd = torch.where(bid == B.PLANT, face.sum(0, dtype=_I32),
                     torch.where(bid == B.VIOLET, n_played,
                                 torch.where(bid == B.PILLAR, pillar.sum(0, dtype=_I32), 0)))
    pen = _tab(_P08_F32, nd.clamp(0, 11), _F32)
    c = torch.where(nd > 0, _fl(c.to(_F32) * pen), c)
    m = torch.where(nd > 0, _fl(m.to(_F32) * pen), m)
    ratio = (_div(c.to(_F32), base_c0.clamp(min=1).to(_F32))
             * _div(m.to(_F32), base_m0.clamp(min=1).to(_F32)))
    ratio = torch.where(s["bact"] & (base_c0 > 0) & (base_m0 > 0), ratio, 1.0)
    final = _fl(final.to(_F32) * ratio)
    final = _fl(final.to(_F32) * (1.0 + 0.5 * n_red.to(_F32)))      # red seals

    need_f = s["need"].clamp(min=1).to(_F32)
    old_prog = _div(s["rchips"].to(_F32), need_f).clamp(max=1.0)
    round2 = s["rchips"] + final
    new_prog = _div(round2.to(_F32), need_f).clamp(max=1.0)
    upd = {
        "money": s["money"] + extra_money, "cons": new_cons, "cn": s["cn"] + n_create,
        "rchips": round2, "career": s["career"] + final,
        "hpt": s["hpt"] + 1, "hpa": s["hpa"] + 1,
        "best": torch.maximum(s["best"], final),
        "pc": s["pc"] + (torch.arange(N_LVL, device=ht.device)[:, None] == ht).to(_I32),
        "green": s["green"] + 1, "sel": torch.zeros_like(sel), "high": uni,
        "bus": torch.where(face.any(0), 0, s["bus"] + 1),
        "btypes": s["btypes"] | torch.where(s["bact"], 1 << ht, 0),
        "bfirst": s["bfirst"] & ~s["bact"],
        "bp": s["bp"] | _slot_set(s["hidx"], sel & s["bact"]),
        "bverd": torch.where(s["bact"] & (bid == B.VERDANT),
                             (s["bverd"] + 1).clamp(max=7), s["bverd"]),
        "ctr": ctr,
    }

    # shaped reward
    HT = HandType
    milestone = torch.where(
        (old_prog < 0.25) & (new_prog >= 0.25), 5.0, torch.where(
            (old_prog < 0.5) & (new_prog >= 0.5), 10.0, torch.where(
                (old_prog < 0.75) & (new_prog >= 0.75), 15.0, torch.where(
                    (old_prog < 1.0) & (new_prog >= 1.0), 25.0, 0.0))))
    ff = final.to(_F32)
    score_reward = torch.where(
        s["ante"] <= 3, _div(ff, 100.0).clamp(max=10.0),
        _div(3.0 * torch.log(final.clamp(min=1).to(_F32)), _LOG10_F32).clamp(max=10.0))
    quality = _tab(_HQ_F32, ht, _F32)
    efficiency = torch.where(
        (ht >= int(HT.THREE_KIND)) & (n_played <= 3), 2.0, torch.where(
            (ht >= int(HT.FLUSH)) & (n_played == 5), 1.0, torch.where(
                (n_played <= 4) & (s["hl"] <= 2), 1.5, 0.0)))
    flush_syn = (_count(s, JT.J_FOUR_FINGERS) + _count(s, JT.J_SHORTCUT) + _count(s, 113)) > 0
    pair_syn = (_count(s, JT.J_ODD_TODD) + _count(s, JT.J_EVEN_STEVEN)
                + _count(s, JT.J_JOLLY) + _count(s, JT.J_ZANY)) > 0
    face_syn = (_count(s, JT.J_SCARY_FACE) + _count(s, JT.J_SMILEY_FACE) + _count(s, 42)) > 0
    n_face = (sel & (ranks >= 11)).sum(0, dtype=_I32).to(_F32)
    synergy = torch.where((ht == int(HT.FLUSH)) & flush_syn, 2.0, 0.0)
    pairish = (ht == int(HT.ONE_PAIR)) | (ht == int(HT.TWO_PAIR)) | (ht == int(HT.THREE_KIND))
    synergy = synergy + torch.where(pairish & pair_syn, 1.5, 0.0)
    synergy = synergy + torch.where((n_face > 0) & face_syn, 0.5 * n_face, 0.0)
    strategy = torch.where((new_prog > _f(0.7)) & (s["hl"] >= 3), 2.0,
                           torch.where((new_prog < _f(0.3)) & (ht >= int(HT.FLUSH)), 3.0, 0.0))
    ante_bonus = torch.where(s["ante"] >= 4,
                             ((s["ante"] - 3).to(_F32) * 0.5).clamp(max=5.0), 0.0)
    reward = (15.0 * new_prog + milestone + score_reward + quality * 2.0
              + efficiency * 1.5 + synergy * 3.0 + strategy * 2.0 + ante_bonus)
    reward = reward.clamp(max=100.0)
    beat = round2 >= s["need"]
    fail = ~beat & (s["hl"] <= 1)
    reward = reward + torch.where(beat, (25.0 + 10.0 * s["ante"].to(_F32)).clamp(max=50.0), 0.0)
    reward = reward + torch.where(fail, -50.0 * (1.0 - new_prog), 0.0)
    return upd, reward, beat, fail, boss_ok, k_boss


def _discard_branch(s, view):
    """The discard action, before the refill. Returns (update, reward, rem):
    ``rem`` is the hand-position mask the caller removes."""
    ranks, _, _, _, seal, present = view
    sel = s["sel"] & present
    n_sel = sel.sum(0, dtype=_I32)
    k_seal, ctr = _stream(s, "seal_applications")
    n_purple = (sel & (seal == int(C.Seal.PURPLE))).sum(0, dtype=_I32)
    n_tarot = torch.minimum(n_purple, (s["cslots"] - s["cn"]).clamp(0, N_CONS))
    c5 = torch.arange(N_CONS, device=sel.device)[:, None]
    tid = KR.randint(*KR.fold_in(k_seal[0][None], k_seal[1][None], c5), 1, 23).to(_I32)
    new_cons = torch.where((c5 >= s["cn"]) & (c5 < s["cn"] + n_tarot), tid, s["cons"])
    is_first = s["dl"] == 3
    trading = (_count(s, JT.J_TRADING_CARD) > 0) & is_first & (n_sel == 1)
    n_face = (sel & (ranks >= 11) & (ranks <= 13)).sum(0, dtype=_I32)
    faceless = (_count(s, JT.J_FACELESS) > 0) & (n_face >= 3)
    money_disc = torch.where(trading, 3, 0) + torch.where(faceless, 5, 0)
    n_syn = (_count(s, JT.J_FACELESS) + _count(s, 130) + _count(s, 82)
             + _count(s, JT.J_LUCHADOR))
    upd = {"money": s["money"] + money_disc, "cons": new_cons, "cn": s["cn"] + n_tarot,
           "green": (s["green"] - 1).clamp(min=0), "dl": s["dl"] - 1, "ctr": ctr,
           "sel": torch.zeros_like(sel), "high": torch.zeros_like(sel)}
    rem = (sel | s["high"]) & (_positions(s) < s["hn"])
    progress = _div(s["rchips"].to(_F32), s["need"].clamp(min=1).to(_F32))
    dl_post = s["dl"] - 1
    reward = _f(0.2) + 0.5 * n_syn.to(_F32) + _div(money_disc.to(_F32), 5.0)
    reward = reward + torch.where((progress < 0.5) & (dl_post > 1), 0.5, torch.where(
        (progress > _f(0.8)) & (dl_post > 1), _f(-0.3), 0.0))
    return upd, reward, rem


# ---------------------------------------------------------------------------
# Consumables
# ---------------------------------------------------------------------------


def _append5(cons, cn, val, gate):
    """Append ``val`` where ``gate`` and a physical slot is free."""
    can = gate & (cn < N_CONS)
    c5 = torch.arange(N_CONS, device=cn.device)[:, None]
    return torch.where(can & (cn == c5), val, cons), cn + can.to(_I32)


def _create_cards(s, n, ranks4, suits4, enhs4):
    """Fill the highest free deck slots with up to 4 new cards ([4, B] rank,
    suit, enhancement); clears stale Pillar marks on the reused slots."""
    free = (~s["al"]).to(_I32)
    csum = free.flip(0).cumsum(0, dtype=_I32).flip(0)      # free slots in [d, 64)
    take = s["al"].logical_not() & (csum <= n)
    ordinal = take.to(_I32).cumsum(0, dtype=_I32) - take.to(_I32)
    pk4 = ranks4 | (suits4 << 4) | (enhs4 << 8)                 # [4, B]
    route = torch.where(take, ordinal, -1)
    hit = route[None] == torch.arange(4, device=n.device)[:, None, None]   # [k, d, B]
    nv = torch.where(hit, pk4[:, None], 0).sum(0, dtype=_I32)
    return {"rk": torch.where(take, nv & 15, s["rk"]),
            "su": torch.where(take, (nv >> 4) & 15, s["su"]),
            "en": torch.where(take, (nv >> 8) & 15, s["en"]),
            "edt": torch.where(take, 0, s["edt"]), "slc": torch.where(take, 0, s["slc"]),
            "al": s["al"] | take, "bp": s["bp"] & ~take}


def _consumable_branch(s, view, a, live):
    """Use of consumable slot ``a - 10``. Every write is gated by a case of
    ``cid``, and ``cid`` is -1 where ``live`` is false, so the returned rows
    equal ``s`` there. Returns (update, reward, rem, destroyed)."""
    ranks, suits, enh, _, _, present = view
    dev = a.device
    idx = (a - Action.USE_CONSUMABLE_BASE).clamp(0, N_CONS - 1)
    raw = _gather_rows(s["cons"], idx)
    cid = torch.where(raw >= CL.ENUMNAME_OFFSET, raw - CL.ENUMNAME_OFFSET, raw)
    cid = torch.where(live, cid, -1)
    sel = s["sel"] & present
    n_sel = sel.sum(0, dtype=_I32)
    key, ctr = _stream(s, "consumable_effects")
    k1, k2, k3, k4 = (KR.split_child(*key, i) for i in range(4))

    def randint(k, lo, hi, i=0):
        return KR.randint(*k, lo, hi, i).to(_I32)

    reward = torch.zeros(a.shape, dtype=_F32, device=dev)
    success = torch.zeros(a.shape, dtype=torch.bool, device=dev)
    cs = dict(s)
    cs["ctr"] = ctr
    is_tarot = (cid >= CL.TAROT_BASE) & (cid < CL.TAROT_BASE + CL.NUM_TAROT)
    is_planet = (cid >= CL.PLANET_BASE) & (cid < CL.PLANET_BASE + CL.NUM_PLANET)
    is_spectral = (cid >= CL.SPECTRAL_BASE) & (cid < CL.SPECTRAL_BASE + CL.NUM_SPECTRAL)
    tgt1 = _first_k(sel, 1)
    t164 = _slot_set(s["hidx"], tgt1)

    # enhancement tarots
    enh_val = torch.where(is_tarot, _tab(CL.ENH_TAROT, cid.clamp(0, 22)), 0)
    enh_k = torch.where(is_tarot, _tab(CL.ENH_COUNT, cid.clamp(0, 22)), 0)
    tgt_enh = _first_k(sel, enh_k)
    do_enh = is_tarot & (enh_val > 0) & (n_sel >= 1)
    cs["en"] = torch.where(do_enh & _slot_set(s["hidx"], tgt_enh), enh_val, cs["en"])
    cs["hen"] = torch.where(do_enh & tgt_enh, enh_val, cs["hen"])
    reward = reward + torch.where(do_enh, 2.0 * tgt_enh.sum(0, dtype=_I32).to(_F32), 0.0)
    success = success | do_enh

    # seal spectrals on the first selected card
    seal_val = torch.where(is_spectral, _tab(CL.SEAL_SPEC, cid.clamp(0, 67)), 0)
    do_seal = is_spectral & (seal_val > 0) & (n_sel >= 1)
    cs["slc"] = torch.where(do_seal & t164, seal_val, cs["slc"])
    cs["hsl"] = torch.where(do_seal & tgt1, seal_val, cs["hsl"])
    reward = reward + torch.where(do_seal, 2.0, 0.0)
    success = success | do_seal

    # Aura / Wheel of Fortune editions on the first selected card
    do_aura = (cid == CL.AURA) & (n_sel >= 1)
    aura_ed = _tab(CL.EDITIONS3, randint(k1, 0, 3))
    fired = KR.uniform_f32(KR.random_bits32(*k1, 0)) < 0.25
    do_wheel = (cid == CL.WHEEL) & (n_sel >= 1) & fired
    wheel_ed = _tab(CL.EDITIONS3, randint(k2, 0, 3))
    ed_do = do_aura | do_wheel
    ed_val = torch.where(do_aura, aura_ed, wheel_ed)
    cs["edt"] = torch.where(ed_do & t164, ed_val, cs["edt"])
    cs["hed"] = torch.where(ed_do & tgt1, ed_val, cs["hed"])
    reward = reward + torch.where(ed_do, 2.0, 0.0)
    success = success | ed_do

    # tarots whose card changes the reference drops: reward only
    do_strength = (cid == CL.STRENGTH) & (n_sel >= 1)
    tgt2 = _first_k(sel, 2)
    n_strength = (tgt2 & (ranks < 14)).sum(0, dtype=_I32).to(_F32)
    reward = reward + torch.where(do_strength, 2.0 * n_strength, 0.0)
    do_death = (cid == CL.DEATH) & (n_sel >= 2)
    reward = reward + torch.where(do_death, 4.0, 0.0)
    is_conv = (cid == CL.STAR) | (cid == CL.MOON) | (cid == CL.SUN) | (cid == CL.WORLD)
    do_conv = is_conv & (n_sel >= 1)
    reward = reward + torch.where(do_conv, 2.0 * n_sel.clamp(max=3).to(_F32), 0.0)
    success = success | do_strength | do_death | do_conv

    # money tarots
    do_hermit, do_temper = cid == CL.HERMIT, cid == CL.TEMPERANCE
    gain = torch.where(do_hermit, s["money"].clamp(0, 20),
                       torch.where(do_temper, (5 * s["jn"]).clamp(max=50), 0))
    cs["money"] = cs["money"] + gain
    reward = reward + _div(gain.to(_F32), 10.0)
    success = success | do_hermit | do_temper

    # planets
    ph = _tab(PLANET_HAND, (cid - CL.PLANET_BASE).clamp(0, 11))
    h = torch.arange(N_LVL, device=dev)[:, None]
    cs["lvl"] = cs["lvl"] + (is_planet & (ph == h)).to(_I32)
    reward = reward + torch.where(is_planet, 10.0, 0.0)
    success = success | is_planet

    # consumable-creating tarots (the reference appends their items twice)
    gate1 = s["cn"] < s["cslots"]
    gate2 = s["cn"] + 1 < s["cslots"]
    p9_0 = CL.PLANET_BASE + randint(k2, 0, 9, 0)
    p9_1 = CL.PLANET_BASE + randint(k2, 0, 9, 1)
    t22_0 = CL.ENUMNAME_OFFSET + CL.TAROT_BASE + randint(k2, 0, 22, 0)
    t22_1 = CL.ENUMNAME_OFFSET + CL.TAROT_BASE + randint(k2, 0, 22, 1)
    fool_i = randint(k2, 0, s["cn"].clamp(min=1))
    fool_pick = torch.where((fool_i >= 0) & (fool_i < N_CONS),
                            _gather_rows(s["cons"], fool_i.clamp(0, N_CONS - 1)), 0)
    do_hp, do_emp = cid == CL.HIGH_PRIESTESS, cid == CL.EMPEROR
    do_judge = cid == CL.JUDGEMENT
    do_fool = (cid == CL.FOOL) & (s["cn"] > 0)
    make_two = do_hp | do_emp
    v0 = torch.where(do_emp, t22_0, p9_0)
    v1 = torch.where(do_emp, t22_1, p9_1)
    c0, n0 = cs["cons"], cs["cn"]
    c1, n1 = _append5(c0, n0, v0, make_two & gate1)
    c2, n2 = _append5(c1, n1, v1, make_two & gate2 & (n1 > n0))
    c3, n3 = _append5(c2, n2, p9_0, do_judge & gate1)
    c4, n4 = _append5(c3, n3, fool_pick, do_fool)
    cs["cons"], cs["cn"] = c4, n4
    items1 = (n1 > n0).to(_I32) + (n2 > n1).to(_I32) + (n3 > n2).to(_I32)
    fool_items = (n4 > n3).to(_I32)
    reward = reward + torch.where(make_two | do_judge, 5.0 * items1.to(_F32), 0.0)
    reward = reward + torch.where(do_fool, 5.0 * fool_items.to(_F32), 0.0)
    success = success | make_two | do_judge | do_fool
    pending = torch.where(make_two | do_judge, items1, torch.where(do_fool, fool_items, 0))
    pend0 = torch.where(do_fool, fool_pick, torch.where(do_judge, p9_0, v0))
    pend1 = v1

    # joker-creating spectrals
    jslot_free = s["jn"] < s["jslots"]
    do_wraith = (cid == CL.WRAITH) & jslot_free
    do_soul = (cid == CL.THE_SOUL) & jslot_free
    wid = _tab(CL.WRAITH_JOKERS, randint(k3, 0, 14))
    sid = _tab(CL.SOUL_JOKERS, randint(k3, 0, 5))
    new_jid = torch.where(do_soul, sid, wid)
    add_joker = (do_wraith | do_soul) & (new_jid > 0)
    sl = torch.arange(N_JOK, device=dev)[:, None]
    cs["jok"] = torch.where(add_joker & (s["jn"].clamp(0, N_JOK - 1) == sl), new_jid, cs["jok"])
    cs["jn"] = cs["jn"] + add_joker.to(_I32)
    reward = reward + torch.where(do_wraith | do_soul, 15.0, 0.0)
    success = success | do_wraith | do_soul

    # hand size, Ankh, Hex, Black Hole
    do_ecto = (cid == CL.ECTOPLASM) & (s["jn"] > 0)
    do_ouija = (cid == CL.OUIJA) & (s["hn"] > 0)
    cs["hsize"] = cs["hsize"] + torch.where(do_wraith | do_ecto | do_ouija, -1, 0)
    do_ankh = (cid == CL.ANKH) & (s["jn"] > 0)
    reward = reward + torch.where(do_ankh, 15.0, 0.0)
    success = (success | do_ecto | do_ankh | ((cid == CL.HEX) & (s["jn"] > 0))
               | (cid == CL.BLACK_HOLE))

    # destroy / create: Hanged Man, Familiar-Grim-Incantation, Immolate, Cryptid
    do_hang = (cid == CL.HANGED_MAN) & (n_sel >= 1)
    hang64 = _slot_set(s["hidx"], tgt2)
    do_fgi = ((cid == CL.FAMILIAR) | (cid == CL.GRIM) | (cid == CL.INCANTATION)) & (n_sel >= 1)
    n_create = torch.where(cid == CL.FAMILIAR, 3, torch.where(cid == CL.GRIM, 2, 4))
    ranks4 = []
    for k in range(4):
        ck = KR.split_child(*k4, k)
        fam = 11 + randint(ck, 0, 3)
        inc = 2 + randint(ck, 0, 9)
        ranks4.append(torch.where(cid == CL.FAMILIAR, fam, torch.where(cid == CL.GRIM, 14, inc)))
    k9, k10 = KR.fold_in(*k4, 9), KR.fold_in(*k4, 10)
    suits4 = torch.stack([randint(k9, 0, 4, k) for k in range(4)])
    enhs4 = torch.stack([_tab(CL.ENH_POOL7, randint(k10, 0, 7, k)) for k in range(4)])

    do_immo = cid == CL.IMMOLATE
    d = torch.arange(N_DECK, device=dev)[:, None]
    ikeys = KR.random_bits32(k3[0][None], k3[1][None], d)               # [64, B]
    kd = torch.where(s["al"], _sortable((ikeys & 0xFFFFFF80) | (127 - d)), I32_MIN)
    top5 = kd.topk(5, dim=0).values
    n_kill = s["al"].sum(0, dtype=_I32).clamp(max=5)
    win = 127 - (top5 & 127)                                            # [5, B]
    valid = torch.arange(5, device=dev)[:, None] < n_kill
    ikill = ((win[None] == d[:, None]) & valid[None]).any(1)            # [64, B]

    do_cryptid = (cid == CL.CRYPTID) & (n_sel >= 1)
    src_rk = torch.where(tgt1, ranks, 0).sum(0, dtype=_I32)
    src_su = torch.where(tgt1, suits, 0).sum(0, dtype=_I32)
    src_en = torch.where(tgt1, enh, 0).sum(0, dtype=_I32)

    dc_kill = (do_hang & hang64) | (do_fgi & t164) | (do_immo & ikill)
    dc_destroy = do_hang | do_fgi | do_immo
    cs["al"] = cs["al"] & ~dc_kill
    hidx = s["hidx"]
    rem_dc = (hidx >= 0) & dc_kill.gather(0, hidx.clamp(0, N_DECK - 1).long())
    cs["money"] = torch.where(do_immo, s["money"] + 20, cs["money"])
    reward = reward + torch.where(do_hang, 2.0 * tgt2.sum(0, dtype=_I32).to(_F32), 0.0)
    reward = reward + torch.where(do_fgi, 3.0 * n_create.to(_F32) + 1.0, 0.0)
    reward = reward + torch.where(do_immo, n_kill.to(_F32) + 2.0, 0.0)
    reward = reward + torch.where(do_cryptid, 6.0, 0.0)
    success = success | do_hang | do_fgi | do_immo | do_cryptid

    cr_n = torch.where(do_fgi, n_create, torch.where(do_cryptid, 2, 0))
    cr_rk = torch.where(do_cryptid, src_rk, torch.stack(ranks4))
    cr_su = torch.where(do_cryptid, src_su, suits4)
    cr_en = torch.where(do_cryptid, src_en, enhs4)
    cs.update(_create_cards(cs, cr_n, cr_rk, cr_su, cr_en))

    # Sigil / Ouija: whole-hand suit / rank conversions
    do_sigil = (cid == CL.SIGIL) & (s["hn"] > 0)
    conv_suit = randint(k3, 0, 4)
    conv_rank = 2 + randint(k3, 0, 13)
    cs["su"] = torch.where(do_sigil & s["ih"], conv_suit, cs["su"])
    cs["rk"] = torch.where(do_ouija & s["ih"], conv_rank, cs["rk"])
    held = _positions(s) < s["hn"]
    cs["hsu"] = torch.where(do_sigil & held, conv_suit, cs["hsu"])
    cs["hrk"] = torch.where(do_ouija & held, conv_rank, cs["hrk"])
    reward = reward + torch.where(do_sigil | do_ouija, 2.0 * s["hn"].to(_F32), 0.0)
    success = success | do_sigil | do_ouija

    # consume on success: pop slot idx, then the reference re-appends
    c5 = torch.arange(N_CONS, device=dev)[:, None]
    nxt = torch.cat([cs["cons"][1:], torch.zeros_like(cs["cons"][:1])])
    popped = torch.where(c5 >= cs["cn"] - 1, 0, torch.where(c5 < idx, cs["cons"], nxt))
    cs["cons"] = torch.where(success, popped, cs["cons"])
    cs["cn"] = cs["cn"] - success.to(_I32)
    cc, nn = _append5(cs["cons"], cs["cn"], pend0, (pending >= 1) & (cs["cn"] < s["cslots"]))
    cs["cons"], cs["cn"] = _append5(cc, nn, pend1, (pending >= 2) & (nn < s["cslots"]))
    cs["sel"] = torch.zeros_like(sel)
    reward = torch.where(success, reward, -1.0)
    touched = ("rk", "su", "en", "edt", "slc", "al", "bp", "hrk", "hsu", "hen", "hed",
               "hsl", "sel", "money", "lvl", "cons", "cn", "jok", "jn", "hsize", "ctr")
    return {k: cs[k] for k in touched}, reward, rem_dc, dc_destroy


# ---------------------------------------------------------------------------
# Shop, blinds, round advance
# ---------------------------------------------------------------------------


def _shift_out(rows, idx, n):
    """Pop row ``idx`` of a list of ``n`` live rows; later rows shift left."""
    r = torch.arange(rows.shape[0], device=rows.device)[:, None]
    nxt = torch.cat([rows[1:], torch.zeros_like(rows[:1])])
    return torch.where(r < n - 1, torch.where(r < idx, rows, nxt), 0)


def _shop_buy_branch(s, a):
    idx = (a - Action.SHOP_BUY_BASE).clamp(0, N_SHOP - 1)
    itype, item, cost = (_gather_rows(s[k], idx) for k in ("sty", "sit", "sco"))
    joker_full = s["jn"] >= s["jslots"]
    buy_joker = (itype == SL.IT_JOKER) & ~joker_full
    blocked = (itype == SL.IT_JOKER) & joker_full
    sl = torch.arange(N_JOK, device=a.device)[:, None]
    upd = {"money": s["money"] - cost, "sn": s["sn"] - 1,
           "jok": torch.where(buy_joker & (s["jn"].clamp(0, N_JOK - 1) == sl), item, s["jok"]),
           "jn": s["jn"] + buy_joker.to(_I32),
           "vou": torch.where(itype == SL.IT_VOUCHER,
                              s["vou"] | torch.where(item == 0, 1, 2), s["vou"])}
    for k in ("sty", "sit", "sco"):
        upd[k] = _shift_out(s[k], idx, s["sn"])
    reward = torch.where(blocked, -1.0, torch.where(
        itype == SL.IT_PACK, 5.0, torch.where(itype == SL.IT_JOKER, 15.0, torch.where(
            itype == SL.IT_CARD, 3.0, torch.where(itype == SL.IT_VOUCHER, 10.0, -1.0)))))
    return upd, reward


def _sell_branch(s, a):
    idx = (a - Action.SELL_JOKER_BASE).clamp(0, N_JOK - 1)
    jid = _gather_rows(s["jok"], idx)
    value = torch.where((jid >= 1) & (jid < JT.NUM_JOKERS),
                        _tab(_SELL_VALUE, jid.clamp(0, JT.NUM_JOKERS - 1)), 3)
    upd = {"jok": _shift_out(s["jok"], idx, s["jn"]), "jn": s["jn"] - 1,
           "money": s["money"] + value, "jsold": s["jsold"] + 1}
    return upd, _div(value.to(_F32), 5.0)


def _blind_branch(s, a):
    bt = (a - Action.SELECT_BLIND_BASE).clamp(0, 2)
    base = _tab(_blind_chips.astype(np.int32).reshape(-1),
                (s["ante"].clamp(1, 8) - 1) * 3 + bt)
    extra = (s["ante"] - 8).clamp(min=0)
    p15 = torch.where((extra >= 1) & (extra <= 92),
                      _tab(_P15_F32, extra.clamp(0, 95), _F32), 1.0)
    chips = _f2i(base.to(_F32) * p15)
    is_boss = bt == 2
    k_boss, ctr = _stream(s, "boss_abilities")
    bid = KR.randint(*k_boss, 1, B.N_BOSS).to(_I32)
    cmult = torch.where(bid == B.WALL, 2.0, 1.0)
    chips = torch.where(is_boss, _fl(chips.to(_F32) * cmult), chips)
    z = torch.zeros_like(bt)
    upd = {"round": bt + 1, "need": chips,
           "dl": torch.where(is_boss & (bid == B.WATER), 0, s["dl"]),
           "hsize": torch.where(is_boss & (bid == B.MANACLE), s["hsize"] - 1, s["hsize"]),
           "hl": torch.where(is_boss & (bid == B.NEEDLE), 1, s["hl"]),
           "bact": is_boss, "bid": torch.where(is_boss, bid, -1), "btypes": z,
           "bfirst": torch.ones_like(is_boss), "bverd": z + 5,
           "bp": torch.zeros_like(s["bp"]), "phase": z + int(Phase.PLAY), "ctr": ctr}
    return upd, torch.where(is_boss, 10.0, 0.0)


def _shop_gen(s, key, ante):
    """A fresh inventory: (types, items, costs [10, B], cost multiplier)."""
    dev = ante.device
    m = torch.where((ante >= 1) & (ante <= 100), _tab(_P115_F32, (ante - 1).clamp(0, 99), _F32),
                    0.0)
    mult = m * torch.where((s["vou"] >> SL.V_MAGIC_TRICK) & 1 == 1, _f(0.9), 1.0)
    k_pack, k_jok, k_vouch, k_cards = (KR.split_child(*key, i) for i in range(4))
    third = KR.randint(*k_pack, SL.PACK_TAROT, SL.PACK_SPECTRAL + 1).to(_I32)

    # Three distinct unowned jokers: the top 3 of packed priority words
    # key20 | base_cost4 | 255-id (all distinct) over the eligible ids.
    elig = torch.as_tensor(_ELIGIBLE, device=dev)[:, None]
    jkeys = KR.random_bits32(k_jok[0][None], k_jok[1][None], elig)        # [145, B]
    owned = (s["jok"][None] == elig[:, None]).any(1)
    words = (jkeys & 0xFFF00000) | const(_JPAYLOAD, _I64, dev)[:, None]
    _check((~owned).sum(0) >= 3, "fewer than 3 eligible unowned shop jokers")
    top3 = torch.where(owned, I32_MIN, _sortable(words)).topk(3, dim=0).values
    jids, jcosts = 255 - (top3 & 255), (top3 >> 8) & 15

    vid = KR.randint(*k_vouch, 0, 2).to(_I32)
    card0 = KR.randint(*k_cards, 0, 52, 0).to(_I32)
    card1 = KR.randint(*k_cards, 0, 52, 1).to(_I32)

    def tc(base):
        return _fl(base.to(_F32) * mult)

    z = torch.zeros_like(ante)
    types = torch.tensor([SL.IT_PACK] * 3 + [SL.IT_JOKER] * 3 + [SL.IT_VOUCHER]
                         + [SL.IT_CARD] * 2 + [0], dtype=_I32, device=dev)[:, None] + z
    items = torch.stack([z, z + SL.PACK_JOKER, third, jids[0], jids[1], jids[2], vid,
                         card0, card1, z])
    costs = torch.stack([tc(z + int(SL.PACK_COSTS[0])), tc(z + int(SL.PACK_COSTS[1])),
                         tc(_tab(SL.PACK_COSTS, third)), tc(jcosts[0]), tc(jcosts[1]),
                         tc(jcosts[2]), tc(_tab(SL.VOUCHER_COSTS, vid)),
                         z + SL.CARD_COST, z + SL.CARD_COST, z])
    return types, items, costs, mult


def _advance(s, gen):
    """Beat or skip a blind: gold-card and boss money, ante/round, round
    money, fresh hands and shop (frozen past ante 100)."""
    types, items, costs, mult = gen
    held = _positions(s) < s["hn"]
    gold = (held & (s["hen"] == int(C.Enhancement.GOLD))).sum(0, dtype=_I32)
    money = s["money"] + gold * C.GOLD_CARD_MONEY + torch.where(s["bact"], B.BOSS_MONEY_REWARD, 0)
    new_ante = torch.where(s["round"] == 3, s["ante"] + 1, s["ante"])
    new_round = torch.where(s["round"] == 3, 1, s["round"] + 1)
    over = new_ante > 100
    money = money + torch.where(over, 0, 25 * new_round + torch.where(new_round == 3, 10, 0))
    z = torch.zeros_like(money)
    gen_sid = R.STREAM_ID["shop_generation"]
    ctr = s["ctr"].clone()
    ctr[gen_sid] = (ctr[gen_sid] + (~over).to(_I64)) & _M32
    return {
        "money": money, "ante": new_ante, "round": new_round,
        "rchips": z, "best": z, "hpa": z, "bact": torch.zeros_like(over), "bid": z - 1,
        "btypes": z, "bfirst": torch.ones_like(over), "bverd": z + 5,
        "bp": torch.zeros_like(s["bp"]), "fd": torch.zeros_like(s["fd"]),
        "hl": torch.where(over, s["hl"], 4), "dl": torch.where(over, s["dl"], 3),
        "phase": torch.where(over, s["phase"], int(Phase.SHOP)),
        "sty": torch.where(over, s["sty"], types), "sit": torch.where(over, s["sit"], items),
        "sco": torch.where(over, s["sco"], costs),
        "sn": torch.where(over, s["sn"], SL.N_ITEMS),
        "rbase": torch.where(over, s["rbase"], SL.REROLL_BASE),
        "rcost": torch.where(over, s["rcost"], _fl(float(SL.REROLL_BASE) * mult)),
        "ctr": ctr,
    }


# ---------------------------------------------------------------------------
# Autoreset and the step
# ---------------------------------------------------------------------------


def _reset_rows(s):
    """Fresh-episode rows: key folded with the step count, deck shuffled by
    sorting 52 packed priority words."""
    dev, z = s["hn"].device, torch.zeros_like(s["hn"])
    nk1, nk2 = KR.fold_in(s["k1"], s["k2"], _i2w(s["sc"]))
    sk = KR.fold_in(nk1, nk2, R.STREAM_ID["deck_shuffle"])
    dk = KR.fold_in(*sk, 0)
    c = torch.arange(52, device=dev)[:, None]
    prio = KR.random_bits32(dk[0][None], dk[1][None], c)
    words = _sortable((prio & 0xFFFFFFC0) | (((c // 13) << 4) | (c % 13)))
    pad = torch.full((N_DECK - 52, z.shape[0]), I32_MAX, dtype=_I32, device=dev)
    v = torch.sort(torch.cat([words, pad]), dim=0).values
    real = torch.arange(N_DECK, device=dev)[:, None] < 52
    deck0 = torch.zeros(N_DECK, z.shape[0], dtype=_I32, device=dev)
    hand0 = torch.zeros(N_HAND, z.shape[0], dtype=_I32, device=dev)
    ctr = torch.zeros_like(s["ctr"])
    ctr[R.STREAM_ID["deck_shuffle"]] = 1
    f = torch.zeros_like(s["done"])
    out = {"rk": torch.where(real, (v & 15) + 2, 0), "su": torch.where(real, (v >> 4) & 3, 0),
           "en": deck0, "edt": deck0, "slc": deck0, "al": real.expand(-1, z.shape[0]),
           "ih": torch.zeros_like(s["ih"]), "hidx": hand0 - 1, "hn": z,
           "sel": hand0 != 0, "fd": hand0 != 0, "high": hand0 != 0,
           "jok": torch.zeros_like(s["jok"]), "jn": z, "green": z + 1, "bus": z,
           "cons": torch.zeros_like(s["cons"]), "cn": z, "vou": z, "jslots": z + 5,
           "cslots": z + 2, "ante": z + 1, "round": z + 1,
           "phase": z + int(Phase.BLIND_SELECT), "need": z + 300, "career": z,
           "rchips": z, "best": z, "money": z + 4, "hl": z + 4, "dl": z + 3,
           "hsize": z + 8, "lvl": torch.ones_like(s["lvl"]), "pc": torch.zeros_like(s["pc"]),
           "sty": torch.zeros_like(s["sty"]), "sit": torch.zeros_like(s["sit"]),
           "sco": torch.zeros_like(s["sco"]), "sn": z, "rbase": z + SL.REROLL_BASE,
           "rcost": z + 5, "bact": f, "bid": z - 1, "btypes": z, "bfirst": ~f,
           "bverd": z + 5, "bp": torch.zeros_like(s["bp"]), "hpt": z, "hpa": z,
           "jsold": z, "k1": nk1, "k2": nk2, "ctr": ctr, "done": f, "sc": z}
    for h in _HAND_CH:
        out[h] = hand0
    return out


def _step(s, a, autoreset=True):
    """One ``step_autoreset`` of every env, branch-free. Returns (state,
    reward, done). With ``autoreset=False`` it is the engine's ``step``: a
    done env keeps its final state (done set, step count advanced)."""
    a = a.to(_I32)
    over = (s["ante"] > 100) | (s["career"] > 1_000_000_000) | s["done"]
    in_range = (a >= 0) & (a < Action.ACTION_SPACE_SIZE)
    legal = _gather_rows(_legal_rows(s), a.clamp(0, Action.ACTION_SPACE_SIZE - 1)) & in_range
    present = _positions(s) < s["hn"]
    view = (s["hrk"], s["hsu"], s["hen"], s["hed"], s["hsl"], present)

    in_play = s["phase"] == int(Phase.PLAY)
    in_shop = s["phase"] == int(Phase.SHOP)
    in_blind = s["phase"] == int(Phase.BLIND_SELECT)
    do_play = in_play & (a == Action.PLAY_HAND)
    do_disc = in_play & (a == Action.DISCARD)
    do_sel = in_play & (a >= 2) & (a < 10)
    do_use = in_play & (a >= 10) & (a < 15)
    do_buy = in_shop & (a >= 20) & (a < 30)
    do_rr = in_shop & (a == Action.SHOP_REROLL)
    do_end = in_shop & (a == Action.SHOP_END)
    do_sell = in_shop & (a >= 32) & (a < 37)
    do_bsel = in_blind & (a >= 45) & (a < 48)
    do_skip = in_blind & (a == Action.SKIP_BLIND)

    play_upd, r_play, beat, fail, boss_ok, k_boss = _play_branch(s, view)
    disc_upd, r_disc, rem_disc = _discard_branch(s, view)
    cons_upd, r_use, rem_dc, dc_destroy = _consumable_branch(s, view, a, do_use)
    pos = (a - Action.SELECT_CARD_BASE).clamp(0, N_HAND - 1)
    toggled = s["sel"] ^ (_positions(s) == pos)
    buy_upd, r_buy = _shop_buy_branch(s, a)
    sell_upd, r_sell = _sell_branch(s, a)
    bsel_upd, r_bsel = _blind_branch(s, a)

    # shared round advance + shop generation
    beat_play = do_play & boss_ok & beat
    adv_do = beat_play | do_skip
    adv_in = _merge(beat_play, play_upd, s)
    adv_ante = torch.where(adv_in["round"] == 3, adv_in["ante"] + 1, adv_in["ante"])
    k_gen, _ = _stream(s, "shop_generation")
    k_rr, ctr_rr = _stream(s, "shop_reroll")
    gen_key = (torch.where(do_rr, k_rr[0], k_gen[0]), torch.where(do_rr, k_rr[1], k_gen[1]))
    gen = _shop_gen(s, gen_key, torch.where(do_rr, s["ante"], adv_ante))
    adv_upd = _advance(adv_in, gen)

    # reroll: the counter advances even when the reroll is unaffordable
    rr_cost = _fl(s["rbase"].to(_F32) * gen[3])
    afford = s["money"] >= rr_cost
    rr_upd = {"money": torch.where(afford, s["money"] - rr_cost, s["money"]),
              "rbase": torch.where(afford, _fl(s["rbase"].to(_F32) * _f(SL.REROLL_GROWTH)),
                                   s["rbase"]),
              "sty": torch.where(afford, gen[0], s["sty"]),
              "sit": torch.where(afford, gen[1], s["sit"]),
              "sco": torch.where(afford, gen[2], s["sco"]),
              "sn": torch.where(afford, SL.N_ITEMS, s["sn"]), "ctr": ctr_rr}
    r_rr = torch.where(afford, 0.0, -1.0)

    # assemble: the action predicates are mutually exclusive
    reward = torch.full(a.shape, -1.0, dtype=_F32, device=a.device)
    play_cont = do_play & boss_ok & ~beat & ~fail
    base = {**s, **{k: v for k, v in cons_upd.items() if k not in ("sel", "ctr")}}
    base = _merge(do_use, {"sel": cons_upd["sel"], "ctr": cons_upd["ctr"]}, base)
    nxt = _merge(play_cont, {**play_upd, "hl": s["hl"] - 1}, base)
    nxt = _merge(do_play & boss_ok & fail, play_upd, nxt)
    nxt = _merge(beat_play, play_upd, nxt)
    nxt = _merge(adv_do, adv_upd, nxt)
    reward = torch.where(do_play, torch.where(boss_ok, r_play, -1.0), reward)
    # a play a boss blocks still highlights its cards
    nxt = _merge(do_play & ~boss_ok, {"high": play_upd["high"]}, nxt)
    term = do_play & boss_ok & fail
    nxt = _merge(do_disc, disc_upd, nxt)
    reward = torch.where(do_disc, r_disc, reward)
    # one pre-draw compaction for the discard and consumable-destroy lanes
    rem = (do_disc & rem_disc) | rem_dc
    nxt = _merge(do_disc | dc_destroy, _remove_positions(s, rem), nxt)
    nxt = _merge(do_sel, {"sel": toggled}, nxt)
    reward = torch.where(do_sel, 0.0, reward)
    reward = torch.where(do_use, r_use, reward)
    nxt = _merge(do_buy, buy_upd, nxt)
    reward = torch.where(do_buy, r_buy, reward)
    nxt = _merge(do_rr, rr_upd, nxt)
    reward = torch.where(do_rr, r_rr, reward)
    nxt = _merge(do_sell, sell_upd, nxt)
    reward = torch.where(do_sell, r_sell, reward)
    nxt = _merge(do_end, {"phase": torch.full_like(s["phase"], int(Phase.PLAY))}, nxt)
    reward = torch.where(do_end, 0.0, reward)
    nxt = _merge(do_bsel, bsel_upd, nxt)
    reward = torch.where(do_bsel, r_bsel, reward)
    reward = torch.where(do_skip, -5.0, reward)

    # shared refill draw
    nxt.update(_draw_pass(nxt, play_cont | do_disc | do_bsel | do_end))

    # boss on-hand-drawn effects for the refreshed hand (play continues)
    (kh1, kh2), (kw1, kw2) = KR.split2(*k_boss)
    p = _positions(nxt)
    present2 = p < nxt["hn"]
    hkeys = torch.where(present2, _sortable(KR.random_bits32(kh1[None], kh2[None], p)), I32_MIN)
    picks = []
    for _ in range(2):
        best_k = torch.full_like(nxt["hn"], I32_MIN)
        best_p = torch.zeros_like(nxt["hn"])
        for q in range(N_HAND):
            better = hkeys[q] > best_k
            best_k = torch.maximum(hkeys[q], best_k)
            best_p = torch.where(better, q, best_p)
        picks.append(best_p)
        hkeys = torch.where(p == best_p, I32_MIN, hkeys)
    n_pres = present2.sum(0, dtype=_I32)
    hook = ((p == picks[0]) | (p == picks[1])) & present2 & (n_pres >= 2)
    wroll = KR.uniform_f32(KR.random_bits32(kw1[None], kw2[None], p))
    bid = nxt["bid"]
    face = torch.where(bid == B.WHEEL, present2 & (wroll < _f(1.0 / 7.0)), torch.where(
        bid == B.HOUSE, present2 & nxt["bfirst"], torch.where(
            bid == B.MARK, present2 & (nxt["hrk"] >= 11) & (nxt["hrk"] <= 13), torch.where(
                bid == B.FISH, present2 & ~nxt["bfirst"], False))))
    gate_fd = play_cont & nxt["bact"]
    nxt["fd"] = torch.where(gate_fd, face, nxt["fd"])
    nxt = _merge(gate_fd & (bid == B.HOOK), _remove_positions(nxt, hook), nxt)

    # illegal actions and finished envs keep their state
    nxt = _merge(legal & ~over, nxt, s)
    reward = torch.where(legal, reward, -1.0)
    reward = torch.where(over, 0.0, reward)
    done = over | (term & legal)
    nxt["done"] = done
    nxt["sc"] = s["sc"] + 1
    if autoreset:
        nxt = _merge(done, _reset_rows(nxt), nxt)
    return nxt, reward, done


def _reference_packed(packed, actions, seed, n_steps):
    """The plain version on packed rows; returns (packed, total_reward,
    episodes)."""
    s = _load(packed)
    B_, dev = s["hn"].shape[0], s["hn"].device
    tot = torch.zeros(B_, dtype=_F32, device=dev)
    epi = torch.zeros(B_, dtype=_I32, device=dev)
    if actions is None:
        child = sample_keys(seed, B_, dev)
    for t in range(n_steps):
        if actions is None:
            a = _sample_action(s, KR.random_bits32(*child, t))
        else:
            a = actions[t]
        s, reward, done = _step(s, a)
        tot = tot + reward
        epi = epi + done.to(_I32)
    return _store(s), tot, epi


def sample_keys(seed, n_envs, device=None, first: int = 0):
    """Sampled mode's per-env keys: ``split_child(seed_key(seed), e)`` for
    ``e`` in ``first .. first + n_envs - 1``, on ``device`` (default: the
    card)."""
    device = run_device((), device)
    k1, k2 = KR.seed_key(seed, device=device)
    return KR.split_child(k1, k2, torch.arange(first, first + n_envs, device=device))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_C_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2 + [ctypes.c_void_p]


def float_tables(device):
    """The kernel's float32 tables, concatenated: powers of 1.5 [96], 0.8
    [12] and 1.15 [100], hand quality [12] and ln 10 [1]."""
    return const(_FTAB, _F32, device)


def _kernel_lib():
    lib = cuda_build.load("fused_full_rollout.cu")
    lib.fused_full_rollout_launch.argtypes = _C_ARGS
    lib.fused_full_rollout_info.argtypes = [ctypes.c_void_p]
    lib.fused_full_rollout_launch.restype = lib.fused_full_rollout_info.restype = ctypes.c_int
    return lib


def rollout_kernel_shape():
    """K2's launch shape and what the compiler gave it, on the current
    card: {"block": threads a block, "shared_bytes": shared memory a block,
    "registers": a thread, "stack_bytes": local memory a thread}."""
    out = (ctypes.c_int * 4)()
    err = _kernel_lib().fused_full_rollout_info(out)
    if err != 0:
        raise RuntimeError(f"fused_full_rollout_info failed: cudaError_t {err}")
    return dict(zip(("block", "shared_bytes", "registers", "stack_bytes"), out))


def _kernel_packed(packed, actions, seed, n_steps):
    """Launches csrc/fused_full_rollout.cu on the packed state's card;
    returns (packed, total_reward, episodes) as the plain version does."""
    ints = packed["ints"]
    dev, B_ = ints.device, ints.shape[1]
    check_arg(packed["cards"], "cards", _I32, (6, N_DECK, B_), dev)
    check_arg(ints, "ints", _I32, (NI, B_), dev)
    check_arg(packed["rng"], "rng", _I32, (NR, B_), dev)
    if actions is not None:
        check_arg(actions, "actions", _I32, (n_steps, B_), dev)
    lib = _kernel_lib()
    out = {k: torch.empty_like(v) for k, v in packed.items()}
    tot = torch.empty(B_, dtype=_F32, device=dev)
    epi = torch.empty(B_, dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_full_rollout_launch(
            packed["cards"].data_ptr(), ints.data_ptr(), packed["rng"].data_ptr(),
            actions.data_ptr() if actions is not None else None,
            float_tables(dev).data_ptr(), out["cards"].data_ptr(), out["ints"].data_ptr(), out["rng"].data_ptr(),
            tot.data_ptr(), epi.data_ptr(), B_, n_steps, int(actions is not None),
            0, int(seed) & _M32, stream)                      # seed_key(seed)
    if err != 0:
        raise RuntimeError(f"fused_full_rollout kernel launch failed: cudaError_t {err}")
    rollout_full_fused.launches += 1
    return out, tot, epi


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def default_reset(seed, n_envs: int, device=None, first: int = 0) -> FE.FullEnvState:
    """``reset`` over ``split(key(seed), N)``: the rollout's default start,
    on ``device`` (default: the card). With ``first`` it is envs ``first ..
    first + n_envs - 1`` of that start for any ``N`` past them (a
    data-parallel rank's slice, built from its own keys)."""
    return FE.reset(torch.stack(sample_keys(seed, n_envs, device, first), -1))


def _prepare(seed, n_envs, n_steps, actions, init_state, device):
    """(packed state, actions [n_steps, n_envs] or None) on the call's
    device. A tensor argument off the host fixes the device, and an explicit
    ``device`` must agree: host data goes to the card, card data never to
    the host."""
    if n_envs < 1 or n_steps < 0:
        raise ValueError(f"want n_envs >= 1 and n_steps >= 0, got {n_envs}, {n_steps}")
    dev = run_device((actions, None if init_state is None else init_state.ante), device)
    if init_state is None:
        with P.span("rollout.reset"):
            init_state = default_reset(seed, n_envs, dev)
    elif init_state.ante.shape != (n_envs,):
        raise ValueError(f"init_state holds {tuple(init_state.ante.shape)} envs, "
                         f"want ({n_envs},)")
    with P.span("rollout.pack"):
        packed = {k: v.to(dev).contiguous() for k, v in pack_full_state(init_state).items()}
    if actions is not None:
        actions = torch.as_tensor(actions).to(device=dev, dtype=_I32)
        if actions.dim() == 1:
            actions = actions[:, None].expand(actions.shape[0], n_envs)
        if tuple(actions.shape) != (n_steps, n_envs):
            raise ValueError(f"actions: want ({n_steps}, {n_envs}) or ({n_steps},), "
                             f"got {tuple(actions.shape)}")
        actions = actions.contiguous()
    return packed, actions


def _result(packed, tot, epi):
    with P.span("rollout.unpack"):
        return {"state": unpack_full_state(packed), "total_reward": tot, "episodes": epi}


def rollout_full_fused(seed, n_envs: int, n_steps: int, *, actions=None,
                       init_state=None, device=None):
    """Flagship-env rollout. Returns ``state`` (the final FullEnvState),
    ``total_reward`` ``[n_envs]`` float32 and ``episodes`` ``[n_envs]`` int32.

    seed: the sampled-mode action seed (and, without ``init_state``, the
    seed of the default reset). actions: optional ``[n_steps, n_envs]`` (or
    ``[n_steps]``, broadcast) action ids to replay; None samples uniformly
    over the legal set. init_state: optional FullEnvState of ``n_envs``
    envs (default: :func:`default_reset`). device: where to run (default:
    the device of a tensor argument off the host, else the card; it raises
    where there is none). With ``device="cpu"`` this is the plain version;
    on a card it is the CUDA kernel.
    """
    with P.span("rollout.call"):
        packed, actions = _prepare(seed, n_envs, n_steps, actions, init_state, device)
        dev = packed["ints"].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"rollout_full_fused: no kernel for device {dev}")
        with P.span("rollout.launch"):
            run = _reference_packed if dev.type == "cpu" else _kernel_packed
            out = run(packed, actions, seed, n_steps)
        return _result(*out)


rollout_full_fused.launches = 0


def rollout_full_rows_reference(seed, n_envs: int, n_steps: int, *, actions=None,
                                init_state=None, device=None):
    """The plain PyTorch version of :func:`rollout_full_fused`, on any
    device, with the same arguments and results."""
    packed, actions = _prepare(seed, n_envs, n_steps, actions, init_state, device)
    return _result(*_reference_packed(packed, actions, seed, n_steps))
