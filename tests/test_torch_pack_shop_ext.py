"""The port's pack opening and modular shop rules (``engine/pack_logic.py``,
``engine/shop_ext.py``) against the reference's, on the CPU.

Each case of tests/test_pack_logic.py and tests/test_shop_ext.py runs on
the port (a batch of one env) and on the reference from the same inputs:
every state field, pack field, reward and sale result is equal, and the
reference test's own assertions hold on the port's values. Rewards are
compared bit for bit; the reference runs eagerly here, as its tests call
it, so ``value / 10`` is an IEEE division on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balatro_gym_tpu.core.constants import Action, Phase
from balatro_gym_tpu.engine import consumable_logic as CL
from balatro_gym_tpu.engine import full_env as JFE
from balatro_gym_tpu.engine import pack_logic as JPK
from balatro_gym_tpu.engine import shop_ext as JSE
from balatro_gym_tpu.engine.shop_logic import IT_CARD, IT_JOKER, IT_PACK, IT_VOUCHER
from balatro_gym_tpu.ops.joker_tables import (
    J_EGG, J_GIFT_CARD, J_JOKER, J_LUCHADOR, J_SWASHBUCKLER, JOKER_BASE_COST_NP)
from balatro_gym_tpu_torch.engine import full_env as TFE
from balatro_gym_tpu_torch.engine import pack_logic as TPK
from balatro_gym_tpu_torch.engine import shop_ext as TSE

SEL0 = Action.SELECT_FROM_PACK_BASE
FIELDS = [f.name for f in dataclasses.fields(TFE.FullEnvState)]


# ---------------------------------------------------------------------------
# pack_logic: both sides from the same state and contents
# ---------------------------------------------------------------------------


def port_state(jst):
    """A reference FullEnvState of one env as the port's batch of one."""
    out = {}
    for name in FIELDS:
        v = getattr(jst, name)
        v = np.asarray(jax.random.key_data(v) if name == "key" else v)[None]
        if name in ("key", "rng_counters"):
            out[name] = torch.as_tensor(v.astype(np.uint32).astype(np.int64))
        elif v.dtype == np.bool_:
            out[name] = torch.as_tensor(v)
        else:
            out[name] = torch.as_tensor(v.astype(np.int64).astype(np.int32))
    return TFE.FullEnvState(**out)


class Both:
    """The reference's (state, pack) and the port's, stepped together."""

    def __init__(self, jst, kinds, ids, mega=False, **mods):
        self.j = JPK.open_pack(jst, jnp.asarray(kinds, jnp.int32), jnp.asarray(ids, jnp.int32),
                               mega=mega, **{k: jnp.asarray(v, jnp.int32) for k, v in mods.items()})
        self.t = TPK.open_pack(port_state(jst), torch.tensor([kinds]), torch.tensor([ids]),
                               mega=mega, **{k: torch.tensor([v]) for k, v in mods.items()})
        self.check()

    def check(self):
        js, jp = self.j
        ts, tp = self.t
        want = port_state(js)
        for name in FIELDS:
            assert torch.equal(getattr(ts, name), getattr(want, name)), name
        for f in dataclasses.fields(tp):
            np.testing.assert_array_equal(getattr(tp, f.name)[0].numpy(),
                                          np.asarray(getattr(jp, f.name)), err_msg=f.name)

    def step(self, action):
        js, jp, jr = JPK.step_pack(*self.j, jnp.int32(action))
        ts, tp, tr = TPK.step_pack(*self.t, torch.tensor([action]))
        self.j, self.t = (js, jp), (ts, tp)
        self.check()
        assert tr.dtype == torch.float32 and tr[0].item() == float(jr)
        return tr[0].item()

    @property
    def st(self):
        return self.t[0]

    @property
    def pack(self):
        return self.t[1]


@pytest.fixture(scope="module")
def st0():
    return JFE.reset(jax.random.key(7))


def test_open_sets_phase_and_picks(st0):
    b = Both(st0, [TPK.K_CARD] * 5, [0, 1, 2, 3, 4])
    assert int(b.st.phase[0]) == Phase.PACK_OPEN and int(b.pack.picks_left[0]) == 1
    assert int(Both(st0, [TPK.K_CARD] * 5, [0] * 5, mega=True).pack.picks_left[0]) == 2


def test_card_pick_joins_deck_with_modifiers(st0):
    b = Both(st0, [TPK.K_CARD] * 5, [14] * 5, item_enh=[2] * 5, item_ed=[1] * 5,
             item_seal=[3] * 5)
    alive0 = b.st.card_alive[0].clone()
    assert b.step(SEL0) == 10.0                 # +3 base +2 enh +3 edition +2 seal
    assert int(b.st.phase[0]) == Phase.SHOP and not bool(b.pack.active[0])
    (slot,) = torch.nonzero(b.st.card_alive[0] & ~alive0)[:, 0].tolist()
    assert slot == 63
    assert [int(getattr(b.st, c)[0, slot]) for c in
            ("card_rank", "card_suit", "card_enh", "card_ed", "card_seal")] == [3, 1, 2, 1, 3]


def test_consumable_pick_rewards_by_family(st0):
    for cid, want in ((CL.TAROT_BASE + 4, 5.0), (CL.PLANET_BASE + 2, 8.0),
                      (CL.SPECTRAL_BASE + 1, 10.0)):
        b = Both(st0, [TPK.K_CONSUMABLE] * 5, [cid] * 5)
        assert b.step(SEL0 + 1) == want
        assert int(b.st.cons_n[0]) == int(st0.cons_n) + 1 and int(b.st.cons[0, 0]) == cid


def test_consumable_pick_full_slots_minus_one(st0):
    full = st0.replace(cons=jnp.full(5, CL.HERMIT, jnp.int32), cons_n=st0.cons_slots)
    b = Both(full, [TPK.K_CONSUMABLE] * 5, [CL.HERMIT] * 5)
    assert b.step(SEL0) == -1.0
    assert int(b.st.cons_n[0]) == int(full.cons_n) and int(b.st.phase[0]) == Phase.SHOP


def test_joker_pick(st0):
    b = Both(st0, [TPK.K_JOKER] * 5, [31] * 5)
    assert b.step(SEL0 + 2) == 15.0
    assert int(b.st.joker_n[0]) == 1 and int(b.st.jokers[0, 0]) == 31
    cap = st0.replace(jokers=jnp.full(5, 1, jnp.int32), joker_n=jnp.int32(5))
    b = Both(cap, [TPK.K_JOKER] * 5, [31] * 5)
    assert b.step(SEL0) == -1.0 and int(b.st.joker_n[0]) == 5


def test_mega_two_picks_and_duplicate_rejected(st0):
    b = Both(st0, [TPK.K_CONSUMABLE] * 5, [CL.TAROT_BASE + i for i in range(5)], mega=True)
    assert b.step(SEL0) == 5.0 and int(b.st.phase[0]) == Phase.PACK_OPEN
    assert b.step(SEL0) == -1.0 and int(b.pack.picks_left[0]) == 1     # a repeated pick
    assert b.step(SEL0 + 3) == 5.0
    assert int(b.st.phase[0]) == Phase.SHOP and not bool(b.pack.active[0])
    assert int(b.st.cons_n[0]) == 2


def test_skip_penalty(st0):
    b = Both(st0, [TPK.K_CARD] * 5, [0] * 5, mega=True)
    assert b.step(Action.SKIP_PACK) == -2.0
    assert int(b.st.phase[0]) == Phase.SHOP and not bool(b.pack.active[0])


def test_out_of_range_and_inactive(st0):
    b = Both(st0, [TPK.K_CARD] * 5, [0] * 5)
    assert b.step(0) == -1.0                     # not a pack action
    b.step(Action.SKIP_PACK)
    assert b.step(SEL0) == -1.0                  # the pack is closed


def test_unknown_kind_is_paid_as_a_joker_and_changes_nothing(st0):
    """The reference's reward select falls through to the joker branch for
    any other kind, while no branch's state is taken."""
    b = Both(st0, [7] * 5, [31] * 5)
    assert b.step(SEL0) == 15.0
    assert int(b.st.joker_n[0]) == int(st0.joker_n) and int(b.st.phase[0]) == Phase.SHOP


def test_batched_packs_step_per_env():
    """Envs of one batch open different packs and take different actions."""
    keys = jax.random.split(jax.random.key(3), 4)
    js = [JFE.reset(k) for k in keys]
    kinds = [[TPK.K_CARD] * 5, [TPK.K_CONSUMABLE] * 5, [TPK.K_JOKER] * 5, [TPK.K_CARD] * 5]
    ids = [[5] * 5, [CL.PLANET_BASE] * 5, [12] * 5, [40] * 5]
    acts = [SEL0, SEL0 + 4, Action.SKIP_PACK, 3]
    singles = [Both(j, k, i) for j, k, i in zip(js, kinds, ids)]
    ports = [port_state(j) for j in js]
    batch = TFE.FullEnvState(**{n: torch.cat([getattr(p, n) for p in ports]) for n in FIELDS})
    st, pack = TPK.open_pack(batch, torch.tensor(kinds), torch.tensor(ids))
    st, pack, r = TPK.step_pack(st, pack, torch.tensor(acts))
    for e, (b, a) in enumerate(zip(singles, acts)):
        assert r[e].item() == b.step(a)
        for name in FIELDS:
            assert torch.equal(getattr(st, name)[e], getattr(b.st, name)[0]), (e, name)


# ---------------------------------------------------------------------------
# shop_ext: the sale, the rewards, the tables
# ---------------------------------------------------------------------------


def mk(jokers, eternal=(), money=50, sold=0):
    jok = np.zeros(5, np.int32)
    jok[:len(jokers)] = jokers
    et = np.zeros(5, bool)
    et[list(eternal)] = True
    return jok, len(jokers), et, money, sold


def sell(args, idx):
    """The port's sale (a batch of one) after checking it against the
    reference's on the same inputs; returns the port's result, unbatched."""
    jok, n, et, money, sold = args
    want = JSE.sell_joker(jnp.asarray(jok), jnp.int32(n), jnp.asarray(et), jnp.int32(money),
                          jnp.int32(sold), idx=idx)
    got = TSE.sell_joker(torch.tensor([jok]), torch.tensor([n], dtype=torch.int32),
                         torch.tensor([et]), torch.tensor([money], dtype=torch.int32),
                         torch.tensor([sold], dtype=torch.int32),
                         torch.tensor([idx], dtype=torch.int32))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w), err_msg=name)
        assert g.dtype in (torch.int32, torch.bool, torch.float32), name
    return type(got)(*(g[0] for g in got))


def test_base_sell_value_formula():
    ids = torch.arange(len(TSE.SELL_VALUE))
    np.testing.assert_array_equal(TSE.sell_value(ids).numpy(), np.asarray(JSE.SELL_VALUE))
    assert int(TSE.sell_value(torch.tensor(J_JOKER))) == 3
    costly = int(np.argmax(JOKER_BASE_COST_NP))
    assert int(TSE.sell_value(torch.tensor(costly))) == max(3, int(JOKER_BASE_COST_NP[costly]) // 2)


def test_egg_and_gift_card_sell_values():
    assert int(TSE.sell_value(torch.tensor(J_EGG))) == 5
    assert int(TSE.sell_value(torch.tensor(J_GIFT_CARD))) == 0


def test_sell_joker_basic():
    res = sell(mk([J_JOKER, J_EGG]), 0)
    assert int(res.joker_n) == 1 and int(res.jokers[0]) == J_EGG and int(res.jokers[1]) == 0
    assert int(res.money) == 53 and float(res.reward) == pytest.approx(0.3)
    assert int(res.jokers_sold) == 1


def test_eternal_block():
    res = sell(mk([J_JOKER, J_EGG], eternal=(0,)), 0)
    assert float(res.reward) == -1.0 and int(res.joker_n) == 2 and int(res.money) == 50
    res = sell(mk([J_JOKER, J_EGG], eternal=(0,)), 1)
    assert float(res.reward) == pytest.approx(0.5) and bool(res.eternal[0])


def test_gift_card_sells_for_nothing():
    res = sell(mk([J_GIFT_CARD]), 0)
    assert (int(res.joker_n), int(res.money), float(res.reward), int(res.jokers_sold)) == \
        (0, 50, 0.0, 1)


def test_luchador_sale_effect():
    assert bool(sell(mk([J_LUCHADOR]), 0).boss_disabled)
    assert not bool(sell(mk([J_JOKER]), 0).boss_disabled)


def test_swashbuckler_bonus_counts_itself():
    res = sell(mk([J_SWASHBUCKLER], sold=2), 0)
    assert int(res.swash_bonus) == 3
    assert int(res.money) == 50 + int(TSE.sell_value(torch.tensor(J_SWASHBUCKLER))) + 3


def test_invalid_index():
    res = sell(mk([J_JOKER]), 3)
    assert float(res.reward) == -1.0 and int(res.joker_n) == 1


def test_purchase_rewards():
    types = torch.arange(-1, 9)
    np.testing.assert_array_equal(TSE.purchase_reward(types).numpy(),
                                  np.asarray(JSE.purchase_reward(jnp.arange(-1, 9))))
    assert [float(TSE.purchase_reward(torch.tensor(t))) for t in
            (IT_PACK, IT_JOKER, IT_CARD, IT_VOUCHER)] == [5.0, 15.0, 3.0, 10.0]


def test_voucher_table():
    assert TSE.VOUCHER_EFFECTS == JSE.VOUCHER_EFFECTS
    assert TSE.VOUCHER_NAMES_16 == JSE.VOUCHER_NAMES_16 and len(TSE.VOUCHER_NAMES_16) == 16
    np.testing.assert_array_equal(TSE.VOUCHER_KIND, np.asarray(JSE.VOUCHER_KIND))
    np.testing.assert_array_equal(TSE.VOUCHER_MAG, np.asarray(JSE.VOUCHER_MAG))
    for name in (*TSE.VOUCHER_NAMES_16, "Nope"):
        assert TSE.voucher_effect(name) == JSE.voucher_effect(name)
    assert TSE.voucher_effect("Liquidation") == "All items in shop are 50% off"
    i = TSE.VOUCHER_NAMES_16.index("Clearance Sale")
    assert (TSE.VOUCHER_KIND[i], TSE.VOUCHER_MAG[i]) == (TSE.VE_DISCOUNT_PCT, 25)


def test_every_sale_of_a_seeded_batch_matches_reference():
    """64 seeded sales in one batch (every slot index, eternal masks, joker
    counts 0-5) against the reference's, env by env."""
    rng = np.random.default_rng(0)
    n = 64
    jok = rng.integers(1, 151, (n, 5)).astype(np.int32)
    jn = rng.integers(0, 6, n).astype(np.int32)
    jok[np.arange(5) >= jn[:, None]] = 0
    jok[:8, 0] = [J_EGG, J_GIFT_CARD, J_LUCHADOR, J_SWASHBUCKLER] * 2
    et = rng.random((n, 5)) < 0.2
    money = rng.integers(0, 100, n).astype(np.int32)
    sold = rng.integers(0, 5, n).astype(np.int32)
    idx = rng.integers(-1, 6, n).astype(np.int32)
    got = TSE.sell_joker(*(torch.as_tensor(x) for x in (jok, jn, et, money, sold, idx)))
    want = jax.vmap(JSE.sell_joker)(*(jnp.asarray(x) for x in (jok, jn, et, money, sold, idx)))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
