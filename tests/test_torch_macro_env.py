"""The port's macro env (``envs/macro_env.py``) and shop generators
(``engine/shop_logic.py``) against the reference's, on the CPU.

The reference runs in its production configuration (x64 off: int32
scores, float32 rewards, 32-bit joker draws) out of process: this file
re-invokes itself with ``--mint <npz>``; that process saves

* 64 envs reset from ``split(key(1), 64)`` and stepped 40 times with seeded
  random legal actions by the jitted ``vmap(step)``: every state, reward,
  mask and observation;
* a scripted batch (play-phase states with Faceless Joker, Bloodstone and
  Misprint held, one hand or no discard left; shop-phase states with 0 to
  5000 money, 0, 4, 5, 15 or 16 jokers, the shop partly bought; done envs)
  stepped with every action 0-69: the id-soup cases (a pack-verb buy of a
  joker, id 20 as a joker-verb buy of slot 0, an unaffordable joker still
  appended, an unaffordable reroll, a shop action below 10, a done env)
  are among them;
* ``generate_inventory`` over 256 keys x antes 1-12 x the four voucher
  sets x seeded owned jokers, and ``pop_item``, ``reroll_charge``,
  ``cost_mult`` and ``displayed_reroll_cost`` on seeded inputs.

Tolerances: every int, bool and key exact; rewards bit for bit (the port
multiplies a play's score by the float32 reciprocal of 100, as the
reference's jit does); observations exact.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.engine import shop_logic as TSL
from balatro_gym_tpu_torch.envs import BalatroMacroGymEnv
from balatro_gym_tpu_torch.envs import macro_env as TM
from balatro_gym_tpu_torch.ops import fused_full_rollout as TFF
from balatro_gym_tpu_torch.ops import kernel_rng as KR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS = 64, 40
GEN_KEYS, ANTES = 256, range(1, 13)
FIELDS = [f.name for f in dataclasses.fields(TM.MacroEnvState)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scripted_states(JM, jax, jnp):
    """Play- and shop-phase states for the all-actions sweep."""
    st = jax.vmap(JM.reset)(jax.random.split(jax.random.key(21), 16))
    shop = jax.vmap(JM._end_round)(st)
    jok16 = jnp.arange(1, 17, dtype=jnp.int32) * 7 % 150 + 1
    rows = []
    for i in range(16):
        p = jax.tree.map(lambda x: x[i], st)
        s = jax.tree.map(lambda x: x[i], shop)
        # play phase: scoring jokers with draws (Bloodstone, Misprint) and
        # Faceless, one hand left (the round ends) or no discard left
        jokers = jnp.zeros(16, jnp.int32).at[:4].set(
            jnp.asarray([117, 27, 57, [1, 31, 34, 72][i % 4]], jnp.int32))
        rows.append(p.replace(jokers=jokers, joker_n=jnp.int32(4),
                              hands_left=jnp.int32(1 + (i % 2) * 3),
                              discards_left=jnp.int32(3 * (i % 3 != 0)),
                              purchased_cards=jnp.int32(i)))
        # shop phase: money, jokers held and a partly bought shop
        n_j = [0, 4, 5, 15, 16][i % 5]
        jk = jnp.where(jnp.arange(16) < n_j, jok16, 0)
        jk = jk.at[0].set(jnp.where(n_j > 0, s.shop_item[3], 0))    # the first shop joker held
        chips = jnp.int32([0, 5, 50, 500, 5000, 45][i % 6])
        t, it, c, n = s.shop_type, s.shop_item, s.shop_cost, s.shop_n
        for _ in range(i % 4):
            t, it, c, n = JM.SL.pop_item(t, it, c, n, jnp.int32(0))
        rows.append(s.replace(jokers=jk, joker_n=jnp.int32(n_j), chips=chips,
                              shop_type=t, shop_item=it, shop_cost=c, shop_n=n,
                              vouchers=jnp.uint32(i % 4), reroll_base=jnp.int32(50 + 17 * i),
                              done=jnp.asarray(i == 7)))
    rows[4] = rows[4].replace(done=jnp.asarray(True))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


def _mint(path):
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from balatro_gym_tpu.engine import shop_logic as JSL
    from balatro_gym_tpu.envs import macro_env as JM

    out = {}

    def put(prefix, st):
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            out[f"{prefix}_{f.name}"] = np.asarray(
                jax.vmap(jax.random.key_data)(v) if f.name == "key" else v)

    step, mask = jax.jit(jax.vmap(JM.step)), jax.jit(jax.vmap(JM.action_mask))
    obs = jax.jit(jax.vmap(JM.observe))
    keys = jax.random.split(jax.random.key(1), B)
    out["keys"] = np.asarray(jax.vmap(jax.random.key_data)(keys))
    st = jax.vmap(JM.reset)(keys)
    put("s0", st)
    rng = np.random.default_rng(0)
    for t in range(STEPS):
        m = np.asarray(mask(st))
        a = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in m], np.int32)
        st, r, d = step(st, jnp.asarray(a))
        out[f"a{t}"], out[f"r{t}"], out[f"d{t}"] = a, np.asarray(r), np.asarray(d)
        put(f"s{t + 1}", st)
        for k, v in obs(st).items():
            out[f"o{t + 1}_{k}"] = np.asarray(v)

    sc = _scripted_states(JM, jax, jnp)
    put("sc", sc)
    for a in range(JM.ACTION_SPACE_SIZE):
        nxt, r, _ = step(sc, jnp.full(sc.ante.shape, a, jnp.int32))
        put(f"sc{a}", nxt)
        out[f"sc{a}_reward"] = np.asarray(r)
    for k, v in obs(sc).items():
        out[f"sc_obs_{k}"] = np.asarray(v)

    # the shop's functions
    gkeys = jax.random.split(jax.random.key(5), GEN_KEYS)
    out["gen_keys"] = np.asarray(jax.vmap(jax.random.key_data)(gkeys))
    owned = np.where(rng.random((GEN_KEYS, 5)) < 0.6, rng.integers(0, 151, (GEN_KEYS, 5)), 0)
    out["gen_owned"] = owned.astype(np.int32)
    gen = jax.jit(jax.vmap(JSL.generate_inventory, in_axes=(0, None, 0, None)))
    for ante in ANTES:
        for v in range(4):
            res = gen(gkeys, jnp.int32(ante), jnp.asarray(out["gen_owned"]), jnp.uint32(v))
            for name, x in zip(("types", "items", "costs", "n"), res):
                out[f"gen{ante}_{v}_{name}"] = np.asarray(x)
    n = 1000
    out["pop_in"] = np.stack([rng.integers(0, 5, (n, 10)), rng.integers(0, 60, (n, 10)),
                              rng.integers(0, 2000, (n, 10))]).astype(np.int32)
    out["pop_n"] = rng.integers(0, 11, n).astype(np.int32)
    out["pop_idx"] = rng.integers(0, 10, n).astype(np.int32)
    pop = jax.jit(jax.vmap(JSL.pop_item))
    for name, x in zip(("types", "items", "costs", "n"),
                       pop(*(jnp.asarray(a) for a in out["pop_in"]), jnp.asarray(out["pop_n"]),
                           jnp.asarray(out["pop_idx"]))):
        out[f"popped_{name}"] = np.asarray(x)
    out["eco_base"] = rng.integers(1, 5000, n).astype(np.int32)
    out["eco_ante"] = rng.integers(0, 120, n).astype(np.int32)
    out["eco_vou"] = rng.integers(0, 4, n).astype(np.uint32)
    args = [jnp.asarray(out[k]) for k in ("eco_base", "eco_ante", "eco_vou")]
    cost, nxt = jax.jit(jax.vmap(JSL.reroll_charge))(*args)
    out["eco_cost"], out["eco_next"] = np.asarray(cost), np.asarray(nxt)
    out["eco_mult"] = np.asarray(jax.jit(jax.vmap(JSL.cost_mult))(*args[1:]))
    out["eco_shown"] = np.asarray(jax.jit(jax.vmap(JSL.displayed_reroll_cost))(*args[1:]))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mint") / "macro.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--mint", path],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return dict(np.load(path))


def state(m, prefix):
    """The port's MacroEnvState from the reference's saved fields."""
    out = {}
    for name in FIELDS:
        v = m[f"{prefix}_{name}"]
        if name == "key":
            out[name] = torch.as_tensor(v.astype(np.uint32).astype(np.int64))
        elif v.dtype == np.bool_:
            out[name] = torch.as_tensor(v)
        else:
            out[name] = torch.as_tensor(v.astype(np.int32))
    return TM.MacroEnvState(**out)


def assert_state(got, m, prefix):
    want = state(m, prefix)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, (prefix, name, g.dtype)
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{prefix}: {name}")


def test_random_legal_rollout_matches_reference(minted):
    """reset, step, action_mask and observe over 64 envs x 40 steps."""
    st = TM.reset(torch.as_tensor(minted["keys"].astype(np.uint32).astype(np.int64)))
    assert_state(st, minted, "s0")
    seen = set()
    for t in range(STEPS):
        mask = TM.action_mask(st)
        a = torch.as_tensor(minted[f"a{t}"])
        assert mask.gather(1, a.long()[:, None]).all(), t     # the reference's draw is legal here
        seen |= set(minted[f"a{t}"].tolist())
        st, r, d = TM.step(st, a)
        assert r.dtype == torch.float32 and d.dtype == torch.bool
        np.testing.assert_array_equal(r.numpy(), minted[f"r{t}"], err_msg=f"reward {t}")
        np.testing.assert_array_equal(d.numpy(), minted[f"d{t}"], err_msg=f"done {t}")
        assert_state(st, minted, f"s{t + 1}")
        for k, v in TM.observe(st).items():
            assert v.dtype == torch.int32, k
            np.testing.assert_array_equal(v.numpy(), minted[f"o{t + 1}_{k}"], err_msg=f"{t} {k}")
    assert int(st.ante.max()) >= 3 and {0, 6, 10, 11} <= seen


def test_every_action_from_scripted_states_matches_reference(minted):
    """Every action 0-69 from play-phase, shop-phase and done states: the
    id soup, the freezes and the play-phase no-ops."""
    sc = state(minted, "sc")
    for k, v in TM.observe(sc).items():
        np.testing.assert_array_equal(v.numpy(), minted[f"sc_obs_{k}"], err_msg=k)
    for a in range(TM.ACTION_SPACE_SIZE):
        nxt, r, d = TM.step(sc, torch.full(sc.ante.shape, a, dtype=torch.int32))
        np.testing.assert_array_equal(r.numpy(), minted[f"sc{a}_reward"], err_msg=f"action {a}")
        assert_state(nxt, minted, f"sc{a}")
        assert torch.equal(d, nxt.done)
    # the cases are there: a pack-verb buy of a joker adds it, an
    # unaffordable joker is still appended, id 20 buys slot 0 by the joker verb
    shop = sc.phase == TM.PHASE_SHOP
    j15 = TM.step(sc, torch.full(sc.ante.shape, TM.A_PACK + 3, dtype=torch.int32))[0]
    added = shop & ~sc.done & (j15.joker_n == sc.joker_n + 1)
    assert (added & (j15.chips == sc.chips)).any() and (added & (j15.chips < sc.chips)).any()
    r_low = TM.step(sc, torch.full(sc.ante.shape, 3, dtype=torch.int32))[1]
    assert (r_low[shop & ~sc.done] == -1.0).all() and (r_low[sc.done] == 0.0).all()


def test_generators_match_reference(minted):
    keys = torch.as_tensor(minted["gen_keys"].astype(np.uint32).astype(np.int64))
    owned = torch.as_tensor(minted["gen_owned"])
    for ante in ANTES:
        for v in range(4):
            got = TSL.generate_inventory(keys, torch.full((GEN_KEYS,), ante, dtype=torch.int32),
                                         owned, torch.full((GEN_KEYS,), v, dtype=torch.int32))
            for name, x in zip(("types", "items", "costs", "n"), got):
                assert x.dtype == torch.int32
                np.testing.assert_array_equal(x.numpy(), minted[f"gen{ante}_{v}_{name}"],
                                              err_msg=f"ante {ante} vouchers {v}: {name}")
            items = got[1][:, 3:6].numpy()
            assert not (items[:, :, None] == minted["gen_owned"][:, None, :]).any()
    got = TSL.pop_item(*(torch.as_tensor(a) for a in minted["pop_in"]),
                       torch.as_tensor(minted["pop_n"]), torch.as_tensor(minted["pop_idx"]))
    for name, x in zip(("types", "items", "costs", "n"), got):
        np.testing.assert_array_equal(x.numpy(), minted[f"popped_{name}"], err_msg=name)
    base, ante = (torch.as_tensor(minted[k]) for k in ("eco_base", "eco_ante"))
    vou = torch.as_tensor(minted["eco_vou"].astype(np.int32))
    cost, nxt = TSL.reroll_charge(base, ante, vou)
    np.testing.assert_array_equal(cost.numpy(), minted["eco_cost"])
    np.testing.assert_array_equal(nxt.numpy(), minted["eco_next"])
    np.testing.assert_array_equal(TSL.cost_mult(ante, vou).numpy(), minted["eco_mult"])
    np.testing.assert_array_equal(TSL.displayed_reroll_cost(ante, vou).numpy(),
                                  minted["eco_shown"])


def test_generator_equals_the_rollouts_shop_gen():
    """``generate_inventory`` and the fused rollout's plain ``_shop_gen``
    (its ``[10, B]`` layout) on the same keys, antes, vouchers and jokers."""
    rng = np.random.default_rng(3)
    n = 2048
    k1, k2 = (torch.as_tensor(rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64))
              for _ in range(2))
    ante = torch.as_tensor(rng.integers(1, 101, n).astype(np.int32))
    vou = torch.as_tensor(rng.integers(0, 4, n).astype(np.int32))
    jok = torch.as_tensor(np.where(rng.random((n, 5)) < 0.5, rng.integers(1, 151, (n, 5)), 0)
                          .astype(np.int32))
    types, items, costs, mult = TFF._shop_gen({"vou": vou, "jok": jok.T.contiguous()},
                                              (k1, k2), ante)
    got = TSL.generate_inventory(torch.stack([k1, k2], 1), ante, jok, vou)
    for name, g, w in zip(("types", "items", "costs"), got, (types, items, costs)):
        np.testing.assert_array_equal(g.numpy(), w.T.numpy(), err_msg=name)
    np.testing.assert_array_equal(TSL.cost_mult(ante, vou).numpy(), mult.numpy())


def test_shell_contract():
    """tests/test_wrappers_macro.py's contract test on the port's shell."""
    env = BalatroMacroGymEnv(seed=3, device="cpu")
    obs, _ = env.reset()
    assert obs["hand"].shape == (8,)
    assert obs["action_mask"].shape == (70,)
    assert (obs["hand"] >= 0).all() and (obs["hand"] < 52).all()
    rng = np.random.default_rng(1)
    for _ in range(40):
        legal = np.flatnonzero(obs["action_mask"])
        assert len(legal) > 0
        obs, r, done, _, _ = env.step(int(rng.choice(legal)))
        assert np.isfinite(r)
        if done:
            break
    assert int(obs["ante"]) >= 2


def test_best_play_macro_scores_at_least_first5():
    """tests/test_wrappers_macro.py's macro comparison on the port."""
    st = TM.reset(torch.stack(KR.seed_key(0)).view(1, 2))
    _, r_best, _ = TM.step(st, torch.tensor([0]))
    _, r_f5, _ = TM.step(st, torch.tensor([1]))
    assert float(r_best[0]) >= float(r_f5[0])


def test_shell_matches_the_reference_shell():
    """The port's shell against the reference's at its production widths
    (x64 off), same seed and actions."""
    import jax
    from balatro_gym_tpu.envs.macro_env import BalatroMacroGymEnv as JEnv
    with jax.enable_x64(False):
        _shells_agree(JEnv)


def _shells_agree(JEnv):
    ours, ref = BalatroMacroGymEnv(seed=11, device="cpu"), JEnv(seed=11)
    (o1, _), (o2, _) = ours.reset(), ref.reset()
    rng = np.random.default_rng(2)
    for t in range(30):
        assert o1.keys() == o2.keys()
        for k in o2:
            assert o1[k].dtype == np.int32 and np.array_equal(o1[k], o2[k]), (t, k)
        a = int(rng.choice(np.flatnonzero(o2["action_mask"])))
        o1, r1, d1, _, _ = ours.step(a)
        o2, r2, d2, _, _ = ref.step(a)
        assert np.float32(r1) == np.float32(r2) and d1 == d2, t
        if d2:
            break


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        BalatroMacroGymEnv()


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
