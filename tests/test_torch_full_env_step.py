"""The port's flagship-env ``step``, ``step_autoreset`` and ``observe``
against the reference engine's, on the CPU.

The reference runs in the x64-off production configuration while
tests/conftest.py turns x64 on, so the JAX side runs out of process: this
file re-invokes itself with ``--mint <npz>``, and that process

* resets 256 envs with ``vmap(full_env.reset)`` over ``split(key(0),
  256)``, runs a 4-step legal prelude with ``step_autoreset``, then the
  state surgery of scripts/fused_full_common.py (boss, consumable, joker,
  card-modifier and near-beat lanes), and plants lanes on their last hand
  (plays that fail end the episode), lanes at ante 5, and lanes already
  over: a career past the score cap, ante 101, ``done`` set;
* for 8 steps draws coverage-biased legal actions, with an illegal one in
  every 11th env, and saves every field of the state, ``vmap(observe)``,
  ``vmap(observe_vector)`` and ``vmap(action_mask)`` of it, and the outputs
  of the jitted ``vmap(step)`` and ``vmap(step_autoreset)`` from it; the
  chain goes on from ``step_autoreset``'s state;
* runs the reference's whole-rollout kernel's plain step
  (``rollout_full_rows``, one step, under ``jax.disable_jit()``) on the
  first state, padded to the kernel's 1024-env tile by copies.

Tolerances. Every integer and bool field and ``done`` exact, autoresets
included (the engine's permutation shuffle on both sides). Rewards within
PARITY #B11's 1e-4: XLA's jit contracts the reward's multiply-add chains
into FMAs, torch does not. The observation dict exact in keys, values and
dtypes. ``observe_vector``, computed eagerly on the JAX side (XLA's jit on
the CPU multiplies by a reciprocal where the port divides), bit for bit
but its ``log1p`` row, within 1 ulp (math libraries). The plain no-reset step against the kernel's plain step, which ran
op by op: the packed rows and rewards bit for bit where no env ended
(where one did, the kernel resets it and the engine's step does not).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.engine import full_env as TFE
from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as TF
from balatro_gym_tpu_torch.ops import fused_policy_rollout as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
STEPS = 8
PRELUDE = 4
SEED = 0
SURGERY_SEED = 777
TILE = 1024          # the reference kernel's env tile
REWARD_ATOL = 1e-4   # PARITY #B11
LOG1P_ROW = TP.OBS_DIM - 6   # log1p(chips_needed) / 10: math libraries may differ by 1 ulp
FIELDS = [f.name for f in dataclasses.fields(TFE.FullEnvState)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's torch ops are many and small: one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The out-of-process JAX side
# ---------------------------------------------------------------------------


def _mint(path):
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import jax.numpy as jnp

    from balatro_gym_tpu.engine import full_env as fe
    from balatro_gym_tpu.ops import fused_full_rollout as FF
    import fused_full_common as FC
    from fused_full_common import sample_legal, surgery

    FC.B = N          # the script's batch, read by its surgery
    out = {}

    def put_state(prefix, st):
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            out[f"{prefix}_{f.name}"] = np.asarray(
                jax.vmap(jax.random.key_data)(v) if f.name == "key" else v)

    st = jax.vmap(fe.reset)(jax.random.split(jax.random.key(SEED), N))
    rng = np.random.default_rng(SEED + 13)
    step_j = jax.jit(jax.vmap(fe.step))
    auto_j = jax.jit(jax.vmap(fe.step_autoreset))
    mask_j = jax.jit(jax.vmap(fe.action_mask))
    obs_j = jax.jit(jax.vmap(fe.observe))
    vec_v = jax.vmap(fe.observe_vector)      # eager, op by op: IEEE divisions
    for _ in range(PRELUDE):
        st, _, _ = auto_j(st, jnp.asarray(sample_legal(np.asarray(mask_j(st)), rng)))
    st = surgery(st, np.random.default_rng(SURGERY_SEED))
    env = np.arange(N)
    phase = np.asarray(st.phase)
    st = st.replace(
        hands_left=jnp.asarray(np.where((env % 8 == 3) & (phase == 0), 1,
                                        np.asarray(st.hands_left))),
        ante=jnp.asarray(np.where(env % 16 == 9, 5, np.where(env % 64 == 21, 101,
                                                              np.asarray(st.ante)))),
        chips_scored=jnp.asarray(np.where(env % 64 == 5, 1_000_000_001,
                                          np.asarray(st.chips_scored))),
        done=jnp.asarray(np.asarray(st.done) | (env % 64 == 37)))

    st0 = st
    acts = np.zeros((STEPS, N), np.int32)
    for t in range(STEPS):
        put_state(f"pre{t}", st)
        mask = np.asarray(mask_j(st))
        out[f"pre{t}_mask"] = mask
        out[f"pre{t}_vector"] = np.asarray(vec_v(st))
        for k, v in obs_j(st).items():
            out[f"pre{t}_obs_{k}"] = np.asarray(v)
        acts[t] = sample_legal(mask, rng)
        for e in np.flatnonzero(env % 11 == t % 11):
            illegal = np.flatnonzero(~mask[e])
            acts[t, e] = rng.choice(illegal)
        a = jnp.asarray(acts[t])
        s1, r1, d1 = step_j(st, a)
        put_state(f"step{t}", s1)
        out[f"step{t}_out_reward"], out[f"step{t}_out_done"] = np.asarray(r1), np.asarray(d1)
        st, r2, d2 = auto_j(st, a)
        put_state(f"auto{t}", st)
        out[f"auto{t}_out_reward"], out[f"auto{t}_out_done"] = np.asarray(r2), np.asarray(d2)
    out["acts"] = acts

    # The reference kernel's plain step from the first state, op by op.
    first = jax.tree.map(lambda *xs: jnp.concatenate(xs), *[st0] * (TILE // N))
    with jax.disable_jit():
        res = FF.rollout_full_rows(first, np.tile(acts[:1], (1, TILE // N)), 1)
    for k, v in FF.pack_full_state(res["state"]).items():
        out[f"rows_{k}"] = np.asarray(v)[..., :N]
    out["rows_reward"] = np.asarray(res["total_reward"])[:N]
    out["rows_episodes"] = np.asarray(res["episodes"])[:N]
    np.savez(path, **out)


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mint") / "full_env_step.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--mint", path],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return dict(np.load(path))


def state_from_fields(m, prefix):
    """The port's FullEnvState from the reference's saved fields (uint32
    bitsets as int32 bit patterns, key words and counters as int64)."""
    out = {}
    for name in FIELDS:
        v = m[f"{prefix}_{name}"]
        if name in ("key", "rng_counters"):
            out[name] = torch.as_tensor(v.astype(np.uint32).astype(np.int64))
        elif v.dtype == np.bool_:
            out[name] = torch.as_tensor(v)
        else:
            out[name] = torch.as_tensor(v.view(np.int32) if v.dtype == np.uint32
                                        else v.astype(np.int32))
    return TFE.FullEnvState(**out)


def assert_states(got, m, prefix, what):
    want = state_from_fields(m, prefix)
    bad = TF.states_equal(got, want)
    assert bad == [], f"{what}: fields differ: {bad}"


# ---------------------------------------------------------------------------
# step and step_autoreset
# ---------------------------------------------------------------------------


def test_step_matches_engine(minted):
    """Every field exact after each step; done exact; rewards within 1e-4.
    Invalid, frozen (already over) and terminating steps all occur."""
    cov = BAT.coverage(minted["acts"])
    assert all(v > 0 for v in cov.values()), cov
    seen = {"illegal": 0, "over": 0, "ended": 0}
    for t in range(STEPS):
        pre = state_from_fields(minted, f"pre{t}")
        a = torch.as_tensor(minted["acts"][t])
        st, reward, done = TFE.step(pre, a)
        assert reward.dtype == torch.float32 and done.dtype == torch.bool
        assert_states(st, minted, f"step{t}", f"step {t}")
        np.testing.assert_array_equal(done.numpy(), minted[f"step{t}_out_done"])
        np.testing.assert_allclose(reward.numpy(), minted[f"step{t}_out_reward"], rtol=0,
                                   atol=REWARD_ATOL)
        legal = minted[f"pre{t}_mask"][np.arange(N), minted["acts"][t]]
        over = pre.done.numpy() | (pre.ante.numpy() > 100) | (pre.chips_scored.numpy() > 1e9)
        seen["illegal"] += int((~legal & ~over).sum())
        seen["over"] += int(over.sum())
        seen["ended"] += int((done.numpy() & ~over).sum())
        assert (reward.numpy()[~legal & ~over] == -1.0).all()
        assert (reward.numpy()[over] == 0.0).all() and done.numpy()[over].all()
    print("coverage:", cov, seen)
    assert all(v > 0 for v in seen.values()), seen


def test_step_autoreset_matches_engine(minted):
    """Integer state exact across autoresets (the engine's permutation
    shuffle of ``fold_in(key, step_count)``)."""
    resets = 0
    for t in range(STEPS):
        pre = state_from_fields(minted, f"pre{t}")
        st, reward, done = TFE.step_autoreset(pre, torch.as_tensor(minted["acts"][t]))
        assert_states(st, minted, f"auto{t}", f"step_autoreset {t}")
        np.testing.assert_array_equal(done.numpy(), minted[f"auto{t}_out_done"])
        np.testing.assert_allclose(reward.numpy(), minted[f"auto{t}_out_reward"], rtol=0,
                                   atol=REWARD_ATOL)
        assert not bool(st.done.any())
        resets += int(done.sum())
    print(f"autoresets: {resets}")
    assert resets > 0


def test_observe_matches_engine(minted):
    """The Dict observation: the same keys, values and dtypes; the policy
    inputs too."""
    for t in range(STEPS):
        st = state_from_fields(minted, f"pre{t}")
        got = TFE.observe(st)
        keys = sorted(k[len(f"pre{t}_obs_"):] for k in minted if k.startswith(f"pre{t}_obs_"))
        assert sorted(got) == keys
        for k in keys:
            want = minted[f"pre{t}_obs_{k}"]
            g = got[k].numpy()
            assert g.dtype == want.dtype and g.shape == want.shape, (k, g.dtype, want.dtype)
            np.testing.assert_array_equal(g, want, err_msg=f"step {t}: {k}")
        np.testing.assert_array_equal(TFE.action_mask(st).numpy(), minted[f"pre{t}_mask"])
        vec, want = TFE.observe_vector(st).numpy(), minted[f"pre{t}_vector"]
        other = np.arange(TP.OBS_DIM) != LOG1P_ROW
        np.testing.assert_array_equal(vec[:, other], want[:, other])
        ulp = np.abs(vec[:, LOG1P_ROW].view(np.int32).astype(np.int64)
                     - want[:, LOG1P_ROW].view(np.int32))
        assert ulp.max() <= 1, f"step {t}: log1p row off by {ulp.max()} ulp"


# ---------------------------------------------------------------------------
# The plain no-reset step against the reference kernel's step
# ---------------------------------------------------------------------------


def test_plain_no_reset_step_matches_kernel_rows(minted):
    pre = state_from_fields(minted, "pre0")
    a = torch.as_tensor(minted["acts"][0])
    s, reward, done = TF._step(TF._load(TF.pack_full_state(pre)), a, autoreset=False)
    rows = TF._store(s)
    np.testing.assert_array_equal(done.numpy(), minted["rows_episodes"] > 0)
    live = ~done.numpy()
    assert live.sum() > N // 2 and (~live).sum() > 0
    for k in ("cards", "ints", "rng"):
        got = rows[k].numpy()
        want = minted[f"rows_{k}"]
        want = want.astype(np.uint32).view(np.int32) if k == "rng" else want
        np.testing.assert_array_equal(got[..., live], want[..., live], err_msg=k)
    np.testing.assert_array_equal(reward.numpy(), minted["rows_reward"])
    # the same step through the wrapper on the CPU
    packed, r2, d2 = TP.env_step_fused(TF.pack_full_state(pre), a, device="cpu")
    assert all(torch.equal(packed[k], rows[k]) for k in rows)
    assert torch.equal(r2, reward) and torch.equal(d2, done)


def test_plain_step_with_autoreset_is_the_kernels_step():
    """``_step``'s default is still the rollout kernel's autoreset step:
    where no env ends the two forms agree, and ends reset with the sort."""
    packed = TF.pack_full_state(TF.default_reset(5, 64, "cpu"))
    for (p, a), ends in zip(BAT.reset_batches(packed), (False, True)):
        s_auto, r_auto, d_auto = TF._step(TF._load(p), a)
        s_eng, r_eng, d_eng = TF._step(TF._load(p), a, autoreset=False)
        assert bool((d_auto == ends).all()) and torch.equal(d_auto, d_eng)
        assert torch.equal(r_auto, r_eng)
        same = all(torch.equal(TF._store(s_auto)[k], TF._store(s_eng)[k]) for k in p)
        assert same != ends
        if ends:
            assert bool(s_eng["done"].all()) and not bool(s_auto["done"].any())


def test_env_step_device_rules(monkeypatch):
    """The wrapper runs the plain version only on the CPU's tensors; with no
    device it runs on the card, and raises where there is none."""
    st = TF.default_reset(2, 8, "cpu")
    packed, a = TF.pack_full_state(st), torch.full((8,), 46, dtype=torch.int32)
    n0 = TP.env_step_fused.launches
    TP.env_step_fused(packed, a, device="cpu")
    TFE.step(st, a)
    assert TP.env_step_fused.launches == n0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TP.env_step_fused(packed, a)
    assert TP.env_step_fused.launches == n0


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
