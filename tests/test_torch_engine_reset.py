"""The port's engine reset, its plain packed-row form
(``ops.fused_policy_rollout.env_reset_rows_reference``, the plain version of
``env_reset_kernel``) and the CPU forms of ``full_env.reset``,
``autoreset`` and ``step_autoreset``, against the reference engine's, on
the CPU.

The reference runs in the x64-off production configuration while
tests/conftest.py turns x64 on, so its side runs out of process: this file
re-invokes itself with ``--mint <npz>``, and that process

* resets 1024 envs with ``vmap(full_env.reset)`` over ``split(key(3),
  1024)`` (the fresh mode's keys);
* runs a 5-step legal prelude with ``step_autoreset``, plants ante 101 in
  every 7th env and one hand left in every 3rd env that plays, and saves
  that state S, legal actions from it, and ``vmap(step_autoreset)``'s
  outputs on them;
* for each mask (all, none, alternating) saves S with the masked envs
  replaced by ``reset(fold_in(key, step_count))`` of their own state (the
  autoreset mode) and by ``reset`` of ``split(key(11), 1024)`` (the fresh
  mode).

Tolerance: none; every packed row and every ``FullEnvState`` field bit for
bit, but ``step_autoreset``'s reward, within PARITY #B11's 1e-4 (XLA's jit
contracts its multiply-adds into FMAs).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.core import cards as C
from balatro_gym_tpu_torch.core import rng as R
from balatro_gym_tpu_torch.engine import full_env as FE
from balatro_gym_tpu_torch.ops import fused_full_rollout as F
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from tests.test_torch_full_env_step import state_from_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
PRELUDE = 5
MASKS = ("all", "none", "alternating")
REWARD_ATOL = 1e-4   # PARITY #B11


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masks(kind, n=N):
    env = np.arange(n)
    return {"all": env >= 0, "none": env < 0, "alternating": env % 2 == 1}[kind]


def _mint(path):
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import dataclasses

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import jax.numpy as jnp

    from balatro_gym_tpu.engine import full_env as fe
    from fused_full_common import sample_legal

    out = {}

    def put_state(prefix, st):
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            out[f"{prefix}_{f.name}"] = np.asarray(
                jax.vmap(jax.random.key_data)(v) if f.name == "key" else v)

    def merged(mask, fresh, st):
        m = jnp.asarray(mask)
        return jax.tree.map(lambda a, b: jnp.where(m.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
                            fresh, st)

    reset_v = jax.jit(jax.vmap(fe.reset))
    auto_j = jax.jit(jax.vmap(fe.step_autoreset))
    mask_j = jax.jit(jax.vmap(fe.action_mask))
    keys = jax.random.split(jax.random.key(3), N)
    out["fresh_keys"] = np.asarray(jax.vmap(jax.random.key_data)(keys))
    st = reset_v(keys)
    put_state("reset", st)
    rng = np.random.default_rng(7)
    for _ in range(PRELUDE):
        st, _, _ = auto_j(st, jnp.asarray(sample_legal(np.asarray(mask_j(st)), rng)))
    env = np.arange(N)
    phase = np.asarray(st.phase)
    st = st.replace(
        ante=jnp.asarray(np.where(env % 7 == 2, 101, np.asarray(st.ante))),
        hands_left=jnp.asarray(np.where((env % 3 == 1) & (phase == 0), 1,
                                        np.asarray(st.hands_left))))
    put_state("pre", st)
    acts = sample_legal(np.asarray(mask_j(st)), rng)
    out["acts"] = acts
    s2, r2, d2 = auto_j(st, jnp.asarray(acts))
    put_state("auto", s2)
    out["auto_out_reward"], out["auto_out_done"] = np.asarray(r2), np.asarray(d2)
    own = reset_v(jax.vmap(jax.random.fold_in)(st.key, st.step_count))
    keys2 = jax.random.split(jax.random.key(11), N)
    out["fresh_keys2"] = np.asarray(jax.vmap(jax.random.key_data)(keys2))
    given = reset_v(keys2)
    for kind in MASKS:
        put_state(f"own_{kind}", merged(masks(kind), own, st))
        put_state(f"given_{kind}", merged(masks(kind), given, st))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mint") / "engine_reset.npz")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--mint", path],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return dict(np.load(path))


def keys_of(m, name):
    return torch.as_tensor(m[name].astype(np.uint32).astype(np.int64))


def assert_state(got, m, prefix, what):
    want = state_from_fields(m, prefix)
    bad = F.states_equal(got, want)
    assert bad == [], f"{what}: fields differ: {bad}"
    return want


def assert_rows(got, want, what):
    for k in ("cards", "ints", "rng"):
        bad = torch.nonzero(got[k] != want[k])
        assert len(bad) == 0, f"{what}: {k} differs at {bad[:5].tolist()}"


def test_reset_matches_engine(minted):
    """``reset`` of the keys on the CPU, every field."""
    assert_state(FE.reset(keys_of(minted, "fresh_keys")), minted, "reset", "reset")


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("mode", ("autoreset", "fresh"))
def test_env_reset_rows_reference_matches_engine(minted, mode, kind):
    """The reset kernel's plain version on packed rows, in both modes and
    with each mask, against the engine's reset merged where masked: every
    packed row and every field; ``env_reset_fused`` on the CPU writes the
    same rows in place; ``autoreset`` is the autoreset mode."""
    pre = state_from_fields(minted, "pre")
    packed, mask = F.pack_full_state(pre), torch.as_tensor(masks(kind))
    keys = None if mode == "autoreset" else keys_of(minted, "fresh_keys2")
    prefix = f"{'own' if mode == 'autoreset' else 'given'}_{kind}"
    want = assert_state(F.unpack_full_state(FP.env_reset_rows_reference(packed, mask, keys)),
                        minted, prefix, f"{mode} {kind}")
    got = FP.env_reset_rows_reference(packed, mask, keys)
    assert_rows(got, F.pack_full_state(want), f"{mode} {kind} rows")
    rows = {k: v.clone() for k, v in packed.items()}
    n0 = FP.env_reset_fused.launches
    same = FP.env_reset_fused(rows, mask, keys, device="cpu")
    assert all(same[k] is rows[k] for k in rows) and FP.env_reset_fused.launches == n0
    assert_rows(rows, got, f"{mode} {kind} env_reset_fused")
    if mode == "autoreset":
        assert_state(FE.autoreset(pre, mask), minted, prefix, f"autoreset {kind}")


def test_step_autoreset_matches_engine(minted):
    """``step_autoreset`` on the CPU, and the plain no-reset step followed
    by the reset's plain rows where done (the card's path, in its plain
    versions), against the engine's; some envs end."""
    pre, a = state_from_fields(minted, "pre"), torch.as_tensor(minted["acts"])
    st, reward, done = FE.step_autoreset(pre, a)
    want = assert_state(st, minted, "auto", "step_autoreset")
    np.testing.assert_array_equal(done.numpy(), minted["auto_out_done"])
    np.testing.assert_allclose(reward.numpy(), minted["auto_out_reward"], rtol=0,
                               atol=REWARD_ATOL)
    assert 0 < int(done.sum()) < N
    packed, _, d = FP.env_step_rows_reference(F.pack_full_state(pre), a)
    assert_rows(FP.env_reset_rows_reference(packed, d), F.pack_full_state(want), "plain rows")


def kernels_deck(k1, k2):
    """The deck of csrc/full_step.cuh's reset_state (K2's and K3a's own
    shuffle, PARITY #B8/#B16): the 52 words of fold_in(stream_key(key,
    deck_shuffle), 0) with their low 6 bits replaced by the card's suit and
    rank, sorted; rank and suit read from those bits."""
    dk = KR.fold_in(*R.stream_key(k1, k2, "deck_shuffle"), 0)
    words = (KR.random_bits32(dk[0][:, None], dk[1][:, None], torch.arange(52))
             & 0xFFFFFFC0) | ((torch.arange(52) // 13) << 4 | torch.arange(52) % 13)
    w = words.sort(-1).values
    return (w & 15) + 2, (w >> 4) & 3


def test_plain_reset_deck_is_the_engine_permutation():
    """The plain reset's deck is ``kernel_rng.permutation``'s (the engine's,
    ``jax.random.permutation``), and not the kernels' packed-word sort."""
    k1, k2 = KR.split_child(*KR.seed_key(21), torch.arange(512))
    st = FE.reset_reference(torch.stack([k1, k2], -1))
    perm = KR.permutation(*KR.fold_in(*R.stream_key(k1, k2, "deck_shuffle"), 0), 52)
    ranks, suits = (torch.as_tensor(x.astype(np.int64)) for x in C.standard_deck_arrays())
    assert torch.equal(st.card_rank[:, :52].long(), ranks[perm])
    assert torch.equal(st.card_suit[:, :52].long(), suits[perm])
    kr, ks = kernels_deck(k1, k2)
    differs = (st.card_rank[:, :52] != kr) | (st.card_suit[:, :52] != ks)
    assert bool(differs.any(1).all())


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--mint":
    _mint(sys.argv[2])
