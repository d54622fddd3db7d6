"""The fused flagship learner's variants against the reference, on the CPU:
the ``fast_decay`` recipe's bfloat16 update (``bf16_compute=True``,
``env_shuffle=True``) and the three-branch ``structured_net``.

As in tests/test_torch_ppo.py (b), the JAX side runs out of process with
x64 off: this file re-invokes itself with ``--mint <variant> <npz>``, one
process a variant, both started with the module. That process binds the
reference's ``step_tiles`` and ``observe_tiles`` to their plain twins and
runs one update of ``PPOConfig(n_envs=1024, rollout_len=2, epochs=2,
minibatches=2, fused_rollout=True)`` with the variant under
``jax.disable_jit()``, recording every step's action, log-prob, value,
reward and done.

Tolerances. The structured net in float32: those of the fused update in
tests/test_torch_ppo.py. The bfloat16 update: 3e-2, the bfloat16 tolerance
of the networks against flax (tests/test_torch_policy_rollout.py), on
log-probs, values and the metrics (absolute, and relative for the metrics);
each parameter's and Adam moment's change over the update within 10% of
the reference's change, in the norm of its leaf (one update moves a
parameter by about 1e-3, so an absolute 3e-2 on the parameters would pass a
skipped optimizer step); an action may differ only where the two
largest Gumbel-perturbed logits lie within it, and such envs (at most 1%)
are left out of later comparisons of that rollout. Env states, raw rewards
and dones of the other envs are exact; the running statistics of the
stored (bfloat16) observations within 3e-2 of the reference's too, since
a flipped env's later observations enter them.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balatro_gym_tpu.ops import fused_policy_rollout as JFP
from balatro_gym_tpu.train import normalize as JN
from balatro_gym_tpu.train import ppo as JP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from balatro_gym_tpu_torch.train import ppo as TP
from tests.test_torch_ppo import (ATOL, FUSED, METRICS, PARAM_ATOL, RTOL, STATS_ATOL,
                                  assert_close, flatten, near_ties, ref_state, unflatten)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 3e-2
BF16_DELTA_RTOL = 0.1    # relative norm of a leaf's change against the reference's
VARIANTS = {"bf16": {"bf16_compute": True, "env_shuffle": True},
            "structured": {"structured_net": True}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's torch ops are many and small: one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mint(variant, path):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    log, out = [], {}

    def recording(name, fn):
        def run(*args, **kw):
            res = fn(*args, **kw)
            log.append((name, res))
            return res
        return run

    def rows(name, fn):
        def run(*args, interpret=False):
            return recording(name, fn)(*args)
        return run

    JFP.step_tiles = rows("step", JFP.step_tiles_rows)
    JFP.observe_tiles = rows("observe", JFP.observe_tiles_rows)
    JFP.sample_fm = recording("sample", JFP.sample_fm)
    JFP.policy_apply_fm = recording("policy", JFP.policy_apply_fm)
    JFP.policy_apply_structured_fm = recording("policy", JFP.policy_apply_structured_fm)

    cfg = JP.PPOConfig(**FUSED, **VARIANTS[variant])
    init_fn, update_fn, _ = JP.make_ppo(JP.full_env_hooks(), cfg)
    rng = np.random.default_rng(7)
    ts = init_fn(jax.random.key(2)).replace(
        obs_stats=JN.RunningStats(
            mean=jnp.asarray(rng.normal(0, 0.3, JFP.OBS_DIM), jnp.float32),
            var=jnp.asarray(rng.uniform(0.2, 2.0, JFP.OBS_DIM), jnp.float32),
            count=jnp.float32(5000.0)),
        ret_stats=JN.RunningStats(mean=jnp.float32(0.3), var=jnp.float32(2.5),
                                  count=jnp.float32(5000.0)),
        ret_carry=jnp.asarray(rng.normal(0, 1, cfg.n_envs), jnp.float32))
    flatten("before", ref_state(ts, True), out)
    with jax.disable_jit():
        ts1, metrics = update_fn(ts)
    flatten("after", ref_state(ts1, True), out)
    for k, v in metrics.items():
        out[f"metric_{k}"] = np.asarray(v)
    steps = [r for n, r in log if n == "step"]
    samples = [r for n, r in log if n == "sample"]
    values = [r[1] for n, r in log if n == "policy"]
    for t in range(cfg.rollout_len):
        out[f"action_{t}"] = np.asarray(samples[t][0])
        out[f"log_prob_{t}"] = np.asarray(samples[t][1])
        out[f"value_{t}"] = np.asarray(values[t], np.float32)
        out[f"reward_{t}"] = np.asarray(JFP.flat_fm(steps[t][3])[0])
        out[f"done_{t}"] = np.asarray(JFP.flat_fm(steps[t][4])[0]) != 0
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def mint_processes(tmp_path_factory):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    procs = {}
    for variant in VARIANTS:
        path = str(tmp_path_factory.mktemp("mint") / f"{variant}.npz")
        procs[variant] = (path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mint", variant, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    yield procs
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_variant_update_matches_reference(mint_processes, variant):
    path, proc = mint_processes[variant]
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    m = dict(np.load(path))
    bf16 = variant == "bf16"
    tol = dict(rtol=BF16_TOL, atol=BF16_TOL) if bf16 else dict(rtol=RTOL, atol=ATOL)
    cfg = TP.PPOConfig(**FUSED, **VARIANTS[variant])
    hooks = TP.full_env_hooks()
    before = unflatten(m, "before")
    ts = TP.load_reference_state(hooks, cfg, before, device="cpu")
    _, update_fn, _ = TP.make_ppo(hooks, cfg, device="cpu")
    with torch.no_grad():
        policy = {k: v.clone() for k, v in ts.params.state_dict().items()}
    rec = {}
    out, metrics = update_fn(ts, record=rec)
    traj, n = rec["traj"], cfg.n_envs
    live = np.ones(n, bool)
    keys = KR.split_keys(KR.split_keys(before["key"], 4)[1], cfg.rollout_len)
    net0 = TP._make_net(hooks, cfg, None)
    net0.load_state_dict(policy)
    for t in range(cfg.rollout_len):
        same = traj.action[t].numpy() == m[f"action_{t}"]
        if not same[live].all():     # a flip needs a near-tie of the rollout's own logits
            with torch.no_grad():
                logits, _ = net0(traj.obs[t].float(), traj.mask[t])
            ties = near_ties(keys[t], logits, torch.arange(60 * n).view(60, n).T,
                             tol=BF16_TOL if bf16 else 1e-5).numpy()
            assert ties[live & ~same].all(), t
        live &= same
        for name in ("log_prob", "value"):
            assert_close(getattr(traj, name)[t].numpy()[live], m[f"{name}_{t}"][live],
                         f"{variant} step {t} {name}", **tol)
        np.testing.assert_array_equal(rec["raw"][t].numpy()[live], m[f"reward_{t}"][live])
        np.testing.assert_array_equal(traj.done[t].numpy()[live], m[f"done_{t}"][live])
    flips = int((~live).sum())
    print(f"{variant}: {flips} envs flipped an action")
    assert flips <= (n // 100 if bf16 else 0), flips
    want = unflatten(m, "after")
    for k in ("cards", "ints", "rng"):
        got = out.env_states[k].numpy()
        w = want["env_states"][k]
        w = w.astype(np.uint32).view(np.int32) if k == "rng" else w
        np.testing.assert_array_equal(got[..., live], w[..., live], err_msg=k)
    for name, got in (("params", TP.param_list(out.params)), ("mu", out.opt_state.mu),
                      ("nu", out.opt_state.nu)):
        w1, w0 = (TP._flax_leaves(out.params, tree[name]) for tree in (want, before))
        worst = 0.0
        for i, (g, v, v0) in enumerate(zip(got, w1, w0)):
            what = f"{variant}: {name}[{i}]"
            if not bf16:
                assert_close(g.detach(), v, what, rtol=0, atol=PARAM_ATOL)
                continue
            # One update moves a parameter by about 1e-3 and the moments are
            # far below 3e-2: hold each leaf's change against the reference's.
            d, dw = (g.detach().double() - v0.double()), (v.double() - v0.double())
            err = float((d - dw).norm() / dw.norm())
            assert dw.norm() > 0 and err <= BF16_DELTA_RTOL, (what, err)
            worst = max(worst, err)
        if bf16:
            print(f"{variant}: {name} changes within {worst:.3g} of the reference's")
    assert out.opt_state.count == want["count"] and out.update_idx == want["update_idx"]
    for name in ("obs_stats", "ret_stats"):
        for got, w in zip(vars(getattr(out, name)).values(), want[name]):
            assert_close(got, w, f"{variant}: {name}",
                         **(tol if bf16 else dict(rtol=RTOL, atol=STATS_ATOL)))
    assert_close(out.ret_carry.numpy()[live], want["ret_carry"][live], f"{variant}: ret_carry",
                 **tol)
    for k in METRICS:
        assert_close(metrics[k], m[f"metric_{k}"], f"{variant}: metric {k}", **tol)


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "--mint":
    _mint(sys.argv[2], sys.argv[3])
