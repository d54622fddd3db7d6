"""The engine's step and reset kernels (csrc/fused_policy_rollout.cu's
``env_step_kernel`` and ``env_reset_kernel``), compiled as host C++,
against their plain versions, on the CPU.

The build is tests/test_torch_full_kernel_host.py's shim and launch file:
the CUDA qualifiers become plain C++, and a kernel whose threads share
shared memory runs block by block, each phase (the code between two
``__syncthreads``, or a warp's step between two ``__syncwarp``) for every
thread of the block before the next, over shared memory and locals filled
with a junk pattern. Env counts leave partial blocks of both kernels (64
envs a step block, 32 a reset block).

Tolerance: none, but a reward's ``log`` term (plays past ante 3) within
1e-4, where the host's math library and torch's may differ in the last bit.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from balatro_gym_tpu_torch.ops import fused_full_battery as BAT
from balatro_gym_tpu_torch.ops import fused_full_rollout as F
from balatro_gym_tpu_torch.ops import fused_policy_rollout as FP
from balatro_gym_tpu_torch.ops import kernel_rng as KR
from tests.test_torch_full_kernel_host import CSRC, POLICY_LAUNCH, _compile

SIZES = (1, 31, 33, 257)
STEP_SIZES = SIZES + (63, 64, 65, 128, 129)
RESET_SIZES = SIZES + (32, 64, 65)
MASKS = ("all", "none", "alternating", "sparse")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    so = _compile(tmp_path_factory, POLICY_LAUNCH)
    so.host_env_step.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int]
    so.host_env_reset.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    so.host_sort64.argtypes = [ctypes.c_void_p]
    so.host_places.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return so


def env_step(so, packed, actions):
    n = packed["ints"].shape[1]
    out = {k: torch.empty_like(v) for k, v in packed.items()}
    reward, done = torch.empty(n), torch.empty(n, dtype=torch.bool)
    so.host_env_step(*(packed[k].data_ptr() for k in ("cards", "ints", "rng")),
                     actions.data_ptr(), F.float_tables("cpu").data_ptr(),
                     *(out[k].data_ptr() for k in ("cards", "ints", "rng")),
                     reward.data_ptr(), done.data_ptr(), n)
    return out, reward, done


def env_reset(so, packed, mask, keys=None):
    """The kernel on a copy of ``packed``, in place; keys as int32 bit
    patterns ``[B, 2]``."""
    out = {k: v.clone() for k, v in packed.items()}
    mask = mask.to(torch.bool).contiguous()
    if keys is not None:
        keys = F._w2i(keys).contiguous()
    so.host_env_reset(*(out[k].data_ptr() for k in ("cards", "ints", "rng")), mask.data_ptr(),
                      keys.data_ptr() if keys is not None else None, mask.shape[0])
    return out


def assert_step_equal(got, want, what):
    for k in ("cards", "ints", "rng"):
        bad = torch.nonzero(got[0][k] != want[0][k])
        assert len(bad) == 0, f"{what}: {k} differs at {bad[:5].tolist()}"
    assert torch.equal(got[2], want[2]), what
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0, atol=1e-4)


def assert_rows_equal(got, want, what):
    for k in ("cards", "ints", "rng"):
        bad = torch.nonzero(got[k] != want[k])
        assert len(bad) == 0, f"{what}: {k} differs at {bad[:5].tolist()}"


def battery(n, seed):
    """A diversified state of ``n`` envs, some on their last hand, past the
    score cap or done, and a function that draws a fed step's actions for a
    packed state: legal ones, but an illegal one in every 11th env."""
    rng = np.random.default_rng(seed)
    st = BAT.surgery(F.rollout_full_fused(seed, n, 4, device="cpu")["state"], rng)
    env = torch.arange(n)
    st.hands_left = torch.where((env % 8 == 3) & (st.phase == 0), 1, st.hands_left)
    st.chips_scored = torch.where(env % 64 == 5, 1_000_000_001, st.chips_scored)
    st.done = st.done | (env % 64 == 37)

    def actions(packed, t):
        mask = F._legal_rows(F._load(packed)).T.numpy()
        a = BAT.sample_legal(mask, rng)
        for i in np.flatnonzero(np.arange(n) % 11 == t % 11):
            a[i] = rng.choice(np.flatnonzero(~mask[i]))
        return torch.as_tensor(a)
    return F.pack_full_state(st), actions, rng


def test_kernel_branch_classes_are_the_battery_s():
    """csrc/full_step.cuh's branch-class enum is BAT.BRANCH_CLASSES, in
    order."""
    src = (CSRC / "full_step.cuh").read_text()
    body = re.search(r"enum\s*\{([^}]*BC_PLAY[^}]*)\};", src).group(1)
    names = [x.strip() for x in body.split(",") if x.strip()]
    assert names[-1] == "kBranchClasses"
    assert [x.removeprefix("BC_").lower() for x in names[:-1]] == list(BAT.BRANCH_CLASSES)


def group_of(c):
    """csrc/full_step.cuh's branch_group: play; reroll, skip; consumable;
    the rest."""
    return 0 if c == 0 else (1 if c <= 2 else (2 if c == 3 else 3))


@pytest.mark.parametrize("envs", (64, 128, 256))
def test_host_run_order_starts_each_group_on_a_warp(host, envs):
    """The step's run order of a block (its places): a permutation of the
    live envs, then the past-the-end ones in place; within each group in
    class order, stable; each group on warps of its own where enough
    envs of the last group fill the gaps, the fill taken from the order's
    tail (the cheapest classes)."""
    rng = np.random.default_rng(envs)
    for trial in range(200):
        live = envs if trial % 3 else int(rng.integers(1, envs + 1))
        p = rng.dirichlet(np.full(len(BAT.BRANCH_CLASSES), 0.3))
        cls = np.full(envs, len(BAT.BRANCH_CLASSES), np.uint8)
        cls[:live] = rng.choice(len(BAT.BRANCH_CLASSES), live, p=p)
        place = np.empty(envs, np.int16)
        host.host_places(cls.ctypes.data, envs, place.ctypes.data)
        assert sorted(place[:live]) == list(range(live)) and list(place[live:]) == list(range(live, envs))
        env_at = np.argsort(place[:live])
        groups = np.array([group_of(c) for c in cls[env_at]])
        n = np.bincount(groups, minlength=4)
        gaps, fill = [], n[3]
        for g in range(3):
            gaps.append(min(-n[g] % 32, fill))
            fill -= gaps[-1]
        want = np.r_[np.zeros(n[0]), np.full(gaps[0], 3), np.ones(n[1]), np.full(gaps[1], 3),
                     np.full(n[2], 2), np.full(gaps[2], 3), np.full(fill, 3)]
        assert np.array_equal(groups, want), trial
        starts = np.cumsum(np.r_[0, n[0], gaps[0], n[1], gaps[1], n[2], gaps[2]])
        aligned = True
        for g, (a, b) in enumerate(((0, n[0]), (starts[2], starts[2] + n[1]),
                                    (starts[4], starts[4] + n[2]), (starts[6], live))):
            at = env_at[a:b]
            assert np.all(np.diff(cls[at].astype(int) * envs + at) > 0), (trial, g)
            aligned = aligned and g < 3 and gaps[g] == -n[g] % 32
            if aligned:                 # every fill so far sufficed: the next group on a warp
                assert (b + gaps[g]) % 32 == 0, (trial, g)


@pytest.mark.parametrize("n", STEP_SIZES)
def test_host_env_step_on_the_battery(host, n):
    """The engine's step along 8 fed steps of the battery (illegal actions,
    ends, envs over) against the plain no-reset step."""
    packed, actions, _ = battery(n, n + 7)
    for t in range(8):
        a = actions(packed, t).to(torch.int32)
        assert_step_equal(env_step(host, packed, a), FP.env_step_rows_reference(packed, a),
                          f"n={n} step {t}")
        packed = FP.step_rows_reference(packed, a)[0]


def single_class_batches(n, seed):
    packed, actions, rng = battery(96, seed)
    pool = []
    for t in range(8):
        pool.append(packed)
        packed = FP.step_rows_reference(packed, actions(packed, t).to(torch.int32))[0]
    return BAT.class_batches(pool, n, rng)


@pytest.mark.parametrize("n", (33, 64, 257))
def test_host_env_step_on_single_class_batches(host, n):
    """The step on each batch whose envs all take one branch class (the
    batches tests/test_torch_full_env_cuda.py steps on the card)."""
    batches = single_class_batches(n, n)
    assert set(batches) == {name for name, _, _ in BAT.ACTION_CLASSES}
    for name, (p, a) in batches.items():
        assert BAT.class_histogram(p, a) == {name: n}, name
        assert_step_equal(env_step(host, p, a), FP.env_step_rows_reference(p, a), name)


def reset_mask(kind, n):
    env = torch.arange(n)
    return {"all": env >= 0, "none": env < 0, "alternating": env % 2 == 1,
            "sparse": env % 37 == 5}[kind]


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("n", RESET_SIZES)
def test_host_env_reset_equals_plain(host, n, kind):
    """The reset kernel in both modes (each env's own fold_in(key, step
    count), and given keys) against ``env_reset_rows_reference``, on a
    mid-game state whose envs have stepped different counts; unmasked envs'
    rows untouched. Masks: every env, none, every other, and one env in 37
    (blocks with one masked env, or none)."""
    packed, actions, _ = battery(n, n + 3)
    for t in range(n % 5 + 2):
        packed = FP.step_rows_reference(packed, actions(packed, t).to(torch.int32))[0]
    mask = reset_mask(kind, n)
    keys = torch.stack(KR.split_child(*KR.seed_key(n + 11), torch.arange(n)), -1)
    for mode, k in (("autoreset", None), ("fresh", keys)):
        got = env_reset(host, packed, mask, k)
        assert_rows_equal(got, FP.env_reset_rows_reference(packed, mask, k), f"{mode} n={n}")
        for name, v in got.items():
            assert torch.equal(v[..., ~mask], packed[name][..., ~mask]), (mode, name)


def test_host_sort64_keeps_tied_words_in_index_order(host):
    """The warp's bitonic sort of (word << 32 | index) keys on crafted
    words: all equal, two values, descending, runs of ties and the largest
    word; the result is the stable sort of the words by index, and the 12
    pads stay last."""
    rng = np.random.default_rng(0)
    cases = [np.zeros(52), np.arange(52) % 2, 51 - np.arange(52), rng.integers(0, 4, 52),
             np.full(52, 0xFFFFFFFF), np.where(np.arange(52) < 26, 0xFFFFFFFF, 7),
             rng.integers(0, 2 ** 32, 52)]
    for words in cases:
        words = np.asarray(words, np.uint64)
        keys = np.full(64, np.iinfo(np.uint64).max, np.uint64)
        keys[:52] = (words << np.uint64(32)) | np.arange(52, dtype=np.uint64)
        v = np.ascontiguousarray(rng.permutation(keys))
        host.host_sort64(v.ctypes.data)
        idx = (v[:52] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        assert np.array_equal(idx, np.argsort(words, kind="stable")), words[:8]
        assert np.all(v[52:] == np.iinfo(np.uint64).max)
