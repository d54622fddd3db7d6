"""The port's running normalisation against the reference's, on the CPU.

Seeded numpy batches (``[N, 189]`` observations and ``[N]`` returns) go
through ``update_stats``, ``normalize``, ``normalize_fm`` and
``normalize_reward`` on both sides; float32 results agree within 1e-6
relative (reductions sum in another order). The variance is the
population variance: the small-batch case fails by a factor (N-1)/N if a
sample variance (ddof 1) creeps in.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balatro_gym_tpu.train import normalize as JN
from balatro_gym_tpu_torch.train import normalize as TN

RTOL = 1e-6


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=1e-7)


def stats_pair(rng, dim):
    shape = () if dim is None else (dim,)
    mean = rng.normal(0, 2, shape).astype(np.float32)
    var = rng.uniform(0.1, 5, shape).astype(np.float32)
    count = np.float32(rng.uniform(10, 1e4))
    return (JN.RunningStats(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(count)),
            TN.RunningStats(torch.as_tensor(mean), torch.as_tensor(var), torch.tensor(count)))


@pytest.mark.parametrize("dim,n", [(189, 4096), (189, 3), (None, 8192), (None, 2)])
def test_update_stats(dim, n):
    rng = np.random.default_rng(n)
    j, t = stats_pair(rng, dim)
    shape = (n,) if dim is None else (n, dim)
    batch = (rng.normal(0.5, 3, shape) * rng.uniform(0.1, 2, shape[1:])).astype(np.float32)
    for _ in range(2):
        j = JN.update_stats(j, jnp.asarray(batch))
        t = TN.update_stats(t, torch.as_tensor(batch))
        for a, b in ((t.mean, j.mean), (t.var, j.var), (t.count, j.count)):
            assert a.dtype == torch.float32
            close(a.numpy(), b)
    fresh = TN.update_stats(TN.init_stats(dim), torch.as_tensor(batch))
    pop = batch.astype(np.float64).var(0)
    close(fresh.var.numpy(), (pop * n + 1e-4 + (batch.astype(np.float64).mean(0) ** 2)
                              * 1e-4 * n / (n + 1e-4)) / (n + 1e-4))


def test_init_stats():
    for dim in (None, 189):
        j, t = JN.init_stats(dim), TN.init_stats(dim)
        for a, b in ((t.mean, j.mean), (t.var, j.var), (t.count, j.count)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.dtype == torch.float32


def test_normalize_and_normalize_fm():
    rng = np.random.default_rng(5)
    j, t = stats_pair(rng, 189)
    x = (rng.normal(0, 8, (1024, 189))).astype(np.float32)
    want = np.asarray(JN.normalize(j, jnp.asarray(x)))
    got = TN.normalize(t, torch.as_tensor(x)).numpy()
    close(got, want)
    assert (np.abs(got) == 10).any()                      # the clip is reached
    close(TN.normalize_fm(t, torch.as_tensor(x.T.copy())).numpy(),
          np.asarray(JN.normalize_fm(j, jnp.asarray(x.T))))


def test_normalize_reward():
    rng = np.random.default_rng(6)
    j, t = stats_pair(rng, None)
    r = rng.normal(0, 30, 4096).astype(np.float32)
    got = TN.normalize_reward(t, torch.as_tensor(r)).numpy()
    close(got, np.asarray(JN.normalize_reward(j, jnp.asarray(r))))
    assert (np.abs(got) == 10).any()
