"""Running observation and reward normalisation (SB3's ``VecNormalize``).

Port of ``balatro_gym_tpu/train/normalize.py``: running mean and variance
of observations and of discounted returns, merged batch by batch with
Chan's parallel formula. The statistics are float32 tensors on the
learner's device. The variances are population variances (``jnp.var``,
ddof 0), so every ``var`` here takes ``correction=0``. Given a data-parallel
mesh (``parallel/mesh.py``), :func:`update_stats` merges the ranks' batches
as the reference's ``axis_name`` path does, so every rank keeps the same
statistics.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RunningStats:
    mean: torch.Tensor    # [D] (or a scalar for returns)
    var: torch.Tensor     # [D]
    count: torch.Tensor   # scalar float32


def init_stats(dim: int | None = None, device=None) -> RunningStats:
    shape = () if dim is None else (dim,)
    return RunningStats(mean=torch.zeros(shape, device=device),
                        var=torch.ones(shape, device=device),
                        count=torch.full((), 1e-4, device=device))


def update_stats(rs: RunningStats, batch, mesh=None) -> RunningStats:
    """Merge a batch of samples (``[N, D]`` or ``[N]``) into the stats.

    With a ``mesh`` (``parallel.mesh.Mesh``) each rank gives its own shard's
    batch and the merge is the pooled one of every rank's, in two
    all-reduces: the mean over ranks of the batch means with the sum of the
    counts, then the mean over ranks of ``b_var + (b_mean - g_mean)**2``
    (the pooled variance needs the between-rank term)."""
    b_mean = batch.mean(0)
    b_var = batch.var(0, correction=0)
    b_count = torch.full((), float(batch.shape[0]), device=batch.device)
    if mesh is not None:
        n = b_mean.numel()
        first = mesh.sum_(torch.cat([b_mean.reshape(-1), b_count.reshape(1)]))
        g_mean = (first[:n] / mesh.size).reshape(b_mean.shape)
        b_var = mesh.mean_(b_var + (b_mean - g_mean) ** 2)
        b_mean, b_count = g_mean, first[n]
    delta = b_mean - rs.mean
    tot = rs.count + b_count
    new_mean = rs.mean + delta * b_count / tot
    m2 = rs.var * rs.count + b_var * b_count + delta ** 2 * rs.count * b_count / tot
    return RunningStats(mean=new_mean, var=m2 / tot, count=tot)


def normalize(rs: RunningStats, x, clip: float = 10.0):
    return ((x - rs.mean) / torch.sqrt(rs.var + 1e-8)).clamp(-clip, clip)


def normalize_fm(rs: RunningStats, x_fm, clip: float = 10.0):
    """:func:`normalize` of feature-major ``[D, E]`` rows."""
    return ((x_fm - rs.mean[:, None]) / torch.sqrt(rs.var[:, None] + 1e-8)).clamp(-clip, clip)


def normalize_reward(rs: RunningStats, r, clip: float = 10.0):
    """SB3's rule: rewards are scaled by the return std, not centred."""
    return (r / torch.sqrt(rs.var + 1e-8)).clamp(-clip, clip)
