"""Data parallelism over ``torch.distributed``: one process a rank.

Port of ``balatro_gym_tpu/parallel/mesh.py``. The reference is one
controller over a ``jax.sharding.Mesh`` of devices: the env batch is
sharded over the mesh's data axis, the learner's parameters are
replicated, and ``shard_map`` runs the single-chip update on every shard
with ``pmean``/``psum`` where the update writes them. The port keeps that
design and maps it onto a process group:

* a rank is a process with its own device; :class:`Mesh` holds its process
  group, rank, size and device (the reference's ``axis_index`` is
  ``mesh.rank``, its mesh size ``mesh.size``);
* every rank runs the single-device program on its own envs, children
  ``rank * n_local .. (rank + 1) * n_local - 1`` of the global batch, and
  keeps its shard: nothing is gathered;
* parameters, optimizer state, statistics and the carried key start equal
  on every rank (the same ``init_fn`` from the same key) and stay equal bit
  for bit, because every rank applies the same reduced bits;
* ``pmean``/``psum`` are ``all_reduce(SUM)`` of one flat buffer (then a
  division by the size for a mean); no other collective is called: no
  ``all_gather``, ``all_to_all`` or point-to-point, as
  tests/test_checkpoint_scaling.py requires of the reference. The
  minibatch shuffle is shard-local, as in the reference.

``DistributedDataParallel`` is not used: the update takes its gradients
with ``torch.autograd.grad`` and gates each minibatch on the approx-KL
averaged over the ranks before it applies anything, which DDP's backward
hooks serve neither of. The reductions stand in ``train/ppo.py``,
``train/a2c.py`` and ``train/normalize.py`` where the reference writes
``pmean``.

Backends. ``nccl`` where each rank owns a card; ``gloo`` on the CPU and
where ranks share a card: NCCL refuses two ranks on one GPU, and gloo
reduces CUDA tensors for ``all_reduce`` and ``broadcast`` (through the
host). :func:`default_backend` states the rule; nothing falls back from one
backend to the other.

Starting ranks: ``torchrun --nproc-per-node <cards> -m
balatro_gym_tpu_torch.train.cli --distributed ...`` (or ``python -m
torch.distributed.run``), or :func:`launch`, which starts a command as
``n`` subprocesses with the environment torchrun gives its ranks; each
rank calls :func:`init_distributed` and :func:`make_mesh`.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Any

import torch
import torch.distributed as dist

from balatro_gym_tpu_torch.core.device import run_device

DATA_AXIS = "dp"
INIT_TIMEOUT_S = 60
# The reference kernels' env tiles, which stride the sampled rollouts' seeds:
# balatro_gym_tpu/ops/fused_rollout.py (8 x 256) and
# balatro_gym_tpu/ops/fused_full_rollout.py (8 x 128).
FUSED_TILE = 2048
FULL_TILE = 1024


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel axis: its process group (None
    for a mesh of one rank with no process group), rank, size and device."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis: str = DATA_AXIS

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``psum``: ``t`` summed over the ranks, in place (one all-reduce)."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``pmean``: the sum over the ranks divided by the size, in place."""
        return self.sum_(t).div_(self.size)


def launcher_env():
    """(world size, rank, local rank) as a launcher (torchrun, :func:`launch`)
    set them in the environment, or None."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return int(os.environ["WORLD_SIZE"]), rank, int(os.environ.get("LOCAL_RANK", rank))


def default_backend(world_size: int, device=None) -> str:
    """``gloo`` on the CPU and where the ranks outnumber the cards (ranks
    sharing a card), else ``nccl``. ``device`` None means the card."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if torch.cuda.is_available() and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None, *,
                     device=None) -> bool:
    """Join the process group; True when there is one to join.

    With ``num_processes > 1`` the ranks meet at ``tcp://<coordinator>``
    (``host:port``) as rank ``process_id``; without ``num_processes`` a
    launcher's environment (``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) says whether and where. Otherwise it does nothing, as
    the reference's does on one host. ``backend`` None takes
    :func:`default_backend` for ``device``. A rendezvous or a collective
    that waits longer than ``INIT_TIMEOUT_S`` raises."""
    if dist.is_initialized():
        return True
    if num_processes is None:
        env = launcher_env()
        if env is None or env[0] <= 1:
            return False
        init_method, world, rank = "env://", env[0], env[1]
    elif num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("num_processes > 1 needs a coordinator and a process_id")
        init_method, world, rank = f"tcp://{coordinator}", num_processes, process_id
    else:
        return False
    dist.init_process_group(backend or default_backend(world, device), init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    return True


def _rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: ``cpu`` if asked, the given ``cuda:i``, else card
    ``local_rank % cards`` (ranks beyond the cards share them)."""
    if device is not None:
        want = torch.device(device)
        if want.type != "cuda" or want.index is not None:
            return run_device((), want)
    run_device((), "cuda")                       # raises where there is no card
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS, *, device=None):
    """This rank's :class:`Mesh` over the first ``n_devices`` ranks of the
    process group (default: all), on ``device`` (see :func:`_rank_device`).
    Every rank must call it (a sub-group is made collectively); a rank
    outside the first ``n_devices`` gets None. With no process group it is
    a mesh of one rank, which reduces nothing."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"n_devices={n_devices} but no process group: start the ranks "
                             "with torchrun or launch() and call init_distributed()")
        return Mesh(None, 0, 1, _rank_device(device, 0), axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} outside 1..{world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    env = launcher_env()
    dev = _rank_device(device, env[2] if env is not None else rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group, rank, n, dev, axis)


def destroy():
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------


def make_distributed_ppo(hooks, cfg, mesh: Mesh):
    """(init_fn, step_fn, policy_fn) of data-parallel PPO over ``mesh``, for
    this rank.

    ``cfg.n_envs`` is the GLOBAL env count and must divide by the mesh
    size. init_fn(key) -> this rank's TrainState: its ``n_envs // size``
    envs reset from children ``rank * n_local ..`` of ``split(k_env,
    n_envs)``, ``ret_carry`` zero, and parameters, Adam, statistics and key
    as on every rank. step_fn(ts, record=None) -> (TrainState, metrics):
    the reference's ``update_fn(ts, axis_name)`` on this rank's shard; the
    metrics are the means over the ranks (``episodes`` the sum)."""
    from balatro_gym_tpu_torch.train.ppo import make_ppo

    return make_ppo(hooks, cfg, device=mesh.device, mesh=mesh)


def train_distributed(num_updates: int = 8, cfg=None, mesh: Mesh | None = None, seed: int = 0,
                      hooks=None, log_every: int = 0):
    """Data-parallel training driver, on every rank. Returns (this rank's
    TrainState, last metrics)."""
    from balatro_gym_tpu_torch.ops import kernel_rng as KR
    from balatro_gym_tpu_torch.train.ppo import PPOConfig, sim_env_hooks

    cfg = cfg or PPOConfig()
    hooks = hooks or sim_env_hooks()
    mesh = mesh or make_mesh()
    init_fn, step_fn, _ = make_distributed_ppo(hooks, cfg, mesh)
    ts = init_fn([int(w) for w in KR.seed_key(seed, device="cpu")])
    metrics = None
    for i in range(num_updates):
        ts, metrics = step_fn(ts)
        if log_every and (i + 1) % log_every == 0 and mesh.rank == 0:
            print(f"update {i + 1}: { {k: float(v) for k, v in metrics.items()} }")
    return ts, metrics


# ---------------------------------------------------------------------------
# Sharded whole-rollout kernels
# ---------------------------------------------------------------------------


def _shard(n_envs: int, mesh: Mesh):
    if n_envs % mesh.size:
        raise ValueError(f"n_envs={n_envs} not divisible by mesh size {mesh.size}")
    local = n_envs // mesh.size
    return local, mesh.rank * local


def _env_columns(x, lo, local, env_dim):
    """This rank's envs of a per-env 2-D argument (envs along ``env_dim``);
    a 1-D one (one joker set, one action a step) is broadcast as it is."""
    if x is None:
        return None
    t = torch.as_tensor(x)
    return t if t.dim() < 2 else t.narrow(env_dim, lo, local)


def rollout_fused_sharded(seed, n_envs: int, n_steps: int, jokers, mesh: Mesh | None = None,
                          actions=None):
    """Data-parallel sim rollout (``ops.fused_rollout.rollout_fused``, K4):
    this rank runs the kernel on its ``n_envs // size`` envs and returns
    its own shard's dict (outputs stay sharded; nothing is gathered).

    ``jokers`` is ``[5]`` or the global ``[n_envs, 5]``; ``actions`` the
    global ``[n_steps, n_envs]`` (or ``[n_steps]``). Fed mode equals the
    one-process call on the same envs bit for bit. In sampled mode the
    rank's seed is ``seed + rank * n_local_tiles``, ``n_local_tiles =
    max(1, n_local // 2048)`` (the reference kernel's tile), as the
    reference strides it so that no two (rank, tile) pairs share a stream.
    """
    from balatro_gym_tpu_torch.ops import fused_rollout as FR

    mesh = mesh or make_mesh()
    local, lo = _shard(n_envs, mesh)
    n_local_tiles = max(1, local // FUSED_TILE)
    return FR.rollout_fused(seed + mesh.rank * n_local_tiles, local, n_steps,
                            _env_columns(jokers, lo, local, 0),
                            actions=_env_columns(actions, lo, local, 1),
                            device=mesh.device)


def slice_envs(state, lo: int, n: int):
    """Envs ``lo .. lo + n - 1`` of a batched dataclass state (every field
    ``[B, ...]``)."""
    return type(state)(**{f.name: getattr(state, f.name)[lo:lo + n]
                          for f in dataclasses.fields(state)})


def rollout_full_sharded(seed, n_envs: int, n_steps: int, mesh: Mesh | None = None,
                         actions=None, init_state=None):
    """Data-parallel flagship rollout (``ops.fused_full_rollout.
    rollout_full_fused``, K2): this rank runs the kernel on its envs and
    returns its own shard's dict (``state``, ``total_reward``,
    ``episodes``; nothing is gathered).

    ``init_state`` is the GLOBAL FullEnvState (this rank takes its slice);
    by default the rank resets its slice of ``default_reset(seed, n_envs)``
    from its own keys (``env_reset_kernel`` on a card). ``actions`` is the
    global ``[n_steps, n_envs]`` (or ``[n_steps]``). A rank's envs must be a
    whole number of the reference kernel's 1024-env tiles; in sampled mode
    its seed is ``seed + rank * n_local // 1024``. Fed mode equals the
    one-process call on the same envs bit for bit."""
    from balatro_gym_tpu_torch.ops import fused_full_rollout as FF

    mesh = mesh or make_mesh()
    local, lo = _shard(n_envs, mesh)
    if local % FULL_TILE:
        raise ValueError(f"{local} envs a rank is not a multiple of the kernel tile {FULL_TILE}")
    st = (FF.default_reset(seed, local, mesh.device, first=lo) if init_state is None
          else slice_envs(init_state, lo, local))
    return FF.rollout_full_fused(seed + mesh.rank * (local // FULL_TILE), local, n_steps,
                                 actions=_env_columns(actions, lo, local, 1),
                                 init_state=st, device=mesh.device)


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv, nprocs: int, *, timeout: float = 600, env=None, cwd=None) -> list:
    """Run ``argv`` as ``nprocs`` ranks, each a subprocess with the
    environment torchrun gives its ranks (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), and return each rank's
    output (stdout and stderr). If a rank exits non-zero, or the ranks are
    not done within ``timeout`` seconds, every rank still running is killed
    and it raises with the failing rank's output."""
    base = dict(os.environ if env is None else env)
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(nprocs)]
        procs = [subprocess.Popen(
            argv, stdout=logs[r], stderr=subprocess.STDOUT, cwd=cwd,
            env=dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(nprocs), RANK=str(r), LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE=str(nprocs))) for r in range(nprocs)]

        def outputs():
            out = []
            for f in logs:
                f.flush()
                f.seek(0)
                out.append(f.read())
            return out

        deadline = time.monotonic() + timeout
        failed = None
        try:
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)),
                              None)
                if time.monotonic() > deadline:
                    failed = "timeout"
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = outputs()
        for f in logs:
            f.close()
    if failed == "timeout":
        raise TimeoutError(f"ranks not done in {timeout} s: {argv}\n"
                           + "\n".join(f"--- rank {r}:\n{o[-3000:]}" for r, o in enumerate(outs)))
    if failed is not None:
        raise RuntimeError(f"rank {failed} exited {procs[failed].returncode}: {argv}\n"
                           f"{outs[failed][-6000:]}")
    return outs
