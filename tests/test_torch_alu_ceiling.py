"""The port's integer-ALU ceiling probe (K6) against the reference, on the CPU.

The reference is scripts/vpu_ceiling.py's Pallas ``kernel``, run through
``pl.pallas_call(..., interpret=True)`` over 2 tiles with ``K = 64`` (2
rounds) set on the imported module object; the file is not edited. The
plain version equals it bit for bit on seeded int32 inputs, and the CUDA
source, compiled as host C++ through the shim of
tests/test_torch_full_kernel_host.py, equals the plain version bit for bit
(at 2 rounds, the remainder loop alone, and at 9, both loops).
"""
import ctypes
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from balatro_gym_tpu_torch.ops import alu_ceiling as AC
from tests.test_torch_full_kernel_host import _compile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOST_LAUNCH = r"""
#define FULL_ROLLOUT_HOST_SHIM
#include "shim.h"
#include "alu_ceiling.cu"
extern "C" void host_chains(const int* x, int* out, int n_tiles, int rounds) {
  for (int i = 0; i < n_tiles * kTile; ++i) {
    blockIdx.x = i / kBlock;
    threadIdx.x = i % kBlock;
    alu_chains_kernel(x, out, n_tiles, rounds);
  }
}
"""


@pytest.fixture
def vpu(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "vpu_ceiling", os.path.join(REPO, "scripts", "vpu_ceiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "K", 64)
    return mod


def seeded(n_tiles, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 31, 2 ** 31, size=(n_tiles, 8, 8, 128)).astype(np.int32)


def test_plain_matches_the_pallas_kernel(vpu):
    x = seeded(2, 0)
    x[0, 0, 0, :4] = (0, -7, 2 ** 31 - 1, -2 ** 31)         # around the select's edge
    blk = pl.BlockSpec((1, vpu.ROWS, vpu.SUB, vpu.LANES), lambda i: (i, 0, 0, 0))
    f = pl.pallas_call(vpu.kernel, grid=(2,), in_specs=[blk], out_specs=blk,
                       out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32), interpret=True)
    want = np.asarray(f(jnp.asarray(x)))
    rounds = vpu.K // (4 * vpu.ROWS)
    assert rounds == 2 and AC.ROUNDS == 4096 // (4 * vpu.ROWS)
    n0 = AC.alu_chains.launches
    got = AC.alu_chains(torch.as_tensor(x), rounds, device="cpu")
    assert AC.alu_chains.launches == n0 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != x).all()


@pytest.mark.parametrize("rounds", [2, 9])
def test_host_build_of_the_kernel_equals_plain(tmp_path_factory, rounds):
    so = _compile(tmp_path_factory, HOST_LAUNCH)
    so.host_chains.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    x = torch.as_tensor(seeded(2, 1))
    out = torch.empty_like(x)
    so.host_chains(x.data_ptr(), out.data_ptr(), 2, rounds)
    assert torch.equal(out, AC.alu_chains_reference(x, rounds))


def test_ops_count_and_shapes():
    assert AC.source_ops(64, 128) == 64 * 8192 * 128 * 6
    assert AC.SATURATING_TILES * 1024 >= 132 * 2048
    with pytest.raises(ValueError):
        AC.alu_chains(torch.zeros(2, 8, 8, 64, dtype=torch.int32), 2, device="cpu")


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        AC.alu_chains(torch.zeros(1, 8, 8, 128, dtype=torch.int32), 2)
