"""The port's masked hand histograms (K5) against the reference, on the CPU.

The plain version equals the reference's Pallas kernel (run in interpret
mode, as tests/test_pallas_kernels.py runs it) and its jnp formulation bit
for bit, on seeded inputs with ranks in [-1, 17] and suits in [-1, 9] (some
outside every bin) and a random mask; the CUDA source, compiled as host C++
through the shim of tests/test_torch_full_kernel_host.py, equals the plain
version bit for bit. Every term is a small integer, so no tolerance.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balatro_gym_tpu.ops import pallas_kernels as JPK
from balatro_gym_tpu_torch.ops import hand_histograms as HH
from tests.test_torch_full_kernel_host import _compile

HOST_LAUNCH = r"""
#define FULL_ROLLOUT_HOST_SHIM
#include "shim.h"
#include "hand_histograms.cu"
namespace { HistSmem smem; }
// Block by block: the count phase for every thread of the block, then the
// copy-out phase (the kernel's __syncthreads between them), over shared
// memory filled with junk before the block runs.
extern "C" void host_hist(const int* r, const int* s, const uint8_t* m, const float* t,
                          float* rh, float* sh, float* ch, int n) {
  for (int base = 0; base < n; base += kBlock) {
    memset(&smem, 0xA5, sizeof smem);
    for (int i = 0; i < kBlock; ++i) hist_count(smem, r, s, m, t, ch, i, base, n);
    for (int i = 0; i < kBlock; ++i) hist_copy_out(smem, rh, sh, i, base, n);
  }
}
"""


def inputs(b, seed):
    rng = np.random.default_rng(seed)
    ranks = rng.integers(-1, 18, size=(b, 8)).astype(np.int32)
    suits = rng.integers(-1, 10, size=(b, 8)).astype(np.int32)
    mask = rng.random((b, 8)) < 0.6
    return ranks, suits, mask


def test_chip_table_is_the_references():
    np.testing.assert_array_equal(HH.CHIP_TABLE, JPK._CHIP_TABLE)
    assert (HH.TILE_B, HH.R_PAD, HH.S_PAD) == (JPK.TILE_B, JPK.R_PAD, JPK.S_PAD)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_the_pallas_kernel_and_the_jnp_reference(seed):
    ranks, suits, mask = inputs(512, seed)
    assert ((ranks < 0) | (ranks > 15)).any() and ((suits < 0) | (suits > 7)).any()
    j = (jnp.asarray(ranks), jnp.asarray(suits), jnp.asarray(mask))
    kernel = JPK.hand_histograms(*j, interpret=True)
    ref = JPK.hand_histograms_reference(*j)
    t = (torch.as_tensor(ranks), torch.as_tensor(suits), torch.as_tensor(mask))
    n0 = HH.hand_histograms.launches
    got = HH.hand_histograms(*t, device="cpu")
    assert HH.hand_histograms.launches == n0                  # the CPU runs no kernel
    for g, k, r in zip(got, kernel, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(k))
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert float(got[2].max()) > 0


def test_batch_must_be_a_tile_multiple():
    ranks, suits, mask = (torch.as_tensor(x) for x in inputs(300, 2))
    with pytest.raises(ValueError, match="multiple of 256"):
        HH.hand_histograms(ranks, suits, mask, device="cpu")


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        HH.hand_histograms(*(torch.as_tensor(x) for x in inputs(256, 3)))


@pytest.fixture(scope="module")
def host_hist(tmp_path_factory):
    so = _compile(tmp_path_factory, HOST_LAUNCH)
    so.host_hist.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]

    def run(ranks, suits, mask):
        n = ranks.shape[0]
        out = (torch.full((n, 16), float("nan")), torch.full((n, 8), float("nan")),
               torch.full((n, 1), float("nan")))
        so.host_hist(ranks.data_ptr(), suits.data_ptr(), mask.data_ptr(),
                     torch.as_tensor(HH.CHIP_TABLE).data_ptr(), *(o.data_ptr() for o in out), n)
        return out
    return run


def test_host_build_of_the_kernel_equals_plain(host_hist):
    ranks, suits, mask = (torch.as_tensor(x) for x in inputs(768, 4))
    for g, w in zip(host_hist(ranks, suits, mask),
                    HH.hand_histograms_reference(ranks, suits, mask)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [256, 4096, 300])
def test_host_build_block_by_block(host_hist, n):
    """Every output written (the outputs start as NaN), out-of-range ranks
    and suits in no bin, a ragged last block included (300 envs: the kernel
    takes any count, the entry point tiles of 256)."""
    ranks, suits, mask = (torch.as_tensor(x) for x in inputs(n, n))
    got = host_hist(ranks, suits, mask)
    want = HH.hand_histograms_reference(ranks, suits, mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    outside = int((((ranks < 0) | (ranks > 15)) & mask).sum())
    assert outside > 0 and int(got[0].sum()) == int(mask.sum()) - outside
