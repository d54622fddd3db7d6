"""The masked hand-histogram kernel (K5) against its plain version, on the
card.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_hand_histograms_cuda.py

No tolerance: every sum is a small integer, exact in float32.
"""
import pytest
import torch

from balatro_gym_tpu_torch.ops import hand_histograms as HH

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(b, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    ranks = torch.randint(-1, 18, (b, 8), generator=g, device=dev, dtype=torch.int32)
    suits = torch.randint(-1, 10, (b, 8), generator=g, device=dev, dtype=torch.int32)
    mask = torch.rand(b, 8, generator=g, device=dev) < 0.6
    return ranks, suits, mask


@pytest.mark.parametrize("b", [256, 512, 65536, 1 << 20, (1 << 20) + 256])
def test_kernel_equals_plain(dev, b):
    ranks, suits, mask = _inputs(b, b, dev)
    n0 = HH.hand_histograms.launches
    got = HH.hand_histograms(ranks, suits, mask)
    assert HH.hand_histograms.launches == n0 + 1
    for g, w in zip(got, HH.hand_histograms_reference(ranks, suits, mask)):
        assert g.device == dev and g.dtype == torch.float32
        assert torch.equal(g, w)


def test_launch_shape(dev):
    """K5's launch shape: 256-thread blocks, the block's rank and suit rows
    staged in static shared memory (256 x (16 + 8) floats), no stack."""
    shape = HH.kernel_shape()
    assert shape["block"] == 256 and shape["stack_bytes"] == 0
    assert shape["shared_bytes"] == 256 * (16 + 8) * 4


def test_misaligned_inputs(dev):
    """Rows that do not start on 16 B (a view seven cards in) are copied
    before the kernel reads them as vectors."""
    views = [x.reshape(-1)[7:7 + 8 * 512].view(512, 8) for x in _inputs(513, 8, dev)]
    assert views[0].data_ptr() % 16 and views[2].data_ptr() % 8
    got = HH.hand_histograms(*views)
    for g, w in zip(got, HH.hand_histograms_reference(*views)):
        assert torch.equal(g, w)


def test_host_inputs_go_to_the_card(dev):
    ranks, suits, mask = (x.cpu() for x in _inputs(512, 5, dev))
    got = HH.hand_histograms(ranks.long(), suits.long(), mask)           # int64 inputs too
    assert got[0].device == dev
    for g, w in zip(got, HH.hand_histograms_reference(ranks, suits, mask)):
        assert torch.equal(g.cpu(), w)


def test_non_contiguous_inputs(dev):
    ranks, suits, mask = _inputs(1024, 6, dev)
    got = HH.hand_histograms(ranks.T.contiguous().T, suits, mask)
    for g, w in zip(got, HH.hand_histograms_reference(ranks, suits, mask)):
        assert torch.equal(g, w)


def test_bad_inputs_raise(dev):
    ranks, suits, mask = _inputs(300, 7, dev)
    with pytest.raises(ValueError, match="multiple of 256"):
        HH.hand_histograms(ranks, suits, mask)
    ranks, suits, mask = _inputs(256, 7, dev)
    with pytest.raises(ValueError):
        HH.hand_histograms(ranks, suits, mask, device="cpu")           # card data never to the host
    with pytest.raises(ValueError):
        HH.hand_histograms(ranks[:, :7], suits[:, :7], mask[:, :7])
