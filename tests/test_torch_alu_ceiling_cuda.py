"""The integer-ALU ceiling kernel (K6) against its plain version, on the
card, and its measurement helpers.

These tests need a card and skip where torch sees none. The machine with
the card has no JAX, and tests/conftest.py imports it, so this file imports
torch and the port only and runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_alu_ceiling_cuda.py

No tolerance: integer arithmetic, bit for bit.
"""
import pytest
import torch

from balatro_gym_tpu_torch.ops import alu_ceiling as AC

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _x(n_tiles, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n_tiles, 8, 8, 128), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("n_tiles,rounds", [(2, 0), (2, 1), (2, 7), (2, 128), (300, 3)])
def test_kernel_equals_plain(dev, n_tiles, rounds):
    x = _x(n_tiles, rounds, dev)
    n0 = AC.alu_chains.launches
    got = AC.alu_chains(x, rounds)
    assert AC.alu_chains.launches == n0 + 1
    assert torch.equal(got, AC.alu_chains_reference(x, rounds))


def test_measure_and_sass(dev):
    sec, rate = AC.measure(AC.REFERENCE_TILES, reps=10, best_of=1)
    assert sec > 0 and rate == AC.source_ops(AC.REFERENCE_TILES, AC.ROUNDS) / sec
    sass = AC.sass_loop()
    assert sass["instructions"] > 0 and sass["per_chain_round"] > 0
    assert any(op.startswith("BRA") for op in sass["opcodes"])


def test_bad_inputs_raise(dev):
    x = _x(2, 1, dev)
    with pytest.raises(ValueError):
        AC.alu_chains(x, 1, device="cpu")                   # card data never to the host
    with pytest.raises(ValueError):
        AC.alu_chains(x.to(torch.int64), 1)
    with pytest.raises(ValueError):
        AC.alu_chains(x, -1)
