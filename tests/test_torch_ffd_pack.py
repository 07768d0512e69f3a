"""The FFD kernel's bit-packed requirement plane, on the CPU.

The kernel reads ``SlotState.valmask`` (bool [.., N, K, V]) packed, one bit
a value: bit v % 8 of byte v / 8 (``ops/cuda_ffd.pack_values``). The solo,
batched and gang wrappers pack the plane before the launch and unpack the
final plane after it (``unpack_values``), so the port's public layout stays
the JAX package's. Both passes are held here to
``numpy.packbits(..., bitorder="little")`` on planes made from a numpy
seed, for the value widths the prepare buckets to (powers of two >= 8).
"""
import numpy as np
import pytest
import torch

from karpenter_core_tpu_torch.ops import cuda_ffd


def _plane(V, shape=(3, 7), seed=0):
    rng = np.random.default_rng(seed + V)
    return rng.random((*shape, V)) < 0.3


@pytest.mark.parametrize("V", [8, 16, 64, 512])
def test_pack_and_unpack_round_trip_against_numpy(V):
    mask = _plane(V)
    packed = cuda_ffd.pack_values(torch.from_numpy(mask))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 7, V // 8)
    np.testing.assert_array_equal(
        packed.numpy(), np.packbits(mask, axis=-1, bitorder="little"))
    back = cuda_ffd.unpack_values(packed)
    assert back.dtype == torch.bool and back.shape == mask.shape
    np.testing.assert_array_equal(back.numpy(), mask)
    # unpacked into a caller's tensor, as the wrapper writes the state's
    out = torch.ones(mask.shape, dtype=torch.bool)
    assert cuda_ffd.unpack_values(packed, out=out) is out
    np.testing.assert_array_equal(out.numpy(), mask)


def test_pack_keeps_a_shared_leading_axis():
    """A plane expanded over a leading axis with stride 0 (the sweep's
    shared statics) packs to one packed row, expanded the same way."""
    row = torch.from_numpy(_plane(64, shape=(5,)))
    shared = row.unsqueeze(0).expand(4, *row.shape)
    packed = cuda_ffd.pack_values(shared)
    assert packed.shape == (4, 5, 8) and packed.stride(0) == 0
    assert torch.equal(packed, cuda_ffd.pack_values(shared.contiguous()))


def test_pack_takes_any_layout():
    mask = _plane(16, shape=(4, 6))
    t = torch.from_numpy(mask).transpose(0, 1)
    np.testing.assert_array_equal(
        cuda_ffd.pack_values(t).numpy(),
        np.packbits(mask, axis=-1, bitorder="little").transpose(1, 0, 2))


def test_pack_refuses_a_width_that_is_not_whole_bytes():
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_ffd.pack_values(torch.zeros((2, 12), dtype=torch.bool))
