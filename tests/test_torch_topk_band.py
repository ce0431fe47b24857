"""Block top-k's banded rounds, on the CPU.

``csrc/block_topk.cu`` runs the reference's 20 bisection rounds, but after
the first 6 (7 for rows over 1024) it counts only the band [lo, hi) of
magnitudes that a later ``mid`` can still put on either side, adding the
count of those at or above ``hi``.  ``kernels/topk.py::block_topk_band``
runs those rounds in plain PyTorch.  No tolerance: the counts are the same
integers, so it equals ``block_topk_plain`` and the JAX package's eager
oracle ``repro.kernels.ref.block_topk_ref`` bit for bit (compared through
int32, so ``-0.0`` differs from ``0.0``), on seeded rows with ties at the
threshold, zero rows, all-negative rows, ``-0.0``, subnormals, k = 1,
k >= block, and blocks of 1, 75, 300, 1024 and 2048 -- subnormal rows against
the port's plain version only, because XLA on the CPU flushes subnormal
results to zero (PyTorch and the card keep them).  The CUDA kernel itself
is held to the plain version on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import topk as ktopk


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _rows(case, block, rng):
    x = (rng.standard_normal((64, block)) * 0.02).astype(np.float32)
    if case == "ties":  # a few magnitudes, row 0 tying its max across half the row
        x = rng.integers(1, 4, (64, block)).astype(np.float32)
        x *= rng.choice(np.array([-1, 1], np.float32), x.shape)
        x[0, ::2] = 3.0
    elif case == "zero_rows":
        x[::3] = 0.0
    elif case == "negative":
        x = -np.abs(x)
    elif case == "signed_zeros":
        x[:, ::4] = -0.0
        x[5] = -0.0
    elif case == "subnormal":
        x = x * np.float32(1e-36)  # many below 2**-126
    elif case == "wide_range":
        x[:, :3] = np.float32(3e38)  # hi past the band's overflow guard
    return x


CASES = ["gaussian", "ties", "zero_rows", "negative", "signed_zeros", "subnormal", "wide_range"]


@pytest.mark.parametrize("block", [1, 75, 300, 1024, 2048])
@pytest.mark.parametrize("case", CASES)
def test_band_rounds_equal_the_reference_bit_for_bit(case, block):
    rng = np.random.default_rng(block + len(case))
    x = _rows(case, block, rng)
    ks = sorted({1, max(1, block // 4), block, block + 7})
    for k in ks:
        band = ktopk.block_topk_band(torch.from_numpy(x), k)
        np.testing.assert_array_equal(_bits(band), _bits(ktopk.block_topk_plain(
            torch.from_numpy(x), k)))
        if case != "subnormal":  # XLA on the CPU flushes subnormal results to zero
            np.testing.assert_array_equal(_bits(band),
                                          _bits(jref.block_topk_ref(jnp.asarray(x), k)))


@pytest.mark.parametrize("iters", [0, 3, 6, 7, 20, 30])
def test_band_rounds_at_any_round_count(iters):
    rng = np.random.default_rng(iters)
    x = torch.from_numpy(_rows("gaussian", 1024, rng))
    assert torch.equal(ktopk.block_topk_band(x, 256, iters).view(torch.int32),
                       ktopk.block_topk_plain(x, 256, iters).view(torch.int32))


def test_band_fits_the_kernel_lists_on_the_trainer_shape():
    """The kernel lists at most 4 band elements per lane (lane l holds the
    16-byte chunks l + 32 j) and runs full rounds for a row that overflows:
    at the trainer's shape (1024-wide rows, k = 256) nearly every row of a
    Gaussian-like residual takes the lists."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2000, 1024)).astype(np.float32))
    mag = x.abs()
    hi = mag.amax(1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(ktopk.full_rounds(1024)):
        mid = 0.5 * (lo + hi)
        over = (mag >= mid).sum(1, keepdim=True) > 256
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    in_band = ((mag >= lo) & (mag < hi)).long()
    lane = (torch.arange(1024) // 4) % 32
    per_lane = torch.zeros(2000, 32, dtype=torch.long).index_add_(1, lane, in_band)
    assert float((per_lane.amax(1) <= 4).float().mean()) > 0.9
