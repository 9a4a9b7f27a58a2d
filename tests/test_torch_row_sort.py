"""Row sort K4 of the PyTorch port against the Pallas bitonic row sort.

The Pallas kernel runs in interpret mode on the CPU; the port's wrapper
runs its plain version there.  Both must be bit-equal to each other.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sketch_rna_tpu.match.pallas_sort import bitonic_row_sort
from sketch_rna_tpu_torch.match.row_sort import row_sort, row_sort_plain

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _rows(seed, W, B=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(I32_MIN, I32_MAX, size=(B, W), endpoint=True).astype(np.int32)
    x[0] = rng.integers(0, 3, size=W)  # heavy duplicates
    x[1, ::2] = I32_MIN  # extremes
    x[1, 1::2] = I32_MAX
    x[2] = np.arange(W)[::-1]  # descending
    return x


@pytest.mark.parametrize("W", [8, 64, 256])
def test_plain_row_sort_equals_pallas(W):
    x = _rows(W, W)
    want = np.asarray(bitonic_row_sort(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(row_sort_plain(torch.from_numpy(x)).numpy(), want)
    before = row_sort.launches
    np.testing.assert_array_equal(row_sort(torch.from_numpy(x)).numpy(), want)
    assert row_sort.launches == before  # a CPU tensor launches no kernel


@pytest.mark.parametrize(
    "x,err",
    [
        (torch.zeros((4, 12), dtype=torch.int32), ValueError),  # not a power of two
        (torch.zeros((4, 1), dtype=torch.int32), ValueError),  # below the narrowest row
        (torch.zeros((1, 1 << 15), dtype=torch.int32), ValueError),  # past 64 KB of shared memory
        (torch.zeros((4, 8), dtype=torch.int16), TypeError),
        (torch.zeros(8, dtype=torch.int32), ValueError),
        (torch.zeros((8, 4), dtype=torch.int32).t(), ValueError),  # not contiguous
    ],
)
def test_row_sort_rejects_bad_input(x, err):
    with pytest.raises(err):
        row_sort(x)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("W", [32768, 65536])
def test_row_sort_wide_equals_torch_sort(W, dtype):
    """Past K4's widest row, row_sort_wide sorts the 16384-lane chunks on
    K4 (its plain version here) and merges them: equal to torch.sort."""
    from sketch_rna_tpu_torch.match.row_sort import row_sort_wide

    info = np.iinfo(dtype)
    rng = np.random.default_rng(W + info.bits)
    x = rng.integers(info.min, info.max, size=(4, W), endpoint=True, dtype=dtype)
    x[0] = rng.integers(0, 3, size=W)  # heavy duplicates
    x[1, ::2], x[1, 1::2] = info.min, info.max  # extremes
    x[2] = np.arange(W, dtype=dtype)[::-1]  # descending
    t = torch.from_numpy(x)
    got = row_sort_wide(t)
    assert got.shape == t.shape and got.dtype == t.dtype
    assert torch.equal(got, torch.sort(t, dim=1).values)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("w", [2, 64, 16384])
def test_merge_pairs_plain_equals_torch_sort(w, dtype):
    """The merge kernel's plain version (bitonic_merge_pair) merges each
    row's two ascending halves: equal to torch.sort of the row, over long
    runs of equal keys and the type's extremes."""
    from sketch_rna_tpu_torch.match.row_sort import merge_pairs

    info = np.iinfo(dtype)
    rng = np.random.default_rng(w + info.bits)
    x = rng.integers(info.min, info.max, size=(8, 2 * w), endpoint=True, dtype=dtype)
    x[0] = rng.integers(0, 3, size=2 * w)  # long runs of equal keys
    x[1, ::2], x[1, 1::2] = info.min, info.max  # extremes
    x[2] = 7  # one key
    x[3, :w], x[3, w:] = info.max, info.min  # the right run entirely first
    x = np.concatenate([np.sort(x[:, :w], axis=1), np.sort(x[:, w:], axis=1)], axis=1)
    t = torch.from_numpy(x)
    before = merge_pairs.launches
    got = merge_pairs(t)
    assert merge_pairs.launches == before  # a CPU tensor launches no kernel
    assert got.dtype == t.dtype and torch.equal(got, torch.sort(t, dim=1).values)


@pytest.mark.parametrize(
    "x,err",
    [
        (torch.zeros((4, 12), dtype=torch.int32), ValueError),  # not a power of two
        (torch.zeros((4, 1), dtype=torch.int64), ValueError),  # no pair
        (torch.zeros((4, 8), dtype=torch.int16), TypeError),
        (torch.zeros(8, dtype=torch.int32), ValueError),
        (torch.zeros((8, 4), dtype=torch.int32).t(), ValueError),  # not contiguous
    ],
)
def test_merge_pairs_rejects_bad_input(x, err):
    from sketch_rna_tpu_torch.match.row_sort import merge_pairs

    with pytest.raises(err):
        merge_pairs(x)
