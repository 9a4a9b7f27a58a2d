"""The merge kernel's plain versions against the JAX package and numpy.

`bitonic_merge_pair` (the plain version of csrc/merge.cu) against the
JAX package's `_bitonic_merge_pair` on the same numpy int32 rows: random
runs, all-equal rows, disjoint runs both ways and runs padded with
INT32_MAX sentinels, as the sharded route's event parts are.  Bit-equal.

`merge_partition_plain` (the plain version of the wide route's partition
launch) against a numpy reference built from np.searchsorted on the
b-keys' side: the same splits.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sketch_rna_tpu.match.rowmatch import _bitonic_merge_pair
from sketch_rna_tpu_torch.match.row_sort import (bitonic_merge_pair, merge_pairs, merge_partition,
                                                 merge_partition_plain, merge_staged)

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _runs(seed, w, dtype=np.int32, B=8):
    """[B, 2w] rows of two ascending w-key runs: random, all equal,
    a below b, a above b, sentinel-padded parts, heavy duplicates across
    the runs, the type's extremes, and a random row of small keys."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    x = rng.integers(info.min, info.max, size=(B, 2 * w), endpoint=True, dtype=dtype)
    x[1] = 5  # all equal
    x[2, :w] = rng.integers(-1000, 0, size=w)  # a entirely below b
    x[2, w:] = rng.integers(0, 1000, size=w)
    x[3, :w] = rng.integers(0, 1000, size=w)  # a entirely above b
    x[3, w:] = rng.integers(-1000, 0, size=w)
    for half in (slice(0, w), slice(w, 2 * w)):  # parts with a few events, then sentinels
        n = int(rng.integers(0, w + 1))
        x[4, half] = info.max
        x[4, half][:n] = rng.integers(0, 50, size=n)
    x[5] = rng.integers(0, 3, size=2 * w)  # long runs of equal keys across both runs
    x[6, ::2], x[6, 1::2] = info.min, info.max
    x[7] = rng.integers(-20, 20, size=2 * w)
    return np.concatenate([np.sort(x[:, :w], axis=1), np.sort(x[:, w:], axis=1)], axis=1)


@pytest.mark.parametrize("w", [1 << e for e in range(14)])
def test_bitonic_merge_pair_equals_jax(w):
    x = _runs(w, w)
    want = np.asarray(_bitonic_merge_pair(jnp.asarray(x[:, :w]), jnp.asarray(x[:, w:])))
    t = torch.from_numpy(x)
    got = bitonic_merge_pair(t[:, :w], t[:, w:])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.sort(x, axis=1))
    before = merge_pairs.launches, merge_partition.launches
    np.testing.assert_array_equal(merge_pairs(t).numpy(), want)
    np.testing.assert_array_equal(merge_staged(t).numpy(), want)
    assert (merge_pairs.launches, merge_partition.launches) == before  # a CPU tensor launches no kernel


def _splits_numpy(x, tile):
    """For each row and boundary d = min(k * tile, 2w): d less the b-keys
    among the first d outputs, each b-key's output position being its
    index plus the a-keys at or below it (ties from a)."""
    N, W = x.shape
    w = W // 2
    d = np.minimum(np.arange(-(-W // tile) + 1) * tile, W)
    out = np.empty((N, d.size), np.int32)
    for r in range(N):
        a, b = x[r, :w], x[r, w:]
        pos_b = np.arange(w) + np.searchsorted(a, b, side="right")
        out[r] = d - np.searchsorted(pos_b, d, side="left")
    return out


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("w,tile", [(1, 1), (4, 3), (64, 7), (256, 3840), (2048, 2816), (16384, 3840)])
def test_merge_partition_plain_equals_numpy(w, tile, dtype):
    x = _runs(w + tile, w, dtype)
    want = _splits_numpy(x, tile)
    got = merge_partition_plain(torch.from_numpy(x), tile)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    before = merge_partition.launches
    np.testing.assert_array_equal(merge_partition(torch.from_numpy(x), tile).numpy(), want)
    assert merge_partition.launches == before  # a CPU tensor launches no kernel
    # Each tile's a- and b-slices merge to the tile's outputs of the row.
    merged = np.sort(x, axis=1)
    for r in range(x.shape[0]):
        for k in range(want.shape[1] - 1):
            d0, d1 = k * tile, min((k + 1) * tile, 2 * w)
            a0, a1 = want[r, k], want[r, k + 1]
            part = np.concatenate([x[r, a0:a1], x[r, w + d0 - a0 : w + d1 - a1]])
            np.testing.assert_array_equal(np.sort(part), merged[r, d0:d1])


@pytest.mark.parametrize("tile", [0, -3, 1 << 31])
def test_merge_partition_rejects_bad_tile(tile):
    with pytest.raises(ValueError):
        merge_partition(torch.from_numpy(_runs(1, 4)), tile)
