"""Plain versions of kernels K2, K3 and K4-int64 against the JAX package,
and the long-read route's sort widths.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
Pallas kernels run in interpret mode.  Integer outputs must be bit-equal.
The Pallas fused kernels count dropped lanes where the port counts
dropped distinct values, so those overflow counts compare as zero versus
nonzero only.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sketch_rna_tpu.hash.pallas_hash import nthash_sketch_pallas, sketch_batch_pallas_multik
from sketch_rna_tpu.sketch.fracminhash import sketch_batch as jax_sketch_batch
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.hash.hash_kernel import nthash_sketch
from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik, window_pad
from sketch_rna_tpu_torch.match.row_sort import MAX_WIDTH, row_sort, row_sort_wide
from sketch_rna_tpu_torch.sketch import dispatch
from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads
from sketch_rna_tpu_torch.sketch.fracminhash import SENTINEL, hash_kept, kept_width, sketch_batch

FRACTION = 0.05
KS = (21, 31)


def _batch(seed, L, B=24, k=31):
    """Random codes; lengths cover empty, shorter than k, exactly k, full."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    lengths[:5] = [0, k - 1, k, L, L]
    codes[4] = np.tile(np.array([0, 1], np.uint8), L // 2)  # heavy duplicate hashes
    for i, n in enumerate(lengths):
        codes[i, n:] = 0
    return codes, lengths


def _caps(L):
    cfg = QuantConfig()
    return [tuple(cfg.sketch_capacity_for(k, L) for k in KS), (2, 2)]  # the second overflows


@pytest.mark.parametrize("L,caps", [(L, c) for L in (104, 152) for c in _caps(L)])
def test_k2_plain_equals_pallas_and_per_k(L, caps):
    codes, lengths = _batch(L + caps[0], L)
    before = fused_sketch_multik.launches
    got = fused_sketch_multik(torch.from_numpy(codes), torch.from_numpy(lengths), KS, FRACTION, caps)
    assert fused_sketch_multik.launches == before  # a CPU tensor launches no kernel
    pallas = sketch_batch_pallas_multik(jnp.asarray(codes), jnp.asarray(lengths), KS, FRACTION, caps,
                                        interpret=True)
    for (h, m, ov), (ph, pm, pov), k, cap in zip(got, pallas, KS, caps):
        jh, jm, jov = jax_sketch_batch(jnp.asarray(codes), jnp.asarray(lengths), k, FRACTION, cap)
        for want_h, want_m in ((ph, pm), (jh, jm)):
            np.testing.assert_array_equal(h.numpy(), np.asarray(want_h).astype(np.int64))
            np.testing.assert_array_equal(m.numpy(), np.asarray(want_m))
        assert int(ov) == int(jov)
        assert (int(ov) > 0) == (int(pov) > 0)
        assert (int(ov) > 0) == (cap < 8)  # the small caps really overflow


@pytest.mark.parametrize("fraction", [FRACTION, 0.9999])
@pytest.mark.parametrize("k,L,B", [(k, L, 8 if L > 1000 else 24) for k in KS for L in (104, 160, 2048)])
def test_k3_plain_equals_pallas(k, L, B, fraction):
    """K3 returns the Pallas plane's kept entries and their positions,
    compacted per row in window order, then the sentinel and -1."""
    codes, lengths = _batch(k + L, L, B=B, k=k)
    codes[5, : lengths[5]] = 2  # all-equal bases: every window the same hash
    plane = np.asarray(
        nthash_sketch_pallas(jnp.asarray(codes), jnp.asarray(lengths), k, fraction, interpret=True)
    ).astype(np.int64)
    before = nthash_sketch.launches
    for pow2 in (False, True):
        h, win, counts = nthash_sketch(torch.from_numpy(codes), torch.from_numpy(lengths), k, fraction, pow2)
        assert nthash_sketch.launches == before  # a CPU tensor launches no kernel
        assert h.dtype == torch.int64 and win.dtype == torch.int32 and counts.dtype == torch.int32
        kept = [np.flatnonzero(row != SENTINEL) for row in plane]
        most = max(p.size for p in kept)
        assert h.shape == win.shape == (B, kept_width(most, pow2))
        for b, pos in enumerate(kept):
            n = int(counts[b])
            assert n == pos.size
            np.testing.assert_array_equal(win[b, :n].numpy(), pos)
            np.testing.assert_array_equal(h[b, :n].numpy(), plane[b, pos])
            assert (h[b, n:] == SENTINEL).all() and (win[b, n:] == -1).all()
    assert int(counts[0]) == int(counts[1]) == 0  # lengths 0 and k - 1: no window
    assert int(counts[2]) <= 1  # length k: one window
    if fraction > 0.5:
        assert int(counts[3]) > 0.99 * (L - k + 1)


@pytest.mark.parametrize("W", [2, 64, 4096])
def test_k4_int64_plain_equals_torch_sort(W):
    rng = np.random.default_rng(W)
    x = rng.integers(-(2**63), 2**63 - 1, size=(12, W), endpoint=True, dtype=np.int64)
    x[0] = rng.integers(0, 3, size=W)  # heavy duplicates
    x[1, ::2], x[1, 1::2] = -(2**63), 2**63 - 1  # extremes
    x[2] = (np.arange(W, dtype=np.int64)[::-1] << 32) | 7  # descending (key << 32) | payload
    before = row_sort.launches_i64
    got = row_sort(torch.from_numpy(x))
    assert row_sort.launches_i64 == before
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=1))


@pytest.mark.parametrize("L,ks", [(1200, (31,)), (1040, (21, 31)), (16414, (31,)), (20000, (21, 31))])
def test_sketch_reads_routes_equal_sketch_batch(L, ks):
    """Reads past K1's 1024 windows sketch through K3 + a K4 dedup (at
    L = 1040, k = 21 takes K3 and k = 31 the fused kernel), past 16384
    windows through K3 + row_sort_wide; every route equals sketch_batch
    and the JAX package's sketch_batch."""
    codes, lengths = _batch(L, L, B=6)
    caps = [QuantConfig().sketch_capacity_for(k, L) for k in ks]
    got = sketch_reads(torch.from_numpy(codes), torch.from_numpy(lengths), ks, FRACTION, caps)
    for (h, m, ov), k, cap in zip(got, ks, caps):
        want = sketch_batch(torch.from_numpy(codes), torch.from_numpy(lengths), k, FRACTION, cap)
        for a, b in zip((h, m, ov), want):
            assert torch.equal(a, b)
        jh, _, jov = jax_sketch_batch(jnp.asarray(codes), jnp.asarray(lengths), k, FRACTION, cap)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh).astype(np.int64))
        assert int(ov) == int(jov)


def _recording_sort(monkeypatch):
    """Replace the long route's dedup sort by one that records each width."""
    widths = []

    def sort(x):
        widths.append(x.shape[1])
        return row_sort_wide(x)

    monkeypatch.setattr(dispatch, "row_sort_wide", sort)
    return widths


@pytest.mark.parametrize("L", [2000, 20000])
def test_long_route_sorts_kept_width(L, monkeypatch):
    """The long route sorts each slice's kept hashes at
    max(2, pow2ceil(its most kept)), not at the reads' nk_pad: 256 lanes or
    fewer for 2,000 bp reads at fraction 0.05, and no row_sort_wide merge
    for 20 kb reads."""
    codes, lengths = _batch(L, L, B=6)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    cap = QuantConfig().sketch_capacity_for(31, L)
    widths = _recording_sort(monkeypatch)
    got = sketch_reads(c, n, (31,), FRACTION, (cap,))[0]
    most = int(hash_kept(c, n, 31, FRACTION)[2].max())
    assert widths == [kept_width(most, True)] * 2  # dedup_select's two sorts
    assert widths[0] < window_pad(L, 31) and widths[0] <= (256 if L == 2000 else MAX_WIDTH)
    for a, b in zip(got, sketch_batch(c, n, 31, FRACTION, cap)):
        assert torch.equal(a, b)


def test_kept_past_k4_width_sorts_wide(monkeypatch):
    """20 kb reads at fraction 0.9999 keep nearly every window, so the
    dedup still sorts through row_sort_wide's merges; equal to sketch_batch."""
    codes, lengths = _batch(7, 20000, B=5)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    widths = _recording_sort(monkeypatch)
    got = sketch_reads(c, n, (31,), 0.9999, (64,))[0]
    assert widths == [32768, 32768]
    want = sketch_batch(c, n, 31, 0.9999, 64)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[2]) > 0  # cap 64 overflows


def test_sketch_reads_refuses_past_k4_width():
    """Past K4's widest row (16384 kept hashes, here every window kept at
    fraction 0.9999) sketch_reads no longer refuses: the dedup sorts
    through row_sort_wide and equals sketch_batch, also when the rows are
    sketched in several slices.  The fused kernel K1 still refuses reads
    past its 1024 windows."""
    codes = torch.zeros((2, 16415), dtype=torch.uint8)
    codes[1, ::3] = 2
    lengths = torch.full((2,), 16415, dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "PLANE_BYTES", 8 * 32768)  # one row per slice
        widths = _recording_sort(mp)
        got = sketch_reads(codes, lengths, (31,), 0.9999, (64,))[0]
    assert widths == [32768] * 4  # two slices, two sorts each
    for a, b in zip(got, sketch_batch(codes, lengths, 31, 0.9999, 64)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="K3"):
        fused_sketch(codes, lengths, 31, FRACTION, 64)
