"""Plain versions of kernels K2, K3 and K4-int64 against the JAX package.

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
from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch, fused_sketch_multik
from sketch_rna_tpu_torch.match.row_sort import row_sort
from sketch_rna_tpu_torch.sketch import dispatch
from sketch_rna_tpu_torch.sketch.dispatch import sketch_reads
from sketch_rna_tpu_torch.sketch.fracminhash import sketch_batch

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


@pytest.mark.parametrize("k,L,B", [(21, 104, 24), (31, 160, 24), (31, 2048, 8)])
def test_k3_plain_equals_pallas(k, L, B):
    codes, lengths = _batch(k + L, L, B=B, k=k)
    before = nthash_sketch.launches
    got = nthash_sketch(torch.from_numpy(codes), torch.from_numpy(lengths), k, FRACTION)
    assert nthash_sketch.launches == before
    want = nthash_sketch_pallas(jnp.asarray(codes), jnp.asarray(lengths), k, FRACTION, interpret=True)
    assert got.dtype == torch.int64 and got.shape == (B, L - k + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert (got[:2] == 0xFFFFFFFF).all()  # lengths 0 and k - 1: no window
    assert (got[2, 1:] == 0xFFFFFFFF).all()  # length k: one window


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


def test_sketch_reads_refuses_past_k4_width():
    """Past K4's widest row (16384 windows) sketch_reads no longer
    refuses: the dedup sorts through row_sort_wide and equals
    sketch_batch, also when the rows are sketched in several slices.
    The fused kernel K1 still refuses reads past its 1024 windows."""
    codes = torch.zeros((2, 16415), dtype=torch.uint8)
    codes[1, ::3] = 2
    lengths = torch.full((2,), 16415, dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "PLANE_BYTES", 8 * 32768)  # one row per slice
        got = sketch_reads(codes, lengths, (31,), FRACTION, (64,))[0]
    for a, b in zip(got, sketch_batch(codes, lengths, 31, FRACTION, 64)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="K3"):
        fused_sketch(codes, lengths, 31, FRACTION, 64)
