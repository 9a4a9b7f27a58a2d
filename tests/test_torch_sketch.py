"""Sketch stage of the PyTorch port against the JAX package, on the CPU.

Integer outputs must be bit-equal: hashes, masks and overflow counts.
The Pallas kernel K1 runs in interpret mode; its overflow statistic
counts dropped lanes rather than distinct values, so it is compared as
zero/nonzero only.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sketch_rna_tpu.hash.nthash import nthash_batch_u32 as jax_nthash
from sketch_rna_tpu.hash.pallas_hash import sketch_batch_pallas
from sketch_rna_tpu.sketch.fracminhash import sketch_batch as jax_sketch_batch
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.hash.nthash import nthash_batch_u32, nthash_prefix_u32
from sketch_rna_tpu_torch.hash.sketch_kernel import fused_sketch
from sketch_rna_tpu_torch.sketch.fracminhash import sketch_batch

FRACTION = 0.05
L = 104  # 100 bp reads as the quant path cuts them (round_up(100, 8))


def _batch(seed, k, B=48):
    """Random codes; lengths cover empty, shorter than k, exactly k, full."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    lengths[:5] = [0, 1, k - 2, k - 1, k]
    # A low-complexity read: heavy duplicate hashes.
    codes[5] = np.tile(np.array([0, 1], np.uint8), L // 2)
    for i, n in enumerate(lengths):
        codes[i, n:] = 0
    return codes, lengths


@pytest.mark.parametrize("k", [21, 31])
def test_nthash_bit_equal(k):
    codes, _ = _batch(1, k)
    got = nthash_batch_u32(torch.from_numpy(codes), k).numpy()
    want = np.asarray(jax_nthash(jnp.asarray(codes), k)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [15, 21, 25, 31])
@pytest.mark.parametrize("L_of", ["k", "104", "152", "1100"])
def test_nthash_prefix_equals_windowed_xor(k, L_of):
    """The prefix-XOR form of the fused sketch kernels (srol^-m terms, one
    33-bit prefix for every k) is bit-equal to the windowed XOR and to the
    JAX package's hash, for a read of exactly k bases up to past 1024
    windows."""
    L = k if L_of == "k" else int(L_of)
    rng = np.random.default_rng(100 * k + L)
    codes = rng.integers(0, 4, size=(6, L)).astype(np.uint8)
    codes[0] = 0  # all-equal bases
    codes[1] = np.arange(L) % 4
    got = nthash_prefix_u32(torch.from_numpy(codes), k)
    assert got.dtype == torch.int64 and tuple(got.shape) == (6, L - k + 1)
    np.testing.assert_array_equal(got.numpy(), nthash_batch_u32(torch.from_numpy(codes), k).numpy())
    want = np.asarray(jax_nthash(jnp.asarray(codes), k)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


def _caps(k):
    return [QuantConfig().sketch_capacity_for(k, L), 4]


@pytest.mark.parametrize("k,cap", [(k, c) for k in (21, 31) for c in _caps(k)])
def test_sketch_batch_equals_jax(k, cap):
    codes, lengths = _batch(2 + k + cap, k)
    h, m, ov = sketch_batch(torch.from_numpy(codes), torch.from_numpy(lengths), k, FRACTION, cap)
    jh, jm, jov = jax_sketch_batch(jnp.asarray(codes), jnp.asarray(lengths), k, FRACTION, cap)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert int(ov) == int(jov)
    if cap == 4:
        assert int(ov) > 0  # the small cap really overflows


@pytest.mark.parametrize("k,cap", [(31, 32), (21, 4)])
def test_sketch_batch_equals_pallas_kernel(k, cap):
    codes, lengths = _batch(3, k, B=16)
    h, m, ov = sketch_batch(torch.from_numpy(codes), torch.from_numpy(lengths), k, FRACTION, cap)
    ph, pm, pov = sketch_batch_pallas(
        jnp.asarray(codes), jnp.asarray(lengths), k, FRACTION, cap, interpret=True
    )
    np.testing.assert_array_equal(h.numpy(), np.asarray(ph).astype(np.int64))
    np.testing.assert_array_equal(m.numpy(), np.asarray(pm))
    assert (int(ov) > 0) == (int(pov) > 0)


def test_fused_sketch_on_cpu_is_plain_version():
    codes, lengths = _batch(4, 31)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    before = fused_sketch.launches
    got = fused_sketch(c, n, 31, FRACTION, 32)
    want = sketch_batch(c, n, 31, FRACTION, 32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_sketch.launches == before  # a CPU tensor launches no kernel


def test_fused_sketch_rejects_bad_input():
    codes, lengths = _batch(5, 31, B=8)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    with pytest.raises(TypeError):
        fused_sketch(c.long(), n, 31, FRACTION, 32)
    with pytest.raises(TypeError):
        fused_sketch(c, n.long(), 31, FRACTION, 32)
    with pytest.raises(TypeError):
        fused_sketch(c, n[:3], 31, FRACTION, 32)
    long_reads = torch.zeros((2, 1100), dtype=torch.uint8)
    with pytest.raises(ValueError, match="K3"):
        fused_sketch(long_reads, torch.full((2,), 1100, dtype=torch.int32), 31, FRACTION, 64)
