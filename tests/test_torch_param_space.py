"""The port off the default parameters, held to the reference math and to
the JAX package (the port's counterpart of tests/test_param_space.py).

Every case runs the port on the CPU, where each kernel's wrapper runs its
plain PyTorch version, and holds the result two ways:

  - to the port's NumPy oracle (oracle/, the C++ tool's math): pi and
    NumReads within rtol 1e-9 / atol 1e-12, the CSV row set equal;
  - to the JAX package's quantify on the same inputs: pi and NumReads
    within 5e-9 relative (PARITY.md's bar), the CSV row set equal, and
    the port's collect_pairs equal to the JAX package's exactly.

Cases: test_param_space.py's eight, on the same draws (four off-default
sketch fraction / chain fraction / EM iteration sets, four random seeds
over k set, transcriptome, read count and read length); the k sets
(15, 25, 33), (17,) and nine ks (past the fused kernels' eight ks a
launch: K2 for eight and K1 for the ninth on the card); 1,200 bp reads at pad
1,280 (past 1,024 windows: K3's kept hashes and the K4-int64 dedup);
20 kb reads at sketch fraction 0.9 (more than 16,384 events a read, held
to the oracle alone: the JAX engines drop events past 16,384);
the streamed engine with a 16-row class buffer and 64-read chunks, which
compacts in the scan; the sharded engine at mesh (1, 1); and
--em-segsum on.
"""

import numpy as np
import pytest

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.pipeline import collect_pairs as jax_collect_pairs, quantify as jax_quantify
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.dist.mesh import make_mesh
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.index.build import build_index
from sketch_rna_tpu_torch.io.fasta import FastaRecords
from sketch_rna_tpu_torch.io.packing import PackedReads
from sketch_rna_tpu_torch.oracle import oracle_quant
from sketch_rna_tpu_torch.pipeline import collect_pairs, quantify, quantify_sharded
from sketch_rna_tpu_torch.sketch.dispatch import fused_groups
from sketch_rna_tpu_torch.stream import quantify_streamed

from util import decode, make_transcriptome, sample_reads

NINE_KS = (11, 13, 15, 17, 19, 21, 23, 25, 27)


def _pack(reads, pad_len):
    codes = np.zeros((len(reads), pad_len), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : r.size] = r
        lens[i] = r.size
    return codes, lens


def _held(seqs, reads, pad_len, engine="fused", jax=True, **knobs):
    """Quantify `reads` against `seqs` through the port's `engine` on the
    CPU and hold it to the port's oracle and (with jax) to the JAX
    package.  knobs: QuantConfig fields that both packages share.
    Returns the port's QuantResult and its collect_pairs."""
    names = [f"T{i}" for i in range(len(seqs))]
    text = [decode(s) for s in seqs]
    knobs = dict(batch_size=64, max_read_len=pad_len, em_dtype="float64", **knobs)
    ks = knobs["kmer_lengths"]
    port_only = {k: knobs.pop(k) for k in ("stream_class_capacity", "stream_chunk_reads") if k in knobs}
    cfg = QuantConfig(**knobs, **port_only)
    codes, lens = _pack(reads, pad_len)
    packed = PackedReads(codes, lens, [str(i) for i in range(len(reads))])
    artifact = build_index(FastaRecords(names, text, 0), cfg, device="cpu")
    index = to_device(artifact, "cpu")
    if engine == "fused":
        result = quantify(index, packed, cfg)
    elif engine == "streamed":
        result = quantify_streamed(index, packed, cfg)
    else:
        result = quantify_sharded(artifact, packed, cfg, make_mesh(1, 1, device="cpu"), device="cpu")
    rows = [t for t in range(len(seqs)) if result.has_entry[t]]

    # The reference math.
    _, o_pi, o_weighted, o_csv = oracle_quant(
        seqs, {f"{i}": r for i, r in enumerate(reads)}, ks, sketch_fraction=cfg.sketch_fraction,
        chain_fraction=cfg.chain_fraction, em_max_iterations=cfg.em_max_iterations)
    np.testing.assert_allclose(result.pi, o_pi, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(result.weighted_counts, o_weighted, rtol=1e-9, atol=1e-12)
    assert rows == o_csv
    pairs = collect_pairs(index, packed, cfg)
    assert pairs[3] == {"sketch_overflow": 0, "expand_dropped": 0, "candidate_spilled": 0}
    if not jax:
        return result, pairs

    # The JAX package on the same inputs (an expansion budget that holds
    # every read's events, so that nothing drops there either).
    jcfg = JaxConfig(**knobs, expand_per_read=1 << 12)
    jidx = jax_build_index(JaxRecords(names, text, 0), jcfg)
    jpacked = JaxPacked(codes, lens, [str(i) for i in range(len(reads))])
    want = jax_quantify(jidx, jpacked, jcfg)
    np.testing.assert_allclose(result.pi, want.pi, rtol=5e-9, atol=0)
    np.testing.assert_allclose(result.weighted_counts, want.weighted_counts, rtol=5e-9, atol=0)
    assert rows == [t for t in range(len(seqs)) if want.has_entry[t]]
    want_pairs = jax_collect_pairs(jidx, jpacked, jcfg)
    for got, exp in zip(pairs[:3], want_pairs[:3]):
        np.testing.assert_array_equal(got, exp)
    assert want_pairs[3] == pairs[3]
    return result, pairs


@pytest.mark.parametrize(
    "sketch_fraction,chain_fraction,em_iters",
    [
        (0.1, 0.5, 20),
        (0.02, 0.9, 5),
        (0.05, 0.75, 20),  # 3/4: exact rational path
        (0.05, 0.833, 20),  # not a small rational: float compare path
    ],
)
def test_quant_matches_oracle_offdefault(sketch_fraction, chain_fraction, em_iters):
    rng = np.random.default_rng(hash((sketch_fraction, chain_fraction)) % 2**31)
    seqs = make_transcriptome(rng, n=14, len_range=(60, 500))
    reads = [r for r in sample_reads(rng, seqs, n_reads=150, read_len=100) if r.size >= 31]
    _held(seqs, reads, 128, kmer_lengths=(31,), sketch_fraction=sketch_fraction, chain_fraction=chain_fraction,
          em_max_iterations=em_iters)


@pytest.mark.parametrize("seed", [11, 222, 3333, 44444])
def test_quant_matches_oracle_random_seeds(seed):
    rng = np.random.default_rng(seed)
    ks = (31,) if rng.random() < 0.5 else (21, 31)
    n_t = int(rng.integers(6, 24))
    seqs = make_transcriptome(rng, n=n_t, len_range=(50, 700))
    n_reads = int(rng.integers(40, 220))
    read_len = int(rng.integers(max(ks), 120))
    reads = [r for r in sample_reads(rng, seqs, n_reads=n_reads, read_len=read_len) if r.size >= max(ks)]
    assert reads
    _held(seqs, reads, 128, kmer_lengths=ks)


@pytest.mark.parametrize("ks", [(15, 25, 33), (17,), NINE_KS], ids=["k15_25_33", "k17", "nine-ks"])
def test_k_sets(ks):
    """Ks above 32, three ks to one K2 launch, and nine ks: more than the
    fused kernels take in one launch (MAX_KS = 8), split into eight and
    one."""
    rng = np.random.default_rng(5)
    seqs = make_transcriptome(rng, n=10)
    reads = [r for r in sample_reads(rng, seqs, n_reads=150, read_len=100) if r.size >= max(ks)]
    if ks == NINE_KS:
        assert fused_groups(104, ks) == [[0, 1, 2, 3, 4, 5, 6, 7], [8]]
    result, _ = _held(seqs, reads, 128, kmer_lengths=ks)
    assert result.num_mapped > len(reads) // 2


def test_long_reads_past_1024_windows():
    """40 reads of 1,200 bp at pad 1,280: 1,170 windows a read at k = 31,
    so every k takes K3's kept hashes and the K4-int64 dedup."""
    rng = np.random.default_rng(1200)
    seqs = make_transcriptome(rng, n=12, len_range=(2600, 4000))
    reads = sample_reads(rng, seqs, n_reads=40, read_len=1200)
    assert all(r.size == 1200 for r in reads)
    assert fused_groups(1200, (21, 31)) == []
    _held(seqs, reads, 1280, kmer_lengths=(21, 31))


def test_events_past_16384_a_read():
    """Two 20 kb reads at sketch fraction 0.9: ~18,000 kept hashes a read,
    so the dedup sorts 32,768 lanes (K4 chunks + the merge's wide round)
    and a read collects more than 16,384 events, past K4's widest row.  The event row sorts wide and drops nothing (the JAX engines stop
    at 16,384 events a read and count the rest as expand_dropped, so the
    JAX package is not the reference here: the oracle is)."""
    rng = np.random.default_rng(20000)
    seqs = make_transcriptome(rng, n=3, len_range=(20000, 25000))
    reads = sample_reads(rng, [s for s in seqs if s.size >= 20000], n_reads=2, read_len=20000)
    _, (read, _, score, _) = _held(seqs, reads, 20480, jax=False, kmer_lengths=(31,), sketch_fraction=0.9)
    assert np.bincount(read, weights=score).min() > 16384  # a candidate's score counts its events


def test_streamed_engine_compacts_in_scan():
    """The streamed engine, called directly, with a 16-row class buffer
    and 64-read chunks: the buffer compacts in the scan (and drains)."""
    rng = np.random.default_rng(1616)
    seqs = make_transcriptome(rng, n=20, len_range=(60, 600))
    reads = [r for r in sample_reads(rng, seqs, n_reads=300, read_len=100) if r.size >= 31]
    result, _ = _held(seqs, reads, 128, engine="streamed", kmer_lengths=(21, 31), stream_class_capacity=16,
                   stream_chunk_reads=64)
    assert result.stats["stream_compactions"] > 0, result.stats
    assert result.stats["class_overflow"] == 0


def test_sharded_engine_at_one_rank():
    """The sharded engine at mesh (1, 1): the searchsorted probe and the
    merged K-wide grouping (sort_event_parts) on every batch."""
    rng = np.random.default_rng(77)
    seqs = make_transcriptome(rng, n=16, len_range=(60, 600))
    reads = [r for r in sample_reads(rng, seqs, n_reads=200, read_len=100) if r.size >= 31]
    _held(seqs, reads, 128, engine="sharded", kmer_lengths=(21, 31), sketch_fraction=0.1, chain_fraction=0.75)


def test_em_segsum_on():
    """The segmented-sum EM route (kernel S on the card)."""
    rng = np.random.default_rng(515)
    seqs = make_transcriptome(rng, n=18, len_range=(60, 600))
    reads = [r for r in sample_reads(rng, seqs, n_reads=250, read_len=100) if r.size >= 31]
    result, _ = _held(seqs, reads, 128, kmer_lengths=(31,), em_segsum="on")
    assert result.num_reads == len(reads)
