"""The long-read cell's five readers (k3_kernel_roofline,
match.eager_sketch_ms_per_mreads, match.eager_batches_per_sample,
match.host_reads_per_mreads, graphs.evictions_per_sample) on hand-built
runs: None with nothing to read, each one's arithmetic, K3's least bytes
against a hand count, and the frozen K3 rule against the port's."""

import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import readers, tracing
from perfbench.reference import oracle
from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_metrics import make_run, read, sample

NAMES = ("k3_kernel_roofline", "match.eager_sketch_ms_per_mreads", "match.eager_batches_per_sample",
         "match.host_reads_per_mreads", "graphs.evictions_per_sample")
# K3's two passes as the profiler names them.
K3_RECORDS = ("void hash_kept_kernel<false>(unsigned char const*, int const*, int, int)",
              "void hash_kept_kernel<true>(unsigned char const*, int const*, int, int)")


def k3_module():
    path = REPO / "perfbench" / "metrics" / "k3_kernel_roofline.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_k3_kernel_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    """Off a card, and at a program without the new span and counters: the
    stage times alone, a host record and a device record of another
    kernel."""
    ev = [tracing.Ev("aten::add", 0, 50, False, True), tracing.Ev("sketch_kernel", 10, 20, True)]
    run = make_run([sample(match=0.1, classes=0.01), sample(traced=True, match=0.1)], ev, spans=[(0.0, 100.0)],
                   traced_s=1e-4, pool=[SimpleNamespace(codes=np.zeros((1, 256), np.uint8), lengths=np.ones(1))])
    assert read(name, run) is None


def test_counter_and_span_readers():
    timing = [{"match.eager_sketch": 0.03, "match.eager_batches": 30, "match.host_reads": 40, "graphs.evictions": 0},
              {"match.eager_sketch": 0.05, "match.eager_batches": 34, "match.host_reads": 44, "graphs.evictions": 3}]
    samples = [sample(reads=2**19, **timing[0]), sample(reads=2**19, **timing[1]),
               sample(reads=2**19, traced=True, **{key: 999 for key in timing[0]})]  # traced: not read
    run = make_run(samples)
    assert read("match.eager_sketch_ms_per_mreads", run) == pytest.approx(1e3 * 0.08 / (2**20 / 1e6))
    assert read("match.eager_batches_per_sample", run) == 32.0
    assert read("match.host_reads_per_mreads", run) == pytest.approx(84 / (2**20 / 1e6))
    assert read("graphs.evictions_per_sample", run) == 1.5


def _toy_sample():
    """A two-group sample: 150-base reads (pad 256, the fused kernels) and
    reads of 1,100-1,500 bases (pad 2048, past 1,024 windows: K3), some
    off-target lengths shorter than k among the short ones."""
    rng = np.random.default_rng(2**31 + 2021)
    lengths = np.concatenate([rng.integers(20, 151, 40), rng.integers(1100, 1501, 12)])
    rng.shuffle(lengths)
    codes = rng.integers(0, 4, (lengths.size, 2048)).astype(np.uint8)
    codes[np.arange(2048)[None, :] >= lengths[:, None]] = 0
    return codes, lengths


@pytest.mark.parametrize("ks", [(31,), (21, 31)])
def test_k3_bytes_equal_a_hand_count(ks):
    codes, lengths = _toy_sample()
    long = lengths > 256
    assert len(readers.length_groups(lengths, 2048, ks)) == 2
    # The long reads' bases and lengths once, per k their distinct kept hashes
    # (the scalar oracle's sketch) and a count a read.
    kept = sum(len(oracle.sketch_scalar(c[:n].tolist(), k, 0.05)) for k in ks
               for c, n in zip(codes[long], lengths[long]))
    n = int(long.sum())
    nbytes = int(lengths[long].sum()) + 4 * n + 4 * kept + 4 * n * len(ks)
    assert kept > 0 and k3_module().k3_bytes(codes, lengths, 2048, ks, 0.05, "codes", "cpu") == nbytes

    ev = [tracing.Ev(K3_RECORDS[0], 0, 30, True), tracing.Ev(K3_RECORDS[1], 100, 150, True),
          tracing.Ev("sketch_kernel", 0, 1000, True)]
    cfg = {"quant": {"kmer_lengths": list(ks), "sketch_fraction": 0.05, "batch_size": 8192}}
    pool = [SimpleNamespace(codes=codes, lengths=lengths)]
    # Two traced samples of the one pool sample: its bytes count twice.
    run = make_run([sample(traced=True), sample(traced=True), sample()], ev, pool=pool, config=cfg,
                   mix={"packing": "codes"}, row_width=2048)
    assert read("k3_kernel_roofline", run) == pytest.approx(100 * 2 * nbytes / readers.HBM_BYTES_PER_S / 80e-6)
    # Only 150-base reads: nothing takes K3, so no bytes.
    short = SimpleNamespace(codes=codes[~long][:, :256], lengths=lengths[~long])
    assert read("k3_kernel_roofline", make_run([sample(traced=True)], ev, pool=[short], config=cfg,
                                               mix={"packing": "codes"}, row_width=256)) == 0.0


@pytest.mark.parametrize("ks", [(31,), (21, 31), (15, 21, 25, 31)])
def test_frozen_k3_rule_is_the_ports(ks):
    from sketch_rna_tpu_torch.sketch.dispatch import fused_groups

    k3 = k3_module()
    for width in range(992, 2561):
        fused = {i for g in fused_groups(width, ks) for i in g}
        assert k3.k3_ks(width, ks) == [k for i, k in enumerate(ks) if i not in fused], width


def test_k3_groups_are_the_ports_groups():
    """The reads and widths of each group that takes K3, as the port's
    match_scan forms them (pipeline.length_groups, the group's width its
    longest read rounded up to 8)."""
    from sketch_rna_tpu_torch.pipeline import length_groups

    rng = np.random.default_rng(2**31 + 7)
    lengths = np.concatenate([rng.integers(100, 2550, 3000), [2549, 1054, 1055, 1024, 1025, 256, 257]])
    ks = (21, 31)
    k3 = k3_module()
    want = []
    for pad, rows in length_groups(lengths, 2560):
        width = min(pad, 2560, -(-max(int(lengths[rows].max()), 31) // 8) * 8)
        if k3.k3_ks(width, ks):
            want.append((np.asarray(rows).tolist(), k3.k3_ks(width, ks)))
    got = [(rows.tolist(), ks_) for rows, ks_ in k3.k3_groups(lengths, 2560, ks)]
    assert got == want and len(want) == 2
