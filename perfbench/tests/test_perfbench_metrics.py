"""Each metric reader's arithmetic on a synthetic run and trace."""

from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness, readers, tracing
from perfbench.reference import oracle
from perfbench.tests.conftest import REPO

CFG = {"quant": {"kmer_lengths": [31], "sketch_fraction": 0.05, "batch_size": 8192}}


def sample(pool=0, reads=16384, start=0.0, seconds=1.0, traced=False, **timing):
    return harness.Sample(pool, reads, start, seconds, dict(timing), traced, False)


def make_run(samples, events=(), spans=(), traced_s=0.0, lengths=None, **kw):
    lengths = [np.full(16384, 150)] if lengths is None else lengths
    args = dict(workload="w", config=CFG, mix={}, samples=samples, window_start=0.0,
                window_end=sum(s.seconds for s in samples), setup_s=12.5, memory_peak_bytes=3 * 2**30,
                pool_lengths=lengths, row_width=256)
    args.update(kw)
    return harness.Run(**args, events=list(events), spans=list(spans), traced_s=traced_s)


def read(name, run):
    return harness.reader(REPO, name)(run)


def test_end_to_end_readers():
    run = make_run([sample(seconds=0.5), sample(seconds=1.5), sample(seconds=1.0)])
    assert read("reads_per_s", run) == pytest.approx(3 * 16384 / 3.0)
    assert read("setup_s", run) == 12.5
    assert read("device_mem_peak_GiB", run) == 3.0
    assert read("device_mem_peak_GiB", make_run([sample()], memory_peak_bytes=0)) is None


def test_p95_over_untraced_samples():
    samples = [sample(seconds=s) for s in np.linspace(0.1, 2.0, 20)] + [sample(seconds=99.0, traced=True)]
    assert read("sample_s_p95", make_run(samples)) == pytest.approx(np.percentile(np.linspace(0.1, 2.0, 20), 95))


@pytest.mark.parametrize("name,key", [("match.ms_per_mreads", "match"), ("classes.ms_per_mreads", "classes"),
                                      ("em.ms_per_mreads", "em_assign"),
                                      ("stream.match_ms_per_mreads", "stream_match")])
def test_stage_ms_per_mreads(name, key):
    samples = [sample(reads=500_000, **{key: 0.05}), sample(reads=1_500_000, **{key: 0.15}),
               sample(reads=10**6, traced=True, **{key: 9.0})]
    assert read(name, make_run(samples)) == pytest.approx(1e3 * 0.2 / 2.0)
    assert read(name, make_run([sample(other=1.0)])) is None


def test_torch_ops_per_batch_counts_top_level_ops_in_the_match_stage():
    ev = [tracing.Ev("aten::copy_", 10, 20, False, True), tracing.Ev("aten::add", 30, 40, False, True),
          tracing.Ev("aten::empty", 35, 36, False, False),  # called by another op
          tracing.Ev("cudaLaunchKernel", 50, 51, False), tracing.Ev("kern", 50, 60, True),
          tracing.Ev("aten::sum", 2000, 2001, False, True)]  # after the match stage
    run = make_run([sample(traced=True, match=0.001)], ev, spans=[(0.0, 5000.0)])
    # 16384 reads of 150 bases: one length group of two batches of 8192.
    assert read("match.torch_ops_per_batch", run) == 1.0
    assert read("match.torch_ops_per_batch", make_run([sample(match=0.001)])) is None


@pytest.mark.parametrize("packing,ks", [("codes", [31]), ("2bit", [31]), ("codes", [21, 31])])
def test_sketch_roofline_share(packing, ks):
    rng = np.random.default_rng(2**31 + 99)
    lengths = rng.integers(20, 151, 200)  # some reads shorter than a k
    codes = rng.integers(0, 4, (200, 152)).astype(np.uint8)
    codes[np.arange(152)[None, :] >= lengths[:, None]] = 0
    # The least bytes, counted by the scalar oracle: bases, lengths, and per k each
    # read's distinct kept 32-bit hashes and a count a read.
    kept = sum(len(oracle.sketch_scalar(c[:n].tolist(), k, 0.05)) for k in ks for c, n in zip(codes, lengths))
    bases = lengths.sum() if packing == "codes" else ((lengths + 3) // 4).sum()
    nbytes = int(bases + 4 * 200 + 4 * kept + 4 * 200 * len(ks))
    assert kept > 0 and readers.sketch_bytes(codes, lengths, ks, 0.05, packing, "cpu") == nbytes
    ev = [tracing.Ev("void sketch_kernel(unsigned char const*, int)", 0, 40, True),
          tracing.Ev("sketch_kernel", 100, 140, True), tracing.Ev("row_sort_kernel", 0, 1000, True)]
    pool = [SimpleNamespace(codes=codes, lengths=lengths)]
    cfg = {"quant": dict(CFG["quant"], kmer_lengths=ks)}
    # Two traced samples of the one pool sample: its bytes count twice.
    run = make_run([sample(traced=True), sample(traced=True), sample()], ev, pool=pool, config=cfg,
                   mix={"packing": packing})
    want = 100 * 2 * nbytes / readers.HBM_BYTES_PER_S / 80e-6
    assert read("sketch_kernel_roofline", run) == pytest.approx(want)
    assert read("sketch_kernel_roofline", make_run([sample(traced=True)], ev[2:], pool=pool)) is None


def test_reserved_memory_readers():
    run = make_run([sample(), sample()], memory_reserved_bytes=6 * 2**30, reserved_growth_bytes=300 * 2**20)
    assert read("device_mem_reserved_GiB", run) == 6.0
    assert read("device.reserved_MiB_per_sample", run) == 150.0
    assert read("device.reserved_MiB_per_sample", make_run([sample()], memory_reserved_bytes=2**30)) == 0.0
    for name in ("device_mem_reserved_GiB", "device.reserved_MiB_per_sample"):
        assert read(name, make_run([sample()])) is None  # off a card


def test_length_groups_split_by_padded_length():
    lengths = np.array([150] * 10 + [300] * 5 + [40] * 3)
    assert readers.length_groups(lengths, 512, [31]) == [(13, 152), (5, 304)]
    assert readers.length_groups(lengths, 256, [31]) == [(18, 256)]


def test_idle_share_and_busy_share():
    ev = [tracing.Ev("a", 0, 100, True), tracing.Ev("b", 50, 150, True), tracing.Ev("c", 300, 400, True),
          tracing.Ev("host", 0, 1000, False)]
    assert tracing.busy_share(ev, 0.001) == pytest.approx((250e-6, 0.25))
    assert read("device.idle_share", make_run([sample(traced=True)], ev, traced_s=0.001)) == pytest.approx(75.0)
    assert read("device.idle_share", make_run([sample()], [], traced_s=0.001)) is None


def test_breakdown_lists():
    ev = [tracing.Ev("void k1<int>(int*)", 0, 100, True), tracing.Ev("k1", 200, 250, True),
          tracing.Ev("k2", 600, 700, True), tracing.Ev("aten::copy_", 260, 590, False, True),
          tracing.Ev("cudaStreamSynchronize", 100, 190, False)]
    assert tracing.device_ms_by_name(ev) == [("k1", pytest.approx(0.15), 2), ("k2", pytest.approx(0.1), 1)]
    # Idle: 100-200 (the sync), 250-600 (the copy), 700-1000 (nothing), longest first.
    assert tracing.idle_gaps(ev, 0, 1000) == [("host: aten::copy_", pytest.approx(350e-6)),
                                              ("no host record", pytest.approx(300e-6)),
                                              ("host: cudaStreamSynchronize", pytest.approx(100e-6))]
    assert tracing.host_ops(ev) == {"launch": 0, "memcpy": 0, "sync": 1, "alloc": 0, "torch_ops": 1}
