"""The readers of the program's spans and counters (perfbench/spans.py and
its eight metrics) on hand-built runs: each one's value, None where the
keys or records are absent (a program without the spans), and the idle
shares' arithmetic over nested and overlapping records."""

import pytest

from perfbench import harness, spans, tracing
from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_metrics import make_run, sample

COUNTERS = {"graphs.captures": 3, "graphs.reserved_bytes": 5 * 2**20, "match.groups": 2, "match.host_reads": 5,
            "em.iterations": 12}


def read(name, run):
    return harness.reader(REPO, name)(run)


def timed(reads=10**6, traced=False, **timing):
    return sample(reads=reads, traced=traced, **timing)


def test_counter_readers_average_the_untraced_samples():
    samples = [timed(**COUNTERS), timed(**dict(COUNTERS, **{"graphs.captures": 5, "em.iterations": 8,
                                                           "match.groups": 3, "match.host_reads": 7,
                                                           "graphs.reserved_bytes": 2**20})),
               timed(traced=True, **{k: 999 for k in COUNTERS})]  # traced: not read
    run = make_run(samples)
    assert read("graphs.captures_per_sample", run) == 4.0
    assert read("em.iterations", run) == 10.0
    assert read("graphs.reserved_MiB_per_sample", run) == 3.0
    assert read("match.host_reads_per_group", run) == pytest.approx(12 / 5)


def test_capture_ms_per_mreads_counts_a_sample_without_captures_as_0():
    samples = [timed(reads=500_000, **{"graphs.captures": 2, "graphs.capture": 0.004}),
               timed(reads=1_500_000, **{"graphs.captures": 0, "graphs.capture": 0.0}),
               timed(reads=10**6, traced=True, **{"graphs.captures": 2, "graphs.capture": 9.0})]
    assert read("graphs.capture_ms_per_mreads", make_run(samples)) == pytest.approx(4.0 / 2.0)


@pytest.mark.parametrize("name", ["graphs.captures_per_sample", "graphs.capture_ms_per_mreads",
                                  "graphs.reserved_MiB_per_sample", "match.host_reads_per_group",
                                  "em.iterations", "match.device_idle_share", "stream.device_idle_share",
                                  "em.device_idle_share"])
def test_nothing_to_read_at_the_parent(name):
    """The parent reports only the stage times and has no srt records."""
    ev = [tracing.Ev("aten::add", 0, 50, False, True), tracing.Ev("kern", 10, 20, True)]
    run = make_run([timed(match=0.1, classes=0.01, em_assign=0.02), timed(traced=True, match=0.1)], ev,
                   spans=[(0.0, 100.0)], traced_s=1e-4)
    assert read(name, run) is None


def test_host_reads_per_group_needs_a_group():
    assert read("match.host_reads_per_group", make_run([timed(**{"match.groups": 0, "match.host_reads": 1})])) is None


@pytest.mark.parametrize("name,span", [("match.device_idle_share", "match"),
                                       ("stream.device_idle_share", "stream_match"),
                                       ("em.device_idle_share", "em_assign")])
def test_idle_share_over_nested_and_overlapping_records(name, span):
    host = [tracing.Ev("srt." + span, 0, 100, False), tracing.Ev("srt." + span, 20, 40, False),  # nested
            tracing.Ev("srt." + span, 90, 150, False),  # overlapping: the union is [0, 150]
            tracing.Ev("srt." + span, 300, 350, False),  # a second sample's record
            tracing.Ev("srt.other", 150, 300, False), tracing.Ev("aten::copy_", 0, 350, False, True)]
    device = [tracing.Ev("k1", 10, 30, True), tracing.Ev("k2", 25, 45, True),  # overlap: 35 busy
              tracing.Ev("k3", 140, 200, True),  # 10 inside the records
              tracing.Ev("k4", 320, 330, True), tracing.Ev("k5", 400, 500, True)]  # 10 inside, 0 inside
    run = make_run([timed(traced=True)], host + device, spans=[(0.0, 500.0)], traced_s=5e-4)
    assert read(name, run) == pytest.approx(100.0 * (1 - 55 / 200))


def test_idle_share_off_the_card_reads_nothing():
    run = make_run([timed(traced=True)], [tracing.Ev("srt.match", 0, 100, False)], spans=[(0.0, 100.0)],
                   traced_s=1e-4)
    assert spans.device_idle_share(run, "match") is None


def test_union_and_overlap():
    assert spans.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    assert spans.overlap([(0, 4), (5, 6)], [(1, 5.5)]) == pytest.approx(3.5)
    assert spans.overlap([], [(0, 1)]) == 0.0


def test_untraced_cpu_run_reads_every_counter_metric(tiny_root, capsys):
    """A CPU run of the port's fused engine: the counter and span-sum
    readers read numbers (no captures off a card: 0), the idle shares
    nothing (no device records)."""
    from perfbench.tests.conftest import last_line

    assert harness.main(["--workload", "tiny.mix", "--seed", "2147483777", "--seconds", "4", "--trace", "1"],
                        root=tiny_root, device="cpu") == 0
    metrics = last_line(capsys)[0]["metrics"]
    assert metrics["graphs.captures_per_sample"]["value"] == 0.0
    assert metrics["graphs.capture_ms_per_mreads"]["value"] == 0.0
    assert metrics["graphs.reserved_MiB_per_sample"]["value"] == 0.0
    assert metrics["match.host_reads_per_group"]["value"] == 2.0  # a group's sizes, the stats
    assert 0 < metrics["em.iterations"]["value"] <= 20
    assert not {"match.device_idle_share", "stream.device_idle_share", "em.device_idle_share"} & set(metrics)
