"""The reader of graphs.replays_per_sample on hand-built runs: the mean of
the counter over the untraced samples, and nothing where the program has
no such counter (a parent without the index-lived graph store)."""

from perfbench import harness
from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_metrics import make_run, sample


def read(run):
    return harness.reader(REPO, "graphs.replays_per_sample")(run)


def test_replays_average_the_untraced_samples():
    samples = [sample(**{"graphs.replays": 256}), sample(**{"graphs.replays": 253}),
               sample(traced=True, **{"graphs.replays": 999})]  # traced: not read
    assert read(make_run(samples)) == 254.5


def test_nothing_to_read_at_the_parent():
    assert read(make_run([sample(match=0.1, **{"graphs.captures": 3}), sample(traced=True)])) is None
