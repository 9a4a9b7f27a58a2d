"""The streamed cells' three readers (stream.upload_ms_per_mreads,
stream.length_groups_per_chunk, stream.captures_per_chunk) on hand-built
runs: None with nothing to read, and each one's arithmetic; and the
flow-cell mix's 2-bit samples at the 2,560 pad, which the check unpacks
(gen.sample_codes)."""

import json

import numpy as np
import pytest
import torch

from perfbench import gen
from perfbench.tests.conftest import REPO
from perfbench.tests.test_perfbench_metrics import make_run, read, sample

NAMES = ("stream.upload_ms_per_mreads", "stream.length_groups_per_chunk", "stream.captures_per_chunk")


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    """A program without the chunk loop's span and counter (the parent of
    the change that added them), a fused cell, and a window whose samples
    were all traced."""
    fused = [sample(match=0.1, **{"match.groups": 5, "graphs.captures": 0}), sample(traced=True, match=0.1)]
    older = [sample(stream_match=0.4, **{"match.groups": 20, "graphs.captures": 0})]
    traced = [sample(traced=True, stream_match=0.4,
                     **{"stream.upload": 0.1, "stream.chunks": 4, "match.groups": 20, "graphs.captures": 0})]
    for samples in (fused, older, traced):
        assert read(name, make_run(samples)) is None


def test_chunk_loop_readers():
    timing = [{"stream.upload": 0.02, "stream.chunks": 4, "match.groups": 20, "graphs.captures": 2},
              {"stream.upload": 0.06, "stream.chunks": 4, "match.groups": 19, "graphs.captures": 0}]
    samples = [sample(reads=2**22, **timing[0]), sample(reads=2**22, **timing[1]),
               sample(reads=2**22, traced=True, **{key: 999 for key in timing[0]})]  # traced: not read
    run = make_run(samples)
    assert read("stream.upload_ms_per_mreads", run) == pytest.approx(1e3 * 0.08 / (2**23 / 1e6))
    assert read("stream.length_groups_per_chunk", run) == pytest.approx(39 / 8)
    assert read("stream.captures_per_chunk", run) == pytest.approx(2 / 8)
    # No chunk at all (a declared counter of 0): nothing to divide by.
    empty = make_run([sample(**{"stream.upload": 0.0, "stream.chunks": 0, "match.groups": 0, "graphs.captures": 0})])
    assert read("stream.length_groups_per_chunk", empty) is None and read("stream.captures_per_chunk", empty) is None


def test_flowcell_mix_at_the_2bit_2560_pad():
    """The mix's samples are Packed2Reads at the native feed's pad of the
    2,560-base longest read (2,560 bases, 640 bytes a row), and
    sample_codes unpacks them to the codes the same draw gives as bytes."""
    mix = dict(json.loads((REPO / "perfbench" / "traffic" / "ont_flowcell_4m.json").read_text()), reads=300)
    gen.check_mix(mix)
    assert gen.pad_width(mix) == 2560 and gen.pad_width(dict(mix, packing="codes")) == 2560
    seqs = gen.synth_transcriptome(np.random.default_rng(2**31 + 4), 200)
    flat = torch.from_numpy(np.concatenate(seqs))
    lengths = torch.from_numpy(np.array([s.size for s in seqs], dtype=np.int32))
    two = gen.draw_pool(2**31 + 2560, flat, lengths, mix)[0]
    one = gen.draw_pool(2**31 + 2560, flat, lengths, dict(mix, packing="codes"))[0]
    assert two.pad_len == 2560 and two.codes2.shape == (300, 640) and two.codes2.dtype == np.uint8
    codes, lens = gen.sample_codes(two)
    assert codes.shape == (300, 2560) and np.array_equal(codes, one.codes) and np.array_equal(lens, one.lengths)
    assert lens.min() >= 100 and lens.max() <= max(s.size for s in seqs) and (lens > 1024).any()
