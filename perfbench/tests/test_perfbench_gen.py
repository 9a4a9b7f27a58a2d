"""The traffic generator: deterministic for a seed, and each parameter of a
mix honoured."""

import numpy as np
import pytest
import torch

from perfbench import gen

TX = {"generator": "synth_transcriptome", "seed": 3, "transcripts": 400, "len_lo": 120, "len_hi": 600,
      "iso_frac": 0.6}
BASE = {"reads": 20000, "read_len": 100, "abundance_sigma": 1.5, "substitution_rate": 0.0, "off_target": 0.0,
        "packing": "codes", "pool": 1, "warmup_samples": 1, "trace_samples": 1, "check_samples": 1}


@pytest.fixture(scope="module")
def tx():
    flat, lengths = gen.transcriptome(TX)
    return torch.from_numpy(flat), torch.from_numpy(lengths)


def draw(tx, seed=2**31 + 99, **kw):
    return gen.draw_pool(seed, tx[0], tx[1], dict(BASE, **kw))[0]


def located(tx, codes, lens):
    """For each read, whether its bases occur verbatim in the transcriptome."""
    text = gen.np.frombuffer(b"ACGT", np.uint8)[tx[0].numpy()].tobytes()
    return np.array([text.find(np.frombuffer(b"ACGT", np.uint8)[codes[i, : lens[i]]].tobytes()) >= 0
                     for i in range(codes.shape[0])])


def test_transcriptome_is_the_ports_generator():
    from sketch_rna_tpu_torch.utils.synth import synth_transcriptome

    seqs = synth_transcriptome(np.random.default_rng(3), 400, 120, 600)
    flat, lengths = gen.transcriptome(TX)
    assert np.array_equal(flat, np.concatenate(seqs)) and lengths.tolist() == [s.size for s in seqs]


def test_same_seed_same_pool_other_seed_other_pool(tx):
    mix = dict(BASE, pool=2, reads=3000, substitution_rate=0.01, off_target=0.1)
    a = gen.draw_pool(2**31 + 5, tx[0], tx[1], mix)
    b = gen.draw_pool(2**31 + 5, tx[0], tx[1], mix)
    c = gen.draw_pool(2**31 + 6, tx[0], tx[1], mix)
    assert all(np.array_equal(x.codes, y.codes) and np.array_equal(x.lengths, y.lengths) for x, y in zip(a, b))
    assert not np.array_equal(a[0].codes, a[1].codes)
    assert not np.array_equal(a[0].codes, c[0].codes)
    assert all(x.num_reads == 3000 for x in a + c)


def test_lengths_padding_and_clean_reads(tx):
    s = draw(tx, reads=4000)
    assert s.codes.shape == (4000, 256)  # the CLI's pad for reads up to 256 bases
    longest = int(tx[1].max())
    assert s.lengths.max() == 100 and s.lengths.min() >= 100 if longest >= 100 else True
    cols = np.arange(256)[None, :]
    assert not s.codes[cols >= s.lengths[:, None]].any()
    assert located(tx, s.codes[:300], s.lengths[:300]).all()  # no errors, no off-target: verbatim


def test_read_len_min_draws_lengths_in_range(tx):
    s = draw(tx, reads=4000, read_len_min=50)
    assert 50 <= s.lengths.min() and s.lengths.max() <= 100 and len(np.unique(s.lengths)) > 20


def test_substitution_rate(tx):
    rate = 0.02
    s = draw(tx, reads=20000, substitution_rate=rate)
    clean = draw(tx, reads=20000)
    # The same draws but for the error planes: the bases that differ are the substitutions.
    diff = (s.codes != clean.codes).sum() / s.lengths.sum()
    assert diff == pytest.approx(rate, rel=0.1)


def test_off_target_share_is_exact(tx):
    s = draw(tx, reads=2000, off_target=0.25)
    found = located(tx, s.codes, s.lengths)
    assert (~found).sum() == pytest.approx(500, abs=5)  # a random 100-mer is never in the transcriptome
    first, last = np.flatnonzero(~found)[[0, -1]]
    assert first < 500 and last > 1500  # shuffled in, not a block at the end


def test_abundance_sigma_skews_the_choice():
    # No isoforms: each read's first 30 bases name its transcript.
    flat, lengths = gen.transcriptome(dict(TX, iso_frac=0.0))
    text = np.frombuffer(b"ACGT", np.uint8)[flat].tobytes()
    ends = np.cumsum(lengths)

    def top_share(sigma):
        s = draw((torch.from_numpy(flat), torch.from_numpy(lengths)), reads=2000, abundance_sigma=sigma)
        tids = [int(np.searchsorted(ends, text.find(np.frombuffer(b"ACGT", np.uint8)[s.codes[i, :30]].tobytes()),
                                    side="right")) for i in range(2000)]
        counts = np.sort(np.bincount(tids, minlength=lengths.size))[::-1]
        return counts[:20].sum() / 2000

    uniform = top_share(0.0)
    assert uniform < 0.15  # 20 of 400 transcripts, chosen by length alone
    assert top_share(1.5) > 2.5 * uniform


def test_2bit_packing_unpacks_to_the_codes(tx):
    a = draw(tx, reads=3000, packing="codes", substitution_rate=0.01, off_target=0.1)
    b = draw(tx, reads=3000, packing="2bit", substitution_rate=0.01, off_target=0.1)
    assert b.pad_len == 104 and b.codes2.shape == (3000, 26)  # the native feed's pad: 100 up to 8, then to 4
    codes, lens = gen.sample_codes(b)
    assert np.array_equal(codes, a.codes[:, :104]) and np.array_equal(lens, a.lengths)


def test_check_mix_refuses_a_mix_without_its_keys():
    with pytest.raises(ValueError):
        gen.check_mix({k: v for k, v in BASE.items() if k != "off_target"})
    with pytest.raises(ValueError):
        gen.check_mix(dict(BASE, packing="fasta"))


def test_abundance_table_sets_the_skew(tmp_path):
    # No isoforms: each read's first 30 bases name its transcript.
    flat, lengths = gen.transcriptome(dict(TX, iso_frac=0.0))
    text = np.frombuffer(b"ACGT", np.uint8)[flat].tobytes()
    ends = np.cumsum(lengths)
    (tmp_path / "table.csv").write_text("# relative abundances\n0, 0, 0\n1000\n")
    mix = gen.load_tables(dict(BASE, abundance_sigma=0.0, abundance_table="table.csv"), tmp_path)
    assert mix["abundance_values"].tolist() == [0.0, 0.0, 0.0, 1000.0]
    s = gen.draw_pool(2**31 + 5, torch.from_numpy(flat), torch.from_numpy(lengths), dict(mix, reads=3000))[0]
    tids = {int(np.searchsorted(ends, text.find(np.frombuffer(b"ACGT", np.uint8)[s.codes[i, :30]].tobytes()),
                                side="right")) for i in range(3000)}
    # A quarter of the transcripts draw the one nonzero value: reads come from them alone.
    assert 0.15 * lengths.size < len(tids) < 0.35 * lengths.size
    (tmp_path / "zero.txt").write_text("0 0\n")
    with pytest.raises(ValueError):
        gen.load_tables(dict(BASE, abundance_table="zero.txt"), tmp_path)


def test_substitutions_follow_the_position_weights():
    # One transcript of a single base: a read's nonzero codes are its substitutions.
    flat, lengths = torch.zeros(5000, dtype=torch.uint8), torch.tensor([5000], dtype=torch.int32)
    weights = [0.0] * 60 + [1.0] * 40
    s = gen.draw_pool(2**31 + 6, flat, lengths, dict(BASE, reads=4000, substitution_rate=0.02,
                                                      substitution_by_position=weights))[0]
    errs = s.codes[:, :100] != 0
    assert not errs[:, :60].any()
    assert errs[:, 60:].mean() == pytest.approx(0.02 * 100 / 40, rel=0.1)  # the rate shared out over 40 bases
    with pytest.raises(ValueError):
        gen.check_mix(dict(BASE, substitution_by_position=[1.0] * 99))


def test_length_table_sets_the_transcript_lengths(tmp_path):
    (tmp_path / "lengths.txt").write_text("300\n450\n")
    flat, lengths = gen.transcriptome(dict(TX, iso_frac=0.0, length_table="lengths.txt"), tmp_path)
    assert set(lengths.tolist()) == {300, 450} and flat.size == lengths.sum()
    # Without a table the recipe gives the port's generator's transcriptome (the test above).
    assert not np.array_equal(lengths, gen.transcriptome(dict(TX, iso_frac=0.0))[1])
