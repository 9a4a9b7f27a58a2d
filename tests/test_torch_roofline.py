"""utils/roofline.py and the quant's CSV rows.

  - bound and the `*_work` rules reproduce the bounds of PERF.md §6's
    kernel table (pinning the move of the yardstick out of chip_smoke.py);
  - csv_rows equals the JAX package's on the sample at float64: the same
    names in the same order, values within 5e-9 relative (the float64
    fuzz bar of PARITY.md deviation 6) and equal as the CSV prints them.
"""

import os

import numpy as np
import pytest

from sketch_rna_tpu.config import QuantConfig as JaxConfig
from sketch_rna_tpu.index.build import build_index as jax_build_index
from sketch_rna_tpu.io.fasta import FastaRecords as JaxRecords
from sketch_rna_tpu.io.packing import PackedReads as JaxPacked
from sketch_rna_tpu.pipeline import quantify as jax_quantify
from sketch_rna_tpu_torch.config import QuantConfig
from sketch_rna_tpu_torch.index.artifact import to_device
from sketch_rna_tpu_torch.io.fasta import load_fasta
from sketch_rna_tpu_torch.io.fastq import load_fastq_dict
from sketch_rna_tpu_torch.io.packing import pack_reads
from sketch_rna_tpu_torch.pipeline import format_cpp_double, quantify
from sketch_rna_tpu_torch.utils import roofline as rf

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.mark.parametrize(
    "work,bound_us,by",
    [
        (rf.sort_work(8192, 256, 4), 5.008, "bytes"),  # K4
        (rf.sort_work(8192, 256, 8), 10.016, "bytes"),  # K4-int64
        (rf.merge_work(8192, 32768, 8), 1282.08, "bytes"),  # the merge's wide round
        (rf.sketch_work(8192, 104, (31,), (32,)), 0.978, "bytes"),  # K1
        (rf.sketch_work(8192, 104, (21, 31), (32, 32)), 1.692, "bytes"),  # K2
        (rf.kept_work(8192, 2000, 31, 140), 15.554, "operations"),  # K3
        (rf.group_work(8192, (128,), 64), 2.661, "bytes"),  # G, one k
        (rf.group_work(8192, (256, 128), 64), 5.165, "bytes"),  # G, ks (21, 31)
    ],
    ids=["K4", "K4-int64", "merge", "K1", "K2", "K3", "G-k31", "G-k21_31"],
)
def test_bounds_of_the_kernel_table(work, bound_us, by):
    ms, got_by = rf.bound(*work)
    assert got_by == by
    assert round(ms * 1e3, 3) == pytest.approx(bound_us, abs=1e-9)


def test_csv_rows_equal_jax_on_the_sample():
    recs = load_fasta(os.path.join(EXAMPLES, "sample.fa"))
    reads = load_fastq_dict(os.path.join(EXAMPLES, "sample.fq"))
    idx = jax_build_index(JaxRecords(recs.names, recs.seqs, 0), JaxConfig())
    packed, _, _ = pack_reads(list(reads.values()), list(reads.keys()), min_len=31, pad_len=256)
    ref = jax_quantify(idx, JaxPacked(packed.codes, packed.lengths, packed.ids), JaxConfig(em_dtype="float64"))
    got = quantify(to_device(idx, "cpu"), packed, QuantConfig(em_dtype="float64"))
    rows, want = got.csv_rows(), ref.csv_rows()
    assert len(rows) == 30 and [r[0] for r in rows] == [w[0] for w in want]
    np.testing.assert_allclose(np.array([r[1:] for r in rows]), np.array([w[1:] for w in want]), rtol=5e-9, atol=0)
    assert [format_cpp_double(v) for r in rows for v in r[1:]] == [format_cpp_double(v) for w in want for v in w[1:]]
