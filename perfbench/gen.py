"""The benchmark's traffic generator: one general generator that every
traffic mix (traffic/<mix>.json) parameterises.

synth_transcriptome is a frozen copy of the port's
sketch_rna_tpu_torch/utils/synth.py synth_transcriptome (the same
numbers for the same Generator state).  draw_sample extends that file's
sample_reads: reads are drawn on the device with torch from one
torch.Generator, so the same seed gives the same samples on one kind of
device, and then copied to host memory once, because users' reads
arrive from the host.

A mix's keys (every one is required; see README.md):

  reads              reads in one sample
  read_len           the longest read; read_len_min, if set, draws each
                     read's length uniformly from [read_len_min, read_len]
  abundance_sigma    transcripts are chosen with probability proportional
                     to abundance x length, abundances log-normal with
                     this sigma (natural log; 0 = uniform).  With
                     abundance_table set (a data file beside the mix, read
                     by read_table) each transcript's abundance is also
                     multiplied by a value drawn from the table, so a
                     published expression profile can set the skew
  substitution_rate  per-base probability of a substitution (a different
                     base, uniformly); substitution_by_position, if set (a
                     list of read_len or more weights), shares that rate
                     out along the read in proportion to the weights
  off_target         share of reads that are uniform random sequence (an
                     exact count, round(share x reads))
  packing            "codes": a PackedReads padded as the CLI pads
                     (max(256, longest rounded up to 128)); "2bit": a
                     Packed2Reads at the native feed's pad (longest
                     rounded up to 8, then to 4)
  pool               distinct samples drawn from the seed and cycled
  warmup_samples     samples quantified in set-up
  trace_samples      samples traced at the start of a --trace 1 window
  check_samples      pool samples whose window results the reference
                     checks, chosen from the seed
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MIX_KEYS = ("reads", "read_len", "abundance_sigma", "substitution_rate", "off_target", "packing", "pool",
            "warmup_samples", "trace_samples", "check_samples")
# Reads drawn in one block on the device (bounds the gather's index tensor).
BLOCK_READS = 1 << 20


def synth_transcriptome(rng: np.random.Generator, n: int, len_lo: int = 600, len_hi: int = 2500,
                        iso_frac: float = 0.6, length_table: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Isoform families sharing long exact stretches: a random base
    transcript, then with probability iso_frac per step an isoform that
    skips a middle segment and gains a 50-base tail.  A base transcript's
    length is uniform in [len_lo, len_hi), or with length_table drawn from
    the table's values (the port's generator has no table)."""
    seqs: List[np.ndarray] = []
    while len(seqs) < n:
        if length_table is None:
            ln = int(rng.integers(len_lo, len_hi))
        else:
            ln = int(length_table[rng.integers(0, length_table.size)])
        base = rng.integers(0, 4, size=ln).astype(np.uint8)
        seqs.append(base)
        while len(seqs) < n and rng.random() < iso_frac:
            a = int(rng.integers(0, ln // 3))
            b = int(rng.integers(a, ln))
            iso = np.concatenate([base[:a], base[b:], rng.integers(0, 4, size=50).astype(np.uint8)])
            if iso.size >= 100:
                seqs.append(iso.astype(np.uint8))
    return seqs[:n]


def read_table(path: Path) -> np.ndarray:
    """The numbers of a data file (.txt or .csv), float64: separated by
    commas or white space, each "#" starting a comment to the line's end."""
    text = Path(path).read_text()
    return np.array([float(x) for line in text.splitlines() for x in line.split("#", 1)[0].replace(",", " ").split()],
                    dtype=np.float64)


def transcriptome(recipe: Dict, folder: Optional[Path] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(flat 2-bit base codes [M] uint8, lengths [T] int32) of a
    configuration's transcriptome recipe; a recipe's length_table names a
    data file in `folder` (the configurations' folder)."""
    if recipe["generator"] != "synth_transcriptome":
        raise ValueError(f"unknown transcriptome generator {recipe['generator']!r}")
    table = None
    if "length_table" in recipe:
        table = read_table(Path(folder) / recipe["length_table"]).astype(np.int64)
        if not table.size or table.min() < 3:
            raise ValueError("a length table holds transcript lengths of 3 bases or more")
    seqs = synth_transcriptome(np.random.default_rng(recipe["seed"]), recipe["transcripts"],
                               recipe.get("len_lo", 600), recipe.get("len_hi", 2500),
                               recipe.get("iso_frac", 0.6), table)
    return np.concatenate(seqs), np.array([s.size for s in seqs], dtype=np.int32)


def check_mix(mix: Dict) -> None:
    missing = [key for key in MIX_KEYS if key not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    if mix["packing"] not in ("codes", "2bit"):
        raise ValueError(f"packing {mix['packing']!r}: 'codes' or '2bit'")
    if not 0 <= mix["off_target"] <= 1 or not 0 <= mix["substitution_rate"] < 1:
        raise ValueError("off_target and substitution_rate are shares")
    w = np.asarray(mix.get("substitution_by_position", [1.0] * int(mix["read_len"])), np.float64)
    if w.size < int(mix["read_len"]) or w.min() < 0 or not w[: int(mix["read_len"])].sum() > 0:
        raise ValueError("substitution_by_position: read_len or more weights, none below 0, not all 0")


def load_tables(mix: Dict, folder: Path) -> Dict:
    """The mix with its abundance_table (a data file in `folder`, the
    mixes' folder) read into abundance_values."""
    if "abundance_table" not in mix:
        return mix
    values = read_table(Path(folder) / mix["abundance_table"])
    if not values.size or values.min() < 0 or not values.max() > 0:
        raise ValueError("an abundance table holds numbers of 0 or more, not all 0")
    return dict(mix, abundance_values=values)


def pad_width(mix: Dict) -> int:
    """The padded row width the mix's samples take (see the module doc)."""
    longest = int(mix["read_len"])
    if mix["packing"] == "2bit":
        return -(-(-(-longest // 8) * 8) // 4) * 4
    return max(256, -(-longest // 128) * 128)


def _block(gen: torch.Generator, flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
           cdf: torch.Tensor, n: int, n_off: int, mix: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """n reads ([n, read_len] uint8 codes, zero past each length; [n]
    int32 lengths) of which the last n_off are off-target."""
    dev = flat.device
    L = int(mix["read_len"])
    lo = int(mix.get("read_len_min", L))
    rl = torch.randint(lo, L + 1, (n,), generator=gen, device=dev) if lo < L else torch.full((n,), L, device=dev)
    n_on = n - n_off
    u = torch.rand(n_on, generator=gen, device=dev, dtype=torch.float64) * cdf[-1]
    tid = torch.searchsorted(cdf, u, right=True).clamp_(max=lens.numel() - 1)
    eff = torch.minimum(lens[tid], rl[:n_on])
    span = (lens[tid] - eff + 1).to(torch.float64)
    start = offs[tid] + (torch.rand(n_on, generator=gen, device=dev, dtype=torch.float64) * span).long()
    col = torch.arange(L, device=dev)
    codes = torch.empty((n, L), dtype=torch.uint8, device=dev)
    codes[:n_on] = flat[(start[:, None] + col[None, :]).clamp_(max=flat.numel() - 1)]
    codes[n_on:] = torch.randint(0, 4, (n_off, L), generator=gen, device=dev, dtype=torch.uint8)
    lengths = torch.cat([eff, rl[n_on:]]).to(torch.int32)
    inside = col[None, :] < lengths[:, None]
    rate = float(mix["substitution_rate"])
    if rate > 0:
        prob = rate
        if "substitution_by_position" in mix:
            w = torch.tensor(mix["substitution_by_position"][:L], dtype=torch.float32, device=dev)
            prob = (rate * w / w.mean())[None, :]
        err = (torch.rand((n, L), generator=gen, device=dev) < prob) & inside
        shift = torch.randint(1, 4, (n, L), generator=gen, device=dev, dtype=torch.uint8)
        codes = torch.where(err, (codes + shift) % 4, codes)
    return torch.where(inside, codes, 0).to(torch.uint8), lengths


def draw_sample(gen: torch.Generator, flat: torch.Tensor, lengths: torch.Tensor, mix: Dict):
    """One sample of the mix, drawn on flat's device from gen: a
    PackedReads or Packed2Reads (mix["packing"]) on the host.

    flat / lengths: the transcriptome's codes [M] uint8 and lengths [T]
    on the device.  Each sample draws its own abundances; its reads come
    in blocks of BLOCK_READS, the off-target ones shuffled in."""
    from sketch_rna_tpu_torch.io.packing import Packed2Reads, PackedReads

    dev = flat.device
    N, L, W = int(mix["reads"]), int(mix["read_len"]), pad_width(mix)
    lens = lengths.to(dev, torch.int64)
    offs = torch.cumsum(lens, 0) - lens
    sigma = float(mix["abundance_sigma"])
    abundance = torch.exp(sigma * torch.randn(lens.numel(), generator=gen, device=dev, dtype=torch.float64))
    if "abundance_values" in mix:
        values = torch.as_tensor(mix["abundance_values"], dtype=torch.float64, device=dev)
        abundance *= values[torch.randint(values.numel(), (lens.numel(),), generator=gen, device=dev)]
    cdf = torch.cumsum(abundance * lens, 0)
    n_off = int(round(float(mix["off_target"]) * N))
    off_rows = torch.zeros(N, dtype=torch.bool, device=dev)
    off_rows[torch.randperm(N, generator=gen, device=dev)[:n_off]] = True
    out_w = W // 4 if mix["packing"] == "2bit" else W
    codes_host = torch.zeros((N, out_w), dtype=torch.uint8)
    lengths_host = torch.zeros(N, dtype=torch.int32)
    for r0 in range(0, N, BLOCK_READS):
        r1 = min(r0 + BLOCK_READS, N)
        off = off_rows[r0:r1]
        codes, lens_b = _block(gen, flat, offs, lens, cdf, r1 - r0, int(off.sum()), mix)
        # Rows of the block in place: on-target reads, then off-target ones.
        order = torch.cat([torch.nonzero(~off).flatten(), torch.nonzero(off).flatten()])
        rows = torch.empty_like(order)
        rows[order] = torch.arange(order.numel(), device=dev)
        codes, lens_b = codes[rows], lens_b[rows]
        padded = torch.zeros((r1 - r0, W), dtype=torch.uint8, device=dev)
        padded[:, :L] = codes
        if mix["packing"] == "2bit":
            q = padded.view(r1 - r0, W // 4, 4)
            padded = q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4) | (q[:, :, 3] << 6)
        codes_host[r0:r1] = padded.cpu()
        lengths_host[r0:r1] = lens_b.cpu()
    if mix["packing"] == "2bit":
        return Packed2Reads(codes_host.numpy(), lengths_host.numpy(), W)
    return PackedReads(codes_host.numpy(), lengths_host.numpy(), [])


def sample_codes(sample) -> Tuple[np.ndarray, np.ndarray]:
    """([N, L] uint8 codes, [N] lengths) of a drawn sample, either packing."""
    if hasattr(sample, "codes2"):
        shifts = np.arange(4, dtype=np.uint8) * 2
        codes = ((sample.codes2[..., None] >> shifts) & 3).reshape(sample.codes2.shape[0], -1)
        return codes[:, : sample.pad_len], sample.lengths
    return sample.codes, sample.lengths


def draw_pool(seed: int, flat: torch.Tensor, lengths: torch.Tensor, mix: Dict) -> list:
    """The mix's pool of distinct samples, drawn from one generator seeded
    with `seed` on flat's device."""
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(int(seed) % (1 << 64))
    return [draw_sample(gen, flat, lengths, mix) for _ in range(int(mix["pool"]))]
