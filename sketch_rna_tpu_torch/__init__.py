"""sketch_rna_tpu_torch — the PyTorch/CUDA port of sketch_rna_tpu.

Single-k `index` + `quant` on one NVIDIA Hopper GPU (or on the CPU,
where every hand-written kernel runs as its plain PyTorch version).
Module names follow the JAX package so each counterpart is easy to find:

  io/      FASTA/FASTQ parsing, validation, 2-bit codes (numpy)
  hash/    ntHash2 window tables + the fused sketch kernel (K1)
  sketch/  FracMinHash threshold + set dedup (K1's plain version)
  index/   `.npz` index artifact, single-k build, transfer to the device
  match/   index probe, posting expansion, row sort kernel (K4), top-C
  em/      equivalence classes, EM + soft assignment
  csrc/    CUDA C++ sources of the kernels (built lazily by kernels.py)

The package imports torch and numpy only — never jax, and nothing from
sketch_rna_tpu, which stays the reference the port is tested against.
"""

__version__ = "0.1.0"
