"""sketch_rna_tpu_torch — the PyTorch/CUDA port of sketch_rna_tpu.

`index` + `quant` on one NVIDIA Hopper GPU, on several (one rank process
per GPU), or on the CPU, where every hand-written kernel runs as its
plain PyTorch version: one k or several, reads of any length, any number
of reads.  Module names follow the JAX package so each counterpart is
easy to find:

  io/        FASTA/FASTQ parsing, validation, 2-bit codes (numpy), and
             the ctypes binding of the native parser (native/fastio.cpp)
  hash/      ntHash2 window tables + the sketch kernels (K1, K2, K3)
  sketch/    FracMinHash threshold + set dedup (the kernels' plain versions)
  index/     `.npz` and reference-binary index artifacts, the build,
             transfer to the device
  match/     index probe, posting expansion, row sort kernel (K4), top-C;
             the global-sort matcher that checks them (candidates.py)
  em/        equivalence classes, EM + assignment, EM checkpoints
  pipeline   the fused engine, routing, multi-sample, CSV
  stream     the streamed engine past the fused bound
  dist/      the process group, the (data, index) mesh, collectives and
             the sharded engine a rank runs (index shards: index/shard.py)
  oracle/    the reference's math in scalar NumPy, the golden model
  utils/     synthetic data, phase timer, profiler hook, the H100 roofline
  csrc/      CUDA C++ sources of the kernels (built lazily by kernels.py)

The package imports torch and numpy only — never jax, and nothing from
sketch_rna_tpu, which stays the reference the port is tested against.
"""

__version__ = "0.1.0"
