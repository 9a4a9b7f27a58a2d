"""The benchmark of sketch_rna_tpu_torch, the PyTorch and CUDA port: one
cell (a configuration under a traffic mix) a run of `run.py`.  Every
configuration, traffic mix, per-layer metric and limit is a file of its
own under this folder, found by the name BENCHMARK.json gives it."""
