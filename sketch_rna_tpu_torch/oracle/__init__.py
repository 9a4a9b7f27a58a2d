"""The reference math as a scalar NumPy oracle (reference_oracle.py)."""

from sketch_rna_tpu_torch.oracle.reference_oracle import (  # noqa: F401
    oracle_assign,
    oracle_build_index,
    oracle_em,
    oracle_quant,
    oracle_sparse_chain,
)
