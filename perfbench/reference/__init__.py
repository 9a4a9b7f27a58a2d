"""The benchmark's plain reference (quant.py) and the frozen scalar oracle
that tests hold it to (oracle.py).  Neither imports the port or JAX."""
