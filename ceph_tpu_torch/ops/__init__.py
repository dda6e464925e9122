"""Low-level array ops: GF arithmetic (NumPy) and the Hopper kernels."""
