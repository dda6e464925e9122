"""Low-level array ops: GF arithmetic (NumPy), the rjenkins hashes, the
byte-layout GF(2^8) product and the Hopper kernels K1 and K2."""
