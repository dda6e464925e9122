"""The codec kernels' share of their roofline (%): the least time of the
codec work this window completed (each data byte read once, each parity
or rebuilt byte written once, at the card's HBM rate) over the device
time of the kernels named below."""
import portbench.readers as r

KERNELS = ["xor_matmul_kernel"]


def read(run):
    return r.codec_roofline(run, KERNELS)
