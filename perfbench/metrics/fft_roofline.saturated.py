"""The two FFT entry points of the CMux step (forward digits, inverse
torus) against their roofline: the least time of every launch in the
traced segment, by bytes or by flops, over its device time, in percent."""
from perfbench.metrics.kernels import roofline


def read(run):
    return roofline(run, ("fwd", "inv"))
