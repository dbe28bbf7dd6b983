"""gemm_roofline.serve_ttft: the roofline bound of every NT/NN/TN/BNT/BNN
dispatch of the traced window (counted from its OpKey by the dispatch
hook, whichever candidate ran it) over the device time of the GEMM
kernels, classified by name (cellbench/readers.py), in %."""

from cellbench.readers import gemm_roofline


def read(r):
    return gemm_roofline(r)
