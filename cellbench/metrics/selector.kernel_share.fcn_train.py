"""selector.kernel_share.fcn_train: the share of the window's NT dispatches
that the default learned selector sent to one of the port's kernel arms
rather than cuBLAS (``SelectorStats.by_op``), in %."""

from cellbench.readers import kernel_share


def read(r):
    return kernel_share(r, "NT")
