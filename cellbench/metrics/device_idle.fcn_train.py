"""device_idle.fcn_train: the share of the traced window in which no kernel
ran on the card (the union of the kernels' intervals), in %."""

from cellbench.readers import device_idle


def read(r):
    return device_idle(r)
