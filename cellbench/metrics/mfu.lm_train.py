"""mfu.lm_train: the window's model FLOPs (cellbench/flops) over its seconds
and the card's datasheet peak for the configuration's dtype, in %."""

from cellbench.readers import mfu


def read(r):
    return mfu(r)
