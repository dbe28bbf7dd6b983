"""dispatch.calls_per_step.lm_train: outermost dispatches (GEMMs and
attention plans, forward, recompute and backward) a training step, from
the port's ``account_dispatches`` hook over the traced window."""

from cellbench.readers import calls_per_step


def read(r):
    return calls_per_step(r)
