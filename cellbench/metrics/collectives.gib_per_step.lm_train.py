"""collectives.gib_per_step.lm_train: the wire bytes one rank's
collectives moved in the window (the port's ring conventions,
``distributed/collectives.STATS``: the gradients' reduce-scatter, the
updated parameters' all-gather, the loss's and the norm's all-reduces)
over its steps, in GiB a step."""


def read(r):
    c = r.counters
    if r.trace is None or not c.get("steps") or c.get("collective_bytes") is None:
        return None
    return c["collective_bytes"] / c["steps"] / 2**30
