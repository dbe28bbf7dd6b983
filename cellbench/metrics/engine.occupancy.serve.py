"""engine.occupancy.serve: mean requests decoded a decode step over the
engine's slots, in %."""

from cellbench.readers import occupancy


def read(r):
    return occupancy(r)
