"""dispatch.select_us.serve_ttft: the host time of a dispatch from its
entry to the call of the arm that runs it (the port's ``dispatch.select``
counter: every dispatch, inner ones included), in us a dispatch."""

from cellbench.spans import counter_us


def read(r):
    return counter_us(r, "dispatch.select")
