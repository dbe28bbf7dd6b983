"""engine.step_self_ms.serve: the median self time of the
``repro_torch.engine.step`` spans -- a step's host time less its prefill
and decode spans (admission, eviction and the step's bookkeeping), in ms."""

from cellbench.spans import median_ms


def read(r):
    return median_ms(r, "engine.step", "self_s")
