"""engine.queue_wait_p90_ms.serve_ttft: the 90th percentile of the
``repro_torch.engine.queued`` spans (a request's wait from submit to its
prefill's start) of the requests admitted in the window, in ms."""

from cellbench.spans import p90_ms


def read(r):
    return p90_ms(r, "engine.queued")
