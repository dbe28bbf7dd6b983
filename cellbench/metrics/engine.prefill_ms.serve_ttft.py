"""engine.prefill_ms.serve_ttft: the median host time of the
``repro_torch.engine.prefill`` spans (one request's admission, from its
padded tokens to its first token's read), in ms."""

from cellbench.spans import median_ms


def read(r):
    return median_ms(r, "engine.prefill")
