"""engine.prefill_share.serve: the host seconds of the
``repro_torch.engine.prefill`` spans over those of the prefill and
``repro_torch.engine.decode`` spans, in %."""

from cellbench.spans import summary


def read(r):
    prefill, decode = summary(r, "engine.prefill"), summary(r, "engine.decode")
    if prefill is None and decode is None:
        return None
    p = prefill.host_s if prefill is not None else 0.0
    d = decode.host_s if decode is not None else 0.0
    return 100.0 * p / (p + d) if p + d > 0 else None
