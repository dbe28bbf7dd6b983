"""engine.decode_step_ms.serve: the median host wall of the engine's decode
steps in the window, as the engine times them (``Request.token_lat``)."""

from cellbench.readers import median_ms


def read(r):
    return median_ms(r, "decode_step_s")
