"""ssm.scan_share.granite_serve: the device time of the kernels launched
under the ``repro_torch.ssm.scan`` spans (the chunked SSD of a prefill,
the state update of a decode step) over the traced window's busy time,
in %.  The kernels' own intervals, joined (``cellbench/span_kernels.py``):
the device's idle time inside a span does not count."""

from cellbench.span_kernels import busy_share


def read(r):
    return busy_share(r, "ssm.scan")
