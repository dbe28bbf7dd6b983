"""attn.fused_share.serve_ttft: the share of the window's attention
dispatches that ran the port's fused kernel (``FUSED_ATTN``) rather
than the unfused plan, in %."""

from cellbench.attn_share import fused_share


def read(r):
    return fused_share(r)
