"""moe.expert_roofline.granite_serve: the roofline bound of the routed
experts' grouped GEMMs (cellbench/flops/granite.py: each call's rows
and the experts they touched, from the ids of its
``repro_torch.moe.experts`` span) over the device time of the GEMM
kernels launched under those spans (``cellbench/span_kernels.py``;
GEMM kernels by name, as ``readers.GEMM_KERNELS``), in %."""

import re

from cellbench.flops import granite as gflops
from cellbench.readers import GEMM_KERNELS
from cellbench.span_kernels import PREFIX, under
from cellbench.spans import _recorder


def read(r):
    u, spans = under(r, "moe.experts"), _recorder(r)
    if u is None or spans is None:
        return None
    gemm = sum(s for name, s in u.kernels.items() if re.search(GEMM_KERNELS, name))
    calls = spans.records(PREFIX + "moe.experts")
    if gemm <= 0 or not calls or any("experts" not in c.ids for c in calls):
        return None
    bound = sum(gflops.expert_bound_s(r.cfg, c.ids["rows"], c.ids["experts"]) for c in calls)
    return 100.0 * bound / gemm
