"""The kernels under the port's spans (``cellbench/span_kernels.py``) and
granite's readers of them, on profiler events made by hand: a kernel
belongs to a span when the host operation that launched it started
inside the span, its own interval counts and the device's idle time
inside the span does not."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from cellbench import harness
from cellbench.flops import granite as gflops
from cellbench.span_kernels import kernels_under
from cellbench.tests.tiny import tiny_context
from cellbench.trace import TraceData

CELL = "granite-h-small.serve-rag-over"


class Ev:
    """The accessors of a Kineto event that ``kernels_under`` reads."""

    def __init__(self, name, dev, start, dur, corr=0, linked=0, annotation=False):
        self._v = (name, dev, start, dur, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _events():
    """decode [0, 1000] holds experts [100, 200] (ops 1 and 2 inside it)
    and op 3 after it; the kernels run later on the device, with idle
    time between them."""
    return [
        Ev("repro_torch.engine.decode", CPU, 0, 1000, corr=10, annotation=True),
        Ev("repro_torch.moe.experts", CPU, 100, 100, corr=11, annotation=True),
        Ev("repro_torch.moe.experts", CUDA, 300, 200, linked=11, annotation=True),  # mirror
        Ev("aten::_grouped_mm", CPU, 110, 20, corr=1),
        Ev("aten::index_copy_", CPU, 150, 10, corr=2),
        Ev("aten::mm", CPU, 400, 10, corr=3),
        Ev("cudaLaunchKernel", CPU, 112, 5, corr=9001, linked=1),  # the runtime's call
        Ev("cudaDeviceSynchronize", CPU, 150, 900, corr=3),  # outside any op: CUPTI's id
        Ev("void cutlass::device_kernel<GemmUniversal>(Params)", CUDA, 300, 50, corr=9001,
           linked=1),
        Ev("at::native::index_elementwise_kernel<128>", CUDA, 340, 60, linked=2),
        Ev("nvjet_tst_64x32", CUDA, 900, 100, linked=3),
        Ev("at::native::elementwise_kernel", CUDA, 1200, 30, linked=0),  # no host op seen
    ]


def test_kernels_are_counted_under_the_spans_their_launches_lie_in():
    got = kernels_under(_events())
    experts = got["repro_torch.moe.experts"]
    assert experts.busy_s == pytest.approx(100e-9)  # [300, 350) and [340, 400), joined
    assert experts.kernels == pytest.approx({"cutlass::device_kernel": 50e-9,
                                             "at::native::index_elementwise_kernel": 60e-9})
    decode = got["repro_torch.engine.decode"]
    assert decode.busy_s == pytest.approx(200e-9)
    assert set(decode.kernels) == {"cutlass::device_kernel",
                                   "at::native::index_elementwise_kernel", "nvjet_tst_64x32"}


def test_no_kernels_no_spans():
    assert kernels_under([Ev("aten::mm", CPU, 0, 10, corr=1)]) == {}
    got = kernels_under([Ev("repro_torch.ssm.scan", CPU, 0, 10, corr=1),
                         Ev("k", CUDA, 50, 10, linked=7)])
    assert got["repro_torch.ssm.scan"].busy_s == 0.0


def _reader(name):
    path = harness.ROOT / "cellbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _r(under, busy_s):
    trace = TraceData(window_s=2e-6, busy_s=busy_s)
    if under is not None:
        trace.under = under
    cfg = tiny_context(CELL, cfg={}, mix={}).cfg  # the published widths
    return SimpleNamespace(cell=CELL, cfg=cfg, mix={}, counters={}, trace=trace)


def test_the_shares_are_over_busy_time():
    r = _r(kernels_under(_events()), busy_s=250e-9)
    assert _reader("moe.device_share.granite_serve")(r) == pytest.approx(40.0)
    assert _reader("ssm.scan_share.granite_serve")(r) is None  # no such span
    r = _r(None, busy_s=250e-9)  # a trace without the attribution
    assert _reader("moe.device_share.granite_serve")(r) is None


def test_the_expert_roofline_is_the_bound_over_the_gemm_kernels_alone():
    from repro_torch.core import spans

    r = _r(kernels_under(_events()), busy_s=250e-9)
    with spans.recording():
        for rows, experts in ((320, 70), (20, 15)):
            with spans.span("repro_torch.moe.experts", rows=rows) as rec:
                pass
            rec.ids["experts"] = torch.tensor(experts)
        bound = (gflops.expert_bound_s(r.cfg, 320, 70) + gflops.expert_bound_s(r.cfg, 20, 15))
        got = _reader("moe.expert_roofline.granite_serve")(r)
    assert got == pytest.approx(100.0 * bound / 50e-9)  # the cutlass kernel's 50 ns only
