"""``attribution``: device operations put down to the program's stages, on
hand-built lists of Kineto-like events (the methods of
``torch._C._autograd._KinetoEvent`` that it reads; an operator's own
correlation id shares its numbers with the runtime's), and the readers of
the per-stage readings."""
import contextlib
import math
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import attribution, bench, loops, smoke, spec, trace
from repro_torch.obs.metrics import MetricsRegistry


class Ev:
    """One Kineto-like event."""

    def __init__(self, name, a, b, *, device=False, activity="cpu_op",
                 corr=0):
        self._name, self._a, self._b = name, a, b
        self._device, self._activity, self._corr = device, activity, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return self._activity in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr


def host_range(name, a, b, corr=0):
    """A benchmark span (a user annotation) or a program stage (an
    operator range)."""
    kind = "user_annotation" if name.startswith("pb.") else "cpu_op"
    return Ev(name, a, b, activity=kind, corr=corr)


def launch(t, corr, name="cudaLaunchKernel"):
    return Ev(name, t, t + 5, activity="cuda_runtime", corr=corr)


def test_launch_names():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cudaMemcpyAsync", "cuLaunchKernelEx", "cudaMemsetAsync"):
        assert attribution.LAUNCH.match(name), name
    for name in ("aten::cudnn_convolution", "cudnn_conv", "custom.stage",
                 "Activity Buffer Request", "pb.window", "cudaX y"):
        assert not attribution.LAUNCH.match(name), name


def kernel(name, a, b, corr, activity="kernel"):
    return Ev(name, a, b, device=True, activity=activity, corr=corr)


def mirror(name, a, b):
    return Ev(name, a, b, device=True, activity="gpu_user_annotation")


def parent_events():
    """A window of the parent's program: only the benchmark's ranges, and
    their device mirrors."""
    return [
        host_range("pb.window", 0, 10_000),
        host_range("pb.decode_batch", 100, 2_000),
        host_range("pb.restore", 2_000, 3_000),
        launch(2_100, 11, "cudaMemcpyAsync"),
        launch(2_300, 12),
        host_range("aten::conv2d", 2_250, 2_400, corr=12),
        host_range("pb.cloud", 3_000, 4_000),
        launch(3_100, 13),
        host_range("pb.to_host", 4_000, 6_000),
        launch(4_050, 14, "cudaMemcpyAsync"),
        kernel("Memcpy HtoD (Pageable -> Device)", 2_150, 2_400, 11,
               "gpu_memcpy"),
        kernel("void conv_kernel<float>(float*)", 2_500, 3_500, 12),
        kernel("void tail_kernel(float*)", 3_600, 4_500, 13),
        kernel("Memcpy DtoH (Device -> Pageable)", 4_600, 4_700, 14,
               "gpu_memcpy"),
        mirror("pb.restore", 2_150, 3_500),
        mirror("pb.cloud", 3_600, 4_500),
        mirror("pb.to_host", 4_600, 4_700),
    ]


def program_events():
    """The same window with the program's stages, the launches inside
    them, and the device mirror of a user annotation not under ``pb.``."""
    return [
        host_range("pb.window", 0, 10_000),
        host_range("pb.serve", 100, 9_000),
        host_range("gateway.run_batch", 200, 8_000),
        host_range("pipeline.decode_batch", 300, 1_500),
        host_range("codec.unpack", 300, 900),
        host_range("pipeline.untile", 1_000, 1_400),
        host_range("pipeline.restore", 2_000, 3_000),
        host_range("pipeline.h2d", 2_000, 2_200),
        launch(2_100, 21, "cudaMemcpyAsync"),
        launch(2_500, 22, "cuLaunchKernel"),
        # an operator's own correlation id is no launch
        host_range("aten::conv2d", 2_450, 2_600, corr=23),
        host_range("split.cloud", 3_000, 4_000),
        launch(3_100, 23),
        launch(7_000, 24, "cudaMemcpyAsync"),      # run_batch's own copy
        kernel("Memcpy HtoD (Pageable -> Device)", 2_150, 2_350, 21,
               "gpu_memcpy"),
        kernel("void baf_conv(float*)", 2_600, 3_400, 22),
        kernel("void tail_kernel(float*)", 3_500, 5_000, 23),
        kernel("Memcpy DtoH (Device -> Pageable)", 7_100, 7_200, 24,
               "gpu_memcpy"),
        kernel("void orphan(float*)", 5_000, 5_300, 99),   # no launch
        mirror("split.cloud", 3_500, 5_000),
        mirror("pb.serve", 2_150, 7_200),
    ]


STAGES = {"gateway.run_batch", "pipeline.decode_batch", "codec.unpack",
          "pipeline.untile", "pipeline.restore", "pipeline.h2d",
          "split.cloud"}


def _profiled_by_parent(monkeypatch, events):
    """``trace.profiled`` as it stands, fed ``events`` for its session."""
    import torch.profiler as tp

    class FakeProfile:
        def __init__(self, *a, **k):
            self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
                events=lambda: list(events)))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tp, "profile", FakeProfile)
    monkeypatch.setattr(tp, "record_function",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    return trace.profiled(lambda: None)[1]


def test_parent_trace_reads_as_trace_profiled(monkeypatch):
    events = parent_events()
    want = _profiled_by_parent(monkeypatch, events)
    got = attribution.collect(events, set())
    assert got.ops == want.ops
    assert got.spans == want.spans
    assert got.window == want.window
    assert got.busy() == want.busy()
    assert got.top_ops() == want.top_ops()
    assert got.idle_gaps() == want.idle_gaps()
    assert got.program == []
    assert got.unattributed_share() == 1.0


@pytest.mark.parametrize("name", ["split.cloud", "pb.serve", "kernel_like"])
def test_annotation_mirror_never_enters_ops(monkeypatch, name):
    events = [host_range("pb.window", 0, 1_000), launch(10, 1),
              kernel("void k(float*)", 100, 200, 1),
              mirror(name, 100, 200)]
    got = attribution.collect(events, {"split.cloud"})
    assert [o[0] for o in got.ops] == ["void k(float*)"]
    # the parent's reading selects by name: a mirror outside pb. is an op
    parent = _profiled_by_parent(monkeypatch, events)
    assert (name in [o[0] for o in parent.ops]) == (name != "pb.serve")


def test_each_op_goes_to_the_innermost_stage_that_launched_it():
    tr = attribution.collect(program_events(), STAGES)
    by_op = dict(zip((o[0] for o in tr.ops), tr.launched_by()))
    assert by_op == {"Memcpy HtoD (Pageable -> Device)": "pipeline.h2d",
                     "void baf_conv(float*)": "pipeline.restore",
                     "void tail_kernel(float*)": "split.cloud",
                     "Memcpy DtoH (Device -> Pageable)": "gateway.run_batch",
                     "void orphan(float*)": None}
    assert tr.device_ns_by_stage() == {"pipeline.h2d": 200,
                                       "pipeline.restore": 800,
                                       "split.cloud": 1_500,
                                       "gateway.run_batch": 100, None: 300}
    assert tr.device_ns_within("pipeline.restore") == 1_000
    assert tr.device_ns_within("gateway.run_batch") == 2_600
    assert tr.device_ns_within("split.edge") == 0
    assert tr.unattributed_share() == 300 / 2_900


def test_launch_outside_every_stage_is_unattributed():
    events = [host_range("pb.window", 0, 1_000),
              host_range("split.edge", 100, 200), launch(50, 1),
              launch(150, 2), kernel("a", 300, 400, 1),
              kernel("b", 400, 700, 2)]
    tr = attribution.collect(events, {"split.edge"})
    assert tr.launched_by() == [None, "split.edge"]
    assert tr.unattributed_share() == 100 / 400


def test_stage_lookup_at_shared_edges():
    table = attribution._innermost_map([("a", 0, 10), ("b", 0, 4),
                                        ("c", 4, 10), ("d", 12, 14)])
    at = [attribution._lookup(table, t) for t in (-1, 0, 3, 4, 9, 10, 12, 14)]
    assert at == [None, "b", "b", "c", "c", None, "d", None]


def test_idle_gaps_split_each_benchmark_span_and_keep_its_total():
    tr = attribution.collect(program_events(), STAGES)
    base = dict(trace.Trace.idle_gaps(tr, 100))
    fine = dict(tr.idle_gaps(100))
    assert {"serve", "serve/pipeline.untile", "serve/split.cloud"} <= \
        fine.keys()
    summed: dict = {}
    for name, s in fine.items():
        summed[name.split("/")[0]] = summed.get(name.split("/")[0], 0) + s
    assert summed.keys() == base.keys()
    for name, s in base.items():
        assert math.isclose(summed[name], s, rel_tol=1e-12), name
    # the card is idle from the window's start to 2150; the middle, 1075,
    # lies in the untile
    assert fine["serve/pipeline.untile"] == pytest.approx(2_150e-9)


def _ctx(tr, registry, completed=4):
    win = loops.Window(t0=0.0, t1=1.0, latencies=[0.1] * completed)
    return bench.Context({}, {}, win, tr, registry, 0.0, {}, {}, None)


def test_stage_names_come_from_the_registry():
    registry = MetricsRegistry()
    registry.histogram("stage_seconds", stage="split.edge").observe(0.1)
    registry.histogram("stage_seconds", stage="pipeline.encode",
                       backend="raw").observe(0.1)
    registry.histogram("other", stage="x.y").observe(0.1)
    assert attribution.stage_names(registry) == {"split.edge",
                                                 "pipeline.encode"}


@pytest.mark.parametrize("metric,want_ns", [
    ("restore_device_ms", 1_000), ("cloud_device_ms", 1_500)])
def test_device_readers(metric, want_ns):
    read = spec.reader(metric)
    tr = attribution.collect(program_events(), STAGES)
    assert read(_ctx(tr, MetricsRegistry())) == want_ns / 1e6 / 4
    assert read(_ctx(None, None)) is None
    # the parent's harness trace, and a program without the stage
    assert read(_ctx(trace.Trace(ops=tr.ops), MetricsRegistry())) is None
    assert read(_ctx(attribution.collect(parent_events(), set()),
                     MetricsRegistry())) is None


def test_edge_readers():
    events = [host_range("pb.window", 0, 10_000),
              host_range("pb.serve", 0, 9_000),
              host_range("split.edge", 100, 1_000), launch(200, 1),
              launch(300, 2), kernel("conv", 400, 900, 1),
              kernel("bn", 900, 1_200, 2),
              host_range("split.edge", 2_000, 3_000), launch(2_100, 3),
              kernel("conv", 2_200, 2_700, 3)]
    registry = MetricsRegistry()
    for s in (0.002, 0.003):
        registry.histogram("stage_seconds", stage="split.edge").observe(s)
    tr = attribution.collect(events, attribution.stage_names(registry))
    ctx = _ctx(tr, registry, completed=2)
    assert spec.reader("edge_device_ms")(ctx) == 1_300 / 1e6 / 2
    assert spec.reader("edge_host_ms")(ctx) == pytest.approx(2.5)
    assert spec.reader("edge_device_ms")(_ctx(None, None)) is None
    assert spec.reader("edge_host_ms")(_ctx(None, None)) is None
    # a registry without the stage (the parent's program)
    assert spec.reader("edge_host_ms")(_ctx(None, MetricsRegistry())) is None


def test_profiled_gateway_window_on_the_cpu():
    """A real profiler session over the smoke gateway cell: the program's
    ranges are found by the registry's stage names, and the summary reads
    the host stages (no device here, so nothing to put down)."""
    cpu = torch.device("cpu")
    cell = smoke.smoke_cell("c64-gateway-raw-b8")
    st = bench.Setup(cell, 2**31 + 7, cpu)
    st.window(0.0, trace.spans(False))
    registry = MetricsRegistry()
    win, tr = attribution.profiled(
        lambda: st.window(0.1, trace.spans(True)), registry)
    stages = attribution.stage_names(registry)
    assert {"split.edge", "gateway.run_batch", "pipeline.untile"} <= stages
    assert {r[0] for r in tr.program} == stages
    assert tr.ops == [] and tr.spans and tr.window[1] > tr.window[0]
    ctx = bench.Context(cell.cfg, cell.traffic, win, tr, registry, 0.0, {},
                        trace.port_kernels(), cell.family)
    out = attribution.summary(ctx)
    assert out["readings"]["edge_host_ms"] > 0
    assert out["readings"]["restore_device_ms"] == 0.0
    assert out["host_ms"].keys() == stages
    (gap,) = out["idle_gaps"]
    assert gap[0].startswith("serve/")
