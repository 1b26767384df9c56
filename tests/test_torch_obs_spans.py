"""The port's stage timers as profiler ranges (``repro_torch.obs.hooks``).

With a registry installed, every ``hooks.timed`` stage is also a range on
``torch.profiler``'s timeline, nested where the work nests: the plan's
encode, decode and restore, the CNN's halves and the gateway's serve.
Without one, nothing is opened. On the CPU, at a small width.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import pipeline
from repro_torch.core.baf import BaFConv, BaFConvConfig
from repro_torch.core.split import cnn_fns
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.obs import hooks
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.gateway import ServingGateway

STAGES = {
    "split.to_device", "split.edge", "split.cloud",
    "pipeline.quantize", "pipeline.to_host", "pipeline.encode",
    "pipeline.tile", "codec.pack", "pipeline.entropy_count",
    "pipeline.decode_batch", "codec.unpack", "pipeline.untile",
    "pipeline.restore", "pipeline.h2d",
    "gateway.encode_request", "gateway.run_batch", "gateway.to_host",
}
CFG = CNNConfig(width_mult=0.125, input_size=64, num_classes=8,
                tail_res_blocks=1)
# (C, tiling): a tiled container at a power of two, channel-last otherwise
LAYOUTS = [(16, "tiled"), (12, "direct")]


@pytest.fixture(scope="module")
def cnn():
    return CNN(CFG, seed=1, device="cpu")


def _plan(cnn, c, tiling):
    baf = BaFConv(BaFConvConfig(c=c, q=CFG.split_q, hidden=8), seed=2,
                  device="cpu")
    sel = np.random.default_rng(c).permutation(CFG.split_p)[:c]
    op = pipeline.OperatingPoint(c=c, bits=8, backend="raw", tiling=tiling)
    spec = pipeline.ModelSpec(sel_idx=sel, params=cnn, baf_params=baf)
    return pipeline.compile(op, spec, device="cpu"), baf, sel, op


def _frames(n):
    gen = torch.Generator().manual_seed(3)
    return torch.randn((n, CFG.input_size, CFG.input_size, 3), generator=gen)


def _ranges(fn, registry=None):
    """Run ``fn`` under the CPU profiler with ``registry`` installed (none:
    nothing installed) -> (its result, [(stage, start_ns, end_ns, event)])."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if registry is None:
            out = fn()
        else:
            with hooks.active(registry):
                out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e)
             for e in prof.profiler.kineto_results.events()
             if e.name() in STAGES]
    return out, spans


def _names(spans):
    return {s[0] for s in spans}


def _inside(spans, child, parent):
    """Every ``child`` range lies inside some ``parent`` range."""
    outer = [(a, b) for n, a, b, _ in spans if n == parent]
    kids = [(a, b) for n, a, b, _ in spans if n == child]
    return bool(kids) and all(any(pa <= a and b <= pb for pa, pb in outer)
                              for a, b in kids)


def _outside(spans, child, parent):
    """No ``child`` range lies inside a ``parent`` range."""
    outer = [(a, b) for n, a, b, _ in spans if n == parent]
    return not any(pa <= a and b <= pb for n, a, b, _ in spans if n == child
                   for pa, pb in outer)


@pytest.mark.parametrize("c,tiling", LAYOUTS)
def test_encode_opens_nested_ranges(cnn, c, tiling):
    plan, _, _, _ = _plan(cnn, c, tiling)
    edge, _ = cnn_fns(cnn)
    z = edge(_frames(1))
    blob, spans = _ranges(lambda: plan.encode(z), MetricsRegistry())
    assert blob.nbytes > 0
    want = {"split.to_device", "pipeline.quantize", "pipeline.to_host",
            "pipeline.encode", "codec.pack", "pipeline.entropy_count"}
    if tiling == "tiled":
        want.add("pipeline.tile")
    assert _names(spans) == want
    for child in want - {"split.to_device", "pipeline.quantize",
                         "pipeline.to_host", "pipeline.encode"}:
        assert _inside(spans, child, "pipeline.encode"), child
    # the quantize kernel and the one copy come before the host's encode
    for stage in ("pipeline.quantize", "pipeline.to_host"):
        assert _outside(spans, stage, "pipeline.encode"), stage


@pytest.mark.parametrize("c,tiling", LAYOUTS)
def test_decode_batch_opens_nested_ranges(cnn, c, tiling):
    plan, _, _, _ = _plan(cnn, c, tiling)
    edge, _ = cnn_fns(cnn)
    frames = _frames(3)
    blobs = [plan.encode(edge(frames[i:i + 1])) for i in range(3)]
    decoded, spans = _ranges(lambda: plan.decode_batch(blobs),
                             MetricsRegistry())
    assert len(decoded) == 3
    want = {"pipeline.decode_batch", "codec.unpack"}
    if tiling == "tiled":
        want.add("pipeline.untile")
    assert _names(spans) == want
    for child in want - {"pipeline.decode_batch"}:
        assert _inside(spans, child, "pipeline.decode_batch"), child
    assert _outside(spans, "pipeline.untile", "codec.unpack")


def test_restore_opens_its_copies_range(cnn):
    plan, _, _, _ = _plan(cnn, 16, "tiled")
    edge, _ = cnn_fns(cnn)
    decoded = plan.decode_batch([plan.encode(edge(_frames(1)))])
    z_tilde, spans = _ranges(lambda: plan.restore(decoded),
                             MetricsRegistry())
    assert z_tilde.shape == (1, CFG.split_hw, CFG.split_hw, CFG.split_p)
    assert _names(spans) == {"pipeline.restore", "pipeline.h2d"}
    assert _inside(spans, "pipeline.h2d", "pipeline.restore")


def test_cnn_fns_open_the_halves_ranges(cnn):
    edge, cloud = cnn_fns(cnn)
    x = _frames(2)
    logits, spans = _ranges(lambda: cloud(edge(x)), MetricsRegistry())
    assert _names(spans) == {"split.edge", "split.cloud"}
    (e,) = [s for s in spans if s[0] == "split.edge"]
    (c,) = [s for s in spans if s[0] == "split.cloud"]
    assert e[2] <= c[1]
    with torch.no_grad():
        want = cnn.cloud(cnn.edge(x)[1])
    assert torch.equal(logits, want)


def test_gateway_serve_opens_nested_ranges(cnn):
    _, baf, sel, op = _plan(cnn, 16, "tiled")
    gw = ServingGateway(cnn, {16: (baf, sel)}, channel=None, default_op=op,
                        max_batch=2, device="cpu")
    imgs = _frames(4).numpy()
    registry = MetricsRegistry()
    (responses, _), spans = _ranges(lambda: gw.serve(imgs), registry)
    assert len(responses) == 4
    count = {}
    for name, *_ in spans:
        count[name] = count.get(name, 0) + 1
    assert count["gateway.encode_request"] == 4
    assert count["split.edge"] == 4
    assert count["gateway.run_batch"] == 2          # two micro-batches of 2
    assert count["split.cloud"] == 2
    for child in ("split.to_device", "split.edge", "pipeline.quantize",
                  "pipeline.to_host", "pipeline.encode", "pipeline.tile",
                  "codec.pack", "pipeline.entropy_count"):
        assert _inside(spans, child, "gateway.encode_request"), child
    for child in ("pipeline.decode_batch", "codec.unpack", "pipeline.untile",
                  "pipeline.restore", "pipeline.h2d", "split.cloud",
                  "gateway.to_host"):
        assert _inside(spans, child, "gateway.run_batch"), child
    assert _outside(spans, "gateway.to_host", "split.cloud")
    # each range was timed into the registry too, once a call
    hist = {labels["stage"]: m.count for name, labels, m in registry.collect()
            if name == "stage_seconds"}
    assert hist == count


def test_ranges_are_host_operator_ranges(cnn):
    """A stage range is an operator range on the host thread, never a user
    annotation, so the profiler mirrors no stage on a device's timeline."""
    edge, _ = cnn_fns(cnn)
    _, spans = _ranges(lambda: edge(_frames(1)), MetricsRegistry())
    assert spans
    for *_, e in spans:
        assert not e.is_user_annotation()
        assert e.device_type() == torch.autograd.DeviceType.CPU


def test_no_registry_opens_no_range(cnn):
    assert hooks.installed() is None
    assert hooks.timed("split.edge") is hooks._NULL
    assert hooks.timed("pipeline.encode", backend="raw") is hooks._NULL
    plan, _, _, _ = _plan(cnn, 16, "tiled")
    edge, cloud = cnn_fns(cnn)

    def work():
        blob = plan.encode(edge(_frames(1)))
        return cloud(plan.restore(plan.decode_batch([blob])))

    logits, spans = _ranges(work)
    assert logits.shape == (1, CFG.num_classes)
    assert spans == []


def test_stage_timer_closes_its_range_on_error():
    registry = MetricsRegistry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with hooks.active(registry):
            with pytest.raises(KeyError):
                with hooks.timed("split.edge"):
                    raise KeyError("x")
            with hooks.timed("split.cloud"):
                pass
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name() in STAGES]
    assert sorted(names) == ["split.cloud", "split.edge"]
    assert registry.get("stage_seconds", stage="split.edge").count == 1
    assert hooks.installed() is None


@pytest.mark.parametrize("c,tiling", LAYOUTS)
def test_codec_host_series_keep_their_names_and_labels(cnn, c, tiling):
    """The two series the benchmark's ``codec_host_ms`` reads, labelled as
    before; the plan no longer observes the decode's batch size."""
    plan, _, _, _ = _plan(cnn, c, tiling)
    edge, _ = cnn_fns(cnn)
    registry = MetricsRegistry()
    with hooks.active(registry):
        blob = plan.encode(edge(_frames(1)))
        plan.decode_batch([blob, blob])
    series = {(name, tuple(sorted(labels.items())))
              for name, labels, _ in registry.collect()}
    assert ("stage_seconds", (("backend", "raw"),
                              ("stage", "pipeline.encode"))) in series
    assert ("stage_seconds", (("backend", "raw"),
                              ("stage", "pipeline.decode_batch"))) in series
    assert not any(name == "pipeline_decode_batch_size"
                   for name, _ in series)
    assert registry.get("stage_seconds", stage="pipeline.decode_batch",
                        backend="raw").count == 1
