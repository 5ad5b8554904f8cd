"""The port's tracer (``utils/prof.py``) on the FLUX and HunyuanVideo paths,
on the CPU at the tiny configs: off it records nothing and changes no bit;
under a ``torch.profiler`` session the spans nest request ⊃ step ⊃ family ⊃
part on the profiler's clock and add no event to its trace; switched on, its
summary lists each span; the counters count with tracing off."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from compactfusion_tpu_torch.models import flux as tflux
from compactfusion_tpu_torch.models import hunyuanvideo as thv
from compactfusion_tpu_torch.ops import _build
from compactfusion_tpu_torch.ops import flash as tflash
from compactfusion_tpu_torch.ops import quant as tqp
from compactfusion_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig
from compactfusion_tpu_torch.pipelines.hunyuanvideo import HunyuanVideoPipeline, HunyuanVideoPipelineConfig
from compactfusion_tpu_torch.utils import prof
from compactfusion_tpu_torch.utils.prof import Profiler, span, tracing

STEPS = 3
PARTS = {"modulate", "qkv", "qk_norm_rope", "attention", "out_gate", "ffn_gate"}
FAMILIES = {"double_blocks", "single_blocks", "refiner"}


@pytest.fixture(autouse=True)
def fresh_profiler():
    Profiler.enable(False)
    Profiler.reset()
    yield
    Profiler.enable(False)
    Profiler.reset()


def _flux():
    tm = dataclasses.replace(tflux.flux_tiny(), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    cfg = FluxPipelineConfig(model=tm, vae=None, num_steps=STEPS, height=64, width=128)
    pipe = FluxPipeline(tflux.init_flux(g, tm), None, cfg, "cpu")
    args = (torch.randn(1, 8, 32, generator=g), torch.randn(1, 16, generator=g))
    return lambda: pipe(*args, latents=torch.randn(1, 32, 16, generator=torch.Generator().manual_seed(1)))


def _video():
    tm = dataclasses.replace(thv.hunyuanvideo_tiny(), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    cfg = HunyuanVideoPipelineConfig(model=tm, num_steps=STEPS, height=32, width=32, num_frames=5)
    pipe = HunyuanVideoPipeline(thv.init_hunyuanvideo(g, tm), None, cfg, "cpu")
    args = (torch.randn(1, 6, 32, generator=g), torch.randn(1, 16, generator=g),
            torch.tensor([[True, True, True, True, False, False]]))
    noise = torch.randn(1, cfg.tokens, 16, generator=g)
    return lambda: pipe(*args, latents=noise)


@pytest.fixture(scope="module", params=["flux", "hunyuanvideo"])
def family(request):
    return request.param, (_flux if request.param == "flux" else _video)()


def test_off_records_nothing_and_changes_no_bit(family):
    _, run = family
    assert not tracing()
    off = run()
    assert Profiler.spans() == [] and span("step") is span("modulate")  # one shared no-op
    Profiler.enable()
    on = run()
    assert torch.equal(off, on) and len(Profiler.spans()) > 0


def test_spans_nest_on_the_profilers_clock(family):
    name, run = family
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = Profiler.spans()
    by_id = {s.id: s for s in spans}

    def names(s):
        return [s.name] + (names(by_id[s.parent]) if s.parent is not None else [])

    (request,) = [s for s in spans if s.name == "request"]
    steps = [s for s in spans if s.name == "step"]
    assert [s.attrs["i"] for s in steps] == list(range(STEPS))
    assert all(s.request == request.id and s.start_ns <= s.end_ns for s in spans)
    for s in spans:
        chain = names(s)
        assert chain[-1] == "request"
        if s.name in PARTS:
            assert chain[1] in FAMILIES and chain[2:] == ["step", "request"], chain
            assert by_id[s.parent].start_ns <= s.start_ns and s.end_ns <= by_id[s.parent].end_ns
    counts = {n: sum(s.name == n for s in spans) for n in PARTS}
    double, single = 2, 2  # the tiny configs' blocks
    assert counts == {"modulate": STEPS * (2 * double + single), "qkv": STEPS * (double + single),
                      "qk_norm_rope": STEPS * (double + single), "attention": STEPS * (double + single),
                      "out_gate": STEPS * double, "ffn_gate": STEPS * (double + single)}
    events = list(prof.profiler.kineto_results.events())
    names_seen = {ev.name() for ev in events}
    assert not names_seen & {s.name for s in spans}, "a span reached the profiler's own events"
    # every operator inside a block lies inside exactly one part span
    ops = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()) for ev in events]
    leaves = [s for s in spans if s.name in PARTS]
    checked = 0
    for fam in (s for s in spans if s.name in ("double_blocks", "single_blocks")):
        kids = [s for s in leaves if s.parent == fam.id]
        lo, hi = min(k.start_ns for k in kids), max(k.end_ns for k in kids)
        for a, b, op in ops:
            if lo <= a < hi:
                inside = [k.name for k in kids if k.start_ns <= a and b <= k.end_ns]
                assert len(inside) == 1, (name, op, inside)
                checked += 1
    assert checked > 100


def test_switched_on_summary_lists_each_span_with_its_count(family):
    _, run = family
    Profiler.enable()
    run()  # a request of its own, before the one the summary reads
    with Profiler.scope("total"):
        run()
    table = Profiler.span_table()  # the last tree closed: the scope and its one request
    assert table["step"]["count"] == STEPS and table["request"]["count"] == 1 and table["total"]["count"] == 1
    assert table["modulate"]["count"] == STEPS * 6 and table["modulate"]["device_ms"] is None  # no card
    assert table["step"]["attrs"] == {"i": list(range(STEPS))}
    text = Profiler.summary()
    assert text.splitlines()[0] == "spans of the last total (1 request(s))"
    for name, row in table.items():
        assert any(line.split()[:2] == [name, str(row["count"])] for line in text.splitlines())
    assert len(Profiler.spans()) == 2 * len(Profiler.window()) - 1  # both requests kept, one read


def test_device_times_are_read_at_a_scopes_exit_and_self_time_leaves_out_children(monkeypatch):
    ticks = iter(range(100))

    class Event:  # a CUDA event on a card whose clock advances one ms a record
        def __init__(self, enable_timing):
            self.t = None

        def record(self):
            self.t = next(ticks)

        def elapsed_time(self, end):
            return float(end.t - self.t)

    monkeypatch.setattr(prof, "_cuda_ready", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    Profiler.enable()
    with Profiler.scope("total"):  # events: total 0-7, request 1-6, steps 2-3 and 4-5
        with span("request"):
            for i in range(2):
                with span("step", {"i": i}):
                    pass
    *inner, total = Profiler.spans()
    assert [(s.name, s.device_ms, s.events) for s in inner] == [("step", 1.0, None), ("step", 1.0, None),
                                                                ("request", 5.0, None)]
    assert total.events is not None  # its own pair is read by the next drain
    table = Profiler.span_table()
    assert total.events is None
    assert {n: (r["device_ms"], r["self_device_ms"]) for n, r in table.items()} == {
        "total": (7.0, 2.0), "request": (5.0, 3.0), "step": (2.0, 2.0)}


def test_counters_count_with_tracing_off_and_the_flash_route_lands_on_its_span(monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "load", lambda: SimpleNamespace(cf_int2_quant=entry, cf_tma_map=entry,
                                                                cf_flash_wgmma=entry))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(tqp, "_stream", lambda t: 7)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    x = torch.randn(8, 64)
    tqp.int2_quant_fastpath(x, torch.zeros(8, 64), torch.ones(8, 1, dtype=torch.bfloat16),
                            torch.ones(1, 64, dtype=torch.bfloat16))
    assert not tracing() and Profiler.spans() == []
    assert Profiler.counter("int2_quant_fastpath.launches") == 1
    assert Profiler.counter("int2_quant_fastpath.vec_launches") == 1
    q = torch.randn(1, 256, 2, 128).to(torch.bfloat16)
    tflash.flash_attn_with_lse(q, q, q)
    assert Profiler.counter("flash_attn_with_lse.launches") == 1
    assert Profiler.counter("flash.body.flash_wgmma_tile") == 1
    Profiler.enable()
    with span("attention") as s:
        tflash.flash_attn_with_lse(q, q, q)
    plan = tflash.flash_plan(1, 2, 256, 128, kernel=1)
    assert s.attrs == {"body": plan[0], "dp": plan[1], "warps": plan[2]} and plan[0] == "flash_wgmma_tile"
    assert Profiler.counter("flash.body.flash_wgmma_tile") == 2
    text = Profiler.summary()  # the summary reads both: the route on its span, the counters
    assert "    body: flash_wgmma_tile" in text.splitlines() and f"    dp: {plan[1]}" in text.splitlines()
    assert any(line.split() == ["flash.body.flash_wgmma_tile", "2"] for line in text.splitlines())
    Profiler.reset()
    assert Profiler.counter("flash_attn_with_lse.launches") == 0 and Profiler.spans() == []
