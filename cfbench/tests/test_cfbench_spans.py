"""The join of the program's spans to a trace (``cfbench/spans.py``), on a
synthetic trace and synthetic spans."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from cfbench import harness, spans
from cfbench.trace import Trace

MS = 1_000_000


def _tool():
    """``tools/trace_split.py``, which reports the join's breakdown."""
    path = Path(__file__).resolve().parents[2] / "tools" / "trace_split.py"
    spec = importlib.util.spec_from_file_location("trace_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, start, end, span_id, parent=None):
    return SimpleNamespace(name=name, start_ns=int(start * MS), end_ns=int(end * MS), id=span_id, parent=parent)


#: one request of two steps; the second step's blocks hold two parts
SPANS = [_span("request", -1, 21, 1), _span("step", 0, 8, 2, 1), _span("embed", 0, 1, 3, 2),
         _span("double_blocks", 1, 7, 4, 2), _span("modulate", 1, 3, 5, 4), _span("attention", 3, 5, 6, 4),
         _span("ffn_gate", 5, 7, 7, 4), _span("scheduler", 7, 8, 8, 2), _span("step", 8, 19, 9, 1),
         _span("single_blocks", 8, 18, 10, 9), _span("qk_norm_rope", 8, 12, 11, 10),
         _span("out_gate", 12, 18, 12, 10)]


def _trace():
    # (name, device start, duration, kind, correlation id); launches: the host call's start
    device = [("elementwise_kernel<AddFunctor>", int(1.5 * MS), MS, "kernel", 1),       # embed's launch
              ("elementwise_kernel<MulFunctor>", 3 * MS, MS, "kernel", 2),              # modulate
              ("CatArrayBatchedCopy", 4 * MS, MS, "kernel", 3),                         # attention: glue
              ("flash_fwd_wgmma_kernel<128, 8>", 5 * MS, 2 * MS, "kernel", 4),          # attention: product
              ("nvjet_tst_192x192", 8 * MS, MS, "kernel", 5),                           # ffn_gate: product
              ("vectorized_elementwise_kernel<gelu>", 10 * MS, MS, "kernel", 6),        # ffn_gate
              ("reduce_kernel<MeanOps>", 13 * MS, 2 * MS, "kernel", 7),                 # qk_norm_rope
              ("Memcpy DtoD", 16 * MS, MS, "gpu_memcpy", 8)]                            # out_gate
    launches = {1: int(0.5 * MS), 2: int(1.5 * MS), 3: int(3.5 * MS), 4: int(4.5 * MS), 5: int(6 * MS),
                6: int(6.5 * MS), 7: int(9 * MS), 8: int(13 * MS)}
    return Trace(device=device, host=[], launches=launches, t0=0, t1=20 * MS, steps=2)


def _run(trace):
    return harness.Run(setup_s=1.0, request_s=[1.0], wall_s=1.0, steps=2, peak_bytes=0, spans={}, flops={},
                       peaks=None, trace=trace)


def test_innermost_holds_nested_spans():
    got = spans.innermost(SPANS, [int(q * MS) for q in (-2, 0.5, 2, 7.5, 8.5, 13, 18.5, 25)])
    assert [s.name if s else None for s in got] == [None, "embed", "modulate", "scheduler", "qk_norm_rope",
                                                  "out_gate", "step", None]


def test_device_events_and_gaps_go_under_the_span_of_their_launch():
    j = spans.join(_trace(), SPANS)
    assert j.steps == 2
    assert [c[0] for c in j.chains] == ["embed", "modulate", "attention", "attention", "ffn_gate", "ffn_gate",
                                        "qk_norm_rope", "out_gate"]
    assert j.chains[1] == ("modulate", "double_blocks", "step", "request")
    # gaps: 0-1.5 (embed's launch), 2.5-3 (modulate), 7-8 (ffn_gate), 9-10 (ffn_gate), 11-13
    # (qk_norm_rope), 15-16 (out_gate), 17-20 (the window's close: the request)
    assert [(ns / MS, c[0]) for ns, c in j.gaps] == [(1.5, "embed"), (0.5, "modulate"), (1.0, "ffn_gate"),
                                                     (1.0, "ffn_gate"), (2.0, "qk_norm_rope"), (1.0, "out_gate"),
                                                     (3.0, "request")]


def test_part_metrics_split_the_work_outside_products(monkeypatch):
    run = _run(_trace())
    monkeypatch.setattr(spans, "program_spans", lambda: SPANS)
    assert spans.part_ms_per_step(run, ("modulate",)) == pytest.approx(0.5)   # 1 ms over 2 steps
    assert spans.part_ms_per_step(run, ("attention",)) == pytest.approx(0.5)  # the concat, not the flash
    assert spans.part_ms_per_step(run, ("out_gate", "ffn_gate")) == pytest.approx(1.0)  # gelu + memcpy
    assert spans.part_ms_per_step(run, ("qk_norm_rope",)) == pytest.approx(1.0)
    assert spans.block_idle_ms_per_step(run) == pytest.approx((0.5 + 1 + 1 + 2 + 1) / 2)
    b = _tool().breakdown(run)
    assert b["covered_share"] == 1.0 and b["steps"] == 2
    # the parts and the rest (embed) sum to everything outside the products
    assert sum(b["outside_products_ms"].values()) == pytest.approx(3.5)
    assert b["outside_products_ms"]["embed"] == pytest.approx(0.5)
    # the tool's check: the part metrics plus the spans they do not read (qkv among them) make elementwise_ms
    metrics = {"elementwise_ms.image": 4.0, "modulate_ms.image": 0.5, "qk_norm_rope_ms.image": 1.0,
               "gate_residual_ms.image": 1.0, "attention_glue_ms.image": 0.5}
    split = {"outside_products_ms": {**b["outside_products_ms"], "qkv": 0.5}}
    check = _tool().split_check(metrics, split)
    assert check["remainder"] == pytest.approx(1.0) and check["rel"] == pytest.approx(0.0)


def test_nothing_to_read_without_spans(monkeypatch):
    run = _run(_trace())
    monkeypatch.setattr(spans, "program_spans", lambda: None)  # a program older than its tracer
    assert spans.part_ms_per_step(run, ("modulate",)) is None and spans.block_idle_ms_per_step(run) is None
    monkeypatch.setattr(spans, "program_spans", lambda: [s for s in SPANS if s.name != "step"])
    assert _tool().breakdown(_run(_trace())) is None  # no step in the window
    assert spans.part_ms_per_step(_run(None), ("modulate",)) is None
