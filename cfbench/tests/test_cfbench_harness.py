"""The harness on the CPU: arguments, discovery by name, the contract of
BENCHMARK.json, the last line, the operation counts, the kernel classifier,
the trace reduction, the import guard and the seeded inputs."""

import json
import math
import re
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT

from cfbench import flops, harness, readers, spec, traffic, weights
from cfbench.trace import Trace, category

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
#: the cells this file knows the sizes of; cells added later are held to the
#: contract by the tests that loop over ``CELLS``
KNOWN = ("flux-1024", "hunyuanvideo-544p-129f")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_arguments():
    run = spec.load_module(ROOT / "cfbench" / "run.py", "cfbench_run_cli")
    a = run.parse_args(["--workload", "flux-1024", "--seed", str(2**31 + 7), "--seconds", "40", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("flux-1024", 2**31 + 7, 40.0, 1)
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "flux-1024", "--seed", "1", "--seconds", "1", "--trace", "2"])
    with pytest.raises(SystemExit):
        run.parse_args(["--seed", "1", "--seconds", "1"])


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cfbench/run.py"] and BENCH["paths"] == ["cfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("cfbench/")
        assert (ROOT / c["file"]).is_file() and (ROOT / c["file"]).with_suffix(".py").is_file()
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "cfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "cfbench" / "workloads" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "cfbench" / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_discovery_by_name(name):
    cell = spec.load_cell(ROOT, name)
    assert cell.chips in (1, 4) and cell.limits and all(k.endswith("_rel") for k in cell.limits)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and "peak_mem_gib" in e2e and len(e2e) >= 3
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    for trace in (False, True):
        for entry, reader in cell.readers(trace):
            assert callable(reader.read), entry["name"]
    shapes = cell.module.input_shapes(cell.cfg, cell.traffic)
    tokens = {"flux-1024": 4096, "hunyuanvideo-544p-129f": 67320}
    if name in tokens:
        assert shapes["noise"][0][1] == tokens[name]
    with pytest.raises(KeyError):
        spec.load_cell(ROOT, "no-such-cell")


def test_operation_counts_against_hand_counts():
    flux = spec.load_cell(ROOT, "flux-1024")
    f = flux.module.step_flops(flux.cfg, flux.traffic)
    d, s = 3072, 4608
    hand_gemm = s * 57 * 2 * (4 * d * d + 8 * d * d)
    hand_attn = 57 * 4 * 24 * s * s * 128
    assert f["flash_attention"] == hand_attn
    assert abs(f["gemm"] - hand_gemm) / hand_gemm < 0.005  # embedders and modulation on top
    assert abs(f["total"] - 7.4e13) / 7.4e13 < 0.01
    hv = spec.load_cell(ROOT, "hunyuanvideo-544p-129f")
    g = hv.module.step_flops(hv.cfg, hv.traffic)
    s = 33 * 34 * 60 + 256
    assert s == 67576 and g["flash_attention"] == 60 * 4 * 24 * s * s * 128
    assert abs(g["total"] - 4.3e15) / 4.3e15 < 0.01
    assert g["other_attention"] == 2 * 4 * 24 * 256 * 256 * 128
    assert flops.mmdit_step(flux.module.model(flux.cfg), 4096, 512, 2)["total"] == 2 * f["total"]


@pytest.mark.parametrize("name,cat", [
    ("void flash_fwd_wgmma_kernel<128, 8>(FlashWgParams)", "attention"),
    ("void ring_flash_hop_wgmma_kernel<128, 8>(FlashWgParams)", "attention"),
    ("void flash_fwd_reg_kernel<80, 8, __nv_bfloat16>(FlashParams)", "attention"),
    ("void flash_fwd_wide_kernel<512, 4>(FlashParams)", "attention"),
    ("void flash_window_reg_kernel<80, 8>(FlashParams)", "attention"),
    ("fmha_cutlassF_bf16_aligned_64x128_rf_sm80", "attention"),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>", "gemm"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::native::MulFunctor>>", "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>", "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 3, 128, 1>", "copies"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MeanOps>>", "reductions"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel", "conv"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>", "other"),
])
def test_kernel_classifier(name, cat):
    assert category(name) == cat


@pytest.mark.parametrize("modules,bad", [
    (["compactfusion_tpu_torch", "compactfusion_tpu_torch.ops.flash", "torch", "numpy"], []),
    (["compactfusion_tpu_torch", "compactfusion_tpu.models.flux"], ["compactfusion_tpu"]),
    (["jaxlib.xla_client", "flax.linen", "jax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "compactfusion_tpu_torchvision"], []),
])
def test_import_guard_compares_top_level_names_whole(modules, bad):
    assert harness.forbidden_modules(dict.fromkeys(modules)) == bad


def test_reference_and_harness_import_no_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import cfbench.reference.flux, cfbench.reference.hunyuanvideo, cfbench.harness, cfbench.spec;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'compactfusion_tpu', 'compactfusion_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _trace():
    ms = 1_000_000
    device = [("flash_fwd_wgmma_kernel<128, 8>", 0, 4 * ms, "kernel", 1),
              ("nvjet_tst_128x256", 5 * ms, 2 * ms, "kernel", 2),
              ("elementwise_kernel<MulFunctor>", 6 * ms, 1 * ms, "kernel", 3),  # overlaps the GEMM
              ("Memcpy HtoD", 9 * ms, 1 * ms, "gpu_memcpy", 4)]
    host = [("aten::linear", 3 * ms, 3 * ms), ("aten::addmm", 4 * ms, 1 * ms), ("aten::copy_", 8 * ms, 2 * ms)]
    return Trace(device=device, host=host, launches={2: int(4.5 * ms), 4: int(8.5 * ms)}, t0=0, t1=12 * ms, steps=2)


def test_trace_reduction():
    t = _trace()
    assert t.window_s == pytest.approx(0.012) and t.busy_s == pytest.approx(0.007)
    assert t.kernels == 3
    cats = t.seconds_by_category()
    assert cats == pytest.approx({"attention": 0.004, "gemm": 0.002, "elementwise": 0.001, "copies": 0.001})
    assert t.device_ops(2) == [["flash_fwd_wgmma_kernel<128, 8>", pytest.approx(0.004)],
                               ["nvjet_tst_128x256", pytest.approx(0.002)]]
    # gap 4-5 ms: launched inside aten::addmm (innermost); 7-9 ms: aten::copy_; 10-12 ms: the close
    assert dict(t.idle_gaps()) == pytest.approx({"aten::addmm": 0.001, "aten::copy_": 0.002,
                                                 "no host operator": 0.002})


def test_readers_on_a_trace():
    run = harness.Run(setup_s=1.0, request_s=[2.0, 4.0], wall_s=6.5, steps=4, peak_bytes=2**31,
                      spans={"decode_s": [0.1, 0.3, 0.2]}, flops={"flash_attention": 1e9, "total": 4e9},
                      peaks={"bf16_flops": 1e12}, trace=_trace())
    assert readers.seconds_per_request(run) == 3.0 and readers.seconds_per_step(run) == 6.5 / 4
    assert readers.peak_gib(run) == 2.0 and readers.span_median(run, "decode_s") == 0.2
    assert readers.elementwise_ms_per_step(run) == pytest.approx(1.0)  # (1 + 1) ms over 2 steps
    assert readers.flash_roofline_pct(run) == pytest.approx(100 * 2e9 / (1e12 * 0.004))
    assert readers.step_mfu_pct(run) == pytest.approx(100 * 8e9 / (1e12 * 0.012))
    assert readers.device_idle_pct(run) == pytest.approx(100 * 5 / 12)
    assert readers.launches_per_step(run) == 1.5
    empty = harness.Run(setup_s=1.0, request_s=[], wall_s=0, steps=0, peak_bytes=0, spans={},
                        flops={}, peaks=None, trace=None)
    for fn in (readers.seconds_per_request, readers.seconds_per_step, readers.peak_gib, readers.flash_roofline_pct,
               readers.step_mfu_pct, readers.device_idle_pct, readers.launches_per_step,
               readers.elementwise_ms_per_step):
        assert fn(empty) is None


def test_weights_are_drawn_from_the_seed():
    from cfbench.reference.layout import Leaf

    lay = {"a": {"w": Leaf((3, 4), "w"), "b": Leaf((4,), "mod_b")}, "n": [{"g": Leaf((5,), "one")}],
           "c": {"w": Leaf((1, 1, 3, 3), "eye"), "b": Leaf((3,), "zero")}}
    a, b, c = (weights.draw(lay, s, "cpu") for s in (7, 7, 8))
    assert torch.equal(a["a"]["w"], b["a"]["w"]) and not torch.equal(a["a"]["w"], c["a"]["w"])
    assert a["a"]["w"].dtype == torch.bfloat16 and a["n"][0]["g"].eq(1).all()
    assert torch.equal(a["c"]["w"][0, 0].float(), torch.eye(3)) and a["c"]["b"].eq(0).all()
    assert 0.1 < a["a"]["b"].float().std() < 2.0
    assert weights.sub_seed(2**40, "x") != weights.sub_seed(2**40, "y") < 2**63


@pytest.mark.parametrize("name", KNOWN)
def test_layout_is_the_ports(name, tiny):
    """The drawn tree has the keys and shapes of the port's own init."""
    cell = tiny(name)
    drawn = cell.module.build(cell.cfg, 1, "cpu")
    prog = cell.module.Program(cell.cfg, cell.traffic, drawn, "cpu")
    m = prog.pipe.cfg.model
    g = torch.Generator().manual_seed(0)
    if name == "flux-1024":
        from compactfusion_tpu_torch.models.flux import init_flux
        from compactfusion_tpu_torch.models.vae import init_vae_decoder

        own = {"dit": init_flux(g, m), "vae": init_vae_decoder(g, prog.pipe.cfg.vae)}
    else:
        from compactfusion_tpu_torch.models.hunyuanvideo import init_hunyuanvideo

        own = {"dit": init_hunyuanvideo(g, m)}

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(drawn) == shapes(own)


def test_traffic_same_sizes_every_seed():
    t = {"loop": "closed", "clients": 1, "pool": 6, "text_lengths": [2, 3, 4, 5, 6, 7]}
    shapes = {"x": ((1, 3, 2), "normal_fp32"), "m": ((1, 8), "prefix_mask"), "y": ((1, 2), "normal_bf16")}
    a, b, c = (traffic.requests(t, shapes, s, "cpu") for s in (3, 3, 2**33 + 1))
    lens = [sorted(int(r["m"].sum()) for r in p) for p in (a, c)]
    assert lens[0] == lens[1] == [2, 3, 4, 5, 6, 7]
    assert [int(r["m"].sum()) for r in a] != [int(r["m"].sum()) for r in c]
    assert all(torch.equal(r["x"], s["x"]) for r, s in zip(a, b)) and a[0]["y"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        traffic.requests(dict(t, loop="open"), shapes, 1, "cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(tiny, trace):
    cell = tiny("flux-1024", "float32")
    res = harness.run_cell(cell, 5, 0.5, trace, "cpu", time.perf_counter(), log=lambda m: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) \
        + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= (2 if trace else 1)
    assert set(res["checks"]) == set(cell.limits)
    assert all(set(v) == {"value", "limit"} and math.isfinite(v["value"]) for v in res["checks"].values())
    names = set(res["metrics"])
    if trace:
        # the CPU has no device trace: only the span reader finds something
        assert names == {"decode_s.image"} and {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert names == {"image_s", "setup_s"}  # no device memory on the CPU
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    json.dumps(res)


@pytest.mark.card
def test_cell_runs_on_the_card(card):
    """A short run of each cell on the card, as the command runs it."""
    for name in CELLS:
        if spec.load_cell(ROOT, name).chips > torch.cuda.device_count():
            continue
        out = subprocess.run([sys.executable, "cfbench/run.py", "--workload", name, "--seed", "3", "--seconds", "5",
                              "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"] is True and res["device"]["platform"] == "gpu"


class _Event:
    """A profiler event as torch 2.11's ``_KinetoEvent`` shows it (no ``activity_type``)."""

    def __init__(self, name, device, start, dur, corr=0, thread=1):
        self._v = (name, device, start, dur, corr, thread)

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

    def start_thread_id(self):
        return self._v[5]


def test_trace_from_events_without_activity_type():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from cfbench.trace import from_profiler

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    evs = [_Event("aten::mm", cpu, 0, 100), _Event("cudaLaunchKernel", cpu, 10, 5, corr=7),
           _Event("nvjet_tst_64x8", gpu, 20, 50, corr=7), _Event("Memcpy DtoH (Device -> Pageable)", gpu, 80, 10),
           _Event("aten::add", cpu, 5, 1, thread=2), _Event("cudaDeviceSynchronize", cpu, 60, 40)]
    tr = from_profiler(SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: evs))),
                       steps=1)
    assert tr.kernels == 1 and [d[3] for d in tr.device] == ["kernel", "gpu_memcpy"]
    assert tr.launches == {7: 10, 0: 60} and tr.host == [("aten::mm", 0, 100)]
    assert (tr.t0, tr.t1) == (0, 100) and tr.busy_s == pytest.approx(60e-9)
    # 0-20 and 70-80 ns: launched inside aten::mm; 90-100: the close
    assert dict(tr.idle_gaps()) == pytest.approx({"aten::mm": 30e-9, "no host operator": 10e-9})
