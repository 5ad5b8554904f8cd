"""The comparison that decides ``correct``, on the CPU at small sizes: the
reference against the port's own float32 path, the control above the
program, and a run whose timed path is broken coming out not correct."""

import contextlib
import time

import pytest
import torch

from cfbench import check, control, harness, traffic
from cfbench.reference.precision import Precision

CELLS = ("flux-1024", "hunyuanvideo-544p-129f")


def _answers(cell, seed, prec="fp32", **kw):
    mod = cell.module
    shapes = mod.input_shapes(cell.cfg, cell.traffic)
    req = traffic.requests(cell.traffic, shapes, seed, "cpu")[0]
    prog = mod.Program(cell.cfg, cell.traffic, mod.build(cell.cfg, seed, "cpu"), "cpu")
    out, _ = prog.request(req, contextlib.nullcontext)
    ref = mod.reference(cell.cfg, cell.traffic, mod.build(cell.cfg, seed, "cpu"), req, Precision(prec), **kw)
    return out, ref


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_ports_float32_math(name, tiny):
    """In float32 the port and the reference compute one function (the port's
    bf16 runs differ by rounding alone), padded prompts included."""
    cell = tiny(name, "float32")
    out, ref = _answers(cell, 4)
    for key in ref:
        assert check.rel_fro(out[key], ref[key]) < 1e-5, key


def test_port_attends_padded_text_tokens(tiny):
    """The departure the configuration states: the port's joint attention
    attends the padded text tokens too, which the published HunyuanVideo
    (``mask_joint=True``) leaves out; with a full prompt the two agree."""
    cell = tiny("hunyuanvideo-544p-129f", "float32")
    cell.traffic["text_lengths"] = [3]
    out, ref = _answers(cell, 4)
    _, published = _answers(cell, 4, mask_joint=True)
    assert check.rel_fro(out["latents"], ref["latents"]) < 1e-5
    assert check.rel_fro(out["latents"], published["latents"]) > 1e-4
    cell.traffic["text_lengths"] = [cell.traffic["text_tokens"]]
    out, _ = _answers(cell, 4)
    _, published = _answers(cell, 4, mask_joint=True)
    assert check.rel_fro(out["latents"], published["latents"]) < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program(name, tiny):
    """The float8 control of ``control.py`` against the bf16 program, on
    three seeds: every number of the control reads above the program's."""
    got = []
    control.readings(tiny(name), [1, 2, 3], [1, 2, 3], False, "cpu", emit=lambda **r: got.append(r))
    prog = {r["seed"]: r["numbers"] for r in got if r["who"] == "program"}
    ctl = {r["seed"]: r["numbers"] for r in got if r["who"] == "control fp8"}
    assert set(prog) == set(ctl) == {1, 2, 3}
    for seed in prog:
        assert all(ctl[seed][k] > 2 * prog[seed][k] for k in prog[seed]), (prog[seed], ctl[seed])


def _step_unchanged(monkeypatch):
    import compactfusion_tpu_torch.pipelines.flux as pf
    import compactfusion_tpu_torch.pipelines.hunyuanvideo as ph

    for mod in (pf, ph):
        monkeypatch.setattr(mod, "flow_match_step", lambda sched, i, sample, velocity: sample)


def _answer_altered(monkeypatch):
    from compactfusion_tpu_torch.pipelines.flux import FluxPipeline
    from compactfusion_tpu_torch.pipelines.hunyuanvideo import HunyuanVideoPipeline

    for cls in (FluxPipeline, HunyuanVideoPipeline):
        sample = cls._sample

        def rolled(self, *a, _sample=sample):
            return torch.roll(_sample(self, *a), 1, dims=1)

        monkeypatch.setattr(cls, "_sample", rolled)


@pytest.mark.parametrize("fault", [None, _step_unchanged, _answer_altered], ids=["sound", "step", "answer"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, tiny, monkeypatch):
    """A run at the cells' limits, the look for a card skipped: sound, it is
    correct; with a step that returns its state unchanged, or each answer
    altered where it is produced, it is not.  (Both cells run batch 1 on one
    chip: no half batch and no exchange between chips to leave out.)"""
    cell = tiny(name, "float32")
    if fault is not None:
        fault(monkeypatch)
    res = harness.run_cell(cell, 9, 0.2, False, "cpu", time.perf_counter(), log=lambda m: None)
    assert res["correct"] is (fault is None), res["checks"]
    assert res["failed"] == (0 if fault is None else 1)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_at_the_cells_size(name, card):
    """At the cell's own size on the card (minutes a seed): the program's
    numbers sit under the cell's limits and the float8 control's above one."""
    from conftest import ROOT

    from cfbench import spec

    cell = spec.load_cell(ROOT, name)
    got = []
    control.readings(cell, [7], [7], False, "cuda", emit=lambda **r: got.append(r))
    prog = next(r["numbers"] for r in got if r["who"] == "program")
    ctl = next(r["numbers"] for r in got if r["who"] == "control fp8")
    assert all(prog[k] <= lim for k, lim in cell.limits.items()), prog
    assert any(ctl[k] > lim for k, lim in cell.limits.items()), ctl
