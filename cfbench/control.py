#!/usr/bin/env python3
"""Readings the check's limits are set from, at a cell's own size, on the card.

    python3 cfbench/control.py --workload <cell> --seeds 11 12 ... [--control-seeds 11 12 13]
                               [--mask-departure] [--out control.jsonl]

For each seed, in one process: the program's answer to one request of the
cell (weights and request drawn from the seed, as a run draws them) against
the float32 reference, the numbers the cell's check compares; for each
control seed the same numbers for the control, the reference in float8
(``reference/precision.py``) put in the program's place.  With
``--mask-departure`` (HunyuanVideo) also the float32 reference of the
published model, whose joint attention leaves the padded text tokens out,
against the configuration's, which attends them as the port does.  One JSON line per reading on standard output and in
``--out``.  The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, control_seeds=(), mask_departure=False, device="cuda", emit=print):
    """Emit the readings of ``seeds`` (and the control's of
    ``control_seeds``) for ``cell`` (``spec.Cell``) on ``device``."""
    import torch

    from cfbench import check, harness, timing, traffic as traffic_gen
    from cfbench.reference.precision import Precision, fp32_matmuls

    mod, cfg, traffic = cell.module, cell.cfg, cell.traffic
    shapes = mod.input_shapes(cfg, traffic)

    def reference(seed, prec, **kw):
        params = mod.build(cfg, seed, device)
        req = traffic_gen.requests(traffic, shapes, seed, device)[0]
        t = time.perf_counter()
        with torch.inference_mode():
            res = mod.reference(cfg, traffic, params, req, Precision(prec), **kw)
        timing.synchronize(device)
        return res, time.perf_counter() - t

    for seed in sorted(set(seeds) | set(control_seeds)):
        program = mod.Program(cfg, traffic, mod.build(cfg, seed, device), device)
        req = traffic_gen.requests(traffic, shapes, seed, device)[0]
        t = time.perf_counter()
        answer, _ = program.request(req, contextlib.nullcontext)
        timing.synchronize(device)
        t_prog = time.perf_counter() - t
        del program, req
        harness.free_memory(device)
        fp32_matmuls()
        ref, t_ref = reference(seed, "fp32")
        if seed in seeds:
            emit(seed=seed, who="program", numbers=check.numbers(answer, ref, cell.limits), program_s=t_prog,
                 reference_s=t_ref)
        del answer
        harness.free_memory(device)
        if seed in control_seeds:
            ctl, t_ctl = reference(seed, "fp8")
            emit(seed=seed, who="control fp8", numbers=check.numbers(ctl, ref, cell.limits), control_s=t_ctl)
            del ctl
            harness.free_memory(device)
        if mask_departure:
            dep, _ = reference(seed, "fp32", mask_joint=True)
            emit(seed=seed, who="published text mask", numbers=check.numbers(dep, ref, cell.limits))
            del dep
        del ref
        harness.free_memory(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--mask-departure", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cfbench import spec

    if not torch.cuda.is_available():
        sys.exit("control: no CUDA device")
    cell = spec.load_cell(ROOT, args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        rec.update(cell=cell.name, device=torch.cuda.get_device_name())
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    readings(cell, args.seeds, args.control_seeds, args.mask_departure, "cuda", emit)
    emit(who="done", seconds=time.perf_counter() - T0, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if out:
        out.close()


if __name__ == "__main__":
    main()
