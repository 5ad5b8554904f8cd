#!/usr/bin/env python3
"""The benchmark of compactfusion_tpu_torch on NVIDIA GPUs.

    python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  One process is one run of one cell
(``BENCHMARK.json``'s ``workloads``): it draws the weights and requests
from the seed on the card, warms up the cell's shapes (set-up, timed from
the process's start), sends requests for ``--seconds``, checks one request
of the window against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (and
``breakdown`` when traced), and ``checks``, each compared number beside its
limit, which the last lines of standard error repeat.  Without a card, or
with fewer than the cell asks for, it prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json's workloads")
    ap.add_argument("--seed", type=int, required=True, help="draws the weights, the requests and the check")
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: profile one request of the window and report the per-layer metrics")
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"cfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None):
    args = parse_args(argv)
    # every cache of the program and of torch inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    if not (ROOT / "compactfusion_tpu_torch").is_dir():
        fail(f"no compactfusion_tpu_torch package in {ROOT}: run from the root of a checkout")
    sys.path.insert(0, str(ROOT))

    import torch

    from cfbench import harness, spec

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card and has no CPU fallback")
    cell = spec.load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} visible")
    torch.set_num_threads(4)
    smi = power_limit()
    print(f"cfbench: {cell.name} seed {args.seed}, {args.seconds} s, trace {args.trace}; {smi}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"the run loaded {bad}: the benchmark measures the port alone", 3)
    if smi is not None:
        result["device"]["power_limit"] = smi.split(",")[-1].strip()
    for name, c in result["checks"].items():
        print(f"cfbench check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
