#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s time goes: its whole run, with every top-level
function of the script timed.

    python3 tools/time_chip_smoke.py > smoke_times.log

Runs ``chip_smoke.main()`` as the script's own command does, with each
top-level function of ``chip_smoke.py`` (but ``main`` and the rank functions,
which run in the spawned processes) and ``parallel.mesh.spawn_local`` wrapped
in a timer, and each ``nvcc`` job of the kernel build timed from the build's
start to the job's end.  After the script's own lines (its ``[done]`` line
has the seconds of every phase) it prints one line per build job and one
per function: cumulative seconds and calls, nested calls counted in each
caller as well.  A run takes as long as ``chip_smoke.py`` itself and needs
the same card; without one it exits non-zero as the script does.
"""

import functools
import inspect
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: {name: (calls, seconds)}
TIMES = {}


def timed(name, fn):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            n, s = TIMES.get(name, (0, 0.0))
            TIMES[name] = (n + 1, s + time.perf_counter() - t0)
    return wrapper


def time_build_jobs():
    """``_build.compile_objects`` with each ``nvcc`` job's end time (seconds
    from the build's start, by source and define) printed after it."""
    from compactfusion_tpu_torch.ops import _build

    real_popen, real_compile = _build.subprocess.Popen, _build.compile_objects
    start, ends = [0.0], {}

    class Timed(real_popen):
        def communicate(self, *a, **kw):
            out = super().communicate(*a, **kw)
            job = " ".join([os.path.basename(str(self.args[-1]))]
                           + [x for x in self.args if str(x).startswith("-D")])
            ends[job] = time.perf_counter() - start[0]
            return out

    def compile_objects(csrc, obj_dir):
        start[0] = time.perf_counter()
        _build.subprocess.Popen = Timed
        try:
            return real_compile(csrc, obj_dir)
        finally:
            _build.subprocess.Popen = real_popen
            for job, s in ends.items():
                print(f"[time] nvcc {job}: done {s:.1f} s after the build's start", flush=True)

    _build.compile_objects = compile_objects


def main():
    import chip_smoke
    from compactfusion_tpu_torch.parallel import mesh

    time_build_jobs()
    for name, obj in list(vars(chip_smoke).items()):
        if inspect.isfunction(obj) and obj.__module__ == "chip_smoke" and name != "main" \
                and not name.endswith("_rank"):
            setattr(chip_smoke, name, timed(name, obj))
    mesh.spawn_local = timed("spawn_local", mesh.spawn_local)
    t0 = time.perf_counter()
    try:
        chip_smoke.main()
    finally:
        print(f"[time] total {time.perf_counter() - t0:.1f} s")
        for name, (n, s) in sorted(TIMES.items(), key=lambda kv: -kv[1][1]):
            print(f"[time] {s:9.1f} s {n:6d} calls  {name}")


if __name__ == "__main__":
    main()
