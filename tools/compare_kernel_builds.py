#!/usr/bin/env python3
"""Compare what two checkouts' CUDA sources compile to, kernel by kernel.

    python3 tools/compare_kernel_builds.py OTHER_ROOT

Compiles ``compactfusion_tpu_torch/csrc`` of this checkout and of
``OTHER_ROOT`` (another checkout's root, e.g. an unpacked ``git archive``
of the parent commit) with the flags of ``ops/_build.py``, one ``nvcc -c``
per source, all started together, into a temporary directory.  For every
instantiation of the production kernels that share the flash tile body
(labels from ``_build.kernel_labels``, e.g. ``flash_fwd_kernel<4, 64>``), it
compares what ``ptxas -v`` said of it (stack, spills, registers, barriers,
constant memory) and its SASS (``cuobjdump -sass``).  Prints one JSON
object and exits 1 when one differs or is missing on either side.  Needs
the CUDA toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``), not a GPU.
"""

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PRODUCTION = ("flash_fwd_kernel", "flash_window_kernel", "ring_flash_hop_kernel",
              "compact_ring_hop_kernel")


def _cuobjdump():
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise SystemExit("cuobjdump not found: this tool needs the CUDA toolkit")
    return found


def build(root: Path, out: Path):
    """({kernel: ptxas line}, {kernel: SASS sha256}) of one checkout."""
    from compactfusion_tpu_torch.ops import _build

    objs, log = _build.compile_objects(root / "compactfusion_tpu_torch" / "csrc", out)
    sass = {}
    for obj in objs:
        dump = subprocess.run([_cuobjdump(), "-sass", str(obj)], capture_output=True, text=True,
                              check=True).stdout
        for block in dump.split("Function : ")[1:]:
            name, _, body = block.partition("\n")
            code = "\n".join(ln.strip() for ln in body.splitlines() if ln.strip())
            sass[name.strip()] = hashlib.sha256(code.encode()).hexdigest()
    labels = _build.kernel_labels(sass)
    return _build.ptxas_summary(log), {labels[name]: h for name, h in sass.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        this = build(REPO, Path(tmp) / "this")
        other = build(args.other.resolve(), Path(tmp) / "other")
    report, same = {}, True
    labels = sorted(set(this[0]) | set(other[0]))
    for label in labels:
        if not label.startswith(PRODUCTION):
            continue
        entry = {"this": this[0].get(label), "other": other[0].get(label),
                 "sass_equal": label in this[1] and this[1].get(label) == other[1].get(label)}
        entry["ptxas_equal"] = entry["this"] is not None and entry["this"] == entry["other"]
        same = same and entry["ptxas_equal"] and entry["sass_equal"]
        report[label] = entry
    print(json.dumps({"identical": same and bool(report), "kernels": report}, indent=1))
    return 0 if same and report else 1


if __name__ == "__main__":
    sys.exit(main())
