#!/usr/bin/env python3
"""Compare what two checkouts' CUDA sources compile to, kernel by kernel.

    python3 tools/compare_kernel_builds.py OTHER_ROOT [--unchanged LABEL ...]

Compiles ``compactfusion_tpu_torch/csrc`` of this checkout and of
``OTHER_ROOT`` (another checkout's root, e.g. an unpacked ``git archive``
of the parent commit) with the flags of ``ops/_build.py``, one ``nvcc -c``
per source, all started together, into a temporary directory.  For every
kernel instantiation of either side (labels from ``_build.kernel_labels``,
e.g. ``flash_fwd_reg_kernel<80, 8>``), it compares what ``ptxas -v`` said of it
(stack, spills, registers, barriers, constant memory) and its SASS
(``cuobjdump -sass``, read by :func:`sass_text`), and reports the global
loads its SASS issues before the first global store
(:func:`loads_before_store`: the loads a thread can have in flight at
once in a kernel that loads, computes, then stores).

``--unchanged`` names the instantiations that must be identical on both
sides: a full label, or ``name<...>`` for every instantiation of ``name``
(the default: every flash kernel of kernels 1, 4 and 7 on the register
body and on the wide body, kernel 1's split over a cluster among them, in
bf16 and fp32, kernel 8's EF pass, the probe and empty kernels, and every
quant and dequant kernel; the wgmma body's kernels,
``flash_fwd_wgmma*`` and ``ring_flash_hop_wgmma*``, are not on it while the
other side predates them).
Prints one JSON object and exits 1 when one of them differs, is missing on
either side or matches nothing; kernels outside the list may differ.
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``), not a GPU.
"""

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
UNCHANGED = ("flash_fwd_reg_kernel<...>", "flash_window_reg_kernel<...>", "ring_flash_hop_reg_kernel<...>",
             "flash_fwd_wide_kernel<...>", "flash_fwd_reg_f32_kernel<...>", "flash_window_reg_f32_kernel<...>",
             "ring_flash_hop_reg_f32_kernel<...>", "flash_fwd_wide_f32_kernel<...>",
             "flash_window_wide_kernel<...>", "ring_flash_hop_wide_kernel<...>", "flash_fwd_wide_split_kernel<...>",
             "flash_window_wide_f32_kernel<...>", "ring_flash_hop_wide_f32_kernel<...>",
             "flash_fwd_wide_split_f32_kernel<...>", "ef_update_fp32_kernel",
             "ef_minmax_int8_kernel", "ef_codes_int8_kernel", "ef_update_fp32_f32rec_kernel",
             "ef_codes_int8_f32rec_kernel", "flash_parts_kernel<...>", "dma_only_kernel", "plumb_kernel", "empty_kernel",
             "binary_quant_kernel<...>", "binary_quant_vec_kernel<...>", "binary_dequant_kernel<...>",
             "binary_dequant_vec_kernel<...>", "int2_quant_kernel<...>", "int2_quant_vec_kernel<...>",
             "int2_dequant_kernel<...>", "int2_dequant_vec_kernel<...>")
# nvcc names each source's anonymous namespace after a hash of the source
# (``_GLOBAL__N__0110b69f_13_flash_attn_cu_3b6b32e1``), and symbols in the
# SASS carry it: an edit elsewhere in the file changes it
_NAMESPACE = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def sass_text(body: str) -> str:
    """One function's SASS as it is compared: each line's words joined by
    one space (cuobjdump pads its columns to the longest name in the
    object), the source's namespace name left out."""
    return _NAMESPACE.sub("_GLOBAL__N_", "\n".join(" ".join(ln.split()) for ln in body.splitlines() if ln.strip()))


def loads_before_store(body: str) -> int:
    """The global loads (``LDG``) in one function's SASS before its first
    global store (``STG``), in program order."""
    n = 0
    for ln in body.splitlines():
        if re.search(r"\bSTG\.", ln):
            break
        n += bool(re.search(r"\bLDG\.", ln))
    return n


def _cuobjdump():
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise SystemExit("cuobjdump not found: this tool needs the CUDA toolkit")
    return found


def build(root: Path, out: Path):
    """({kernel: ptxas line}, {kernel: SASS sha256}, {kernel: its
    :func:`loads_before_store`}) of one checkout."""
    from compactfusion_tpu_torch.ops import _build

    objs, log = _build.compile_objects(root / "compactfusion_tpu_torch" / "csrc", out)
    sass, loads = {}, {}
    for obj in objs:
        dump = subprocess.run([_cuobjdump(), "-sass", str(obj)], capture_output=True, text=True,
                              check=True).stdout
        for block in dump.split("Function : ")[1:]:
            name, _, body = block.partition("\n")
            sass[name.strip()] = hashlib.sha256(sass_text(body).encode()).hexdigest()
            loads[name.strip()] = loads_before_store(body)
    labels = _build.kernel_labels(sass)
    return (_build.ptxas_summary(log), {labels[name]: h for name, h in sass.items()},
            {labels[name]: n for name, n in loads.items()})


def matches(label: str, pattern: str) -> bool:
    """``pattern`` is ``label`` itself, or ``name<...>`` for any
    instantiation of ``name``."""
    if pattern.endswith("<...>"):
        return label.startswith(pattern[:-len("...>")])
    return label == pattern


def verdict(this, other, unchanged=UNCHANGED):
    """(ok, report) of two builds, each (ptxas lines, SASS hashes[, loads
    before the first store]) by label.
    The report has every label of either side; ``ok`` holds when every
    label that an ``unchanged`` pattern names has the same ptxas line and
    SASS on both sides, and every pattern names at least one label."""
    report, ok = {}, True
    labels = sorted(set(this[0]) | set(other[0]) | set(this[1]) | set(other[1]))
    for label in labels:
        entry = {"this": this[0].get(label), "other": other[0].get(label),
                 "sass_equal": label in this[1] and this[1].get(label) == other[1].get(label)}
        entry["ptxas_equal"] = entry["this"] is not None and entry["this"] == entry["other"]
        if len(this) > 2:
            entry["loads_before_store"] = {"this": this[2].get(label), "other": other[2].get(label)}
        entry["must_be_unchanged"] = any(matches(label, p) for p in unchanged)
        if entry["must_be_unchanged"]:
            ok = ok and entry["ptxas_equal"] and entry["sass_equal"]
        report[label] = entry
    unmatched = [p for p in unchanged if not any(matches(label, p) for label in labels)]
    return ok and not unmatched, {"unmatched": unmatched, "kernels": report}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--unchanged", nargs="+", default=list(UNCHANGED), metavar="LABEL",
                    help=f"instantiations that must be identical (default: {' '.join(UNCHANGED)})")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        this = build(REPO, Path(tmp) / "this")
        other = build(args.other.resolve(), Path(tmp) / "other")
    ok, report = verdict(this, other, args.unchanged)
    print(json.dumps({"unchanged_identical": ok, "unchanged": args.unchanged, **report}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
