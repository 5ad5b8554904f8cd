"""Where kernel 1's time goes: its tile body with stages switched off.

Counterpart of the JAX repo's ``_prof_kernel_parts.py`` (the Pallas flash
kernel with stages removed, at PixArt-alpha 512's self-attention shape).
Each variant runs kernel 1's grid, block and shared-memory layout
(``ops.probes.flash_parts``, ``csrc/probes.cu``) with the stages it names
on; its delta against ``full`` is what the missing stage costs:

* ``full`` — every stage (kernel 1's body, bit-equal to ``real``);
* ``dma_only`` — the Q tile and every K/V tile load, no S^2 work;
* ``no_scale``, ``no_max``, ``no_exp``, ``no_qk``, ``no_av`` — one stage
  off (``ops/probes.py`` says what stands in for it);
* ``matmuls_only`` — the two products alone;
* ``real`` — ``ops.flash.flash_attn_with_lse``, kernel 1 as the pipeline
  calls it (with its LSE);
* ``sdpa`` — one ``scaled_dot_product_attention`` call (cuDNN on an H100):
  the yardstick, never on the pipeline's path.

Inputs are bf16 (B, H, S, D) tensors passed as their (B, S, H, D)
``transpose(1, 2)`` views (kernel 1 reads through strides).  Each time is
per call without dispatch cost (``probes/timing.per_call_ms``: CUDA graphs
of 20 and 120 launches, the minimum of 3 repetitions), each call on the
next of enough sets of inputs that it reads them from DRAM, not from L2.

    python -m compactfusion_tpu_torch.probes.flash_parts [variant ...]

On an H100 the nine rows take a few seconds after the kernel build.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.ops import flash as ops_flash
from compactfusion_tpu_torch.ops import probes as ops_probes
from compactfusion_tpu_torch.probes import timing

B, H, S, D = 2, 16, 1024, 72
N_LO, N_HI = 20, 120
ALL = ops_probes.STAGES

#: name -> the stages on (None: kernel 1 itself; the yardstick is "sdpa")
VARIANTS = {
    "full": ALL,
    "dma_only": (),
    "no_scale": ("qk", "max", "exp", "av"),
    "no_max": ("qk", "scale", "exp", "av"),
    "no_exp": ("qk", "scale", "max", "av"),
    "no_qk": ("scale", "max", "exp", "av"),
    "no_av": ("qk", "scale", "max", "exp"),
    "matmuls_only": ("qk", "av"),
    "real": None,
    "sdpa": None,
}

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def make_inputs(generator: torch.Generator, b=B, h=H, s=S, d=D):
    """q, k, v: bf16 (B, H, S, D) normals from ``generator`` (on its
    device), returned as their (B, S, H, D) views."""
    def rnd():
        return torch.randn((b, h, s, d), generator=generator, device=generator.device).to(torch.bfloat16)

    return tuple(rnd().transpose(1, 2) for _ in range(3))


def call(name: str, q, k, v):
    """A no-argument call of variant ``name`` on the (B, S, H, D) views."""
    if name == "real":
        return lambda: ops_flash.flash_attn_with_lse(q, k, v)[0]
    if name == "sdpa":
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)
    parts = VARIANTS[name]
    return lambda: ops_probes.flash_parts(q, k, v, parts)


def bound(name: str, b=B, h=H, s=S, d=D):
    """(bound_ms, bound_by): q, k, v read once and the output written once
    (and kernel 1's LSE) over the memory rate, against the bf16 products the
    variant keeps (2 * S^2 * D each) over the bf16 peak."""
    parts = ALL if VARIANTS[name] is None else VARIANTS[name]
    nbytes = 4 * b * s * h * d * 2 + (4 * b * h * s if name in ("full", "real") else 0)
    ops = 2 * b * h * s * s * d * sum(p in parts for p in ("qk", "av"))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def run(names: Optional[Sequence[str]] = None, *, device="cuda", b=B, h=H, s=S, d=D):
    """One row per variant (in ``VARIANTS`` order): µs per call and per
    (b, h), the delta against ``full``, the bound, the launches the device
    ran (``flash_parts``, ``flash_attn_with_lse``), and the output of one
    call on the inputs of seed 0.  The timed calls cycle through as many
    sets of inputs as ``timing.copies`` says, so each reads its inputs from
    DRAM.  On ``device="cpu"`` the wrappers run their twins and nothing is
    timed (the times are None); on CUDA without a card it raises."""
    names = list(VARIANTS) if not names else list(names)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; the variants are {list(VARIANTS)}")
    device = torch.device(device)
    if device.type == "cuda":
        timing.require_cuda("the flash stage probe")
    gen = torch.Generator(device=device).manual_seed(0)
    n_sets = timing.copies(4 * b * s * h * d * 2) if device.type == "cuda" else 1
    sets = [make_inputs(gen, b, h, s, d) for _ in range(n_sets)]
    kernels = (ops_probes.flash_parts, ops_flash.flash_attn_with_lse)
    rows = []
    for name in names:
        before = timing.counts(kernels)
        row = {"name": name, "out": call(name, *sets[0])()}
        row["bound_ms"], row["bound_by"] = bound(name, b, h, s, d)
        if device.type == "cuda":
            first = {kn: c - before[kn] for kn, c in timing.counts(kernels).items()}
            fn = timing.rotate([call(name, *qkv) for qkv in sets])
            ms, ran = timing.per_call_ms(fn, N_LO, N_HI, kernels)
            row["launches"] = {kn: first[kn] + ran[kn] for kn in ran}
            row["us_per_call"] = ms * 1e3
            row["us_per_bh"] = ms * 1e3 / (b * h)
        else:
            row["launches"], row["us_per_call"], row["us_per_bh"] = None, None, None
        rows.append(row)
    full = next((r["us_per_call"] for r in rows if r["name"] == "full"), None)
    for r in rows:
        r["delta_vs_full_us"] = None if full is None or r["us_per_call"] is None else r["us_per_call"] - full
    return rows


def format_row(row) -> str:
    def us(x):
        return "not measured" if x is None else f"{x:9.2f}"

    return (f"{row['name']:13s} {us(row['us_per_call'])} us/call {us(row['us_per_bh'])} us/(b,h)  "
            f"vs full {us(row['delta_vs_full_us'])} us  bound {row['bound_ms'] * 1e3:8.2f} us "
            f"({row['bound_by']})")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"a subset of {list(VARIANTS)}")
    ap.add_argument("--device", default="cuda", help="cuda (timed) or cpu (the twins, untimed)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        timing.require_cuda("the flash stage probe")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = run(args.variants, device=args.device)
    for row in rows:
        print(format_row(row))
    print(json.dumps([{k: v for k, v in r.items() if k != "out"} for r in rows]))


if __name__ == "__main__":
    main()
