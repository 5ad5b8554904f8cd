#!/usr/bin/env python3
"""Where the time of one PixArt-alpha 512 or FLUX.1-dev 1024 image goes on the GPU.

    python3 tools/profile_torch.py [--out build/profile_torch.json] [--warm 3]
                                   [--only NAME ...] [--root OTHER_ROOT]

Builds the same full-width pipelines as ``chip_smoke.py`` (random weights,
spiced AdaLN tables): compression off, the ring-8 compressed emulation
with the 1-bit codec, INT2, LOW_RANK rank 4 and the per-layer plan on int8
EF caches, DiTFastAttn with ``chip_smoke.py``'s phase-10 calibrated plan
(threshold 0.5, window 64) and its phase-9 fixed plan (all seven methods),
and FBCache at threshold 0.12; and ``chip_smoke.py``'s phase-18 FLUX.1-dev
(``flux_lossless``: 19 + 38 blocks at full width, 28 steps, guidance 3.5,
1024 x 1024, spiced modulation biases).  For each it runs ``--warm`` requests, times
two more with CUDA events, then profiles one request with
``torch.profiler`` (CPU + CUDA) and
sums the device time and launches of its kernels by category (the QR
category is ``torch.linalg.qr``'s cuSOLVER kernels).  The device busy share is
that sum over the mean unprofiled time (one stream, so kernels do not
overlap).  Prints a summary per pipeline and writes everything, with the
card's ``nvidia-smi`` name, power limit and SM clock, to ``--out``.
``--only`` profiles a subset of the pipelines (``NAMES``); ``--root``
profiles another checkout's package (e.g. an unpacked ``git archive`` of
the parent commit) with this checkout's harness (``chip_smoke.py``), so
two trees are measured alike.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXART = ("lossless", "compressed_ring8", "int2_ring8", "low_rank4_ring8", "layer_plan_int8_ring8",
          "fast_attn_calibrated", "fast_attn_mixed", "fbcache_0.12")
NAMES = PIXART + ("flux_lossless",)

# kernel-name patterns, first match wins
CATEGORIES = (
    ("flash kernel", ("flash_fwd_reg_kernel", "flash_fwd_wide_kernel", "flash_fwd_wide_split_kernel")),
    ("window flash kernel", ("flash_window_reg_kernel", "flash_window_wide_kernel")),
    ("quant kernel", ("binary_quant_kernel",)),
    ("dequant kernel", ("binary_dequant_kernel",)),
    ("int2 quant kernel", ("int2_quant_kernel",)),
    ("int2 dequant kernel", ("int2_dequant_kernel",)),
    ("QR (cuSOLVER/MAGMA)", ("geqr", "orgqr", "ormqr", "larf", "cusolver", "magma", "householder")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit_convolve")),
    ("copies/cat", ("CatArray", "copy", "Memcpy", "Memset")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def category(name):
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _harness():
    """This checkout's chip_smoke.py, by path (another root may hold its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_harness", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_pipeline(request, pipe, warm, seed):
    """``request(pipe, seed)``: one image, as ``chip_smoke.py`` makes it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        request(pipe, seed)
    walls = [request(pipe, seed)[2] for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, profiled_wall = request(pipe, seed)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat, n_cat, by_name = {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e6
        n_cat[cat] = n_cat.get(cat, 0) + 1
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + us / 1e6, n + 1)
    busy = sum(by_cat.values())
    top = sorted(((t, n, name[:90]) for name, (t, n) in by_name.items()), reverse=True)[:20]
    return {
        "wall_s_unprofiled": walls,
        "wall_s_profiled": profiled_wall,
        "device_kernel_s": busy,
        "busy_share_vs_unprofiled_wall": busy / (sum(walls) / len(walls)),
        "kernel_launches": len(kernels),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "by_category_s": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "launches_by_category": n_cat,
        "top": top,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_torch.json"))
    ap.add_argument("--warm", type=int, default=3, help="unmeasured requests first")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--only", nargs="+", choices=NAMES, default=list(NAMES),
                    help="the pipelines to profile (default: all)")
    ap.add_argument("--root", default=ROOT, help="the checkout whose package is profiled")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    chip_smoke = _harness()
    sys.path.insert(0, os.path.abspath(args.root))
    from compactfusion_tpu_torch.cache.accel import CacheAccelConfig
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda)
    dev = torch.device("cuda")
    report = {"smi": smi, "torch": torch.__version__, "warm": args.warm, "seed": args.seed,
              "root": os.path.abspath(args.root)}
    if any(n in PIXART for n in args.only):
        mcfg, vcfg, params, vae_params = chip_smoke.build_models(dev)
    plan = None
    if "fast_attn_calibrated" in args.only:
        plan, report["fast_attn_calibration_s"] = chip_smoke.calibrated_plan(params, mcfg, vcfg, dev)

    def fast_attn(plan):
        return {"fast_attn_plan": tuple(tuple(int(m) for m in row) for row in plan),
                "fast_attn_window": chip_smoke.WINDOW}

    configs = {"lossless": lambda: {},
               "compressed_ring8": lambda: {"compact": chip_smoke.compressed_config()},
               "int2_ring8": lambda: {"compact": chip_smoke.compressed_config("int2")},
               "low_rank4_ring8": lambda: {"compact": chip_smoke.compressed_config("low-rank", comp_rank=4)},
               "layer_plan_int8_ring8": lambda: {"compact": chip_smoke.layer_plan_config()},
               "fast_attn_calibrated": lambda: fast_attn(plan),
               "fast_attn_mixed": lambda: fast_attn(chip_smoke.mixed_plan()),
               "fbcache_0.12": lambda: {"cache": CacheAccelConfig(mode="fbcache", threshold=0.12)}}
    for name in (n for n in PIXART if n in args.only):
        cfg = PixArtPipelineConfig(model=mcfg, vae=vcfg, num_steps=chip_smoke.STEPS,
                                   guidance_scale=4.5, **configs[name]())
        report[name] = profile_pipeline(chip_smoke.request, PixArtPipeline(params, vae_params, cfg, dev),
                                        args.warm, args.seed)
    if "flux_lossless" in args.only:
        params = vae_params = None  # PixArt's weights leave the card first
        torch.cuda.empty_cache()
        pipe = chip_smoke.flux_pipeline(*chip_smoke.build_flux(dev), dev)
        report["flux_lossless"] = profile_pipeline(chip_smoke.flux_request, pipe, args.warm, args.seed)
    for name in (n for n in NAMES if n in args.only):
        r = report[name]
        print(name, json.dumps({k: v for k, v in r.items() if k != "top"}))
        for t, n, kname in r["top"][:12]:
            print(f"  {t:10.4f} s x {n:6d}  {kname}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
