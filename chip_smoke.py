#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA machine

Phases (each prints one line; any failure ends the run with a non-zero exit):

1. Device: ``nvidia-smi`` name and power limit, and the time ``nvcc`` took
   to build the kernels from ``compactfusion_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch twin at the shapes the main path
   gives it, with the times of both (CUDA events).
3. The full-width PixArt-alpha 512 pipeline (28 blocks, dim 1152, S=1024,
   CFG batch 2, 20 DPM-Solver++ steps, SD-VAE decode), random weights with
   spiced AdaLN tables, compression off: 3 requests, each from its own seed.
4. The same pipeline with the 1-bit compressed-ring emulation (ring 8,
   residual 1 + error feedback, warmup 4), from request 1's seed; its
   latents are held against request 1's lossless latents.

Then one JSON line with each kernel's launches on the main path, error and
times, and a last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.  It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

# flash vs twin on bf16 outputs: the output is rounded to bf16 (half an ulp
# is 2^-9 relative) and the kernel rounds running, unnormalised
# probabilities to bf16 where the twin rounds normalised ones, so outputs of
# magnitude ~1 may differ by a few bf16 ulps
FLASH_OUT_ATOL = 2e-2
# both sides take the LSE in fp32 from fp32 scores of the same bf16 inputs;
# only the summation order and exp2/log2 against exp/log differ
FLASH_LSE_ATOL = 1e-3
# quant new_base vs twin: the same fp32 arithmetic, K=1 scale products exact
QUANT_NEW_BASE_RTOL = 1e-6
# compressed vs lossless latents (relative Frobenius error): the 1-bit ring
# must change the result (> 0) but stay close to it
COMPRESSED_REL_ERR_MAX = 0.05

STEPS = 20
DEPTH = 28
RING = 8
WARMUP = 4


def _time_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _reset_counts(kernels):
    for fn in kernels:
        fn.launches = 0


def check_flash(flash, dev, gen):
    """Flash kernel vs twin at the three path shapes; returns a report."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    dim = 1152
    qkv = rnd(2, 1024, 3 * dim)  # PixArt's q/k/v are column slices of one tensor
    q, k, v = (t.view(2, 1024, 16, 72) for t in qkv.split(dim, dim=-1))
    cases = [
        ("self-attn B2 H16 S1024 d72", (q, k, v), 20),
        ("ring-8 query chunk B2 H16 Sq128 Sk1024 d72", (q[:, :128], k.contiguous(), v.contiguous()), 20),
        ("VAE mid-attn B1 H1 S4096 d512", (rnd(1, 4096, 1, 512), rnd(1, 4096, 1, 512), rnd(1, 4096, 1, 512)), 5),
    ]
    rows = []
    for name, (qq, kk, vv), iters in cases:
        out, lse = flash.flash_attn_with_lse(qq, kk, vv)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash.flash_attn_with_lse_ref(qq, kk, vv)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ms = _time_ms(lambda: flash.flash_attn_with_lse(qq, kk, vv), iters)
        plain_ms = _time_ms(lambda: flash.flash_attn_with_lse_ref(qq, kk, vv), iters)
        rows.append({"shape": name, "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                     "ms": ms, "plain_ms": plain_ms})
        print(f"[2] flash {name}: out err {err_out:.3e} (tol {FLASH_OUT_ATOL}), lse err "
              f"{err_lse:.3e} (tol {FLASH_LSE_ATOL}); kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
        if not (err_out <= FLASH_OUT_ATOL and err_lse <= FLASH_LSE_ATOL):
            raise AssertionError(f"flash kernel disagrees with its twin at {name}")
    return rows


def check_quant(quant, codecs, dev, gen):
    """Binary quant/dequant kernels vs twins at the ring-8 PixArt shape."""
    import torch

    n, c = 256, 1152
    x = torch.randn((n, c), generator=gen, device=dev)
    base = torch.randn((n, c), generator=gen, device=dev) * 0.9
    u, v = codecs._scale_uv(x - base, -1)
    u, v = codecs._wire(u), codecs._wire(v)
    packed, new_base = quant.binary_quant_fastpath(x, base, u, v)
    x_hat = quant.binary_dequant_fastpath(packed, base, u, v)
    torch.cuda.synchronize()
    ref_packed, ref_base = quant.binary_quant_fastpath_ref(x, base, u, v)
    ref_hat = quant.binary_dequant_fastpath_ref(packed, base, u, v)
    if not torch.equal(packed, ref_packed):
        raise AssertionError("quant kernel: packed bytes differ from the twin's")
    rel = ((new_base - ref_base).abs() / ref_base.abs().clamp_min(1e-30)).max().item()
    if rel > QUANT_NEW_BASE_RTOL:
        raise AssertionError(f"quant kernel: new_base off the twin by {rel:.3e} relative")
    if not torch.equal(x_hat, new_base):
        raise AssertionError("dequant output is not bit-identical to quant's new_base")
    err_q = (new_base - ref_base).abs().max().item()
    err_d = (x_hat - ref_hat).abs().max().item()
    times = {
        "quant": (_time_ms(lambda: quant.binary_quant_fastpath(x, base, u, v), 200),
                  _time_ms(lambda: quant.binary_quant_fastpath_ref(x, base, u, v), 200)),
        "dequant": (_time_ms(lambda: quant.binary_dequant_fastpath(packed, base, u, v), 200),
                    _time_ms(lambda: quant.binary_dequant_fastpath_ref(packed, base, u, v), 200)),
    }
    print(f"[2] binary quant N{n} C{c} K1 fp32: packed bytes equal, new_base rel err {rel:.3e} "
          f"(tol {QUANT_NEW_BASE_RTOL}), dequant == new_base bit for bit; quant "
          f"{times['quant'][0]:.4f} ms (twin {times['quant'][1]:.4f}), dequant "
          f"{times['dequant'][0]:.4f} ms (twin {times['dequant'][1]:.4f})")
    return err_q, err_d, times


def check_image(img, what):
    import torch

    if tuple(img.shape) != (1, 512, 512, 3):
        raise AssertionError(f"{what}: image shape {tuple(img.shape)}")
    f = img.float()
    if not bool(torch.isfinite(f).all()):
        raise AssertionError(f"{what}: non-finite pixels")
    lo, hi = f.min().item(), f.max().item()
    if lo < 0.0 or hi > 1.0 or hi <= lo:
        raise AssertionError(f"{what}: pixels span [{lo}, {hi}]")
    return lo, hi


def build_models(dev):
    """Full-width PixArt-alpha 512 + SD-VAE with random weights from fixed
    seeds; the zero-init AdaLN tables are spiced so attention (and
    compression error) reaches the output at trained-model-like magnitude."""
    import numpy as np
    import torch

    from compactfusion_tpu_torch.models.pixart import init_pixart, pixart_alpha_512
    from compactfusion_tpu_torch.models.vae import init_vae_decoder, sd_vae

    mcfg, vcfg = pixart_alpha_512(), sd_vae()
    params = init_pixart(torch.Generator(device=dev).manual_seed(0), mcfg)
    spice = np.random.default_rng(99)
    for tree, key in ((params["blocks"], "scale_shift_table"), (params["adaln_single"], "b")):
        tree[key] = torch.from_numpy(spice.standard_normal(tuple(tree[key].shape)) * 0.5).to(
            device=dev, dtype=mcfg.dtype)
    vae_params = init_vae_decoder(torch.Generator(device=dev).manual_seed(1), vcfg)
    return mcfg, vcfg, params, vae_params


def compressed_config():
    """The 1-bit compressed-ring emulation: ring 8, residual 1 with error
    feedback, warmup 4, the fused quant kernels on."""
    from compactfusion_tpu_torch.config import CompactConfig, CompressType

    return CompactConfig(enabled=True, compress_type=CompressType.BINARY, comp_rank=-1,
                         warmup_steps=WARMUP, residual=1, error_feedback=True,
                         fastpath=True, simulate_ring=RING)


def request(pipe, seed):
    """One image: random text (2, 1, 120, text_dim) with a full mask, and
    the noise, both from ``seed``; returns (latents, image, seconds from
    CUDA events)."""
    import torch

    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(seed)
    text = torch.randn((2, 1, 120, pipe.cfg.model.text_dim), generator=g, device=dev)
    mask = torch.ones((2, 1, 120), dtype=torch.bool, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lat = pipe(text, mask, generator=g, decode=False)
    img = pipe.decode(lat)
    end.record()
    torch.cuda.synchronize()
    return lat, img, start.elapsed_time(end) / 1e3


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from compactfusion_tpu_torch.compact import codecs
    from compactfusion_tpu_torch.ops import _build, flash, quant
    from compactfusion_tpu_torch.pipelines.pixart import PixArtPipeline, PixArtPipelineConfig

    # float32 matmuls and convolutions in full fp32 (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = (flash.flash_attn_with_lse, quant.binary_quant_fastpath, quant.binary_dequant_fastpath)

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.load()
    regs = [ln.split(":", 1)[1].strip() for ln in _build.last_build_log.splitlines() if "Used" in ln]
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"kernels built in {_build.last_build_seconds:.1f} s (load {time.perf_counter() - t0:.1f} s); "
          f"ptxas: {regs}")

    # -- 2. kernels vs twins ----------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    flash_rows = check_flash(flash, dev, gen)
    err_q, err_d, qtimes = check_quant(quant, codecs, dev, gen)

    # -- 3. full-width pipeline, compression off -----------------------------
    mcfg, vcfg, params, vae_params = build_models(dev)
    base_cfg = PixArtPipelineConfig(model=mcfg, vae=vcfg, num_steps=STEPS, guidance_scale=4.5)
    pipe = PixArtPipeline(params, vae_params, base_cfg, dev)
    _reset_counts(kernels)  # the main path starts here
    lossless = None
    secs = []
    for seed in (1, 2, 3):
        before = flash.flash_attn_with_lse.launches
        lat, img, sec = request(pipe, seed)
        lo, hi = check_image(img, f"request seed {seed}")
        launched = flash.flash_attn_with_lse.launches - before
        if launched < DEPTH * STEPS:
            raise AssertionError(f"request seed {seed}: flash launched {launched} < {DEPTH * STEPS} times")
        if quant.binary_quant_fastpath.launches or quant.binary_dequant_fastpath.launches:
            raise AssertionError("compression off, yet the quant kernels launched")
        if lossless is None:
            lossless = lat
        secs.append(sec)
        print(f"[3] request seed {seed}: image (1, 512, 512, 3) in [{lo:.4f}, {hi:.4f}], "
              f"flash launches {launched}, {sec:.4f} s/image")

    # -- 4. full-width pipeline, compressed ring emulation ---------------------
    compact = compressed_config()
    pipe_c = PixArtPipeline(params, vae_params, PixArtPipelineConfig(
        model=mcfg, vae=vcfg, compact=compact, num_steps=STEPS, guidance_scale=4.5), dev)
    before = [fn.launches for fn in kernels]
    lat_c, img_c, sec_c = request(pipe_c, 1)
    delta = [fn.launches - b for fn, b in zip(kernels, before)]
    counts = {fn.__name__: fn.launches for fn in kernels}  # the main path ends here
    check_image(img_c, "compressed request")
    expect = DEPTH * RING * 2 * (STEPS - WARMUP)
    if delta[1] != expect or delta[2] != expect:
        raise AssertionError(f"quant/dequant launched {delta[1]}/{delta[2]} times, expected {expect} each")
    rel = (torch.linalg.vector_norm(lat_c - lossless) / torch.linalg.vector_norm(lossless)).item()
    if not 0.0 < rel < COMPRESSED_REL_ERR_MAX:
        raise AssertionError(f"compressed vs lossless latent rel err {rel} not in (0, {COMPRESSED_REL_ERR_MAX})")
    print(f"[4] compressed ring-{RING} binary request seed 1: latent rel err vs lossless {rel:.6f} "
          f"(bound {COMPRESSED_REL_ERR_MAX}), quant/dequant launches {delta[1]}/{delta[2]} "
          f"(expected {expect}), flash launches {delta[0]}, {sec_c:.4f} s/image; lossless "
          f"s/image {', '.join(f'{s:.4f}' for s in secs)}")

    for name, count in counts.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    src = "compactfusion_tpu_torch/csrc/"
    report = {"kernels": [
        {"name": "flash_attn_with_lse", "route": "cuda", "source": src + "flash_attn.cu",
         "replaces": "compactfusion_tpu/ops/flash_pallas.py:593",
         "launches": counts["flash_attn_with_lse"],
         "max_abs_err": max(r["max_abs_err_out"] for r in flash_rows),
         "ms": flash_rows[0]["ms"], "plain_ms": flash_rows[0]["plain_ms"], "shapes": flash_rows},
        {"name": "binary_quant_fastpath", "route": "cuda", "source": src + "binary_quant.cu",
         "replaces": "compactfusion_tpu/ops/quant_pallas.py:118",
         "launches": counts["binary_quant_fastpath"], "max_abs_err": err_q,
         "ms": qtimes["quant"][0], "plain_ms": qtimes["quant"][1]},
        {"name": "binary_dequant_fastpath", "route": "cuda", "source": src + "binary_quant.cu",
         "replaces": "compactfusion_tpu/ops/quant_pallas.py:159",
         "launches": counts["binary_dequant_fastpath"], "max_abs_err": err_d,
         "ms": qtimes["dequant"][0], "plain_ms": qtimes["dequant"][1]},
    ], "s_per_image_lossless": secs, "s_per_image_compressed": sec_c,
       "compressed_latent_rel_err": rel}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
