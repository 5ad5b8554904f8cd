"""Where the PixArt-alpha 512 block's time goes: the 28-block forward with
parts of the block switched off or replaced.

Counterpart of the JAX repo's ``_prof2_dbg.py``: ``make_params`` is its
stacked bf16 parameter tree (``:31-50``) and ``make_fwd`` its block
(``:107-196``), here on the port's ``models/common`` and ``ops/attention``.
The variants:

* ``full`` — self-attention through ``sdpa``, which is kernel 1 on CUDA;
* ``no_self_attn``, ``no_cross``, ``no_ffn``, ``no_modulation`` — one part
  of the block left out;
* ``cross_lse`` (the JAX ``cross_xla``) — cross-attention through
  ``attn_with_lse``, the math path with its LSE.  The port's ``sdpa`` is
  that path without the LSE (it has no counterpart of the JAX package's
  bound-based ``_xla_attn_nolse``), so this variant measures the same work
  as ``full``;
* ``self_transpose`` — in place of attention, the (B, S, H, D) ->
  (B, H, S, D) -> back round trip, made contiguous both ways;
* ``self_plumb`` — in place of attention, ``ops.probes.plumb``: q, k and v
  read once through attention's layout, none of its math;
* ``self_sdpa`` — in place of attention, one
  ``scaled_dot_product_attention`` call (cuDNN on an H100): the yardstick,
  never on the pipeline's path.

Not ported: the JAX variants that set flash flags working around the TPU's
lane padding and VMEM (``self_bq512``, ``*bf16exp``, ``*fuse*``, ``*hp*``,
``self_bhsd_io``, ``self_single*``, ``self_fold*``, ``*sbf16``;
``flash_pallas.py:354-388``).  Kernel 1 reads q/k/v as strided views of
the qkv product and writes (B, S, H, D), so it has no relayout copy to
remove, and none of those flags is part of its contract.

Each variant is timed per forward both ways (``probes/timing.
per_forward_ms``): replays of one captured CUDA graph of the forward
(no host launch gaps) and eager calls, 2 and 10 of each, the minimum of 3
repetitions.

    python -m compactfusion_tpu_torch.probes.block_parts [variant ...]

At full width (28 blocks, dim 1152, 16 heads, B 2, S 1024, text 120 with
``kv_lens`` 120; 1.19 GB of bf16 parameters) the nine variants take about
half a minute on an H100.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.pixart import _heads, _layer, _unheads
from compactfusion_tpu_torch.ops import flash as ops_flash
from compactfusion_tpu_torch.ops import probes as ops_probes
from compactfusion_tpu_torch.ops.attention import attn_with_lse, sdpa
from compactfusion_tpu_torch.probes import timing

DEPTH, DIM, HEADS = 28, 1152, 16
B, S, ST = 2, 1024, 120
N_LO, N_HI = 2, 10

VARIANTS = {
    "full": {},
    "no_self_attn": {"self_attn": False},
    "no_cross": {"cross": False},
    "no_ffn": {"ffn": False},
    "no_modulation": {"modulate": False},
    "cross_lse": {"cross_impl": "lse"},
    "self_transpose": {"self_kw": "transpose_probe"},
    "self_plumb": {"self_kw": "plumb_probe"},
    "self_sdpa": {"self_kw": "sdpa_probe"},
}

#: what each part of the block costs per forward: (part, variant, baseline)
PARTS = (
    ("self-attention (kernel 1)", "full", "no_self_attn"),
    ("cross-attention", "full", "no_cross"),
    ("FFN", "full", "no_ffn"),
    ("modulation", "full", "no_modulation"),
    ("plumb in place of attention", "self_plumb", "no_self_attn"),
    ("transpose round trip in place of attention", "self_transpose", "no_self_attn"),
    ("SDPA in place of attention", "self_sdpa", "no_self_attn"),
)


def make_params(generator: torch.Generator, depth: int = DEPTH, dim: int = DIM):
    """The stacked bf16 block tree: normals times 1/sqrt(fan-in) for the
    weights, zero biases, a 0.02 scale-shift table; on the generator's
    device."""
    def nrm(shape, scale):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * scale).to(torch.bfloat16)

    def lin(i, o):
        return {"w": nrm((depth, i, o), i**-0.5),
                "b": torch.zeros((depth, o), dtype=torch.bfloat16, device=generator.device)}

    return {
        "scale_shift_table": nrm((depth, 6, dim), 0.02),
        "attn_qkv": lin(dim, 3 * dim),
        "attn_out": lin(dim, dim),
        "cross_q": lin(dim, dim),
        "cross_kv": lin(dim, 2 * dim),
        "cross_out": lin(dim, dim),
        "ffn": {"fc1": lin(dim, 4 * dim), "fc2": lin(4 * dim, dim)},
    }


def _self_attention(kind, q, k, v):
    if kind is None:
        return sdpa(q, k, v)
    if kind == "plumb_probe":
        return ops_probes.plumb(q, k, v)
    if kind == "transpose_probe":
        return q.transpose(1, 2).contiguous().transpose(1, 2).contiguous()
    if kind == "sdpa_probe":
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)
    raise ValueError(f"unknown self-attention probe {kind!r}")


def make_fwd(self_attn=True, cross=True, ffn=True, modulate=True, cross_impl="auto",
             self_kw=None, heads=HEADS):
    """The forward over every block of a stacked tree:
    ``fwd(params, x (B, S, dim), text_d (B, St, dim), mod6 (B, 6, dim),
    lens (B,))`` -> x.  ``cross_impl``: "auto" (``sdpa``) or "lse"
    (``attn_with_lse``); ``self_kw``: None (``sdpa``), "transpose_probe",
    "plumb_probe" or "sdpa_probe"."""
    if cross_impl not in ("auto", "lse"):
        raise ValueError(f"cross_impl must be 'auto' or 'lse', got {cross_impl!r}")

    def fwd(params, x, text_d, mod6, lens):
        d = x.shape[-1]
        for layer in range(params["scale_shift_table"].shape[0]):
            p = _layer(params, layer)
            table = p["scale_shift_table"][None] + mod6
            sh_a, sc_a, g_a, sh_m, sc_m, g_m = [table[:, i][:, None] for i in range(6)]
            xn = cm.layernorm({}, x) * (1 + sc_a) + sh_a if modulate else x
            q, k, v = cm.linear(p["attn_qkv"], xn).split(d, dim=-1)
            if self_attn:
                o = _self_attention(self_kw, _heads(q, heads), _heads(k, heads), _heads(v, heads))
            else:
                o = _heads(q, heads)
            x = x + g_a * cm.linear(p["attn_out"], _unheads(o))
            if cross:
                q = cm.linear(p["cross_q"], x)
                k2, v2 = cm.linear(p["cross_kv"], text_d).split(d, dim=-1)
                qh, kh, vh = _heads(q, heads), _heads(k2, heads), _heads(v2, heads)
                if cross_impl == "lse":
                    o, _ = attn_with_lse(qh, kh, vh, kv_lens=lens)
                else:
                    o = sdpa(qh, kh, vh, kv_lens=lens)
                x = x + cm.linear(p["cross_out"], _unheads(o))
            if ffn:
                xn = cm.layernorm({}, x) * (1 + sc_m) + sh_m if modulate else x
                x = x + g_m * cm.ffn(p["ffn"], xn)
        return x

    return fwd


def make_inputs(generator: torch.Generator, b=B, s=S, st=ST, dim=DIM):
    """x (B, S, dim), text states (B, St, dim) and the modulation (B, 6,
    dim), bf16 normals, and ``kv_lens`` (B,) = St."""
    def rnd(*shape):
        return torch.randn(shape, generator=generator, device=generator.device).to(torch.bfloat16)

    lens = torch.full((b,), st, dtype=torch.int32, device=generator.device)
    return rnd(b, s, dim), rnd(b, st, dim), rnd(b, 6, dim), lens


def run(names: Optional[Sequence[str]] = None, *, device="cuda", depth=DEPTH, dim=DIM,
        heads=HEADS, b=B, s=S, st=ST):
    """One row per variant (in ``VARIANTS`` order): ms per forward by graph
    replay and eager, the replay delta against ``full``, the launches the
    device ran (``flash_attn_with_lse``, ``plumb``) and the output of one
    eager forward, on parameters and inputs of seed 0.  On
    ``device="cpu"`` nothing is timed (the times are None); on CUDA without
    a card it raises."""
    names = list(VARIANTS) if not names else list(names)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; the variants are {list(VARIANTS)}")
    device = torch.device(device)
    if device.type == "cuda":
        timing.require_cuda("the block probe")
    gen = torch.Generator(device=device).manual_seed(0)
    params = make_params(gen, depth, dim)
    x, text_d, mod6, lens = make_inputs(gen, b, s, st, dim)
    kernels = (ops_flash.flash_attn_with_lse, ops_probes.plumb)
    rows = []
    for name in names:
        fwd = make_fwd(**VARIANTS[name], heads=heads)

        def call():
            return fwd(params, x, text_d, mod6, lens)

        before = timing.counts(kernels)
        row = {"name": name, "out": call()}
        if device.type == "cuda":
            first = {kn: c - before[kn] for kn, c in timing.counts(kernels).items()}
            times, ran = timing.per_forward_ms(call, N_LO, N_HI, kernels)
            row.update(times, launches={kn: first[kn] + ran[kn] for kn in ran})
        else:
            row.update(launches=None, replay_ms=None, eager_ms=None)
        rows.append(row)
    full = next((r["replay_ms"] for r in rows if r["name"] == "full"), None)
    for r in rows:
        r["delta_vs_full_ms"] = None if full is None or r["replay_ms"] is None else r["replay_ms"] - full
    return rows


def breakdown(rows):
    """[(part, ms per forward, share of ``full``)] by graph replay, for the
    parts whose variants were run."""
    ms = {r["name"]: r["replay_ms"] for r in rows}
    full = ms.get("full")
    out = []
    for part, with_it, without in PARTS:
        if ms.get(with_it) is not None and ms.get(without) is not None and full:
            cost = ms[with_it] - ms[without]
            out.append((part, cost, cost / full))
    return out


def format_row(row) -> str:
    def ms(x):
        return "not measured" if x is None else f"{x:9.4f}"

    return (f"{row['name']:15s} replay {ms(row['replay_ms'])} ms/fwd  eager {ms(row['eager_ms'])} "
            f"ms/fwd  vs full {ms(row['delta_vs_full_ms'])} ms")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"a subset of {list(VARIANTS)}")
    ap.add_argument("--device", default="cuda", help="cuda (timed) or cpu (untimed)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        timing.require_cuda("the block probe")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = run(args.variants, device=args.device)
    for row in rows:
        print(format_row(row))
    for part, cost, share in breakdown(rows):
        print(f"{part}: {cost:.4f} ms per forward ({share:.1%} of full)")
    print(json.dumps([{k: v for k, v in r.items() if k != "out"} for r in rows]))


if __name__ == "__main__":
    main()
