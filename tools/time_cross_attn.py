#!/usr/bin/env python3
"""Time the forms of ``sdpa``'s no-LSE route at PixArt's cross-attention shape.

    python3 tools/time_cross_attn.py [--out FILE]

``ops/attention.py::_attn_nolse`` makes two choices that only the card can
settle, and this tool times each form of both at B2 Sq1024 H16 Sk120 d72
bf16 (``chip_smoke.py::cross_inputs``: q heads of a projection, k and v
column slices of the text's key-value projection) with ``kv_lens`` (120,
120):

* the scores: ``bmm`` of the bf16 operands with ``out_dtype`` fp32
  (``direct``) or of fp32 copies (``upcast``), the AV product likewise;
  or ``baddbmm`` of the bf16 operands with the softmax scale as its
  ``alpha`` (``alpha``: the scale applied to the fp32 product in the
  GEMM's epilogue, no pass of its own), the AV product ``direct``;
* the row sum r of the rounded p: a separate fp32 sum (``sum``) or a
  ones-column in v, padded to 80 (``lanes``), read from the AV product, as
  the JAX ``_xla_attn_nolse`` does where d % 128 != 0.

Each form is checked against the math path (``_attn_math``, relative
Frobenius error on the live rows, ``chip_smoke.py::CROSS_REL_MAX``) and
against ``_attn_nolse``'s own form (bit for bit or not), and timed in two
turns, eager (the least of 3 runs of 50 calls between CUDA events) and by
CUDA graphs on inputs from DRAM (``chip_smoke.py::graph_ms``), beside
``_attn_nolse`` itself (which must equal its own form bit for bit), the
math path and one
``scaled_dot_product_attention`` call with the key padding as a bool mask.
Prints the card's name and power limit, one line per form and one JSON
line (also written to ``--out``); exits non-zero without a CUDA device or
when a form disagrees.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
#: (scores, row sum) of ``_attn_nolse`` as this tree has it
SHIPPED = ("alpha", "sum")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_harness", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def form(scores_form, rowsum):
    """``_attn_nolse``'s arithmetic with the scores and AV products taken
    ``scores_form`` ("direct", "upcast" or "alpha") and r taken ``rowsum``
    ("sum" or "lanes")."""
    import torch

    def mm(a, b, how, scale=1.0):
        out = torch.empty(a.shape[:-1] + b.shape[-1:], dtype=torch.float32, device=a.device)
        for i in range(a.shape[0]):
            if how == "alpha":
                torch.baddbmm(out[i], a[i], b[i], torch.float32, beta=0, alpha=scale, out=out[i])
            elif how == "direct":
                torch.bmm(a[i], b[i], torch.float32, out=out[i])
            else:
                torch.bmm(a[i].float(), b[i].float(), out=out[i])
        return out

    av = "upcast" if scores_form == "upcast" else "direct"

    def run(q, k, v, kv_lens):
        b, sq, h, d = q.shape
        sk = k.shape[1]
        if scores_form == "alpha":
            scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), "alpha", d**-0.5)
        else:
            scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), scores_form).mul_(d**-0.5)
        col = torch.arange(sk, device=q.device)
        scores.masked_fill_(col >= kv_lens[:, None, None, None], float("-inf"))
        m = scores.amax(dim=-1, keepdim=True).clamp_min_(-1e30)
        p = torch.exp(scores.sub_(m), out=torch.empty(scores.shape, dtype=v.dtype, device=q.device))
        if rowsum == "sum":
            out = mm(p, v.transpose(1, 2), av)
            r = p.sum(dim=-1, keepdim=True, dtype=torch.float32)
        else:
            lanes = -(-(d + 1) // 8) * 8
            v_aug = torch.zeros((b, sk, h, lanes), dtype=v.dtype, device=v.device)
            v_aug[..., :d] = v
            v_aug[..., d] = 1
            out_aug = mm(p, v_aug.transpose(1, 2), av)
            out, r = out_aug[..., :d], out_aug[..., d:d + 1]
        res = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        torch.div(out, r.clamp_min(1.0), out=res.transpose(1, 2))
        return res

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    smoke = _smoke()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_cross_attn: no CUDA device")
    from compactfusion_tpu_torch.ops import attention
    from compactfusion_tpu_torch.probes import timing

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = smoke.cross_inputs(gen, dev)
    kl = torch.tensor((120, 120), dtype=torch.int32, device=dev)
    ref = attention._attn_math(q, k, v, None, False, None, kl)[0]
    nbytes = smoke._nbytes(q, k, v, ref, kl)
    sets = [(q, k, v)] + [smoke.cross_inputs(gen, dev) for _ in range(timing.copies(nbytes) - 1)]
    calls = {f"{s}/{r}": form(s, r) for s in ("direct", "upcast", "alpha") for r in ("sum", "lanes")}
    calls["_attn_nolse"] = lambda q, k, v, kl: attention._attn_nolse(q, k, v, None, kl)
    calls["_attn_math"] = lambda q, k, v, kl: attention._attn_math(q, k, v, None, False, None, kl)[0]
    shipped = calls["/".join(SHIPPED)](q, k, v, kl)
    if not torch.equal(calls["_attn_nolse"](q, k, v, kl), shipped):
        raise AssertionError(f"_attn_nolse is not the {'/'.join(SHIPPED)} form")
    rows = []
    for turn in (1, 2):
        for name, fn in calls.items():
            out = fn(q, k, v, kl)
            torch.cuda.synchronize()
            rel = smoke.rel_fro(out, ref)
            rows.append({"form": name, "turn": turn, "rel_err_vs_math": rel,
                         "equal_to_shipped": torch.equal(out, shipped),
                         "ms": min(smoke._time_ms(lambda: fn(q, k, v, kl), 50) for _ in range(3)),
                         "graph_ms": smoke.graph_ms(timing, [lambda t=t: fn(*t, kl) for t in sets])})
            print(f"turn {turn} {name}: rel err vs the math path {rel:.3e}, bit-equal to _attn_nolse "
                  f"{rows[-1]['equal_to_shipped']}; eager {rows[-1]['ms']:.4f} ms, graphs "
                  f"{rows[-1]['graph_ms']:.4f} ms ({len(sets)} input sets)")
            if rel > smoke.CROSS_REL_MAX:
                raise AssertionError(f"{name} disagrees with the math path")
    mask = (torch.arange(k.shape[1], device=dev) < kl[:, None])[:, None, None, :]
    lib, backend = smoke._library(q, k, v, mask)
    rows.append({"form": f"SDPA with a key-padding mask [{backend}]", "ms": smoke._time_ms(lib, 50)})
    print(f"{rows[-1]['form']}: eager {rows[-1]['ms']:.4f} ms")
    line = json.dumps({"card": card, "torch": torch.__version__, "shipped": "/".join(SHIPPED), "rows": rows})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
