"""The weight trees the benchmark draws: the port's layout of each model.

A tree is nested dicts and lists whose leaves are :class:`Leaf` (a shape
and how its values are drawn, see ``cfbench/weights.py``).  Block families
are stacked on a leading layer axis.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    #: ``w`` a linear weight, ``conv_w`` a convolution's, ``b`` a bias,
    #: ``mod_b`` a modulation bias, ``one`` a norm's gain, ``zero`` a
    #: norm's bias, ``eye`` a 1x1 convolution that is the identity
    kind: str


def _linear(d_in, d_out, stack=(), bias=True, mod=False):
    p = {"w": Leaf((*stack, d_in, d_out), "w")}
    if bias:
        p["b"] = Leaf((*stack, d_out), "mod_b" if mod else "b")
    return p


def _mlp(d_in, d_hidden, d_out, stack=(), bias=True):
    return {"fc1": _linear(d_in, d_hidden, stack, bias), "fc2": _linear(d_hidden, d_out, stack, bias)}


def mmdit_layout(m: dict, context_embedder: bool = True) -> dict:
    """FLUX's tree (``models/flux.py::init_flux``): embedders, the double
    blocks (``m["double"]`` deep) and the single blocks (``m["single"]``),
    the AdaLN-Continuous head.  ``m`` holds ``dim``, ``heads``, ``head_dim``,
    ``double``, ``single``, ``in_channels``, ``text_dim``, ``pooled_dim``,
    ``mlp_ratio`` and ``guidance``."""
    d, hd, f = m["dim"], m["head_dim"], m["mlp_ratio"] * m["dim"]
    dl, sl = (m["double"],), (m["single"],)
    p = {
        "x_embedder": _linear(m["in_channels"], d),
        "t_embed": _mlp(256, d, d),
        "pooled_embed": _mlp(m["pooled_dim"], d, d),
        "double_blocks": {
            **{f"{s}_mod": _linear(d, 6 * d, dl, mod=True) for s in ("img", "txt")},
            **{f"{s}_qkv": _linear(d, 3 * d, dl) for s in ("img", "txt")},
            **{f"{s}_{n}_norm": {"g": Leaf((*dl, hd), "one")} for s in ("img", "txt") for n in ("q", "k")},
            **{f"{s}_out": _linear(d, d, dl) for s in ("img", "txt")},
            **{f"{s}_ffn": _mlp(d, f, d, dl) for s in ("img", "txt")},
        },
        "single_blocks": {
            "mod": _linear(d, 3 * d, sl, mod=True),
            "qkv": _linear(d, 3 * d, sl),
            "q_norm": {"g": Leaf((*sl, hd), "one")},
            "k_norm": {"g": Leaf((*sl, hd), "one")},
            "mlp": {"fc1": _linear(d, f, sl), "fc2": _linear(f, d, sl, bias=False)},
            "out_attn": _linear(d, d, sl),
        },
        "norm_out_mod": _linear(d, 2 * d, mod=True),
        "proj_out": _linear(d, m["in_channels"]),
    }
    if context_embedder:
        p["context_embedder"] = _linear(m["text_dim"], d)
    if m["guidance"]:
        p["guidance_embed"] = _mlp(256, d, d)
    return p


def hunyuanvideo_layout(m: dict) -> dict:
    """HunyuanVideo's tree (``models/hunyuanvideo.py::init_hunyuanvideo``):
    FLUX's without ``context_embedder``, with the token refiner
    (``m["refiner"]`` blocks)."""
    d, rl = m["dim"], (m["refiner"],)
    p = mmdit_layout(m, context_embedder=False)
    p["refiner"] = {
        "t_embed": _mlp(256, d, d),
        "c_embed": _mlp(m["text_dim"], d, d),
        "proj_in": _linear(m["text_dim"], d),
        "blocks": {
            "norm1": {"g": Leaf((*rl, d), "one"), "b": Leaf((*rl, d), "zero")},
            "attn_qkv": _linear(d, 3 * d, rl),
            "attn_out": _linear(d, d, rl),
            "norm2": {"g": Leaf((*rl, d), "one"), "b": Leaf((*rl, d), "zero")},
            "ffn": _mlp(d, m["mlp_ratio"] * d, d, rl),
            "ada": _linear(d, 2 * d, rl, mod=True),
        },
    }
    return p


def _conv(c_in, c_out, k=3, kind="conv_w"):
    return {"w": Leaf((k, k, c_in, c_out), kind), "b": Leaf((c_out,), "zero" if kind == "eye" else "b")}


def _groupnorm(c):
    return {"g": Leaf((c,), "one"), "b": Leaf((c,), "zero")}


def _resnet(c_in, c_out):
    p = {"norm1": _groupnorm(c_in), "conv1": _conv(c_in, c_out), "norm2": _groupnorm(c_out),
         "conv2": _conv(c_out, c_out)}
    if c_in != c_out:
        p["shortcut"] = _conv(c_in, c_out, 1)
    return p


def vae_decoder_layout(v: dict) -> dict:
    """The AutoencoderKL decoder's tree (``models/vae.py::init_vae_decoder``).
    The port's decoder always runs ``post_quant_conv``; FLUX's VAE has none
    (``use_post_quant_conv`` false), so it is drawn as the identity."""
    chans = v["block_out_channels"]
    c0, lat = chans[-1], v["latent_channels"]
    p = {
        "post_quant_conv": _conv(lat, lat, 1, "conv_w" if v["use_post_quant_conv"] else "eye"),
        "conv_in": _conv(lat, c0),
        "mid_res1": _resnet(c0, c0),
        "mid_attn": {"norm": _groupnorm(c0), **{n: _linear(c0, c0) for n in ("q", "k", "v", "out")}},
        "mid_res2": _resnet(c0, c0),
        "norm_out": _groupnorm(chans[0]),
        "conv_out": _conv(chans[0], v["out_channels"]),
    }
    up, c_prev = [], c0
    for c in reversed(chans):
        blocks = []
        for _ in range(v["layers_per_block"] + 1):
            blocks.append(_resnet(c_prev, c))
            c_prev = c
        up.append({"resnets": blocks, "upsample_conv": _conv(c, c)})
    up[-1].pop("upsample_conv")
    p["up"] = up
    return p
