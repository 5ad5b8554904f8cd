"""Text encoders: the T5 encoder stack and the CLIP text model
(counterpart of ``compactfusion_tpu/models/text_encoders.py``).

T5-XXL feeds PixArt's and FLUX's prompts; CLIP-L gives FLUX its pooled
vector (CLIP-G with a projection is SD3's).  Parameters are the JAX trees:
per-layer tensors stacked on a leading layer axis, linears ``(d_in,
d_out)``, loadable from HuggingFace checkpoints (``io/hf.py``).  The JAX
package computes the attention products as plain einsums (no Pallas
kernel), so they are plain torch here: scores and softmax in fp32, the
linears in the parameter dtype.

Prompts are encoded once per request, outside the denoise loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from compactfusion_tpu_torch.models import common as cm


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    dtype: Any = torch.bfloat16


def t5_xxl() -> T5Config:
    return T5Config()


def t5_tiny() -> T5Config:
    return T5Config(vocab_size=128, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4)


def init_t5(generator: torch.Generator, cfg: T5Config):
    """Random init on the generator's device: the tree of the JAX
    ``init_t5`` (other random draws)."""
    d, dt, L = cfg.d_model, cfg.dtype, (cfg.num_layers,)
    dev = generator.device
    inner = cfg.num_heads * cfg.d_kv

    def lin(i, o):
        return cm.init_linear(generator, i, o, bias=False, dtype=dt, stack=L)

    blocks = {
        "ln1": cm.init_rmsnorm(d, dt, dev, L),
        "q": lin(d, inner),
        "k": lin(d, inner),
        "v": lin(d, inner),
        "o": lin(inner, d),
        "ln2": cm.init_rmsnorm(d, dt, dev, L),
        "wi_0": lin(d, cfg.d_ff),
        "wi_1": lin(d, cfg.d_ff),
        "wo": lin(cfg.d_ff, d),
    }
    emb = torch.randn((cfg.vocab_size, d), generator=generator, dtype=torch.float32, device=dev)
    return {
        "embed": emb.to(dt),
        "rel_bias": torch.zeros((cfg.rel_buckets, cfg.num_heads), dtype=dt, device=dev),
        "blocks": blocks,
        "final_ln": cm.init_rmsnorm(d, dt, dev),
    }


def quantize_t5_int8(params):
    """Per-output-channel symmetric int8 weights for every T5 linear
    (``cm.quantize_params_int8``) and a per-row scale for the embedding
    table, as the JAX ``quantize_t5_int8``: T5-XXL's 9.5 GB of bf16 weights
    become about half; :func:`t5_encode` dequantizes one layer's weights at
    a time, at each matmul."""
    out = cm.quantize_params_int8({k: v for k, v in params.items() if k != "embed"})
    emb32 = params["embed"].float()
    esc = emb32.abs().amax(dim=1, keepdim=True) / 127.0
    esc = torch.where(esc == 0.0, torch.ones_like(esc), esc)
    out["embed_q"] = torch.clamp(torch.round(emb32 / esc), -127, 127).to(torch.int8)
    out["embed_scale"] = esc
    return out


def _t5_rel_buckets(rel_pos: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional relative position buckets (HF T5 semantics) of an
    integer array, on the host.  The large-distance branch truncates
    ``log(n / max_exact + 1e-6) / log(max_distance / max_exact) *
    (num_buckets - max_exact)`` toward zero; at n = 16, 32 and 64 that value
    lies within a few fp32 ulps of an integer, so it is taken in float64
    (exact there: the table equals the JAX package's fp32 one for every
    |n| < 4096, ``tests/test_torch_text_encoders.py``) and does not depend
    on the machine's fp32 ``log``."""
    rel_pos = np.asarray(rel_pos, np.int64)
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    with np.errstate(divide="ignore"):
        val_large = max_exact + np.trunc(
            np.log(n.astype(np.float64) / max_exact + 1e-6) / np.log(max_distance / max_exact)
            * (num_buckets - max_exact)).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(n < max_exact, n, val_large)


def t5_encode(params, token_ids: torch.Tensor, cfg: T5Config,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S) int token ids -> (B, S, d_model) encoder states.  Takes plain
    and :func:`quantize_t5_int8` trees.  The attention is unscaled (T5 folds
    the scale into its init) and padded keys get a -1e30 bias, as in JAX."""
    b, s = token_ids.shape
    h = cfg.num_heads
    dev = token_ids.device
    if "embed_q" in params:
        x = (params["embed_q"][token_ids].float() * params["embed_scale"][token_ids]).to(cfg.dtype)
    else:
        x = params["embed"][token_ids]
    pos = np.arange(s)
    buckets = torch.from_numpy(_t5_rel_buckets(pos[None, :] - pos[:, None], cfg.rel_buckets,
                                               cfg.rel_max_distance)).to(dev)
    bias = params["rel_bias"][buckets].float().permute(2, 0, 1)[None]  # (1, H, S, S)
    if mask is not None:
        bias = torch.where(mask[:, None, None, :].to(dev), bias, torch.tensor(-1e30, device=dev))

    blocks = params["blocks"]
    for l in range(cm.weight_shape(blocks["q"])[0]):
        p = cm.layer_of(blocks, l)
        xn = cm.rmsnorm(p["ln1"], x)
        q = cm.linear(p["q"], xn).reshape(b, s, h, cfg.d_kv).float()
        k = cm.linear(p["k"], xn).reshape(b, s, h, cfg.d_kv).float()
        v = cm.linear(p["v"], xn).reshape(b, s, h, cfg.d_kv).float()
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        x = x + cm.linear(p["o"], o.reshape(b, s, h * cfg.d_kv).to(x.dtype))
        xn = cm.rmsnorm(p["ln2"], x)
        ff = cm.gelu(cm.linear(p["wi_0"], xn)) * cm.linear(p["wi_1"], xn)
        x = x + cm.linear(p["wo"], ff)
    return cm.rmsnorm(params["final_ln"], x)


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    d_model: int = 768  # CLIP-L; CLIP-G: 1280
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 77
    #: "quick_gelu" (OpenAI CLIP-L) or "gelu" (OpenCLIP bigG / SD3's CLIP-G)
    hidden_act: str = "quick_gelu"
    #: CLIPTextModelWithProjection: project the pooled output to this dim
    #: (no bias); None = the raw pooled hidden state
    projection_dim: Optional[int] = None
    dtype: Any = torch.bfloat16


def clip_l() -> CLIPTextConfig:
    return CLIPTextConfig()


def clip_l_proj() -> CLIPTextConfig:
    """SD3's CLIP-L: CLIPTextModelWithProjection, 768 -> 768."""
    return CLIPTextConfig(projection_dim=768)


def clip_g() -> CLIPTextConfig:
    """SD3's CLIP-G (OpenCLIP bigG): exact-GELU MLP + 1280-dim projection."""
    return CLIPTextConfig(d_model=1280, num_layers=32, num_heads=20, hidden_act="gelu",
                          projection_dim=1280)


def clip_tiny() -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=128, d_model=64, num_layers=2, num_heads=4, max_len=16)


def init_clip(generator: torch.Generator, cfg: CLIPTextConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_clip`` (other random draws)."""
    d, dt, L = cfg.d_model, cfg.dtype, (cfg.num_layers,)
    dev = generator.device

    def lin(i, o):
        return cm.init_linear(generator, i, o, dtype=dt, stack=L)

    blocks = {
        "ln1": cm.init_layernorm(d, dt, dev, L),
        "q": lin(d, d),
        "k": lin(d, d),
        "v": lin(d, d),
        "o": lin(d, d),
        "ln2": cm.init_layernorm(d, dt, dev, L),
        "fc1": lin(d, 4 * d),
        "fc2": lin(4 * d, d),
    }
    tok = torch.randn((cfg.vocab_size, d), generator=generator, dtype=torch.float32, device=dev) * 0.02
    p = {
        "token_embed": tok.to(dt),
        "pos_embed": torch.zeros((cfg.max_len, d), dtype=dt, device=dev),
        "blocks": blocks,
        "final_ln": cm.init_layernorm(d, dt, dev),
    }
    if cfg.projection_dim is not None:
        p["text_proj"] = cm.init_linear(generator, d, cfg.projection_dim, bias=False, dtype=dt)
    return p


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def clip_encode(params, token_ids: torch.Tensor, cfg: CLIPTextConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) -> (hidden (B, S, D), pooled (B, D or projection_dim)), pooled
    at the highest token id (EOS in CLIP's vocabulary; the first one where
    several tie, as ``jnp.argmax``)."""
    b, s = token_ids.shape
    h = cfg.num_heads
    hd = cfg.d_model // h
    dev = token_ids.device
    x = params["token_embed"][token_ids] + params["pos_embed"][None, :s]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
    if cfg.hidden_act == "quick_gelu":
        act = _quick_gelu
    else:
        act = lambda v: torch.nn.functional.gelu(v, approximate="none")  # noqa: E731  (HF "gelu" = erf)
    scale = hd ** -0.5
    blocks = params["blocks"]
    for l in range(cm.weight_shape(blocks["q"])[0]):
        p = cm.layer_of(blocks, l)
        xn = cm.layernorm(p["ln1"], x, eps=1e-5)  # HF CLIP layer_norm_eps
        q = cm.linear(p["q"], xn).reshape(b, s, h, hd).float()
        k = cm.linear(p["k"], xn).reshape(b, s, h, hd).float()
        v = cm.linear(p["v"], xn).reshape(b, s, h, hd).float()
        scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
        scores = torch.where(causal[None, None], scores, torch.tensor(-1e30, device=dev))
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        x = x + cm.linear(p["o"], o.reshape(b, s, cfg.d_model).to(x.dtype))
        xn = cm.layernorm(p["ln2"], x, eps=1e-5)
        x = x + cm.linear(p["fc2"], act(cm.linear(p["fc1"], xn)))
    x = cm.layernorm(params["final_ln"], x, eps=1e-5)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    eos = torch.argmax(token_ids, dim=-1)
    pooled = x[torch.arange(b, device=dev), eos]
    if "text_proj" in params:
        pooled = cm.linear(params["text_proj"], pooled)
    return x, pooled
