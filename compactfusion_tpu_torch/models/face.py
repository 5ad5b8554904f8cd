"""ConsisID face encoder, ``local_facial_extractor``
(counterpart of ``compactfusion_tpu/models/face.py``).

The perceiver resampler that the diffusers ``ConsisIDTransformer3DModel``
runs over the face features once per generation, outside the denoise loop:

  * ``id_cond`` (B, id_dim=1280): the ArcFace global embedding with the
    CLIP-visual class embedding;
  * ``id_vit_hidden``: ``num_scale`` (5) intermediate CLIP-ViT hidden-state
    maps, each (B, S_vit, vit_dim=1024).

Output: (B, num_queries=32, output_dim=2048) identity tokens.  Learned
latent queries are joined by ``num_id_token`` tokens mapped from
``id_cond``; for each ViT scale the mapped features (with the id tokens)
are the context of ``depth / num_scale`` (attention, ffn) layers.  The
perceiver attention appends the latents to its K/V and scales q and k each
by ``dim_head ** -0.25`` before an fp32 softmax.

The image stand-in (the ``--img_file_path`` path without ArcFace or CLIP
weights): deterministic, image-dependent features from the decoded pixels
through seeded numpy projections (``default_rng`` seeds 101, 200 + i and
303, as in the JAX package), so that the same decoded image array gives
the same identity tokens bit for bit.  The image is read by the port's own
PNG reader and resized by ``utils/image.resize_uint8``, PIL's bicubic
resampler; ``tests/test_torch_face.py`` holds it against PIL.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class LFEConfig:
    id_dim: int = 1280
    vit_dim: int = 1024
    depth: int = 10
    dim_head: int = 64
    heads: int = 16
    num_id_token: int = 5
    num_queries: int = 32
    output_dim: int = 2048
    ff_mult: int = 4
    num_scale: int = 5
    dtype: Any = torch.float32

    @property
    def inner_dim(self):
        return self.dim_head * self.heads

    @property
    def depth_per_scale(self):
        assert self.depth % self.num_scale == 0
        return self.depth // self.num_scale


def lfe_consisid() -> LFEConfig:
    """The published ConsisID-preview face encoder."""
    return LFEConfig()


def lfe_tiny() -> LFEConfig:
    return LFEConfig(id_dim=24, vit_dim=16, depth=10, dim_head=4, heads=4, num_id_token=3, num_queries=6,
                     output_dim=20, ff_mult=2)


def _init_mlp3(generator, d_in, d_mid, d_out, dt):
    """Linear -> LN -> LeakyReLU -> Linear -> LN -> LeakyReLU -> Linear."""
    dev = generator.device
    return {"fc1": cm.init_linear(generator, d_in, d_mid, dtype=dt), "ln1": cm.init_layernorm(d_mid, dt, dev),
            "fc2": cm.init_linear(generator, d_mid, d_mid, dtype=dt), "ln2": cm.init_layernorm(d_mid, dt, dev),
            "fc3": cm.init_linear(generator, d_mid, d_out, dtype=dt)}


def init_lfe(generator: torch.Generator, cfg: LFEConfig):
    """Random init on the generator's device: the tree of the JAX
    ``init_lfe`` (other draws)."""
    dt, dev = cfg.dtype, generator.device
    v, inner = cfg.vit_dim, cfg.inner_dim
    scale = v**-0.5
    layers = [{
        "attn": {"norm1": cm.init_layernorm(v, dt, dev), "norm2": cm.init_layernorm(v, dt, dev),
                 "q": cm.init_linear(generator, v, inner, bias=False, dtype=dt),
                 "kv": cm.init_linear(generator, v, 2 * inner, bias=False, dtype=dt),
                 "out": cm.init_linear(generator, inner, v, bias=False, dtype=dt)},
        "ffn": {"ln": cm.init_layernorm(v, dt, dev),
                "fc1": cm.init_linear(generator, v, cfg.ff_mult * v, bias=False, dtype=dt),
                "fc2": cm.init_linear(generator, cfg.ff_mult * v, v, bias=False, dtype=dt)},
    } for _ in range(cfg.depth)]

    def randn(*shape):
        return (scale * torch.randn(shape, generator=generator, device=dev)).to(dt)

    return {
        "latents": randn(1, cfg.num_queries, v),
        "proj_out": randn(v, cfg.output_dim),
        "id_mapping": _init_mlp3(generator, cfg.id_dim, v, v * cfg.num_id_token, dt),
        "mappings": [_init_mlp3(generator, v, v, v, dt) for _ in range(cfg.num_scale)],
        "layers": layers,
    }


def _leaky(x, slope: float = 0.01):
    return torch.where(x >= 0, x, slope * x)


def _mlp3(p, x):
    x = _leaky(cm.layernorm(p["ln1"], cm.linear(p["fc1"], x), eps=1e-5))
    x = _leaky(cm.layernorm(p["ln2"], cm.linear(p["fc2"], x), eps=1e-5))
    return cm.linear(p["fc3"], x)


def _perceiver_attn(p, ctx, latents, cfg: LFEConfig):
    """The latents query [ctx; latents]; q and k each scaled by
    dim_head ** -0.25, the softmax in fp32 (diffusers ``PerceiverAttention``)."""
    b, s, _ = latents.shape
    h, dh = cfg.heads, cfg.dim_head
    x = cm.layernorm(p["norm1"], ctx, eps=1e-5)
    lat = cm.layernorm(p["norm2"], latents, eps=1e-5)
    q = cm.linear(p["q"], lat).reshape(b, s, h, dh)
    k, v = cm.linear(p["kv"], torch.cat([x, lat], dim=1)).chunk(2, dim=-1)
    k, v = k.reshape(b, -1, h, dh), v.reshape(b, -1, h, dh)
    scale = dh**-0.25
    w = torch.einsum("bqhd,bkhd->bhqk", q * scale, k * scale)
    w = torch.softmax(w.float(), dim=-1).to(w.dtype)
    return cm.linear(p["out"], torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, h * dh))


def _lfe_ffn(p, x):
    xn = cm.layernorm(p["ln"], x, eps=1e-5)
    return cm.linear(p["fc2"], F.gelu(cm.linear(p["fc1"], xn)))


def lfe_forward(params, id_cond: torch.Tensor, id_vit_hidden: Sequence[torch.Tensor], cfg: LFEConfig) -> torch.Tensor:
    """(B, id_dim) + num_scale x (B, S_vit, vit_dim) -> (B, nq, output_dim)."""
    assert len(id_vit_hidden) == cfg.num_scale
    b = id_cond.shape[0]
    lat = params["latents"].expand((b,) + tuple(params["latents"].shape[1:]))
    id_tok = _mlp3(params["id_mapping"], id_cond).reshape(b, cfg.num_id_token, cfg.vit_dim)
    lat = torch.cat([lat, id_tok], dim=1)
    dps = cfg.depth_per_scale
    for i in range(cfg.num_scale):
        ctx = torch.cat([id_tok, _mlp3(params["mappings"][i], id_vit_hidden[i])], dim=1)
        for layer in params["layers"][i * dps:(i + 1) * dps]:
            lat = _perceiver_attn(layer["attn"], ctx, lat, cfg) + lat
            lat = _lfe_ffn(layer["ffn"], lat) + lat
    return lat[:, :cfg.num_queries] @ params["proj_out"]


# ---------------------------------------------------------------------------
# the image stand-in (module note)
# ---------------------------------------------------------------------------


def _load_image(path: str, size: int = 224) -> np.ndarray:
    """An image file -> (size, size, 3) float32 in [-1, 1]: RGB, resized
    as PIL's ``Image.resize`` resizes it."""
    from compactfusion_tpu_torch.utils.image import load_png, resize_uint8

    return resize_uint8(load_png(path), size, size).astype(np.float32) / 127.5 - 1.0


def _seeded_proj(d_in: int, d_out: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((d_in, d_out), dtype=np.float32) / np.sqrt(np.float32(d_in))


def image_face_features(path: str, cfg: LFEConfig, device="cpu"):
    """Image file -> (id_cond (1, id_dim), [id_vit_hidden (1, 576, vit_dim)]
    x num_scale), fp32 tensors on ``device`` (the stand-in for ArcFace +
    CLIP-ViT): a 24 x 24 patch grid (the CLIP ViT-L/14@336 geometry) of the
    224 x 224 image projected by one seeded matrix per scale, and a global
    projection of a 32 x 32 copy."""
    img, small = _load_image(path), _load_image(path, size=32)
    id_cond = small.reshape(1, -1) @ _seeded_proj(32 * 32 * 3, cfg.id_dim, seed=101)
    grid = 24
    p = img.shape[0] // grid
    patches = img[:grid * p, :grid * p].reshape(grid, p, grid, p, 3).transpose(0, 2, 1, 3, 4).reshape(
        grid * grid, p * p * 3)
    hidden = [(patches @ _seeded_proj(p * p * 3, cfg.vit_dim, seed=200 + i))[None] for i in range(cfg.num_scale)]
    return torch.from_numpy(id_cond).to(device), [torch.from_numpy(h).to(device) for h in hidden]


def image_to_id_states(path: str, id_tokens: int, id_dim: int, device="cpu") -> torch.Tensor:
    """Image file -> (1, id_tokens, id_dim) fp32 identity tokens on
    ``device`` through the seed-303 projection of a 32 x 32 copy, for
    pipelines built without face-encoder weights."""
    small = _load_image(path, size=32)
    out = small.reshape(1, -1) @ _seeded_proj(32 * 32 * 3, id_tokens * id_dim, seed=303)
    return torch.from_numpy(out.reshape(1, id_tokens, id_dim)).to(device)
