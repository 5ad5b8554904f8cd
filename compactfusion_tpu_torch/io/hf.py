"""HuggingFace (diffusers, transformers) checkpoints -> the port's
parameter trees (counterpart of part of ``compactfusion_tpu/io/hf.py``).

:func:`load_safetensors` reads ``.safetensors`` files itself (an 8-byte
little-endian header length, a JSON header, then the raw tensors), and
:func:`save_safetensors` writes them, so no ``safetensors`` package is
needed; bf16 tensors come back as exact fp32.
The state dict maps names to numpy arrays in torch layouts; the converters
return the trees ``init_*`` builds, in torch tensors of ``cfg.dtype`` on the
CPU:

  * a torch ``nn.Linear`` stores (out, in): transposed to (in, out);
  * conv kernels (out, in, kh, kw) are transposed to HWIO;
  * PixArt's patch-embed conv becomes a linear over raster-ordered (kh, kw,
    c) patch vectors (``models/common.patchify``);
  * separate to_q/to_k/to_v projections are fused into one qkv matrix;
  * per-layer tensors are stacked on a leading layer axis;
  * the q and k columns of FLUX's and CogVideoX's qkv and their qk-norm
    affines are permuted per head from the checkpoint's interleaved rope
    layout to the rotate-half layout the model runs
    (``models/common.apply_rope_half``);
  * 3D conv kernels (out, in, kt, kh, kw) are transposed to (kt, kh, kw,
    in, out); a 2D kernel loads with kt = 1;
  * Step-Video's per-head packed projections keep their head axis: (d, n,
    H, hd) in, (H, hd, d) out.

Converters: T5, CLIP, PixArt, FLUX, SD3, HunyuanDiT, CogVideoX, Latte,
HunyuanVideo, ConsisID and its face encoder, Step-Video, the AutoencoderKL
decoder and
the CogVideoX and HunyuanVideo causal 3D VAE decoders.  This module imports
numpy and torch, not JAX.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict

import numpy as np
import torch

from compactfusion_tpu_torch.models.common import rope_half_perm


_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
              "U16": np.uint16, "U32": np.uint32, "U64": np.uint64}


def _load_safetensors_file(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    state = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw, shape = data[begin:end], tuple(info["shape"])
        if info["dtype"] == "BF16":
            # the bf16 bits are the top half of the fp32 ones
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = np.frombuffer(raw, np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which is not read")
        state[name] = np.array(arr.reshape(shape), copy=True)
    return state


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One ``.safetensors`` file, or every ``*.safetensors`` shard of a
    directory in name order, as a dict of numpy arrays (bf16 as fp32)."""
    if os.path.isdir(path):
        state: Dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(path)):
            if name.endswith(".safetensors"):
                state.update(_load_safetensors_file(os.path.join(path, name)))
        return state
    return _load_safetensors_file(path)


def save_safetensors(state: Dict[str, Any], path: str) -> None:
    """Write ``state`` (name -> numpy array or CPU torch tensor; torch bf16
    as BF16) as one ``.safetensors`` file, in the layout
    :func:`load_safetensors` reads: the header's JSON (padded with spaces to
    a multiple of 8 bytes), then every tensor's little-endian bytes in name
    order, back to back."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(state):
        t = state[name]
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            code, arr = "BF16", t.detach().cpu().contiguous().view(torch.int16).numpy().astype("<i2")
        else:
            arr = np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)
            if arr.dtype.type not in names:
                raise ValueError(f"save_safetensors: tensor {name!r} has dtype {arr.dtype}, which is not written")
            code, arr = names[arr.dtype.type], arr.astype(arr.dtype.newbyteorder("<"), order="C", copy=False)
        blob = arr.tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape), "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def _tensor(a: np.ndarray, dtype) -> torch.Tensor:
    """A numpy array -> a torch tensor of ``dtype`` (round to nearest even)."""
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dtype)


def _lin(state, name, dtype):
    """torch Linear -> {w (in, out), b?}."""
    p = {"w": _tensor(state[f"{name}.weight"].T, dtype)}
    if f"{name}.bias" in state:
        p["b"] = _tensor(state[f"{name}.bias"], dtype)
    return p


def _lin_nobias(state, name, dtype):
    return {"w": _tensor(state[f"{name}.weight"].T, dtype)}


def _fused_kv(state, k, v, dtype):
    p = {"w": _tensor(np.concatenate([state[f"{k}.weight"].T, state[f"{v}.weight"].T], axis=1), dtype)}
    if f"{k}.bias" in state:
        p["b"] = _tensor(np.concatenate([state[f"{k}.bias"], state[f"{v}.bias"]]), dtype)
    return p


def _conv(state, name, dtype):
    """torch conv (O, I, kh, kw) -> {w (kh, kw, I, O), b}."""
    return {"w": _tensor(state[f"{name}.weight"].transpose(2, 3, 1, 0), dtype),
            "b": _tensor(state[f"{name}.bias"], dtype)}


def _patch_conv_as_linear(state, name, dtype):
    """Patch-embed conv (D, C, p, p) -> a linear over (p, p, C) raster patches."""
    w = state[f"{name}.weight"]
    d, c, p, _ = w.shape
    return {"w": _tensor(w.transpose(2, 3, 1, 0).reshape(p * p * c, d), dtype),
            "b": _tensor(state[f"{name}.bias"], dtype)}


def _norm(state, name, dtype):
    return {"g": _tensor(state[f"{name}.weight"], dtype), "b": _tensor(state[f"{name}.bias"], dtype)}


def _fused_qkv(state, q, k, v, dtype):
    w = np.concatenate([state[f"{q}.weight"].T, state[f"{k}.weight"].T, state[f"{v}.weight"].T], axis=1)
    p = {"w": _tensor(w, dtype)}
    if f"{q}.bias" in state:
        p["b"] = _tensor(np.concatenate([state[f"{q}.bias"], state[f"{k}.bias"], state[f"{v}.bias"]]), dtype)
    return p


def _half_rope_qkv(p, heads):
    """Permute the q and k output columns of a fused qkv linear, per head,
    from the interleaved-pair rope layout to the rotate-half one (new[j] =
    old[2j], new[D/2 + j] = old[2j + 1]).  Attention scores do not change
    under a head-dim permutation of both q and k."""
    dh = p["w"].shape[-1] // 3 // heads
    perm = torch.from_numpy(rope_half_perm(dh))

    def pq(a):
        ar = a.reshape(*a.shape[:-1], 3, heads, dh)
        qk = ar[..., :2, :, :][..., perm]
        return torch.cat([qk, ar[..., 2:, :, :]], dim=-3).reshape(a.shape)

    return {k: pq(v) for k, v in p.items()}


def _half_rope_rms(p):
    """The matching permutation of a per-head-dim qk-norm gain (rmsnorm's
    mean square does not depend on the order)."""
    return {"g": p["g"][..., torch.from_numpy(rope_half_perm(p["g"].shape[-1]))]}


def _half_rope_norm(p):
    """Same for an affine LayerNorm qk-norm (the CogVideoX family): its mean
    and variance over the head dim do not depend on the order; gain and
    bias relabel."""
    perm = torch.from_numpy(rope_half_perm(p["g"].shape[-1]))
    return {"g": p["g"][..., perm], "b": p["b"][..., perm]}


def _rms(state, name, dtype):
    return {"g": _tensor(state[f"{name}.weight"], dtype)}


def _stack(trees):
    """A list of equal trees -> one tree with a leading layer axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _embedder(state, prefix, dtype):
    return {"fc1": _lin(state, f"{prefix}.linear_1", dtype), "fc2": _lin(state, f"{prefix}.linear_2", dtype)}


def convert_flux(state: Dict[str, np.ndarray], cfg) -> Any:
    """diffusers ``FluxTransformer2DModel`` names -> ``models/flux.init_flux``'s tree."""
    dt = cfg.dtype
    doubles = []
    for i in range(cfg.double_layers):
        p = f"transformer_blocks.{i}"
        doubles.append({
            "img_mod": _lin(state, f"{p}.norm1.linear", dt),
            "txt_mod": _lin(state, f"{p}.norm1_context.linear", dt),
            "img_qkv": _half_rope_qkv(_fused_qkv(state, f"{p}.attn.to_q", f"{p}.attn.to_k",
                                                 f"{p}.attn.to_v", dt), cfg.heads),
            "txt_qkv": _half_rope_qkv(_fused_qkv(state, f"{p}.attn.add_q_proj", f"{p}.attn.add_k_proj",
                                                 f"{p}.attn.add_v_proj", dt), cfg.heads),
            "img_q_norm": _half_rope_rms(_rms(state, f"{p}.attn.norm_q", dt)),
            "img_k_norm": _half_rope_rms(_rms(state, f"{p}.attn.norm_k", dt)),
            "txt_q_norm": _half_rope_rms(_rms(state, f"{p}.attn.norm_added_q", dt)),
            "txt_k_norm": _half_rope_rms(_rms(state, f"{p}.attn.norm_added_k", dt)),
            "img_out": _lin(state, f"{p}.attn.to_out.0", dt),
            "txt_out": _lin(state, f"{p}.attn.to_add_out", dt),
            "img_ffn": {"fc1": _lin(state, f"{p}.ff.net.0.proj", dt), "fc2": _lin(state, f"{p}.ff.net.2", dt)},
            "txt_ffn": {"fc1": _lin(state, f"{p}.ff_context.net.0.proj", dt),
                        "fc2": _lin(state, f"{p}.ff_context.net.2", dt)},
        })
    singles = []
    for i in range(cfg.single_layers):
        p = f"single_transformer_blocks.{i}"
        proj_out = state[f"{p}.proj_out.weight"].T  # (dim + mlp, dim)
        singles.append({
            "mod": _lin(state, f"{p}.norm.linear", dt),
            "qkv": _half_rope_qkv(_fused_qkv(state, f"{p}.attn.to_q", f"{p}.attn.to_k",
                                             f"{p}.attn.to_v", dt), cfg.heads),
            "q_norm": _half_rope_rms(_rms(state, f"{p}.attn.norm_q", dt)),
            "k_norm": _half_rope_rms(_rms(state, f"{p}.attn.norm_k", dt)),
            # proj_out's rows [dim:] act on the gelu(mlp) half
            "mlp": {"fc1": _lin(state, f"{p}.proj_mlp", dt), "fc2": {"w": _tensor(proj_out[cfg.dim:], dt)}},
            # its rows [:dim] act on the attention half, which carries the bias
            "out_attn": {"w": _tensor(proj_out[: cfg.dim], dt), "b": _tensor(state[f"{p}.proj_out.bias"], dt)},
        })
    params = {
        "x_embedder": _lin(state, "x_embedder", dt),
        "context_embedder": _lin(state, "context_embedder", dt),
        "t_embed": _embedder(state, "time_text_embed.timestep_embedder", dt),
        "pooled_embed": _embedder(state, "time_text_embed.text_embedder", dt),
        "double_blocks": _stack(doubles),
        "single_blocks": _stack(singles),
        "norm_out_mod": _lin(state, "norm_out.linear", dt),
        "proj_out": _lin(state, "proj_out", dt),
    }
    if cfg.guidance_embeds:
        params["guidance_embed"] = _embedder(state, "time_text_embed.guidance_embedder", dt)
    return params


def convert_t5(state: Dict[str, np.ndarray], cfg) -> Any:
    """``google/t5-v1_1-xxl`` encoder names -> ``models/text_encoders.init_t5``'s tree."""
    dt = cfg.dtype
    blocks = []
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}"
        blocks.append({
            "ln1": _rms(state, f"{p}.layer.0.layer_norm", dt),
            "q": _lin_nobias(state, f"{p}.layer.0.SelfAttention.q", dt),
            "k": _lin_nobias(state, f"{p}.layer.0.SelfAttention.k", dt),
            "v": _lin_nobias(state, f"{p}.layer.0.SelfAttention.v", dt),
            "o": _lin_nobias(state, f"{p}.layer.0.SelfAttention.o", dt),
            "ln2": _rms(state, f"{p}.layer.1.layer_norm", dt),
            "wi_0": _lin_nobias(state, f"{p}.layer.1.DenseReluDense.wi_0", dt),
            "wi_1": _lin_nobias(state, f"{p}.layer.1.DenseReluDense.wi_1", dt),
            "wo": _lin_nobias(state, f"{p}.layer.1.DenseReluDense.wo", dt),
        })
    return {
        "embed": _tensor(state["shared.weight"], dt),
        "rel_bias": _tensor(state["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"], dt),
        "blocks": _stack(blocks),
        "final_ln": _rms(state, "encoder.final_layer_norm", dt),
    }


def convert_clip(state: Dict[str, np.ndarray], cfg) -> Any:
    """``openai/clip-vit-large-patch14`` text names -> ``init_clip``'s tree
    (with ``text_proj`` where the checkpoint has ``text_projection``)."""
    dt = cfg.dtype
    tm = "text_model"
    blocks = []
    for i in range(cfg.num_layers):
        p = f"{tm}.encoder.layers.{i}"
        blocks.append({
            "ln1": _norm(state, f"{p}.layer_norm1", dt),
            "q": _lin(state, f"{p}.self_attn.q_proj", dt),
            "k": _lin(state, f"{p}.self_attn.k_proj", dt),
            "v": _lin(state, f"{p}.self_attn.v_proj", dt),
            "o": _lin(state, f"{p}.self_attn.out_proj", dt),
            "ln2": _norm(state, f"{p}.layer_norm2", dt),
            "fc1": _lin(state, f"{p}.mlp.fc1", dt),
            "fc2": _lin(state, f"{p}.mlp.fc2", dt),
        })
    params = {
        "token_embed": _tensor(state[f"{tm}.embeddings.token_embedding.weight"], dt),
        "pos_embed": _tensor(state[f"{tm}.embeddings.position_embedding.weight"], dt),
        "blocks": _stack(blocks),
        "final_ln": _norm(state, f"{tm}.final_layer_norm", dt),
    }
    if "text_projection.weight" in state:
        params["text_proj"] = {"w": _tensor(state["text_projection.weight"].T, dt)}
    return params


def convert_pixart(state: Dict[str, np.ndarray], cfg) -> Any:
    """diffusers ``PixArtTransformer2DModel`` names -> ``models/pixart.init_pixart``'s tree."""
    dt = cfg.dtype
    blocks = []
    for i in range(cfg.depth):
        p = f"transformer_blocks.{i}"
        blocks.append({
            "scale_shift_table": _tensor(state[f"{p}.scale_shift_table"], dt),
            "attn_qkv": _fused_qkv(state, f"{p}.attn1.to_q", f"{p}.attn1.to_k", f"{p}.attn1.to_v", dt),
            "attn_out": _lin(state, f"{p}.attn1.to_out.0", dt),
            "cross_q": _lin(state, f"{p}.attn2.to_q", dt),
            "cross_kv": _fused_kv(state, f"{p}.attn2.to_k", f"{p}.attn2.to_v", dt),
            "cross_out": _lin(state, f"{p}.attn2.to_out.0", dt),
            "ffn": {"fc1": _lin(state, f"{p}.ff.net.0.proj", dt), "fc2": _lin(state, f"{p}.ff.net.2", dt)},
        })
    return {
        "patch_embed": _patch_conv_as_linear(state, "pos_embed.proj", dt),
        "t_embed": _embedder(state, "adaln_single.emb.timestep_embedder", dt),
        "adaln_single": _lin(state, "adaln_single.linear", dt),
        "caption_fc1": _lin(state, "caption_projection.linear_1", dt),
        "caption_fc2": _lin(state, "caption_projection.linear_2", dt),
        "blocks": _stack(blocks),
        "final_scale_shift": _tensor(state["scale_shift_table"], dt),
        "proj_out": _lin(state, "proj_out", dt),
    }


def convert_vae_decoder(state: Dict[str, np.ndarray], cfg) -> Any:
    """diffusers ``AutoencoderKL`` decoder names -> ``models/vae.init_vae_decoder``'s tree."""
    dt = cfg.dtype

    def resnet(p):
        out = {"norm1": _norm(state, f"{p}.norm1", dt), "conv1": _conv(state, f"{p}.conv1", dt),
               "norm2": _norm(state, f"{p}.norm2", dt), "conv2": _conv(state, f"{p}.conv2", dt)}
        if f"{p}.conv_shortcut.weight" in state:
            out["shortcut"] = _conv(state, f"{p}.conv_shortcut", dt)
        return out

    mid = "decoder.mid_block"
    params = {
        "post_quant_conv": _conv(state, "post_quant_conv", dt),
        "conv_in": _conv(state, "decoder.conv_in", dt),
        "mid_res1": resnet(f"{mid}.resnets.0"),
        "mid_attn": {
            "norm": _norm(state, f"{mid}.attentions.0.group_norm", dt),
            "q": _lin(state, f"{mid}.attentions.0.to_q", dt),
            "k": _lin(state, f"{mid}.attentions.0.to_k", dt),
            "v": _lin(state, f"{mid}.attentions.0.to_v", dt),
            "out": _lin(state, f"{mid}.attentions.0.to_out.0", dt),
        },
        "mid_res2": resnet(f"{mid}.resnets.1"),
        "norm_out": _norm(state, "decoder.conv_norm_out", dt),
        "conv_out": _conv(state, "decoder.conv_out", dt),
    }
    up = []
    for i in range(len(cfg.block_out_channels)):
        p = f"decoder.up_blocks.{i}"
        blk = {"resnets": [resnet(f"{p}.resnets.{j}") for j in range(cfg.layers_per_block + 1)]}
        if f"{p}.upsamplers.0.conv.weight" in state:
            blk["upsample_conv"] = _conv(state, f"{p}.upsamplers.0.conv", dt)
        up.append(blk)
    params["up"] = up
    return params


# ---------------------------------------------------------------------------
# CogVideoX (diffusers CogVideoXTransformer3DModel naming)
# ---------------------------------------------------------------------------


def convert_cogvideox(state: Dict[str, np.ndarray], cfg) -> Any:
    """diffusers ``CogVideoXTransformer3DModel`` names -> ``models/cogvideox.
    init_cogvideox``'s tree (2B, 5B and 1.5-5B)."""
    dt = cfg.dtype
    blocks = []
    for i in range(cfg.depth):
        p = f"transformer_blocks.{i}"
        blocks.append({
            "mod_attn": _lin(state, f"{p}.norm1.linear", dt),
            "norm1": _norm(state, f"{p}.norm1.norm", dt),
            "mod_ff": _lin(state, f"{p}.norm2.linear", dt),
            "norm2": _norm(state, f"{p}.norm2.norm", dt),
            "qkv": _half_rope_qkv(_fused_qkv(state, f"{p}.attn1.to_q", f"{p}.attn1.to_k", f"{p}.attn1.to_v", dt),
                                  cfg.heads),
            "q_norm": _half_rope_norm(_norm(state, f"{p}.attn1.norm_q", dt)),
            "k_norm": _half_rope_norm(_norm(state, f"{p}.attn1.norm_k", dt)),
            "attn_out": _lin(state, f"{p}.attn1.to_out.0", dt),
            "ffn": {"fc1": _lin(state, f"{p}.ff.net.0.proj", dt), "fc2": _lin(state, f"{p}.ff.net.2", dt)},
        })
    if cfg.patch_t > 1:
        # CogVideoX 1.5: patch_embed.proj is a linear over (p_t, p, p, C)-packed
        # tokens, the packing this model uses; proj_out's output features are
        # (C, p_t, p, p)-ordered in the checkpoint, ours (p_t, p, p, C)
        patch_embed = _lin(state, "patch_embed.proj", dt)
        c, p_t, pp = cfg.out_channels, cfg.patch_t, cfg.patch
        w = np.asarray(state["proj_out.weight"]).reshape(c, p_t, pp, pp, -1).transpose(1, 2, 3, 0, 4)
        b = np.asarray(state["proj_out.bias"]).reshape(c, p_t, pp, pp).transpose(1, 2, 3, 0).reshape(-1)
        proj_out = {"w": _tensor(w.reshape(-1, w.shape[-1]).T, dt), "b": _tensor(b, dt)}
    else:
        patch_embed = _patch_conv_as_linear(state, "patch_embed.proj", dt)
        proj_out = _lin(state, "proj_out", dt)
    out = {
        "patch_embed": patch_embed,
        "text_proj": _lin(state, "patch_embed.text_proj", dt),
        "t_embed": _embedder(state, "time_embedding", dt),
        "blocks": _stack(blocks),
        "norm_final": _norm(state, "norm_final", dt),
        "norm_out_mod": _lin(state, "norm_out.linear", dt),
        "norm_out_norm": _norm(state, "norm_out.norm", dt),
        "proj_out": proj_out,
    }
    if cfg.patch_t > 1:
        out["ofs_embed"] = _embedder(state, "ofs_embedding", dt)  # the ofs branch (constant 2.0)
    return out


# ---------------------------------------------------------------------------
# the CogVideoX causal 3D VAE decoder (diffusers AutoencoderKLCogVideoX naming)
# ---------------------------------------------------------------------------


def _conv3(state, name, dtype):
    """torch Conv3d (O, I, T, H, W) -> {w (T, H, W, I, O), b}; a 4D Conv2d
    weight (the upsampler's per-frame conv) loads with T = 1."""
    w = state[f"{name}.weight"]
    if w.ndim == 4:
        w = w[:, :, None]
    return {"w": _tensor(np.transpose(w, (2, 3, 4, 1, 0)), dtype), "b": _tensor(state[f"{name}.bias"], dtype)}


def convert_vae3d_decoder(state: Dict[str, np.ndarray], cfg) -> Any:
    """CogVideoX causal 3D VAE decoder -> ``models/vae3d.init_vae3d_decoder``'s tree."""
    dt = cfg.dtype

    def spatial_norm(p):
        return {"norm": _norm(state, f"{p}.norm_layer", dt), "conv_y": _conv3(state, f"{p}.conv_y", dt),
                "conv_b": _conv3(state, f"{p}.conv_b", dt)}

    def resnet(p):
        out = {"norm1": spatial_norm(f"{p}.norm1"), "conv1": _conv3(state, f"{p}.conv1.conv", dt),
               "norm2": spatial_norm(f"{p}.norm2"), "conv2": _conv3(state, f"{p}.conv2.conv", dt)}
        if f"{p}.conv_shortcut.weight" in state:
            out["shortcut"] = _conv3(state, f"{p}.conv_shortcut", dt)
        return out

    mid = "decoder.mid_block"
    params = {
        "conv_in": _conv3(state, "decoder.conv_in.conv", dt),
        "mid_res1": resnet(f"{mid}.resnets.0"),
        "mid_res2": resnet(f"{mid}.resnets.1"),
        "norm_out": spatial_norm("decoder.norm_out"),
        "conv_out": _conv3(state, "decoder.conv_out.conv", dt),
    }
    up = []
    for i in range(len(cfg.block_out_channels)):
        p = f"decoder.up_blocks.{i}"
        blk = {"resnets": [resnet(f"{p}.resnets.{j}") for j in range(cfg.layers_per_block + 1)]}
        if f"{p}.upsamplers.0.conv.weight" in state:
            blk["upsample_conv"] = _conv3(state, f"{p}.upsamplers.0.conv", dt)
        up.append(blk)
    params["up"] = up
    return params


def convert_sd3(state: Dict[str, np.ndarray], cfg) -> Any:
    """diffusers ``SD3Transformer2DModel`` names -> ``models/sd3.init_sd3``'s tree.

    The last block is ``context_pre_only``: its ``norm1_context`` is
    AdaLN-Continuous, a (d -> 2d) linear giving [scale, shift], laid out
    here as AdaLN-Zero's 6d [shift, scale, gate 0, 0, 0, 0], so the
    symmetric block reproduces the continuous norm with the text updates
    gated off; its missing text out-projection and text ffn are zeros."""
    dt, d = cfg.dtype, cfg.dim
    blocks = []
    for i in range(cfg.depth):
        p = f"transformer_blocks.{i}"
        w_ctx = np.asarray(state[f"{p}.norm1_context.linear.weight"]).T
        b_ctx = np.asarray(state[f"{p}.norm1_context.linear.bias"])
        if w_ctx.shape[1] == 2 * d:
            txt_mod = {"w": _tensor(np.concatenate([w_ctx[:, d:], w_ctx[:, :d], np.zeros((d, 4 * d), w_ctx.dtype)],
                                                   axis=1), dt),
                       "b": _tensor(np.concatenate([b_ctx[d:], b_ctx[:d], np.zeros(4 * d, b_ctx.dtype)]), dt)}
        else:
            txt_mod = _lin(state, f"{p}.norm1_context.linear", dt)
        blk = {
            "img_mod": _lin(state, f"{p}.norm1.linear", dt),
            "txt_mod": txt_mod,
            "img_qkv": _fused_qkv(state, f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v", dt),
            "txt_qkv": _fused_qkv(state, f"{p}.attn.add_q_proj", f"{p}.attn.add_k_proj", f"{p}.attn.add_v_proj", dt),
            "img_out": _lin(state, f"{p}.attn.to_out.0", dt),
            "img_ffn": {"fc1": _lin(state, f"{p}.ff.net.0.proj", dt), "fc2": _lin(state, f"{p}.ff.net.2", dt)},
        }
        if f"{p}.attn.to_add_out.weight" in state:
            blk["txt_out"] = _lin(state, f"{p}.attn.to_add_out", dt)
            blk["txt_ffn"] = {"fc1": _lin(state, f"{p}.ff_context.net.0.proj", dt),
                              "fc2": _lin(state, f"{p}.ff_context.net.2", dt)}
        else:
            def zeros(n_in, n_out):
                return {"w": torch.zeros((n_in, n_out), dtype=dt), "b": torch.zeros((n_out,), dtype=dt)}

            blk["txt_out"] = zeros(d, d)
            blk["txt_ffn"] = {"fc1": zeros(d, cfg.mlp_ratio * d), "fc2": zeros(cfg.mlp_ratio * d, d)}
        if cfg.qk_norm:
            blk["img_q_norm"] = _rms(state, f"{p}.attn.norm_q", dt)
            blk["img_k_norm"] = _rms(state, f"{p}.attn.norm_k", dt)
            blk["txt_q_norm"] = _rms(state, f"{p}.attn.norm_added_q", dt)
            blk["txt_k_norm"] = _rms(state, f"{p}.attn.norm_added_k", dt)
        blocks.append(blk)
    return {
        "patch_embed": _patch_conv_as_linear(state, "pos_embed.proj", dt),
        "context_embedder": _lin(state, "context_embedder", dt),
        "t_embed": _embedder(state, "time_text_embed.timestep_embedder", dt),
        "pooled_embed": _embedder(state, "time_text_embed.text_embedder", dt),
        "blocks": _stack(blocks),
        "norm_out_mod": _lin(state, "norm_out.linear", dt),
        "proj_out": _lin(state, "proj_out", dt),
    }


def convert_hunyuandit(state: Dict[str, np.ndarray], cfg) -> Any:
    """diffusers ``HunyuanDiT2DModel`` names (v1.2: no style or size
    conditioning) -> ``models/hunyuandit.init_hunyuandit``'s tree.  The
    checkpoint has skip weights for blocks past depth/2 only: the first up
    block (up slot 0) gets zeros, never read by the forward."""
    dt = cfg.dtype

    def block(i, with_skip):
        p = f"blocks.{i}"
        out = {
            "mod_shift": _lin(state, f"{p}.norm1.linear", dt),
            "norm1": _norm(state, f"{p}.norm1.norm", dt),
            "attn_qkv": _fused_qkv(state, f"{p}.attn1.to_q", f"{p}.attn1.to_k", f"{p}.attn1.to_v", dt),
            "q_norm": _norm(state, f"{p}.attn1.norm_q", dt),
            "k_norm": _norm(state, f"{p}.attn1.norm_k", dt),
            "attn_out": _lin(state, f"{p}.attn1.to_out.0", dt),
            "norm2": _norm(state, f"{p}.norm2", dt),
            "cross_q": _lin(state, f"{p}.attn2.to_q", dt),
            "cross_kv": _fused_kv(state, f"{p}.attn2.to_k", f"{p}.attn2.to_v", dt),
            "cross_q_norm": _norm(state, f"{p}.attn2.norm_q", dt),
            "cross_k_norm": _norm(state, f"{p}.attn2.norm_k", dt),
            "cross_out": _lin(state, f"{p}.attn2.to_out.0", dt),
            "norm3": _norm(state, f"{p}.norm3", dt),
            "ffn": {"fc1": _lin(state, f"{p}.ff.net.0.proj", dt), "fc2": _lin(state, f"{p}.ff.net.2", dt)},
        }
        if with_skip:
            if f"{p}.skip_linear.weight" in state:
                out["skip_norm"] = _norm(state, f"{p}.skip_norm", dt)
                out["skip_proj"] = _lin(state, f"{p}.skip_linear", dt)
            else:
                d = state[f"{p}.attn1.to_q.weight"].shape[0]
                out["skip_norm"] = {"g": torch.zeros((2 * d,), dtype=dt), "b": torch.zeros((2 * d,), dtype=dt)}
                out["skip_proj"] = {"w": torch.zeros((2 * d, d), dtype=dt), "b": torch.zeros((d,), dtype=dt)}
        return out

    half, te = cfg.depth // 2, "time_extra_emb"
    return {
        "patch_embed": _patch_conv_as_linear(state, "pos_embed.proj", dt),
        "t_embed": _embedder(state, f"{te}.timestep_embedder", dt),
        "text_embedder": {"fc1": _lin(state, "text_embedder.linear_1", dt),
                          "fc2": _lin(state, "text_embedder.linear_2", dt)},
        "text_pad": _tensor(state["text_embedding_padding"], dt),
        "pooler": {
            "pos": _tensor(state[f"{te}.pooler.positional_embedding"], dt),
            "q": _lin(state, f"{te}.pooler.q_proj", dt),
            "k": _lin(state, f"{te}.pooler.k_proj", dt),
            "v": _lin(state, f"{te}.pooler.v_proj", dt),
            "out": _lin(state, f"{te}.pooler.c_proj", dt),
        },
        "extra_embedder": {"fc1": _lin(state, f"{te}.extra_embedder.linear_1", dt),
                           "fc2": _lin(state, f"{te}.extra_embedder.linear_2", dt)},
        "down_blocks": _stack([block(i, False) for i in range(half)]),
        "up_blocks": _stack([block(i, True) for i in range(half, cfg.depth)]),
        "norm_out_mod": _lin(state, "norm_out.linear", dt),
        "proj_out": _lin(state, "proj_out", dt),
    }


# ---------------------------------------------------------------------------
# Latte, HunyuanVideo and ConsisID (diffusers naming)
# ---------------------------------------------------------------------------


def convert_latte(state: Dict[str, np.ndarray], cfg) -> Any:
    """diffusers ``LatteTransformer3DModel`` names -> ``models/latte.init_latte``'s tree."""
    dt = cfg.dtype

    def attn1(p):
        return {"scale_shift_table": _tensor(state[f"{p}.scale_shift_table"], dt),
                "attn_qkv": _fused_qkv(state, f"{p}.attn1.to_q", f"{p}.attn1.to_k", f"{p}.attn1.to_v", dt),
                "attn_out": _lin(state, f"{p}.attn1.to_out.0", dt)}

    def ffn(p):
        return {"fc1": _lin(state, f"{p}.ff.net.0.proj", dt), "fc2": _lin(state, f"{p}.ff.net.2", dt)}

    def spatial(i):
        p = f"transformer_blocks.{i}"
        return {**attn1(p), "cross_q": _lin(state, f"{p}.attn2.to_q", dt),
                "cross_kv": _fused_kv(state, f"{p}.attn2.to_k", f"{p}.attn2.to_v", dt),
                "cross_out": _lin(state, f"{p}.attn2.to_out.0", dt), "ffn": ffn(p)}

    def temporal(i):
        p = f"temporal_transformer_blocks.{i}"
        return {**attn1(p), "ffn": ffn(p)}

    return {
        "patch_embed": _patch_conv_as_linear(state, "pos_embed.proj", dt),
        "t_embed": _embedder(state, "adaln_single.emb.timestep_embedder", dt),
        "adaln_single": _lin(state, "adaln_single.linear", dt),
        "caption_fc1": _lin(state, "caption_projection.linear_1", dt),
        "caption_fc2": _lin(state, "caption_projection.linear_2", dt),
        "spatial_blocks": _stack([spatial(i) for i in range(cfg.num_pairs)]),
        "temporal_blocks": _stack([temporal(i) for i in range(cfg.num_pairs)]),
        "final_scale_shift": _tensor(state["scale_shift_table"], dt),
        "proj_out": _lin(state, "proj_out", dt),
    }


class _Overlay(dict):
    """A read-through view of a state dict with some names replaced (the
    JAX package's ``_OverlayState``): reads of other names reach the base
    state, so a caller tracking which names were read sees them."""

    def __init__(self, base, over):
        super().__init__(over)
        self._base = base

    def __getitem__(self, name):
        return super().__getitem__(name) if dict.__contains__(self, name) else self._base[name]

    def __contains__(self, name):
        return dict.__contains__(self, name) or name in self._base


def convert_hunyuanvideo(state: Dict[str, np.ndarray], cfg) -> Any:
    """diffusers ``HunyuanVideoTransformer3DModel`` names -> ``models/
    hunyuanvideo.init_hunyuanvideo``'s tree: the FLUX-named double and
    single blocks through :func:`convert_flux`, ``x_embedder`` a (1, 2, 2)
    Conv3d flattened to a linear over the (t, h, w, c) patch vector, and
    ``context_embedder.*`` the token refiner."""
    dt = cfg.dtype
    w = state["x_embedder.proj.weight"]
    o, i_, kt, kh, kw = w.shape
    wr = np.transpose(w, (0, 2, 3, 4, 1)).reshape(o, kt * kh * kw * i_)
    params = convert_flux(_Overlay(state, {
        "context_embedder.weight": np.zeros((cfg.dim, cfg.text_dim), np.float32),
        "context_embedder.bias": np.zeros((cfg.dim,), np.float32),
        "x_embedder.weight": wr, "x_embedder.bias": state["x_embedder.proj.bias"]}), cfg)
    del params["context_embedder"]
    ref = "context_embedder"
    blocks = []
    for i in range(cfg.refiner_layers):
        p = f"{ref}.token_refiner.refiner_blocks.{i}"
        blocks.append({
            "norm1": _norm(state, f"{p}.norm1", dt),
            "attn_qkv": _fused_qkv(state, f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v", dt),
            "attn_out": _lin(state, f"{p}.attn.to_out.0", dt),
            "norm2": _norm(state, f"{p}.norm2", dt),
            "ffn": {"fc1": _lin(state, f"{p}.ff.net.0.proj", dt), "fc2": _lin(state, f"{p}.ff.net.2", dt)},
            "ada": _lin(state, f"{p}.norm_out.linear", dt),
        })
    params["refiner"] = {
        "t_embed": _embedder(state, f"{ref}.time_text_embed.timestep_embedder", dt),
        "c_embed": _embedder(state, f"{ref}.time_text_embed.text_embedder", dt),
        "proj_in": _lin(state, f"{ref}.proj_in", dt),
        "blocks": _stack(blocks),
    }
    return params


def convert_stepvideo(state: Dict[str, np.ndarray], cfg) -> Any:
    """Step-Video-T2V checkpoint (the vendored ``step_video_t2v`` naming) ->
    ``models/stepvideo.init_stepvideo``'s tree: ``attn1.wqkv`` rows grouped
    per head (h, [q|k|v], hd) -> (d, 3, H, hd); ``attn2.wq`` (h, hd) -> (d,
    1, H, hd) and ``attn2.wkv`` (h, [k|v], hd) -> (d, 2, H, hd); the output
    projections' columns per head -> (H, hd, d); bias-free projections get
    zero biases, the qk norms are affine RMSNorms; the top level is the
    PixArt-style AdaLayerNormSingle and caption projection."""
    dt = cfg.dtype
    d, h, hd = cfg.dim, cfg.heads, cfg.head_dim

    def packed_qkv(name):
        w = np.asarray(state[f"{name}.weight"]).reshape(h, 3, hd, d)
        b = state.get(f"{name}.bias")
        b = np.zeros((3, h, hd), np.float32) if b is None else np.asarray(b).reshape(h, 3, hd).transpose(1, 0, 2)
        return {"w": _tensor(np.transpose(w, (3, 1, 0, 2)), dt), "b": _tensor(b, dt)}

    def q_only(name):
        w = np.asarray(state[f"{name}.weight"]).reshape(h, hd, d)
        return {"w": _tensor(np.transpose(w, (2, 0, 1))[:, None], dt), "b": torch.zeros((1, h, hd), dtype=dt)}

    def kv_only(name):
        w = np.asarray(state[f"{name}.weight"]).reshape(h, 2, hd, d)
        return {"w": _tensor(np.transpose(w, (3, 1, 0, 2)), dt), "b": torch.zeros((2, h, hd), dtype=dt)}

    def head_out(name):
        w = np.asarray(state[f"{name}.weight"]).reshape(d, h, hd)
        b = state.get(f"{name}.bias")
        return {"w": _tensor(np.transpose(w, (1, 2, 0)), dt),
                "b": _tensor(np.zeros((d,), np.float32) if b is None else b, dt)}

    blocks = []
    for i in range(cfg.depth):
        p = f"transformer_blocks.{i}"
        blocks.append({
            "scale_shift_table": _tensor(state[f"{p}.scale_shift_table"], dt),
            "norm1": _norm(state, f"{p}.norm1", dt),
            "qkv": packed_qkv(f"{p}.attn1.wqkv"),
            "q_norm": _rms(state, f"{p}.attn1.q_norm", dt),
            "k_norm": _rms(state, f"{p}.attn1.k_norm", dt),
            "attn_out": head_out(f"{p}.attn1.wo"),
            "cross_q": q_only(f"{p}.attn2.wq"),
            "cross_kv": kv_only(f"{p}.attn2.wkv"),
            "cross_q_norm": _rms(state, f"{p}.attn2.q_norm", dt),
            "cross_k_norm": _rms(state, f"{p}.attn2.k_norm", dt),
            "cross_out": head_out(f"{p}.attn2.wo"),
            "norm2": _norm(state, f"{p}.norm2", dt),
            "ffn": {"fc1": _lin(state, f"{p}.ff.net.0.proj", dt), "fc2": _lin(state, f"{p}.ff.net.2", dt)},
        })
    return {
        "patch_embed": _patch_conv_as_linear(state, "pos_embed.proj", dt),
        "text_proj": {"fc1": _lin(state, "caption_projection.linear_1", dt),
                      "fc2": _lin(state, "caption_projection.linear_2", dt)},
        "t_embed": _embedder(state, "adaln_single.emb.timestep_embedder", dt),
        "adaln": _lin(state, "adaln_single.linear", dt),
        "blocks": _stack(blocks),
        "final_scale_shift": _tensor(state["scale_shift_table"], dt),
        "proj_out": _lin(state, "proj_out", dt),
    }


def convert_consisid(state: Dict[str, np.ndarray], cfg) -> Any:
    """ConsisID: :func:`convert_cogvideox`'s tree plus the
    ``perceiver_cross_attention.{j}`` modules (bias-free q/kv/out and their
    LayerNorms), stacked.  A checkpoint without perceiver tensors gets zero
    projections with unit norms, which leaves the model CogVideoX.  The
    face encoder is :func:`convert_local_facial_extractor`'s."""
    params = convert_cogvideox(state, cfg)
    dt, d = cfg.dtype, cfg.dim
    pers = []
    for j in range(cfg.perceivers):
        p = f"perceiver_cross_attention.{j}"
        if f"{p}.to_q.weight" in state:
            pers.append({"norm1": _norm(state, f"{p}.norm1", dt), "norm2": _norm(state, f"{p}.norm2", dt),
                         "q": _lin_nobias(state, f"{p}.to_q", dt), "kv": _lin_nobias(state, f"{p}.to_kv", dt),
                         "out": _lin_nobias(state, f"{p}.to_out", dt)})
        else:
            pers.append({"norm1": {"g": torch.ones((cfg.id_dim,), dtype=dt), "b": torch.zeros((cfg.id_dim,), dtype=dt)},
                         "norm2": {"g": torch.ones((d,), dtype=dt), "b": torch.zeros((d,), dtype=dt)},
                         "q": {"w": torch.zeros((d, d), dtype=dt)},
                         "kv": {"w": torch.zeros((cfg.id_dim, 2 * d), dtype=dt)},
                         "out": {"w": torch.zeros((d, d), dtype=dt)}})
    params["perceiver"] = _stack(pers)
    return params


def convert_local_facial_extractor(state: Dict[str, np.ndarray], cfg, prefix: str = "local_facial_extractor.") -> Any:
    """ConsisID's face encoder -> ``models/face.init_lfe``'s tree.  ``prefix``
    is its place in the ``ConsisIDTransformer3DModel`` state dict ("" for a
    checkpoint of the extractor alone); ``latents`` and ``proj_out`` are raw
    (in, out) parameters, not transposed."""
    dt = cfg.dtype

    def mlp3(p):
        return {"fc1": _lin(state, f"{p}.0", dt), "ln1": _norm(state, f"{p}.1", dt), "fc2": _lin(state, f"{p}.3", dt),
                "ln2": _norm(state, f"{p}.4", dt), "fc3": _lin(state, f"{p}.6", dt)}

    layers = []
    for i in range(cfg.depth):
        p = f"{prefix}layers.{i}"
        layers.append({
            "attn": {"norm1": _norm(state, f"{p}.0.norm1", dt), "norm2": _norm(state, f"{p}.0.norm2", dt),
                     "q": _lin_nobias(state, f"{p}.0.to_q", dt), "kv": _lin_nobias(state, f"{p}.0.to_kv", dt),
                     "out": _lin_nobias(state, f"{p}.0.to_out", dt)},
            "ffn": {"ln": _norm(state, f"{p}.1.0", dt), "fc1": _lin_nobias(state, f"{p}.1.1", dt),
                    "fc2": _lin_nobias(state, f"{p}.1.3", dt)},
        })
    return {
        "latents": _tensor(state[f"{prefix}latents"], dt),
        "proj_out": _tensor(state[f"{prefix}proj_out"], dt),
        "id_mapping": mlp3(f"{prefix}id_embedding_mapping"),
        "mappings": [mlp3(f"{prefix}mapping_{i}") for i in range(cfg.num_scale)],
        "layers": layers,
    }


def convert_hv_vae3d_decoder(state: Dict[str, np.ndarray], cfg) -> Any:
    """HunyuanVideo causal 3D VAE decoder (``AutoencoderKLHunyuanVideo``) ->
    ``models/vae3d.init_hv_vae3d_decoder``'s tree."""
    dt = cfg.dtype

    def resnet(p):
        out = {"norm1": _norm(state, f"{p}.norm1", dt), "conv1": _conv3(state, f"{p}.conv1.conv", dt),
               "norm2": _norm(state, f"{p}.norm2", dt), "conv2": _conv3(state, f"{p}.conv2.conv", dt)}
        if f"{p}.conv_shortcut.conv.weight" in state:
            out["shortcut"] = _conv3(state, f"{p}.conv_shortcut.conv", dt)
        return out

    mid = "decoder.mid_block"
    params = {
        "conv_in": _conv3(state, "decoder.conv_in.conv", dt),
        "mid_res1": resnet(f"{mid}.resnets.0"),
        "mid_attn": {"norm": _norm(state, f"{mid}.attentions.0.group_norm", dt),
                     **{k: _lin(state, f"{mid}.attentions.0.to_{k}", dt) for k in ("q", "k", "v")},
                     "out": _lin(state, f"{mid}.attentions.0.to_out.0", dt)},
        "mid_res2": resnet(f"{mid}.resnets.1"),
        "norm_out": _norm(state, "decoder.conv_norm_out", dt),
        "conv_out": _conv3(state, "decoder.conv_out.conv", dt),
    }
    up = []
    for i in range(len(cfg.block_out_channels)):
        p = f"decoder.up_blocks.{i}"
        blk = {"resnets": [resnet(f"{p}.resnets.{j}") for j in range(cfg.layers_per_block + 1)]}
        if f"{p}.upsamplers.0.conv.conv.weight" in state:
            blk["upsample_conv"] = _conv3(state, f"{p}.upsamplers.0.conv.conv", dt)
        up.append(blk)
    params["up"] = up
    return params
