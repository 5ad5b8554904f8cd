"""HuggingFace (diffusers) state dicts -> the port's parameter trees
(counterpart of part of ``compactfusion_tpu/io/hf.py``).

The state dict maps names to numpy arrays in torch layouts; the converters
return the trees ``init_*`` builds, in torch tensors of ``cfg.dtype`` on the
CPU:

  * a torch ``nn.Linear`` stores (out, in): transposed to (in, out);
  * separate to_q/to_k/to_v projections are fused into one qkv matrix;
  * per-layer tensors are stacked on a leading layer axis;
  * the q and k columns of FLUX's qkv and its qk-norm gains are permuted
    per head from the checkpoint's interleaved rope layout to the
    rotate-half layout the model runs (``models/common.apply_rope_half``).

Only FLUX's converter is ported so far.  This module imports numpy and
torch, not JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from compactfusion_tpu_torch.models.common import rope_half_perm


def _tensor(a: np.ndarray, dtype) -> torch.Tensor:
    """A numpy array -> a torch tensor of ``dtype`` (round to nearest even)."""
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dtype)


def _lin(state, name, dtype):
    """torch Linear -> {w (in, out), b?}."""
    p = {"w": _tensor(state[f"{name}.weight"].T, dtype)}
    if f"{name}.bias" in state:
        p["b"] = _tensor(state[f"{name}.bias"], dtype)
    return p


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
