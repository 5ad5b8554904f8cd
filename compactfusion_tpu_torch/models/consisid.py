"""ConsisID backbone: CogVideoX with perceiver identity injection
(counterpart of ``compactfusion_tpu/models/consisid.py``).

The CogVideoX-5B video backbone (``models/cogvideox.py``'s blocks) plus
identity conditioning: after every ``cross_attn_interval``-th block a
bias-free perceiver cross-attention (``perceiver_cross_attention.{j}``:
the LayerNorm'd face tokens as K/V, the LayerNorm'd video stream as
queries) is added to the video stream, scaled by ``local_face_scale``.
The face encoder (``models/face.py``) runs outside the denoise loop; its
output is ``id_states``.  With ``id_states=None`` the model is CogVideoX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import SingleDeviceAttn
from compactfusion_tpu_torch.models.cogvideox import CogVideoXConfig, cogvideox_forward, init_cogvideox
from compactfusion_tpu_torch.ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class ConsisIDConfig(CogVideoXConfig):
    id_dim: int = 2048  # local_facial_extractor output width
    cross_attn_interval: int = 2
    local_face_scale: float = 1.0

    @property
    def perceivers(self) -> int:
        return (self.depth + self.cross_attn_interval - 1) // self.cross_attn_interval


def consisid_preview() -> ConsisIDConfig:
    return ConsisIDConfig(dim=3072, depth=42, heads=48, axes_dim=(16, 24, 24))


def consisid_tiny() -> ConsisIDConfig:
    return ConsisIDConfig(dim=64, depth=2, heads=4, text_dim=32, time_embed_dim=32, axes_dim=(8, 4, 4), id_dim=16,
                          cross_attn_interval=2)


def init_consisid(generator: torch.Generator, cfg: ConsisIDConfig):
    """Random init on the generator's device: ``init_cogvideox``'s tree and
    the perceiver stack (one per ``cross_attn_interval`` blocks, stacked on
    a leading axis), as the JAX ``init_consisid`` builds it."""
    d, dt, dev, n = cfg.dim, cfg.dtype, generator.device, (cfg.perceivers,)
    p = init_cogvideox(generator, cfg)
    p["perceiver"] = {
        "norm1": cm.init_layernorm(cfg.id_dim, dt, dev, n),
        "norm2": cm.init_layernorm(d, dt, dev, n),
        "q": cm.init_linear(generator, d, d, bias=False, dtype=dt, stack=n),
        "kv": cm.init_linear(generator, cfg.id_dim, 2 * d, bias=False, dtype=dt, stack=n),
        "out": cm.init_linear(generator, d, d, bias=False, dtype=dt, stack=n),
    }
    return p


def perceiver_ca(p, id_states: torch.Tensor, latents: torch.Tensor, heads: int) -> torch.Tensor:
    """PerceiverAttentionCA: the LayerNorm'd face tokens give K/V, the
    LayerNorm'd video stream the queries."""
    b, s, d = latents.shape
    x = cm.layernorm(p["norm1"], id_states, eps=1e-5)
    lat = cm.layernorm(p["norm2"], latents, eps=1e-5)
    q = cm.linear(p["q"], lat).reshape(b, s, heads, d // heads)
    k, v = cm.linear(p["kv"], x).chunk(2, dim=-1)
    o = sdpa(q, k.reshape(b, -1, heads, d // heads), v.reshape(b, -1, heads, d // heads))
    return cm.linear(p["out"], o.reshape(b, s, d))


def consisid_forward(
    params,
    video: torch.Tensor,
    txt: torch.Tensor,
    id_states: Optional[torch.Tensor],
    t: torch.Tensor,
    cfg: ConsisIDConfig,
    *,
    video_rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    attn=SingleDeviceAttn(),
    attn_state=(),
    tp_axis: Optional[str] = None,
    pp_stages: int = 1,
    mesh=None,
):
    """ConsisID denoiser: :func:`models.cogvideox.cogvideox_forward` with the
    identity injected after every ``cross_attn_interval``-th block (its
    index in the whole stack, so PipeFusion stages inject at theirs; the
    perceiver stack stays whole on every stage).  ``id_states`` (B, S_id,
    id_dim), the same on every sequence-parallel rank, or None: CogVideoX.
    Returns (v prediction, attn_state)."""
    after = None
    if id_states is not None:
        ids = id_states.to(cfg.dtype)
        interval = cfg.cross_attn_interval

        def after(layer, vid):
            if layer % interval:
                return vid
            p = cm.layer_of(params["perceiver"], layer // interval)
            return vid + cfg.local_face_scale * perceiver_ca(p, ids, vid, cfg.heads)

    return cogvideox_forward(params, video, txt, t, cfg, video_rope=video_rope, attn=attn, attn_state=attn_state,
                             tp_axis=tp_axis, pp_stages=pp_stages, mesh=mesh, after_block=after)
