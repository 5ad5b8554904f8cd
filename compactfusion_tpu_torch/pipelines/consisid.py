"""ConsisID identity-preserving text-to-video pipeline
(counterpart of ``compactfusion_tpu/pipelines/consisid.py``).

The CogVideoX pipeline (``pipelines/cogvideox.py``: v-prediction DDIM on
the zero-terminal-SNR schedule, dynamic CFG, the causal 3D VAE, the same
parallel axes and the compressed ring on the video K/V) with identity
tokens (``id_states``) fed to the perceiver cross-attention of
``models/consisid.py``.  The face encoder runs outside the denoise loop
(:meth:`ConsisIDPipeline.encode_face`); without identity tokens the
pipeline feeds zeros, as the JAX pipeline does.  The identity tokens are
the same on every rank: the whole batch, repeated to this rank's model
batch when that is larger (the CFG batch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from compactfusion_tpu_torch.models.consisid import ConsisIDConfig, consisid_forward
from compactfusion_tpu_torch.parallel.mesh import AXIS_TP
from compactfusion_tpu_torch.pipelines.cogvideox import CogVideoXPipeline, CogVideoXPipelineConfig


@dataclasses.dataclass(frozen=True)
class ConsisIDPipelineConfig(CogVideoXPipelineConfig):
    model: ConsisIDConfig = None  # type: ignore[assignment]
    #: face-identity tokens fed to the perceiver cross-attention
    id_tokens: int = 5


class ConsisIDPipeline(CogVideoXPipeline):
    """``ConsisIDPipeline(params, vae_params, cfg, device="cuda", mesh=None)``;
    ``lfe_params`` (the face encoder's, or None) is set by the builder."""

    lfe_params = None

    def encode_face(self, lfe_params, id_cond, id_vit_hidden, lfe_cfg=None) -> torch.Tensor:
        """The face encoder (``models/face.lfe_forward``), once per request:
        (B, id_dim) + ``num_scale`` ViT maps -> identity tokens."""
        from compactfusion_tpu_torch.models.face import lfe_consisid, lfe_forward

        with torch.inference_mode():
            return lfe_forward(lfe_params, id_cond, id_vit_hidden, lfe_cfg or lfe_consisid())

    def __call__(self, txt, generator: Optional[torch.Generator] = None, latents: Optional[torch.Tensor] = None,
                 id_states: Optional[torch.Tensor] = None, decode: bool = True):
        """``CogVideoXPipeline.__call__`` with ``id_states`` (B, S_id, id_dim):
        the identity tokens, zeros when None."""
        cfg = self.cfg
        if id_states is None:
            id_states = torch.zeros((txt.shape[1], cfg.id_tokens, cfg.model.id_dim), dtype=torch.float32)
        self._ids = id_states
        return super().__call__(txt, generator=generator, latents=latents, decode=decode)

    def _forward(self, x, txt, t, rope, pe, attn, attn_state):
        m, p = self.cfg.model, self.cfg.parallel
        ids = self._ids.to(self.device)
        if ids.shape[0] != x.shape[0]:
            ids = torch.cat([ids] * (x.shape[0] // ids.shape[0]), dim=0)
        return consisid_forward(self.params, x, txt, ids.to(m.dtype), t, m, video_rope=rope, attn=attn,
                                attn_state=attn_state, mesh=self.mesh,
                                tp_axis=AXIS_TP if p.tp_degree > 1 else None, pp_stages=p.pp_degree)
