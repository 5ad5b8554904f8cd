"""Patch-pipelined PipeFusion for FLUX (counterpart of
``compactfusion_tpu/pipelines/flux_patch_pp.py``; reference
``pipeline_flux.py:555-721`` ``_async_pipeline``).

Image token patches stream through the pp stages; the patched attention
(``PatchKVAttn``) runs the fresh patch against the one-step-stale K/V of the
other patches, and the text stream is computed fresh with every patch (only
image K/V ages).  FLUX's two block families make a virtual pipeline 2*PS
stages deep: virtual stages 0..PS-1 are each rank's double blocks, PS..2PS-1
its single blocks.  In round u, stage s takes patch u - s through its
doubles and patch u - PS - s through its singles; stage 0's singles take the
doubles output of stage PS-1 (the hop wraps round).  One hop a round
carries both families' (image patch, text) outputs to the next stage; the
last stage applies the head and the patch's flow-match Euler step and
broadcasts the new patch.  ``runtime_warmup_steps`` (at least 1) sync steps
first run the full sequence through the patch strategy at offset 0, exact
full attention that primes the caches.  M >= 2*PS, so a patch's next step
starts after its update landed.

Each rank runs its own control flow: a stage skips the compute of a family
in a round with no patch for it, but never a hop or the broadcast.
"""

from __future__ import annotations

import dataclasses

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import PatchKVAttn
from compactfusion_tpu_torch.models.flux import (
    flux_double_scan,
    flux_forward,
    flux_head,
    flux_single_scan,
    flux_time_embed,
)
from compactfusion_tpu_torch.parallel.mesh import AXIS_DP, AXIS_PP, AXIS_TP
from compactfusion_tpu_torch.parallel.ring import ring_shift
from compactfusion_tpu_torch.pipelines import base


@torch.inference_mode()
def flux_patch_pp_sample(pipe, txt, pooled, latents):
    """The patch-pipelined sampler of ``pipe`` (a ``FluxPipeline`` with
    pp > 1 and M >= 2*pp; its params padded and cut to this stage): txt
    (B, S_txt, text_dim), pooled (B, pooled_dim), latents (B, tokens,
    in_channels) noise; returns the final latents, whole, on every rank."""
    cfg, m, p, mesh, dev = pipe.cfg, pipe.model, pipe.cfg.parallel, pipe.mesh, pipe.device
    M, PS = cfg.num_pipeline_patch, p.pp_degree
    if PS < 2 or M < 2 * PS:
        raise ValueError(f"the FLUX patch pipeline needs pp > 1 and M >= 2*pp, got pp {PS}, M {M}")
    if p.sp_degree != 1:
        raise ValueError("patch mode shards the tokens by patch, not by sequence parallelism")
    S = cfg.tokens
    s_patch = S // M
    warmup = min(max(cfg.runtime_warmup_steps, 1), cfg.num_steps)
    if cfg.num_steps <= warmup:
        raise ValueError("patch mode needs at least one steady (post-warmup) step")
    sched, params = pipe.sched, pipe.params
    sigmas = sched.sigmas
    tp_axis = AXIS_TP if p.tp_degree > 1 else None
    my = mesh.axis_index(AXIS_PP)
    cos_full, sin_full = pipe.img_rope

    b_local = latents.shape[0] // p.dp_degree
    rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
    txt, pooled = txt.to(dev)[rows].to(m.dtype), pooled.to(dev)[rows]
    # a copy: the patch writes below update the latents in place
    latents = latents.to(dev, torch.float32)[rows].clone()
    b = latents.shape[0]
    txt_rope = cm.rope_frequencies(torch.zeros((txt.shape[1], len(m.axes_dim)), dtype=torch.int64, device=dev),
                                   m.axes_dim)
    guidance = (torch.full((b,), cfg.guidance_scale * 1000.0, dtype=torch.float32, device=dev)
                if m.guidance_embeds else None)
    txt_emb = cm.linear(params["context_embedder"], txt)
    attn = PatchKVAttn()
    kv_d = attn.init_state(m.double_layers // PS, b, S, m.heads, m.head_dim, m.dtype, dev)
    kv_s = attn.init_state(m.single_layers // PS, b, S, m.heads, m.head_dim, m.dtype, dev)
    tp_kw = dict(tp_axis=tp_axis, mesh=mesh)

    def t_at(i):
        return torch.full((b,), float(sched.timesteps[i]), dtype=torch.float32, device=dev)

    def euler(x, i, v):
        # x + (sigma_{i+1} - sigma_i) v in fp32, as the JAX sampler writes it
        return x + float(sigmas[i + 1] - sigmas[i]) * v.float()

    # ---- warmup: sync PipeFusion over both families, the patch strategy at
    # offset 0 (exact full attention) priming the caches
    for i in range(warmup):
        v, _, _ = flux_forward(params, latents.to(m.dtype), txt, pooled, t_at(i), guidance, m,
                               img_rope=(cos_full, sin_full), txt_rope=txt_rope, attn=attn, attn_state_double=kv_d,
                               attn_state_single=kv_s, pp_stages=PS, **tp_kw)
        latents = euler(latents, i, v)

    # ---- the patch-pipelined steady state over the 2*PS virtual stages
    total = (cfg.num_steps - warmup) * M
    zero = (torch.zeros((b, s_patch, m.dim), dtype=m.dtype, device=dev), torch.zeros_like(txt_emb))
    in_d = in_s = zero

    def unit(u_off):
        """(valid, step, token offset) of this stage's patch at a round."""
        g = u_off - my
        if not 0 <= g < total:
            return False, 0, 0
        return True, warmup + g // M, (g % M) * s_patch

    for u in range(total + 2 * PS - 1):
        out_d, out_s = zero, zero
        valid, i, off = unit(u)
        if valid:  # doubles: patch u - my
            if my == 0:
                img_in = cm.linear(params["x_embedder"], latents[:, off:off + s_patch].to(m.dtype))
                txt_in = txt_emb
            else:
                img_in, txt_in = in_d
            rope = (cos_full[off:off + s_patch], sin_full[off:off + s_patch])
            out_d = flux_double_scan(params["double_blocks"], img_in, txt_in, flux_time_embed(
                params, pooled, t_at(i), guidance, m), m, img_rope=rope, txt_rope=txt_rope,
                attn=dataclasses.replace(attn, offset=off), attn_state=kv_d, **tp_kw)[:2]
        valid, i, off = unit(u - PS)
        new = torch.zeros((b, s_patch, latents.shape[-1]), dtype=torch.float32, device=dev)
        if valid:  # singles: patch u - PS - my; stage 0 takes stage PS-1's doubles
            temb = flux_time_embed(params, pooled, t_at(i), guidance, m)
            rope = (cos_full[off:off + s_patch], sin_full[off:off + s_patch])
            out_s = flux_single_scan(params["single_blocks"], *(in_d if my == 0 else in_s), temb, m,
                                     img_rope=rope, txt_rope=txt_rope, attn=dataclasses.replace(attn, offset=off),
                                     attn_state=kv_s, **tp_kw)[:2]
            if my == PS - 1:
                new = euler(latents[:, off:off + s_patch], i, flux_head(params, out_s[0], temb, m))
        # the last stage's new patch reaches every stage (zeros in its bubbles)
        g_last = u - PS - (PS - 1)
        (new,) = mesh.broadcast_tree((new,), AXIS_PP, PS - 1)
        if 0 <= g_last < total:
            off = (g_last % M) * s_patch
            latents[:, off:off + s_patch] = new
        # both families' outputs to the next stage
        in_d, in_s = ring_shift((out_d, out_s), mesh, AXIS_PP)
    return base.gather_batch(latents, mesh)
