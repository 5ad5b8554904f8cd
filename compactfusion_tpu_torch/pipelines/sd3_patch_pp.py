"""Patch-pipelined PipeFusion for SD3 (counterpart of
``compactfusion_tpu/pipelines/sd3_patch_pp.py``; reference
``pipeline_stable_diffusion_3.py`` ``_async_pipeline``).

Image token patches stream through the pp stages, each stage holding its
slice of the joint blocks; the patched attention (``PatchKVAttn``) runs the
fresh patch, and the text stream computed fresh with it, against the
one-step-stale image K/V of the other patches.  The hop between stages
carries the (image patch, text) pair, since SD3's joint blocks update both
streams.  ``runtime_warmup_steps`` (at least 1) sync steps first run the
full sequence through sync PipeFusion with the patch strategy at offset 0:
exact full attention that primes the caches.  Then ``steady * M + PS - 1``
micro-rounds: in round u stage s works on patch counter g = u - s (patch
g mod M, step warmup + g div M); the last stage applies the head and the
patch's flow-match Euler step (stateless, so no per-patch scheduler state)
and broadcasts the new patch.

Each rank runs its own control flow: a stage skips the compute of a round
with no patch for it, but never a hop or the broadcast.
"""

from __future__ import annotations

import dataclasses

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import PatchKVAttn
from compactfusion_tpu_torch.models.sd3 import sd3_embed, sd3_forward, sd3_head, sd3_joint_scan, sd3_time_embed
from compactfusion_tpu_torch.parallel.mesh import AXIS_DP, AXIS_PP, AXIS_TP
from compactfusion_tpu_torch.parallel.ring import ring_shift
from compactfusion_tpu_torch.pipelines import base


@torch.inference_mode()
def sd3_patch_pp_sample(pipe, txt, pooled, latents):
    """The patch-pipelined sampler of ``pipe`` (an ``SD3Pipeline`` with
    pp > 1 and M >= pp; its params cut to this stage): txt (2, B, S_txt,
    text_dim), pooled (2, B, pooled_dim), latents (B, tokens, p*p*C) noise;
    returns the final latents, whole, on every rank."""
    cfg, m, p, mesh, dev = pipe.cfg, pipe.cfg.model, pipe.cfg.parallel, pipe.mesh, pipe.device
    M, PS = cfg.num_pipeline_patch, p.pp_degree
    if PS < 2 or M < PS:
        raise ValueError(f"the patch pipeline needs pp > 1 and M >= pp, got pp {PS}, M {M}")
    if p.sp_degree != 1:
        raise ValueError("patch mode shards the tokens by patch, not by sequence parallelism")
    S = cfg.tokens
    s_patch = S // M
    warmup = min(max(cfg.runtime_warmup_steps, 1), cfg.num_steps)
    if cfg.num_steps <= warmup:
        raise ValueError("patch mode needs at least one steady (post-warmup) step")
    sched, params, pos_full = pipe.sched, pipe.params, pipe.pos_embed
    tp_kw = dict(tp_axis=AXIS_TP if p.tp_degree > 1 else None, mesh=mesh)
    my = mesh.axis_index(AXIS_PP)

    b_local = latents.shape[0] // p.dp_degree
    rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
    txt, pooled = base.split_cfg(txt.to(dev)[:, rows], pooled.to(dev)[:, rows], cfg.do_cfg, p.cfg_degree, mesh)
    txt = txt.to(m.dtype)
    # a copy: the patch writes below update the latents in place
    latents = latents.to(dev, torch.float32)[rows].clone()
    b, nb = latents.shape[0], txt.shape[0]
    txt_emb = cm.linear(params["context_embedder"], txt)
    attn = PatchKVAttn()
    kv = attn.init_state(m.depth // PS, nb, S, m.heads, m.head_dim, m.dtype, dev)

    def model_batch(x):
        return torch.cat([x, x], dim=0) if nb > b else x

    def t_at(i):
        return torch.full((nb,), float(sched.timesteps[i]), dtype=torch.float32, device=dev)

    def velocity(v):
        return base.cfg_combine(v, cfg.guidance_scale, p.cfg_degree, mesh) if cfg.do_cfg else v

    def euler(x, i, v):
        # x + (sigma_{i+1} - sigma_i) v in fp32, as the JAX sampler writes it
        return x + float(sched.sigmas[i + 1] - sched.sigmas[i]) * v.float()

    # ---- warmup: sync PipeFusion with the patch strategy at offset 0
    # (exact full attention) priming the caches
    for i in range(warmup):
        v, _ = sd3_forward(params, model_batch(latents).to(m.dtype), txt, pooled, t_at(i), m, pos_embed=pos_full,
                           attn=attn, attn_state=kv, pp_stages=PS, **tp_kw)
        latents = euler(latents, i, velocity(v))

    # ---- the patch-pipelined steady state
    total = (cfg.num_steps - warmup) * M
    out = (torch.zeros((nb, s_patch, m.dim), dtype=m.dtype, device=dev), torch.zeros_like(txt_emb))
    inbox = out
    for u in range(total + PS - 1):
        g = u - my
        new = torch.zeros((b, s_patch, latents.shape[-1]), dtype=torch.float32, device=dev)
        if 0 <= g < total:
            i, off = warmup + g // M, (g % M) * s_patch
            temb = sd3_time_embed(params, pooled, t_at(i), m)
            if my == 0:
                h_in = (sd3_embed(params, model_batch(latents[:, off:off + s_patch]).to(m.dtype),
                                  pos_full[off:off + s_patch], m), txt_emb)
            else:
                h_in = inbox
            out = sd3_joint_scan(params["blocks"], *h_in, temb, m, attn=dataclasses.replace(attn, offset=off),
                                 attn_state=kv, **tp_kw)[:2]
            if my == PS - 1:
                new = euler(latents[:, off:off + s_patch], i, velocity(sd3_head(params, out[0], temb, m)))
        # the last stage's new patch reaches every stage (zeros in its bubbles)
        g_last = u - (PS - 1)
        (new,) = mesh.broadcast_tree((new,), AXIS_PP, PS - 1)
        if 0 <= g_last < total:
            off = (g_last % M) * s_patch
            latents[:, off:off + s_patch] = new
        # the (image patch, text) pair to the next stage
        inbox = ring_shift(out, mesh, AXIS_PP)
    return base.gather_batch(latents, mesh)
