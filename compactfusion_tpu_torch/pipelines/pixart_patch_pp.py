"""Patch-pipelined PipeFusion for PixArt (counterpart of
``compactfusion_tpu/pipelines/pixart_patch_pp.py``; reference
``_async_pipeline`` with ``PipelineGroupCoordinator`` and ``CacheManager``).

The latent image is cut into M token patches that stream through the pp
stages, each stage holding its slice of the blocks; a block's attention
runs the fresh patch against the full-sequence K/V cache, whose other
patches are one step stale (``PatchKVAttn``, or ``PatchKVUlyssesAttn``
under Ulysses).  ``runtime_warmup_steps`` sync full-sequence steps come
first; the last of them runs through the patch strategy, so it primes the
caches as it denoises.  Then ``steady * M + PS - 1`` micro-rounds: in round
u stage s works on patch counter g = u - s (patch g mod M, step warmup +
g div M); the last stage applies the head and the patch's own DPM-Solver++
update (``dpm_step_patch``), and the update reaches every stage.

Each rank runs its own control flow, where the JAX package computes
masked values in every round on every device: a stage skips the compute of
a round with no patch for it (a bubble), but never a collective.  Every
round every stage sends its output to the next stage, and the last stage
broadcasts the patch's latent update (zeros in a bubble).  The update is
written as the JAX package writes it, ``full + (new - full)`` on the
patch, so the latents match its bits.
"""

from __future__ import annotations

import dataclasses

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import PatchKVAttn, PatchKVUlyssesAttn
from compactfusion_tpu_torch.models.pixart import pixart_embed, pixart_forward, pixart_head, precompute_text_kv
from compactfusion_tpu_torch.parallel.mesh import AXIS_CFG, AXIS_DP, AXIS_PP, AXIS_TP, AXIS_ULYSSES
from compactfusion_tpu_torch.parallel.ring import ring_shift
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.diffusion import dpm_step_patch


@torch.inference_mode()
def patch_pp_sample(pipe, text, text_mask, latents):
    """The patch-pipelined sampler of ``pipe`` (a ``PixArtPipeline`` with
    pp > 1 and M > 1): text (2, B, S_text, text_dim), text_mask (2, B,
    S_text), latents (B, tokens, p*p*C) noise; returns the final latents,
    whole, on every rank.  dp and cfg compose with it, Ulysses shards each
    patch, the ring does not (as in the JAX package)."""
    cfg, m, p, mesh, dev = pipe.cfg, pipe.cfg.model, pipe.cfg.parallel, pipe.mesh, pipe.device
    M, PS, U = cfg.num_pipeline_patch, p.pp_degree, p.ulysses_degree
    if PS < 2 or M < PS:
        raise ValueError(f"the patch pipeline needs pp > 1 and M >= pp, got pp {PS}, M {M}")
    if p.ring_degree != 1:
        raise ValueError("patch mode composes with Ulysses only (ring_degree must be 1)")
    S = cfg.tokens
    s_patch = S // M
    spl = s_patch // U  # this Ulysses rank's rows of a patch
    warmup = min(cfg.runtime_warmup_steps, cfg.num_steps)
    if cfg.num_steps <= warmup:
        raise ValueError("patch mode needs at least one steady (post-warmup) step")
    sched, params, pos_full = pipe.sched, pipe.params, pipe.pos_embed
    tp_axis = AXIS_TP if p.tp_degree > 1 else None
    my, u_idx = mesh.axis_index(AXIS_PP), mesh.axis_index(AXIS_ULYSSES)

    text = text.to(dev)
    text_mask = text_mask.to(dev)
    latents = latents.to(dev, torch.float32)
    b_local = latents.shape[0] // p.dp_degree
    rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
    # a copy: the patch writes below update the latents in place
    text, text_mask, latents = text[:, rows], text_mask[:, rows], latents[rows].clone()
    cfg_split = cfg.do_cfg and p.cfg_degree == 2
    if cfg_split:
        i_cfg = mesh.axis_index(AXIS_CFG)
        text, text_mask = text[i_cfg], text_mask[i_cfg]
    elif cfg.do_cfg:
        text = torch.cat([text[0], text[1]], dim=0)
        text_mask = torch.cat([text_mask[0], text_mask[1]], dim=0)
    else:
        text, text_mask = text[0], text_mask[0]
    b = latents.shape[0]
    nb = 2 * b if cfg.do_cfg and not cfg_split else b
    text_kv = precompute_text_kv(params, text).to(m.dtype)
    fwd = dict(text_mask=text_mask, text_kv=text_kv, tp_axis=tp_axis, mesh=mesh)

    attn = PatchKVUlyssesAttn(mesh=mesh, ulysses_size=U) if U > 1 else PatchKVAttn()
    kv_state = attn.init_state(m.depth // PS, nb, S, m.heads, m.head_dim, m.dtype, dev)

    def model_batch(x):
        return torch.cat([x, x], dim=0) if nb > b else x

    def t_at(i):
        return torch.full((nb,), float(sched.timesteps[i]), dtype=torch.float32, device=dev)

    def eps_of(out):
        eps = out[..., : out.shape[-1] // 2]  # drop the learned-variance half
        return base.cfg_combine(eps, cfg.guidance_scale, p.cfg_degree, mesh) if cfg.do_cfg else eps

    # ---- warmup: sync full-sequence steps through sync PipeFusion
    px0 = torch.zeros_like(latents)
    plam = torch.zeros((M,), dtype=torch.float32)
    phave = [False] * M
    for i in range(max(warmup - 1, 0)):
        out, _ = pixart_forward(params, model_batch(latents).to(m.dtype), t_at(i), None, m, pos_embed=pos_full,
                                pp_stages=PS, **fwd)
        latents, px0, lam = dpm_step_patch(sched, i, cfg.num_steps, latents, eps_of(out), px0, plam[0], phave[0])
        plam.fill_(float(lam))
        phave = [True] * M

    # the last warmup step rides through the patch strategy at offset 0, so
    # it primes the caches as it denoises; each Ulysses rank feeds its rows
    i_last = max(warmup - 1, 0)
    sl = slice(u_idx * (S // U), (u_idx + 1) * (S // U))
    x_in, pos_in = latents[:, sl], pos_full[sl]
    out, _ = pixart_forward(params, model_batch(x_in).to(m.dtype), t_at(i_last), None, m, pos_embed=pos_in,
                            attn=attn, attn_state=kv_state, pp_stages=PS, **fwd)
    if warmup > 0:
        new_loc, x0_loc, lam = dpm_step_patch(sched, i_last, cfg.num_steps, x_in, eps_of(out), px0[:, sl],
                                              plam[0], phave[0])
        latents = torch.cat(mesh.all_gather(new_loc, AXIS_ULYSSES), dim=1)
        px0 = torch.cat(mesh.all_gather(x0_loc, AXIS_ULYSSES), dim=1)
        plam.fill_(float(lam))
        phave = [True] * M
    # (without a warmup step that forward only primed the caches)

    # ---- the patch-pipelined steady state
    total = (cfg.num_steps - warmup) * M
    h_out = torch.zeros((nb, spl, m.dim), dtype=m.dtype, device=dev)
    inbox = h_out
    for u in range(total + PS - 1):
        g = u - my
        if 0 <= g < total:
            mp, i = g % M, warmup + g // M
            off = mp * s_patch
            loc = slice(off + u_idx * spl, off + (u_idx + 1) * spl)
            t = t_at(i)
            x_patch, pos_patch = latents[:, loc], pos_full[loc]
            h_in = pixart_embed(params, model_batch(x_patch).to(m.dtype), pos_patch, m) if my == 0 else inbox
            h_out, _ = pixart_forward(params, h_in, t, None, m, pos_embed=pos_patch,
                                      attn=dataclasses.replace(attn, offset=off), attn_state=kv_state,
                                      x_is_hidden=True, return_hidden=True, **fwd)
        # the last stage's patch (in a bubble of the last stage: zeros)
        g_last = u - (PS - 1)
        write = 0 <= g_last < total
        upd = (torch.zeros((b, spl, latents.shape[-1]), dtype=torch.float32, device=dev),
               torch.zeros((b, spl, latents.shape[-1]), dtype=torch.float32, device=dev),
               torch.zeros((), dtype=torch.float32, device=dev))
        mp_l = g_last % M if write else 0
        loc_l = slice(mp_l * s_patch + u_idx * spl, mp_l * s_patch + (u_idx + 1) * spl)
        if write and my == PS - 1:
            i_l = warmup + g_last // M
            temb = cm.timestep_embedder(params["t_embed"], t_at(i_l), 256)
            eps = eps_of(pixart_head(params, h_out, temb, m))
            x_patch, x0_prev = latents[:, loc_l], px0[:, loc_l]
            new_patch, x0_patch, lam = dpm_step_patch(sched, i_l, cfg.num_steps, x_patch, eps, x0_prev,
                                                      plam[mp_l], phave[mp_l])
            upd = (new_patch - x_patch, x0_patch - x0_prev, lam.reshape(()).to(dev))
        d_lat, d_x0, lam = mesh.broadcast_tree(upd, AXIS_PP, PS - 1)
        if write:
            patch = slice(mp_l * s_patch, (mp_l + 1) * s_patch)
            latents[:, patch] = latents[:, patch] + torch.cat(mesh.all_gather(d_lat, AXIS_ULYSSES), dim=1)
            px0[:, patch] = px0[:, patch] + torch.cat(mesh.all_gather(d_x0, AXIS_ULYSSES), dim=1)
            plam[mp_l] = float(lam)
            phave[mp_l] = True
        # hand the hidden patch to the next stage
        (inbox,) = ring_shift((h_out,), mesh, AXIS_PP)
    return base.gather_batch(latents, mesh)
