"""Patch-pipelined PipeFusion for HunyuanDiT with the skip channel
(counterpart of ``compactfusion_tpu/pipelines/hunyuandit_patch_pp.py``;
reference ``pipeline_hunyuandit.py`` ``_async_pipeline`` with
``pipeline_send_skip``/``recv_skip``).

A virtual pipeline 2*PS stages deep, as FLUX's: virtual stages 0..PS-1 are
each rank's down blocks, PS..2PS-1 its up blocks; in round u stage s takes
patch u - s through its down chunk and patch u - PS - s through its up
chunk, and stage 0's up chunk takes the down output of stage PS-1 (the hop
wraps round).  The U-ViT's long skips ride along as a SKIP TRAIN, a (PS,
L_local, B, s_patch, dim) buffer: down chunk s deposits its skip stack at
slot s, and up chunk s reads slot PS-1-s, reversed.  One hop a round
carries both chunks' (hidden patch, train) pairs to the next stage.  The
last stage applies the head and the patch's own DPM-Solver++ update
(``dpm_step_patch``) and broadcasts it.

``runtime_warmup_steps`` (at least 1) exact sync PipeFusion steps come
first, then one patched full forward at the next step's timestep whose
only product is the primed stale-K/V caches (its output is dropped, as in
the JAX package).  M >= 2*PS.

Each rank runs its own control flow: a stage skips the compute of a chunk
in a round with no patch for it, but never a hop or the broadcast.
"""

from __future__ import annotations

import dataclasses

import torch

from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.attn_impl import PatchKVAttn
from compactfusion_tpu_torch.models.hunyuandit import (
    hunyuandit_down_scan,
    hunyuandit_forward,
    hunyuandit_head,
    hunyuandit_up_scan,
)
from compactfusion_tpu_torch.parallel.mesh import AXIS_DP, AXIS_PP, AXIS_TP
from compactfusion_tpu_torch.parallel.ring import ring_shift
from compactfusion_tpu_torch.pipelines import base
from compactfusion_tpu_torch.schedulers.diffusion import dpm_step_patch


@torch.inference_mode()
def hunyuandit_patch_pp_sample(pipe, text, text_mask, latents):
    """The patch-pipelined sampler of ``pipe`` (a ``HunyuanDiTPipeline``
    with pp > 1 and M >= 2*pp; its params cut to this stage): text (2, B,
    S_text, text_dim), text_mask (2, B, S_text), latents (B, tokens, p*p*C)
    noise; returns the final latents, whole, on every rank."""
    cfg, m, p, mesh, dev = pipe.cfg, pipe.cfg.model, pipe.cfg.parallel, pipe.mesh, pipe.device
    M, PS = cfg.num_pipeline_patch, p.pp_degree
    if PS < 2 or M < 2 * PS:
        raise ValueError(f"the HunyuanDiT patch pipeline needs pp > 1 and M >= 2*pp, got pp {PS}, M {M}")
    if p.sp_degree != 1:
        raise ValueError("patch mode shards the tokens by patch, not by sequence parallelism")
    N, S = cfg.num_steps, cfg.tokens
    s_patch, l_loc = S // M, m.depth // 2 // PS
    warmup = min(max(cfg.runtime_warmup_steps, 1), N)
    if N <= warmup:
        raise ValueError("patch mode needs at least one steady (post-warmup) step")
    sched, params = pipe.sched, pipe.params
    cos_full, sin_full = pipe.rope
    tp_kw = dict(tp_axis=AXIS_TP if p.tp_degree > 1 else None, mesh=mesh)
    my = mesh.axis_index(AXIS_PP)

    b_local = latents.shape[0] // p.dp_degree
    rows = slice(mesh.axis_index(AXIS_DP) * b_local, (mesh.axis_index(AXIS_DP) + 1) * b_local)
    text, text_mask = base.split_cfg(text.to(dev)[:, rows], text_mask.to(dev)[:, rows], cfg.do_cfg,
                                     p.cfg_degree, mesh)
    text = text.to(m.dtype)
    kv_lens = text_mask.sum(dim=-1).to(torch.int32)
    # a copy: the patch writes below update the latents in place
    latents = latents.to(dev, torch.float32)[rows].clone()
    b, nb = latents.shape[0], text.shape[0]

    def model_batch(x):
        return torch.cat([x, x], dim=0) if nb > b else x

    def t_at(i):
        return torch.full((nb,), float(sched.timesteps[i]), dtype=torch.float32, device=dev)

    def eps_of(out):
        eps = out[..., : out.shape[-1] // 2]  # drop the learned-variance half
        return base.cfg_combine(eps, cfg.guidance_scale, p.cfg_degree, mesh) if cfg.do_cfg else eps

    # ---- warmup: exact sync PipeFusion steps
    px0 = torch.zeros_like(latents)
    plam = torch.zeros((M,), dtype=torch.float32)
    phave = [False] * M
    fwd = dict(rope=(cos_full, sin_full), text_mask=text_mask, pp_stages=PS, **tp_kw)
    for i in range(warmup):
        out, _, _ = hunyuandit_forward(params, model_batch(latents).to(m.dtype), t_at(i), text, m, **fwd)
        latents, px0, lam = dpm_step_patch(sched, i, N, latents, eps_of(out), px0, plam[0], phave[0])
        plam.fill_(float(lam))
        phave = [True] * M

    # ---- one patched full forward primes the stale-K/V caches
    attn = PatchKVAttn()
    kv_d = attn.init_state(l_loc, nb, S, m.heads, m.head_dim, m.dtype, dev)
    kv_u = attn.init_state(l_loc, nb, S, m.heads, m.head_dim, m.dtype, dev)
    hunyuandit_forward(params, model_batch(latents).to(m.dtype), t_at(min(warmup, N - 1)), text, m, attn=attn,
                       attn_state_down=kv_d, attn_state_up=kv_u, **fwd)

    # ---- the patch-pipelined steady state with the skip train
    total = (N - warmup) * M
    zero_h = torch.zeros((nb, s_patch, m.dim), dtype=m.dtype, device=dev)
    zero_train = torch.zeros((PS, l_loc) + tuple(zero_h.shape), dtype=m.dtype, device=dev)
    in_d = in_u = (zero_h, zero_train)
    out_d = out_u = (zero_h, zero_train)

    def unit(g):
        """(valid, step, token offset) of patch counter g."""
        if not 0 <= g < total:
            return False, 0, 0
        return True, warmup + g // M, (g % M) * s_patch

    def temb_at(i):
        return cm.timestep_embedder(params["t_embed"], t_at(i), 256)

    def rope_at(off):
        return cos_full[off:off + s_patch], sin_full[off:off + s_patch]

    blk = dict(kv_lens=kv_lens, **tp_kw)
    for u in range(total + 2 * PS - 1):
        valid, i, off = unit(u - my)
        if valid:  # down chunk: patch u - my; it deposits its skips at slot my
            if my == 0:
                h_in = cm.linear(params["patch_embed"], model_batch(latents[:, off:off + s_patch]).to(m.dtype))
                train = torch.zeros_like(zero_train)
            else:
                h_in, train = in_d[0], in_d[1].clone()
            h, _, skips = hunyuandit_down_scan(params["down_blocks"], h_in, temb_at(i), text, m, rope=rope_at(off),
                                               attn=dataclasses.replace(attn, offset=off), attn_state=kv_d, **blk)
            train[my] = skips
            out_d = (h, train)
        valid, i, off = unit(u - PS - my)
        upd = (torch.zeros((b, s_patch, latents.shape[-1]), dtype=torch.float32, device=dev),
               torch.zeros((b, s_patch, latents.shape[-1]), dtype=torch.float32, device=dev),
               torch.zeros((), dtype=torch.float32, device=dev))
        if valid:  # up chunk: patch u - PS - my; stage 0 takes stage PS-1's down output
            h_in, train = in_d if my == 0 else in_u
            temb = temb_at(i)
            h, _ = hunyuandit_up_scan(params["up_blocks"], h_in, train[PS - 1 - my].flip(0), temb, text, m,
                                      rope=rope_at(off), attn=dataclasses.replace(attn, offset=off),
                                      attn_state=kv_u, offset=my * l_loc, **blk)
            out_u = (h, train)
            if my == PS - 1:
                mp = (u - PS - my) % M
                new, x0, lam = dpm_step_patch(sched, i, N, latents[:, off:off + s_patch],
                                              eps_of(hunyuandit_head(params, h, temb, m)),
                                              px0[:, off:off + s_patch], plam[mp], phave[mp])
                upd = (new, x0, lam.reshape(()).to(dev))
        # the last stage's patch update reaches every stage (zeros in its bubbles)
        new, x0, lam = mesh.broadcast_tree(upd, AXIS_PP, PS - 1)
        g_last = u - PS - (PS - 1)
        if 0 <= g_last < total:
            mp, off = g_last % M, (g_last % M) * s_patch
            latents[:, off:off + s_patch] = new
            px0[:, off:off + s_patch] = x0
            plam[mp] = float(lam)
            phave[mp] = True
        # both chunks' (hidden patch, skip train) pairs to the next stage
        in_d, in_u = ring_shift((out_d, out_u), mesh, AXIS_PP)
    return base.gather_batch(latents, mesh)
