"""DiTFastAttn: per-(step, layer) attention compression plans
(counterpart of ``compactfusion_tpu/cache/fast_attn.py``).

Methods (:class:`FastAttnMethod`, the same integer values): full attention,
windowed attention plus a cached full-minus-window residual, output sharing
with the previous step, CFG sharing (attention on the cond half of the
[cond; uncond] batch, mirrored to the uncond half) and the FULL variants
that skip the residual refresh when no later step reads it
(:func:`optimize_plan`).  The plan is a (steps, layers) int table: the
pipeline writes ``plan[i]`` into the state's host-side ``method`` row each
step, and each layer's strategy call picks its branch from that host
integer, so choosing a branch needs no device sync.

Window attention runs the banded flash kernel on a CUDA tensor
(``ops/flash.flash_attn_window_with_lse``; off-band KV tiles are skipped, so
the work scales with S * window) and its masked-attention twin on a CPU
tensor.  Calibration (:class:`CalibrationAttn`, :func:`calibrate_pixart`)
measures every candidate's loss per (step, layer) in one forward per step
and :func:`select_methods` picks the cheapest under a depth-ramped budget.
Single-device only: window bands do not shard over sequence parallelism.
"""

from __future__ import annotations

import dataclasses
import enum
import json

import numpy as np
import torch

from compactfusion_tpu_torch.ops.attention import sdpa
from compactfusion_tpu_torch.ops.flash import flash_attn_window_with_lse, window_mask  # noqa: F401


class FastAttnMethod(enum.IntEnum):
    FULL_ATTN = 0
    RESIDUAL_WINDOW_ATTN = 1
    OUTPUT_SHARE = 2
    FULL_ATTN_CFG_SHARE = 3
    RESIDUAL_WINDOW_ATTN_CFG_SHARE = 4
    # FULL variants that skip the residual-refresh window pass when no later
    # step consumes it; never emitted by calibration, optimize_plan derives them
    FULL_ATTN_NO_RESIDUAL = 5
    FULL_ATTN_CFG_SHARE_NO_RESIDUAL = 6


def window_attention(q, k, v, window: int) -> torch.Tensor:
    """Banded self-attention |i - j| <= window: the banded flash kernel on a
    CUDA tensor, its plain twin (masked attention) on a CPU tensor."""
    out, _ = flash_attn_window_with_lse(q, k, v, window)
    return out


def _tile_cond(x_half: torch.Tensor) -> torch.Tensor:
    """[cond] -> [cond; cond] (CFG share: mirror to the uncond rows)."""
    return torch.cat([x_half, x_half], dim=0)


# without a [cond; uncond] batch the CFG-share methods run their plain twins
_NO_CFG = {
    FastAttnMethod.FULL_ATTN_CFG_SHARE: FastAttnMethod.FULL_ATTN,
    FastAttnMethod.RESIDUAL_WINDOW_ATTN_CFG_SHARE: FastAttnMethod.RESIDUAL_WINDOW_ATTN,
    FastAttnMethod.FULL_ATTN_CFG_SHARE_NO_RESIDUAL: FastAttnMethod.FULL_ATTN_NO_RESIDUAL,
}


@dataclasses.dataclass(frozen=True)
class FastAttnAttn:
    """Attention strategy applying a per-layer method plan.

    State (leaves stacked over layers, updated in place):
      method:   (L,) int32 on the host, written by the pipeline from plan[step];
      residual: (L, B, S, H, D) cached full-minus-window residual;
      last_out: (L, B, S, H, D) cached output for OUTPUT_SHARE.

    ``cfg_batched``: the model batch is [cond; uncond] rows, which enables
    the CFG_SHARE methods; without it they degrade to their non-shared
    counterparts.
    """

    window_size: int = 64
    cfg_batched: bool = False

    def init_state(self, n_layers, batch, seq_local, heads, head_dim, dtype, device=None):
        shape = (n_layers, batch, seq_local, heads, head_dim)
        return {
            "method": torch.zeros((n_layers,), dtype=torch.int32),
            "residual": torch.zeros(shape, dtype=dtype, device=device),
            "last_out": torch.zeros(shape, dtype=dtype, device=device),
        }

    def __call__(self, q, k, v, state, *, joint_q=None, joint_k=None, joint_v=None,
                 joint_strategy="front"):
        """``state``: this layer's entries; ``residual`` and ``last_out`` are
        written in place and the same state is returned."""
        assert joint_q is None, "fast-attn plans are for self-attention DiTs"
        F = FastAttnMethod
        method = F(int(state["method"]))
        residual, last_out = state["residual"], state["last_out"]
        dt = residual.dtype
        half = q.shape[0] // 2
        if not (self.cfg_batched and q.shape[0] % 2 == 0):
            method = _NO_CFG.get(method, method)
        w = self.window_size
        qh, kh, vh = q[:half], k[:half], v[:half]

        if method == F.FULL_ATTN:
            out = sdpa(q, k, v)
            residual.copy_((out.float() - window_attention(q, k, v, w).float()).to(dt))
        elif method == F.RESIDUAL_WINDOW_ATTN:
            out = (window_attention(q, k, v, w).float() + residual.float()).to(q.dtype)
        elif method == F.OUTPUT_SHARE:
            # a copy: the cache is rewritten below (rounded to q.dtype and back)
            out = last_out.to(q.dtype, copy=True)
        elif method == F.FULL_ATTN_CFG_SHARE:
            # cond half only; mirror the output AND the residual
            out_h = sdpa(qh, kh, vh)
            residual.copy_(_tile_cond((out_h.float() - window_attention(qh, kh, vh, w).float()).to(dt)))
            out = _tile_cond(out_h)
        elif method == F.RESIDUAL_WINDOW_ATTN_CFG_SHARE:
            win_h = window_attention(qh, kh, vh, w)
            out = _tile_cond((win_h.float() + residual[:half].float()).to(q.dtype))
        elif method == F.FULL_ATTN_NO_RESIDUAL:
            out = sdpa(q, k, v)
        else:  # FULL_ATTN_CFG_SHARE_NO_RESIDUAL
            out = _tile_cond(sdpa(qh, kh, vh))
        last_out.copy_(out.to(dt))
        return out, state


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def compression_loss(ref: torch.Tensor, approx: torch.Tensor) -> torch.Tensor:
    """Relative L2 loss over all elements, a 0-dim fp32 tensor."""
    r32 = ref.float()
    return torch.linalg.vector_norm(approx.float() - r32) / torch.clamp(
        torch.linalg.vector_norm(r32), min=1e-8)


@dataclasses.dataclass(frozen=True)
class CalibrationAttn:
    """Computes the FULL output while measuring every candidate's loss.

    State (leaves stacked over layers, written in place): ``last_out``
    (L, B, S, H, D) and the per-layer losses ``window_loss``, ``share_loss``,
    ``full_cfg_loss``, ``window_cfg_loss`` (L,) fp32.  With ``cfg_batched``
    the CFG-share candidates are measured by mirroring the cond half;
    otherwise their losses are inf, so :func:`select_methods` never picks
    them.
    """

    window_size: int = 64
    cfg_batched: bool = False

    def init_state(self, n_layers, batch, seq_local, heads, head_dim, dtype, device=None):
        def loss():
            return torch.zeros((n_layers,), dtype=torch.float32, device=device)

        return {
            "last_out": torch.zeros((n_layers, batch, seq_local, heads, head_dim), dtype=dtype,
                                    device=device),
            "window_loss": loss(),
            "share_loss": loss(),
            "full_cfg_loss": loss(),
            "window_cfg_loss": loss(),
        }

    def __call__(self, q, k, v, state, *, joint_q=None, joint_k=None, joint_v=None,
                 joint_strategy="front"):
        # dropping joint tensors would calibrate against the wrong attention
        assert joint_q is None, "fast-attn calibration is for self-attention DiTs"
        out = sdpa(q, k, v)
        win = window_attention(q, k, v, self.window_size)
        if self.cfg_batched and q.shape[0] % 2 == 0:
            half = q.shape[0] // 2
            state["full_cfg_loss"].copy_(compression_loss(out, _tile_cond(out[:half])))
            state["window_cfg_loss"].copy_(compression_loss(out, _tile_cond(win[:half])))
        else:
            state["full_cfg_loss"].fill_(float("inf"))
            state["window_cfg_loss"].fill_(float("inf"))
        state["window_loss"].copy_(compression_loss(out, win))
        state["share_loss"].copy_(compression_loss(out, state["last_out"]))
        state["last_out"].copy_(out.to(state["last_out"].dtype))
        return out, state


def select_methods(window_loss, share_loss, threshold: float, n_layers: int,
                   window_cfg_loss=None, full_cfg_loss=None) -> np.ndarray:
    """Greedy per-layer selection with a depth-ramped threshold: block i's
    budget is ``(i+1)/L * threshold``; candidates are tried cheapest first
    (OUTPUT_SHARE, RESIDUAL_WINDOW_ATTN_CFG_SHARE, RESIDUAL_WINDOW_ATTN,
    FULL_ATTN_CFG_SHARE), falling back to FULL_ATTN."""
    window_loss = np.asarray(window_loss)
    share_loss = np.asarray(share_loss)
    inf = np.full_like(window_loss, np.inf)
    window_cfg_loss = np.asarray(window_cfg_loss) if window_cfg_loss is not None else inf
    full_cfg_loss = np.asarray(full_cfg_loss) if full_cfg_loss is not None else inf
    plan = np.full((n_layers,), int(FastAttnMethod.FULL_ATTN), np.int32)
    for i in range(n_layers):
        budget = (i + 1) / n_layers * threshold
        if share_loss[i] < budget:
            plan[i] = int(FastAttnMethod.OUTPUT_SHARE)
        elif window_cfg_loss[i] < budget:
            plan[i] = int(FastAttnMethod.RESIDUAL_WINDOW_ATTN_CFG_SHARE)
        elif window_loss[i] < budget:
            plan[i] = int(FastAttnMethod.RESIDUAL_WINDOW_ATTN)
        elif full_cfg_loss[i] < budget:
            plan[i] = int(FastAttnMethod.FULL_ATTN_CFG_SHARE)
    return plan


def optimize_plan(plan) -> np.ndarray:
    """Rewrite FULL_ATTN(_CFG_SHARE) -> its ``_NO_RESIDUAL`` variant where no
    later RESIDUAL_WINDOW step reads the refreshed residual before the next
    FULL overwrites it (OUTPUT_SHARE passes it through).  Idempotent."""
    F = FastAttnMethod
    plan = np.asarray(plan, np.int32).copy()
    steps, n_layers = plan.shape
    window = {int(F.RESIDUAL_WINDOW_ATTN), int(F.RESIDUAL_WINDOW_ATTN_CFG_SHARE)}
    to_nores = {
        int(F.FULL_ATTN): int(F.FULL_ATTN_NO_RESIDUAL),
        int(F.FULL_ATTN_CFG_SHARE): int(F.FULL_ATTN_CFG_SHARE_NO_RESIDUAL),
    }
    for l in range(n_layers):
        consumed_later = False  # does a later step read the residual before a FULL rewrites it?
        for s in range(steps - 1, -1, -1):
            m = int(plan[s, l])
            if m in window:
                consumed_later = True
            elif m in to_nores:
                if not consumed_later:
                    plan[s, l] = to_nores[m]
                consumed_later = False
    return plan


@torch.inference_mode()
def calibrate_pixart(params, pcfg, text, text_mask, generator=None, threshold: float = 0.5,
                     *, latents=None) -> np.ndarray:
    """DiTFastAttn calibration on the PixArt pipeline: drive the denoise loop
    once, measure each candidate method's loss per (step, layer) with one
    :class:`CalibrationAttn` forward per step, and pick the cheapest under
    the depth-ramped budget; step 0 stays FULL.  The text path is run in
    every step (not hoisted), as in the JAX calibration.

    ``text`` (2, B, S_text, text_dim) = [cond, uncond], ``text_mask``
    (2, B, S_text) bool or None; the noise is ``latents`` (B, tokens,
    p*p*C) when given, else drawn from ``generator``.  Runs on the device of
    ``params``.  Returns a (steps, depth) int32 plan for
    ``PixArtPipelineConfig.fast_attn_plan``; persist it with
    :func:`save_plan`.
    """
    from compactfusion_tpu_torch.models import common as cm
    from compactfusion_tpu_torch.models.pixart import pixart_forward
    from compactfusion_tpu_torch.pipelines import base
    from compactfusion_tpu_torch.schedulers.diffusion import ddpm_schedule, dpm_init_state, dpm_step

    assert pcfg.parallel.world_size == 1, "calibrate on a single device"
    m = pcfg.model
    device = params["patch_embed"]["w"].device
    steps = pcfg.num_steps
    sched = ddpm_schedule(steps, timestep_spacing="linspace")
    hp, wp = pcfg.grid
    pos = cm.sincos_pos_embed_2d(m.dim, hp, wp, base_size=m.base_size,
                                 interpolation_scale=m.interpolation_scale).to(device)
    do_cfg = pcfg.do_cfg
    cal = CalibrationAttn(window_size=pcfg.fast_attn_window, cfg_batched=do_cfg)

    text = text.to(device)
    text_mask = (torch.ones(text.shape[:3], dtype=torch.bool) if text_mask is None else text_mask).to(device)
    if do_cfg:
        txt, mask = torch.cat([text[0], text[1]], dim=0), torch.cat([text_mask[0], text_mask[1]], dim=0)
    else:
        txt, mask = text[0], text_mask[0]
    b = text.shape[1]
    nb = 2 * b if do_cfg else b
    if latents is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or explicit latents")
        latents = base.prepare_latents(generator, b, pcfg.tokens, m.patch**2 * m.in_channels,
                                       torch.float32, device)
    latents = latents.to(device, torch.float32)
    dpm = dpm_init_state(latents.shape, device)
    cst = cal.init_state(m.depth, nb, pcfg.tokens, m.heads, m.head_dim, torch.float32, device)

    plan = np.zeros((steps, m.depth), np.int32)  # FULL everywhere
    for i in range(steps):
        t = torch.full((nb,), float(sched.timesteps[i]), dtype=torch.float32, device=device)
        x = torch.cat([latents, latents], dim=0) if do_cfg else latents
        out, cst = pixart_forward(params, x.to(m.dtype), t, txt, m, pos_embed=pos, attn=cal,
                                  attn_state=cst, text_mask=mask)
        eps = out[..., : out.shape[-1] // 2]
        if do_cfg:
            eps = base.cfg_combine(eps, pcfg.guidance_scale, 1)
        latents, dpm = dpm_step(sched, i, steps, latents, eps, dpm)
        if i == 0:
            continue  # step 0 stays FULL, as in the reference
        losses = {k: cst[k].cpu().numpy() for k in
                  ("window_loss", "share_loss", "window_cfg_loss", "full_cfg_loss")}
        plan[i] = select_methods(losses["window_loss"], losses["share_loss"], threshold, m.depth,
                                 window_cfg_loss=losses["window_cfg_loss"],
                                 full_cfg_loss=losses["full_cfg_loss"])
    return plan


def save_plan(plan, path: str) -> None:
    """Write a plan as JSON (a list of lists of ints); the JAX package's
    ``load_plan`` reads it, and :func:`load_plan` reads its files."""
    with open(path, "w") as f:
        json.dump(np.asarray(plan).tolist(), f)


def load_plan(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray(json.load(f), np.int32)
