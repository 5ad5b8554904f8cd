"""DPM-Solver++ 2M and the v-prediction DDIM step on the DDPM schedule
(counterpart of part of ``compactfusion_tpu/schedulers/diffusion.py``).

The schedule tables and the per-step scalars are fp32, as in the JAX
package; the step index is a Python int, so the first/last-step branches
are plain ``if``s; :func:`dpm_step_patch` steps one patch of the latents
with its own state (patch-pipelined PipeFusion).  The CogVideoX variants of the schedule (SNR shift,
zero terminal SNR) are ported, with the DDIM steps (eta 0) for epsilon and
v prediction, and the ancestral DDPM step (:func:`ddpm_step`), whose noise
comes from the caller's ``torch.Generator`` where JAX draws from a
``PRNGKey`` (a recorded divergence; :func:`ddpm_posterior` is the rest of
the step, held against JAX).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class DDPMSchedule(NamedTuple):
    timesteps: torch.Tensor  # (N,) int32, descending
    alphas_cumprod: torch.Tensor  # (T,) fp32 over the 1000 train steps
    final_alpha_cumprod: torch.Tensor  # () fp32


def ddpm_schedule(num_steps: int, num_train_timesteps: int = 1000, beta_start: float = 0.0001,
                  beta_end: float = 0.02, beta_schedule: str = "scaled_linear",
                  set_alpha_to_one: bool = True,
                  timestep_spacing: str = "leading", snr_shift_scale: Optional[float] = None,
                  rescale_zero_snr: bool = False) -> DDPMSchedule:
    """Tables on the CPU (the per-step scalars are read on the host).
    ``snr_shift_scale`` / ``rescale_zero_snr`` are the CogVideoX DDIM
    variants (shift the SNR of the forward process; force terminal SNR 0)."""
    if beta_schedule == "scaled_linear":
        betas = torch.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                               dtype=torch.float32) ** 2
    elif beta_schedule == "linear":
        betas = torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)

    if snr_shift_scale is not None:
        alphas_cumprod = alphas_cumprod / (snr_shift_scale + (1.0 - snr_shift_scale) * alphas_cumprod)
    if rescale_zero_snr:
        # Lin et al. 2023: shift and scale sqrt(alpha_bar) so the last step
        # has SNR exactly 0 while the first is unchanged
        ab = torch.sqrt(alphas_cumprod)
        ab0, abt = ab[0], ab[-1]
        ab = (ab - abt) * ab0 / (ab0 - abt)
        alphas_cumprod = torch.clamp(ab**2, 1e-12, 1.0)

    if timestep_spacing == "leading":
        step = num_train_timesteps // num_steps
        timesteps = (torch.arange(num_steps) * step).flip(0).to(torch.int32)
    elif timestep_spacing == "trailing":
        # numpy's fp32 arange fills start + i * step in fp32 as the JAX
        # package's does; torch's differs from it in the last bit at about
        # half of the N in 1..1000 (48, 96, 112, ...), and rounds elsewhere
        grid = np.arange(num_train_timesteps, 0, -num_train_timesteps / num_steps, dtype=np.float32)
        timesteps = torch.from_numpy(np.round(grid).astype(np.int32)) - 1
    elif timestep_spacing == "linspace":
        # N+1 points over [0, T-1], reversed, dropping the final 0 (the
        # diffusers DPMSolverMultistepScheduler default)
        timesteps = torch.linspace(0.0, num_train_timesteps - 1, num_steps + 1,
                                   dtype=torch.float32).round().flip(0)[:-1].to(torch.int32)
    else:
        raise ValueError(f"unknown timestep spacing {timestep_spacing}")

    final = torch.tensor(1.0) if set_alpha_to_one else alphas_cumprod[0]
    return DDPMSchedule(timesteps, alphas_cumprod, final)


def _alpha_at(sched: DDPMSchedule, t: int) -> torch.Tensor:
    """alphas_cumprod[t]; t < 0 means the final alpha."""
    return sched.alphas_cumprod[t] if t >= 0 else sched.final_alpha_cumprod


def _pred_x0(sample32, eps32, a_t):
    return (sample32 - torch.sqrt(1.0 - a_t).item() * eps32) / torch.sqrt(a_t).item()


def ddim_step(sched: DDPMSchedule, i: int, num_steps: int, sample: torch.Tensor, eps: torch.Tensor,
              num_train_timesteps: int = 1000) -> torch.Tensor:
    """DDIM step (eta 0) for epsilon-prediction models, in fp32."""
    t = int(sched.timesteps[i])
    a_t = _alpha_at(sched, t)
    a_prev = _alpha_at(sched, t - num_train_timesteps // num_steps)
    x32, e32 = sample.float(), eps.float()
    x0 = _pred_x0(x32, e32, a_t)
    out = torch.sqrt(a_prev).item() * x0 + torch.sqrt(1.0 - a_prev).item() * e32
    return out.to(sample.dtype)


def ddim_step_v(sched: DDPMSchedule, i: int, num_steps: int, sample: torch.Tensor, v: torch.Tensor,
                num_train_timesteps: int = 1000) -> torch.Tensor:
    """DDIM step (eta 0) for v-prediction models (the CogVideoX family):
    x0 = sqrt(a) x - sqrt(1 - a) v, eps = sqrt(a) v + sqrt(1 - a) x, in fp32."""
    t = int(sched.timesteps[i])
    a_t = _alpha_at(sched, t)
    a_prev = _alpha_at(sched, t - num_train_timesteps // num_steps)
    x32, v32 = sample.float(), v.float()
    sa, sb = torch.sqrt(a_t).item(), torch.sqrt(1.0 - a_t).item()
    x0 = sa * x32 - sb * v32
    eps = sa * v32 + sb * x32
    out = torch.sqrt(a_prev).item() * x0 + torch.sqrt(1.0 - a_prev).item() * eps
    return out.to(sample.dtype)


def ddpm_posterior(sched: DDPMSchedule, i: int, num_steps: int, sample: torch.Tensor, eps: torch.Tensor,
                   num_train_timesteps: int = 1000):
    """DDPM's posterior q(x_{t-1} | x_t, x0) at step ``i`` (DDPM eq. 7), x0
    predicted from ``eps`` and clipped to [-1, 1]: (the fp32 mean, its
    standard deviation as a float; 0 at the last step)."""
    t = int(sched.timesteps[i])
    t_prev = t - num_train_timesteps // num_steps
    a_t = _alpha_at(sched, t)
    a_prev = _alpha_at(sched, t_prev)
    alpha_t = a_t / a_prev
    beta_t = 1.0 - alpha_t
    x32, e32 = sample.float(), eps.float()
    x0 = torch.clamp(_pred_x0(x32, e32, a_t), -1.0, 1.0)
    coef_x0 = (torch.sqrt(a_prev) * beta_t / (1.0 - a_t)).item()
    coef_xt = (torch.sqrt(alpha_t) * (1.0 - a_prev) / (1.0 - a_t)).item()
    mean = coef_x0 * x0 + coef_xt * x32
    var = torch.clamp(beta_t * (1.0 - a_prev) / (1.0 - a_t), min=1e-20)
    return mean, torch.sqrt(var).item() if t_prev >= 0 else 0.0


def ddpm_step(sched: DDPMSchedule, i: int, num_steps: int, sample: torch.Tensor, eps: torch.Tensor,
              generator: torch.Generator, num_train_timesteps: int = 1000) -> torch.Tensor:
    """One DDPM ancestral step: the posterior mean plus its standard
    deviation times fp32 noise drawn from ``generator`` (on the sample's
    device; no draw at the last step, where the deviation is 0)."""
    mean, std = ddpm_posterior(sched, i, num_steps, sample, eps, num_train_timesteps)
    if std:
        mean = mean + std * torch.randn(sample.shape, generator=generator, dtype=torch.float32,
                                        device=sample.device)
    return mean.to(sample.dtype)


class DPMState(NamedTuple):
    prev_x0: torch.Tensor  # x0 prediction from the previous step
    prev_lambda: torch.Tensor  # () fp32 lambda at the previous step
    have_prev: bool


def dpm_init_state(shape, device=None) -> DPMState:
    return DPMState(
        prev_x0=torch.zeros(shape, dtype=torch.float32, device=device),
        prev_lambda=torch.zeros((), dtype=torch.float32),
        have_prev=False,
    )


def dpm_step(sched: DDPMSchedule, i: int, num_steps: int, sample: torch.Tensor,
             eps: torch.Tensor, state: DPMState):
    """One DPM-Solver++ 2M step (data prediction, multistep order <= 2)."""
    t = int(sched.timesteps[i])
    is_last = i == num_steps - 1
    t_prev = -1 if is_last else int(sched.timesteps[min(i + 1, num_steps - 1)])
    a_t = _alpha_at(sched, t)
    a_next = _alpha_at(sched, t_prev)

    alpha_t, sigma_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
    alpha_n = torch.sqrt(a_next)
    sigma_n = torch.sqrt(1.0 - torch.clamp(a_next, max=1 - 1e-8))
    lam_t = torch.log(alpha_t) - torch.log(torch.clamp(sigma_t, min=1e-10))
    lam_n = torch.log(alpha_n) - torch.log(torch.clamp(sigma_n, min=1e-10))

    x32, e32 = sample.float(), eps.float()
    x0 = (x32 - sigma_t.item() * e32) / alpha_t.item()

    h = lam_n - lam_t
    if state.have_prev and not is_last:
        r = (lam_t - state.prev_lambda) / (h if h != 0 else torch.tensor(1e-10))
        c = (1.0 / (2.0 * r)).item()
        d = (1.0 + c) * x0 - c * state.prev_x0
    else:
        d = x0
    out = (sigma_n / sigma_t).item() * x32 - (alpha_n * torch.expm1(-h)).item() * d
    return out.to(sample.dtype), DPMState(prev_x0=x0, prev_lambda=lam_t, have_prev=True)


def dpm_step_patch(sched: DDPMSchedule, i: int, num_steps: int, sample: torch.Tensor, eps: torch.Tensor,
                   prev_x0: torch.Tensor, prev_lambda: torch.Tensor, have_prev: bool):
    """:func:`dpm_step` on a slice of the latents with its own scalar state:
    the patch-pipelined PipeFusion advances each image patch through the
    schedule on its own (reference patch-gated scheduler wrappers).  Returns
    (new sample, this step's x0, this step's lambda)."""
    out, st = dpm_step(sched, i, num_steps, sample, eps,
                       DPMState(prev_x0=prev_x0, prev_lambda=prev_lambda, have_prev=have_prev))
    return out, st.prev_x0, st.prev_lambda
