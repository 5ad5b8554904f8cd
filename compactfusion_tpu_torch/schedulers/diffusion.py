"""DPM-Solver++ 2M on the DDPM schedule
(counterpart of part of ``compactfusion_tpu/schedulers/diffusion.py``).

The schedule tables and the per-step scalars are fp32, as in the JAX
package; the step index is a Python int, so the first/last-step branches
are plain ``if``s.  DDIM/DDPM steppers and the CogVideoX schedule variants
are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DDPMSchedule(NamedTuple):
    timesteps: torch.Tensor  # (N,) int32, descending
    alphas_cumprod: torch.Tensor  # (T,) fp32 over the 1000 train steps
    final_alpha_cumprod: torch.Tensor  # () fp32


def ddpm_schedule(num_steps: int, num_train_timesteps: int = 1000, beta_start: float = 0.0001,
                  beta_end: float = 0.02, beta_schedule: str = "scaled_linear",
                  set_alpha_to_one: bool = True,
                  timestep_spacing: str = "leading") -> DDPMSchedule:
    """Tables on the CPU (the per-step scalars are read on the host)."""
    if beta_schedule == "scaled_linear":
        betas = torch.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                               dtype=torch.float32) ** 2
    elif beta_schedule == "linear":
        betas = torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)

    if timestep_spacing == "leading":
        step = num_train_timesteps // num_steps
        timesteps = (torch.arange(num_steps) * step).flip(0).to(torch.int32)
    elif timestep_spacing == "trailing":
        timesteps = torch.round(
            torch.arange(num_train_timesteps, 0, -num_train_timesteps / num_steps)
        ).to(torch.int32) - 1
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
