"""Flow-match Euler discrete scheduler for FLUX
(counterpart of ``compactfusion_tpu/schedulers/flow_match.py``).

The schedule is a static fp32 table on the CPU; the step index is a Python
int and ``step`` is one ``x + (sigma_{i+1} - sigma_i) * v`` in fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class FlowMatchSchedule(NamedTuple):
    sigmas: torch.Tensor  # (N+1,) fp32, sigma_N = 0
    timesteps: torch.Tensor  # (N,) fp32: the model's conditioning values (sigma * 1000)


def flow_match_schedule(num_steps: int, shift: float = 3.0, use_dynamic_shifting: bool = False,
                        mu: Optional[float] = None, num_train_timesteps: int = 1000,
                        final_sigma: Optional[float] = None) -> FlowMatchSchedule:
    """The sigma table: ``linspace(1, final_sigma, N)`` (default final sigma
    ``1 / num_train_timesteps``; the FLUX pipeline passes ``1 / N``), then
    FLUX's dynamic shift by ``mu`` (:func:`calculate_shift`) or the static
    SD3-style ``shift``."""
    if final_sigma is None:
        final_sigma = 1.0 / num_train_timesteps
    sigmas = torch.linspace(1.0, final_sigma, num_steps, dtype=torch.float32)
    if use_dynamic_shifting:
        if mu is None:
            raise ValueError("dynamic shifting requires mu")
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    timesteps = sigmas * num_train_timesteps
    sigmas = torch.cat([sigmas, torch.zeros((1,), dtype=torch.float32)])
    return FlowMatchSchedule(sigmas=sigmas, timesteps=timesteps)


def calculate_shift(image_seq_len: int, base_seq_len: int = 256, max_seq_len: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """FLUX's resolution-dependent mu (diffusers ``calculate_shift``)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def flow_match_step(sched: FlowMatchSchedule, i: int, sample: torch.Tensor,
                    velocity: torch.Tensor) -> torch.Tensor:
    """Euler step x <- x + (sigma_{i+1} - sigma_i) * v in fp32, returned in
    sample.dtype."""
    dt = float(sched.sigmas[i + 1] - sched.sigmas[i])  # an fp32 difference
    return (sample.float() + dt * velocity.float()).to(sample.dtype)


def flow_match_scale_noise(sched: FlowMatchSchedule, i: int, sample: torch.Tensor,
                           noise: torch.Tensor) -> torch.Tensor:
    """The forward process at step i (img2img entry): (1 - sigma) x0 + sigma eps."""
    sigma = float(sched.sigmas[i])
    return ((1.0 - sigma) * sample.float() + sigma * noise).to(sample.dtype)
