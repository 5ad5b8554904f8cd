"""TeaCache / First-Block-Cache: skip the block stack on small step deltas
(counterpart of ``compactfusion_tpu/cache/accel.py``).

* FBCache: run the first block; if the relative-L1 change of its residual
  (block0(x) - x) against the last fully computed step is under the
  threshold, skip the other blocks and replay the cached residual
  (final - first-block output) of that step.
* TeaCache: probe the timestep-modulated input of the first block, pass its
  relative change through a polynomial rescale and accumulate it across
  steps; skip while the accumulator stays under the threshold, reset it on
  every computed step.

The decision is a 0-dim tensor; ``models/pixart.pixart_forward`` reads it on
the host once per step (the eager counterpart of the JAX ``lax.cond``).
Under sequence parallelism the probe's sums run over the (ring, ulysses)
ranks (``sp_axes``, an all-reduce on the mesh), so every rank takes the
same branch.
Incompatible with CompactFusion EF compression: skipped steps would desync
the EF caches, and the pipelines refuse the combination.  Incompatible with
PipeFusion too (:data:`PIPEFUSION_REFUSAL`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

#: why PixArt and FLUX refuse a cache under PipeFusion.  The JAX package
#: runs it, but there each stage runs only its own blocks and passes no
#: activations on, so its pp-2 latents leave its pp-1 latents with the same
#: cache (tests/test_torch_cache_accel.py::test_jax_cache_under_pipefusion_leaves_one_stage)
PIPEFUSION_REFUSAL = ("TeaCache/FBCache does not compose with PipeFusion: the cache probes block 0 to decide "
                      "whether to skip the rest, and block 0 and the rest are not one stage's blocks (the JAX "
                      "package's result there is not its one-process result: ROADMAP.md, Recorded divergences)")


@dataclasses.dataclass(frozen=True)
class CacheAccelConfig:
    mode: str = "none"  # "none" | "fbcache" | "teacache"
    threshold: float = 0.12
    #: polynomial rescale coefficients (highest order first), TeaCache only;
    #: the default is the identity, FLUX uses the fitted polynomial below
    poly: Tuple[float, ...] = (1.0, 0.0)
    #: mesh axes to sum the probe over under sequence parallelism, so
    #: every rank takes the same branch (the pipelines set them)
    sp_axes: Tuple[str, ...] = ()


#: TeaCache's fitted degree-4 rescale polynomial for FLUX (highest order first)
FLUX_TEACACHE_POLY: Tuple[float, ...] = (
    498.651651,
    -283.781631,
    55.8554382,
    -3.82021401,
    0.264230861,
)


class CacheAccelState(NamedTuple):
    prev_probe: torch.Tensor  # previous probe tensor
    residual: torch.Tensor  # cached (final - first_block_out) residual
    accum: torch.Tensor  # () fp32 TeaCache accumulator
    has_prev: torch.Tensor  # () int32
    skips: torch.Tensor  # () int32, number of skipped steps


def init_cache_state(probe_shape, residual_shape, dtype, device=None) -> CacheAccelState:
    return CacheAccelState(
        prev_probe=torch.zeros(probe_shape, dtype=dtype, device=device),
        residual=torch.zeros(residual_shape, dtype=dtype, device=device),
        accum=torch.zeros((), dtype=torch.float32, device=device),
        has_prev=torch.zeros((), dtype=torch.int32, device=device),
        skips=torch.zeros((), dtype=torch.int32, device=device),
    )


def _rel_l1(cur, prev, sp_axes, mesh=None) -> torch.Tensor:
    """sum |cur - prev| / sum |prev|, each sum over every rank of
    ``sp_axes`` (summed apart, then divided, as the JAX ``psum`` does)."""
    num = (cur.float() - prev.float()).abs().sum()
    den = prev.float().abs().sum()
    if sp_axes:
        if mesh is None:
            raise ValueError(f"cache probes summed over {sp_axes} need this rank's mesh")
        sums = torch.stack([num, den])
        for ax in sp_axes:
            sums = mesh.all_reduce_sum(sums, ax)
        num, den = sums[0], sums[1]
    return num / torch.clamp(den, min=1e-8)


def _polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
    """Horner's rule in fp32, as ``jnp.polyval`` evaluates it."""
    c = torch.tensor(coeffs, dtype=torch.float32, device=x.device)
    y = torch.zeros_like(x)
    for i in range(c.shape[0]):
        y = y * x + c[i]
    return y


def should_skip(cfg: CacheAccelConfig, state: CacheAccelState, probe: torch.Tensor,
                force_compute=None, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (skip: 0-dim bool, new_accum).

    ``probe`` is the first-block residual block0(x) - x (fbcache) or the
    modulated first-block input (teacache).  ``force_compute``: a bool (or
    0-dim bool tensor) forcing a full run; the pipelines pass
    ``i == num_steps - 1`` so the final step always computes.  ``mesh``:
    this rank's ``parallel.mesh.Mesh`` when ``cfg.sp_axes`` is not empty.
    """
    rel = _rel_l1(probe, state.prev_probe, cfg.sp_axes, mesh)
    keep = None if force_compute is None else torch.logical_not(
        torch.as_tensor(force_compute, device=rel.device))
    if cfg.mode == "teacache":
        accum = state.accum + _polyval(cfg.poly, rel)
        skip = (state.has_prev > 0) & (accum < cfg.threshold)
        if keep is not None:
            skip = skip & keep
        return skip, torch.where(skip, accum, torch.zeros_like(accum))
    skip = (state.has_prev > 0) & (rel < cfg.threshold)
    if keep is not None:
        skip = skip & keep
    return skip, state.accum


def next_probe(cfg: CacheAccelConfig, state: CacheAccelState, probe, skip) -> torch.Tensor:
    """The prev_probe to carry: FBCache pins it across skipped steps (slow
    drift accumulates against a fixed reference and eventually forces a
    recompute); TeaCache refreshes it every step (its accumulator carries
    the history)."""
    probe = probe.to(state.prev_probe.dtype)
    if cfg.mode == "teacache":
        return probe
    return torch.where(skip, state.prev_probe, probe)
