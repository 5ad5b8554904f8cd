"""Shared pipeline machinery (counterpart of ``compactfusion_tpu/pipelines/base.py``).

CFG as a doubled batch or exchanged over the cfg axis (CogVideoX's dynamic
guidance table with it), latent noise from a
``torch.Generator``, EF state carried across step segments, and the
compression schedule, layer-uniform or per-layer (``compress_func``).
Under a mesh each rank holds its share of the latents: batch over dp,
tokens over (ring, ulysses) with the ring index major, as the JAX
package's ``LATENT_SPEC`` shards them; :func:`gather_latents` stands in for
that spec's out_spec and gives every rank the whole latents.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from compactfusion_tpu_torch.parallel.mesh import AXIS_CFG, AXIS_DP, AXIS_RING, AXIS_ULYSSES, Mesh
from compactfusion_tpu_torch.parallel.ring import ring_shift


def seq_shard_info(mesh: Optional[Mesh], ulysses_size: int, ring_size: int):
    """(shard_index, num_shards) of this rank's tokens under the (ring,
    ulysses) sharding."""
    if mesh is None:
        return 0, 1
    idx = mesh.axis_index(AXIS_RING) * ulysses_size + mesh.axis_index(AXIS_ULYSSES)
    return idx, ring_size * ulysses_size


def slice_local_tokens(full: torch.Tensor, mesh: Optional[Mesh], ulysses_size: int,
                       ring_size: int, dim: int = 0) -> torch.Tensor:
    """This rank's token shard of a replicated table (a view)."""
    idx, n = seq_shard_info(mesh, ulysses_size, ring_size)
    local = full.shape[dim] // n
    return full.narrow(dim, idx * local, local)


def cfg_combine(eps: torch.Tensor, guidance_scale, cfg_degree: int,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Classifier-free guidance.  cfg_degree 1: on a [cond; uncond] batch.
    cfg_degree 2: this rank computed the cond (cfg index 0) or the uncond
    (1) prediction; the two exchange over the cfg axis and both form
    ``uncond + g * (cond - uncond)``, so the latents stay the same on both.
    ``guidance_scale`` is a float, or a 0-d fp32 tensor (an entry of
    :func:`dynamic_cfg_table`), which makes the result fp32 as the JAX
    package's promotion does: ``cond - uncond`` in eps's dtype, then fp32."""
    if cfg_degree == 2:
        other = ring_shift((eps,), mesh, AXIS_CFG)[0]
        cond, uncond = (eps, other) if mesh.axis_index(AXIS_CFG) == 0 else (other, eps)
    else:
        cond, uncond = eps.chunk(2, dim=0)
    if isinstance(guidance_scale, torch.Tensor):
        return uncond.float() + guidance_scale.item() * (cond - uncond).float()
    return uncond + guidance_scale * (cond - uncond)


def split_cfg(first: torch.Tensor, second: torch.Tensor, do_cfg: bool, cfg_degree: int,
              mesh: Optional[Mesh]):
    """Two (2, B, ...) [cond, uncond] inputs (text states with their masks or
    pooled vectors) -> this rank's model batch of each: the cfg rank's half
    (cfg_degree 2), [cond; uncond] stacked on the batch axis (a doubled
    batch), or cond alone without CFG."""
    if do_cfg and cfg_degree == 2:
        i = mesh.axis_index(AXIS_CFG)
        return first[i], second[i]
    if do_cfg:
        return torch.cat([first[0], first[1]], dim=0), torch.cat([second[0], second[1]], dim=0)
    return first[0], second[0]


def gather_latents(local: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(B_local, S_local, C) shards -> the whole (B, S, C) on every rank:
    tokens gathered over ulysses then ring, the batch over dp."""
    if mesh is None:
        return local
    x = torch.cat(mesh.all_gather(local, AXIS_ULYSSES), dim=1)
    x = torch.cat(mesh.all_gather(x, AXIS_RING), dim=1)
    return torch.cat(mesh.all_gather(x, AXIS_DP), dim=0)


def gather_batch(local: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(B_local, S, C) -> the whole batch (B, S, C) on every rank, gathered
    over dp (the patch pipelines, whose ranks hold every token)."""
    return local if mesh is None else torch.cat(mesh.all_gather(local, AXIS_DP), dim=0)


def prepare_latents(generator: torch.Generator, batch: int, tokens: int, token_dim: int,
                    dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Standard-normal noise tokens (B, tokens, token_dim), drawn in fp32 on
    the generator's device and moved to ``device``."""
    z = torch.randn((batch, tokens, token_dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return z.to(device=device, dtype=dtype)


def dynamic_cfg_table(guidance_scale: float, timesteps, num_steps: int) -> torch.Tensor:
    """Per-step CogVideoX dynamic-CFG scales: g(t) = 1 + g0 * (1 - cos(pi *
    ((n - t) / n)^5)) / 2 with t the raw timestep value.  Taken on the host
    in float64 and rounded to fp32 once: the phase reaches ~1e7 rad, far
    past fp32's cosine."""
    ts = np.asarray(timesteps, np.float64)
    g = 1.0 + guidance_scale * ((1.0 - np.cos(np.pi * ((num_steps - ts) / num_steps) ** 5.0)) / 2.0)
    return torch.from_numpy(g.astype(np.float32))


def _structure(tree):
    """Container types and ``None`` positions of a state tree (not shapes)."""
    if isinstance(tree, torch.Tensor):
        return "leaf"
    if tree is None:
        return None
    return (type(tree), tuple(_structure(t) for t in tree))


def _has_leaves(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return True
    return tree is not None and any(_has_leaves(t) for t in tree)


def carry_ef_state(prev, make_fresh, device):
    """The EF cache to enter a step segment with: ``prev`` (EF continues
    across the warmup/steady or per-layer-plan boundary) when it has the
    structure of the segment's own state (the same layer segments, the same
    int8 or dense entries), else ``make_fresh(device)``.  That structure is read
    from a build on the "meta" device, so carrying ``prev`` allocates
    nothing."""
    if (prev is not None and _has_leaves(prev)
            and _structure(prev) == _structure(make_fresh(torch.device("meta")))):
        return prev
    return make_fresh(device)


def layer_plan_segments(plans, depth: int):
    """One layer segmentation shared by every step: ``((l0, l1), ...)`` with
    bounds at every layer where any step's plan changes method, so the EF
    state keeps one structure across step segments and carries through."""
    bounds = {0, depth}
    for plan in plans:
        bounds.update(l for l in range(1, depth) if plan[l] != plan[l - 1])
    edges = sorted(bounds)
    return tuple(zip(edges[:-1], edges[1:]))


def compact_layer_segments(compact, num_steps: int, depth: int):
    """``[(plan, [step, ...]), ...]``: contiguous runs of steps that share
    one plan.  ``plan`` is None (compression off), one CompressType for every
    layer, or, with a per-layer ``compress_func``, a tuple of
    ``(method, n_layers)`` segments over the shared segmentation."""
    return _group_by_method(compact, num_steps, depth, lambda plans: _family_plans(plans, 0, depth))


def compact_two_family_segments(compact, num_steps: int, n_first: int, n_second: int):
    """:func:`compact_layer_segments` for a model with two stacked block
    families (FLUX's double then single blocks; a layer index runs over the
    first family, then the second).  With a per-layer ``compress_func`` each
    step's plan is a pair ``(first_segs, second_segs)`` of ``(method,
    n_layers)`` tuples, each family with its own shared segmentation."""
    return _group_by_method(compact, num_steps, n_first + n_second, lambda plans: list(zip(
        _family_plans(plans, 0, n_first), _family_plans(plans, n_first, n_second))))


def _family_plans(plans, lo: int, n: int):
    """Each step's ``(method, n_layers)`` segments of layers ``[lo, lo + n)``
    of its per-layer plan, over one segmentation shared by every step."""
    ranges = layer_plan_segments([plan[lo:lo + n] for plan in plans], n)
    return [tuple((plan[lo + l0], l1 - l0) for l0, l1 in ranges) for plan in plans]


def _group_by_method(compact, num_steps: int, depth: int, per_layer):
    """Each step's plan (``per_layer`` of the steps' per-layer plans with a
    per-layer ``compress_func``, else one CompressType or None), grouped into
    contiguous runs of equal plans.  One rule for the one- and two-family
    pipelines, so their step segmentations cannot diverge."""
    if compact.enabled and compact.compress_func is not None:
        schedule = per_layer([compact.layer_plan(s, depth) for s in range(num_steps)])
    else:
        schedule = [compact.type_at(0, s) if compact.enabled else None for s in range(num_steps)]
    segments = []
    for s, m in enumerate(schedule):
        if segments and segments[-1][0] == m:
            segments[-1][1].append(s)
        else:
            segments.append((m, [s]))
    return segments
