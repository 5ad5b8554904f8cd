"""The patch-pipelined PipeFusion across gloo processes vs the JAX patch
pipelines on the CPU mesh (fp32 tiny configs; the same inputs and noise).

One spawn of 4 gloo processes: PixArt pp2 with M = 4 micro-patches and 2
sync warmup steps, the same under Ulysses 2 (the cache sharded by heads),
and M = pp = 2 after 1 warmup step (the entry point's default); FLUX pp2
with M = 4 over the 2*pp-deep virtual pipeline; the one-process sync runs
they approximate; and the staleness-decay runs of ``tests/models/
test_pixart.py::test_patch_pipelined_error_decays_with_steps`` (pp2 M4
warmup 2 at 4, 8 and 12 steps, each against one process).

Bounds: every patch run within 2e-4 relative of JAX's patch pipeline (the
latent write is JAX's ``full + (new - full)``), and, as JAX asserts, more
than 1e-6 and less than 0.3 from the sync result (the stale K/V is used);
the Ulysses run equal to the pp-only run up to fp32 order; the staleness
error's increments shrink along the trajectory.
"""

import functools

import numpy as np
import pytest

from compactfusion_tpu.config import ParallelConfig as JParallel
from tests.helpers import rel_err
from tests.test_torch_pipefusion import jax_models, jax_sample, job, ranks_of, spawn_beside
from tests.test_torch_rank_fns import parallel_pipeline_latents

BOUND = 2e-4
M4W2 = dict(num_pipeline_patch=4, runtime_warmup_steps=2)
DECAY_STEPS = (4, 8, 12)
CONFIGS = {
    "pixart": [("one-6", {}, None, dict(num_steps=6)),
               ("pp2-M4w2", dict(pp_degree=2), None, dict(M4W2, num_steps=6)),
               ("pp2u2-M4w2", dict(pp_degree=2, ulysses_degree=2), None, dict(M4W2, num_steps=6)),
               ("one-4", {}, None, {}),
               ("pp2-M2w1", dict(pp_degree=2), None, dict(num_pipeline_patch=2, runtime_warmup_steps=1))]
    + [(f"decay-{n}", dict(pp_degree=2), None, dict(M4W2, num_steps=n)) for n in DECAY_STEPS]
    + [(f"one-{n}", {}, None, dict(num_steps=n)) for n in DECAY_STEPS[1:]],
    "flux": [("one-6", {}, None, dict(num_steps=6)),
             ("pp2-M4w2", dict(pp_degree=2), None, dict(M4W2, num_steps=6))],
}
MODEL_KW = {"pixart": {}, "flux": {}}
# (family, patch run, its sync run)
PATCH = [("pixart", "pp2-M4w2", "one-6"), ("pixart", "pp2u2-M4w2", "one-6"), ("pixart", "pp2-M2w1", "one-4"),
         ("flux", "pp2-M4w2", "one-6")]


@pytest.fixture(scope="module")
def models():
    return jax_models(MODEL_KW)


@pytest.fixture(scope="module")
def spawned(models, jax_latents):
    jobs = {family: job(models, family, configs, MODEL_KW) for family, configs in CONFIGS.items()}
    return spawn_beside(parallel_pipeline_latents, 4, (jobs,),
                        lambda: [jax_latents(f, name) for f, n, sync in PATCH for name in (n, sync)])


@pytest.fixture(scope="module")
def jax_latents(models):
    @functools.lru_cache(maxsize=None)
    def run(family, name):
        _, par, compact, extra = {c[0]: c for c in CONFIGS[family]}[name]
        extra = dict(extra)
        return jax_sample(models, family, par, compact, steps=extra.pop("num_steps", 4), **extra)

    return run


@pytest.mark.parametrize("family,name,sync", PATCH, ids=[f"{f}-{n}" for f, n, _ in PATCH])
def test_patch_pipeline_matches_jax(spawned, jax_latents, family, name, sync):
    ref = jax_latents(family, name)
    par = {c[0]: c for c in CONFIGS[family]}[name][1]
    got = ranks_of(spawned, family, name)
    assert len(got) == JParallel(**par).world_size
    one = spawned[0][family, sync][0]
    assert rel_err(one, jax_latents(family, sync)) < BOUND
    for rank, (lat, _) in enumerate(got):
        assert np.isfinite(lat).all()
        assert rel_err(lat, ref) < BOUND, rank
        # the stale K/V is used: not the sync result, but close to it
        assert 1e-6 < rel_err(lat, one) < 0.3, rank
        np.testing.assert_array_equal(lat, got[0][0])


def test_patch_pipeline_under_ulysses_matches_pp_only(spawned):
    """The cache sharded by heads computes what the pp-only pipeline
    computes (tests/models/test_pixart.py's
    ``test_patch_pipelined_pipefusion_with_ulysses``)."""
    a = ranks_of(spawned, "pixart", "pp2u2-M4w2")[0][0]
    b = ranks_of(spawned, "pixart", "pp2-M4w2")[0][0]
    assert rel_err(a, b) < 1e-5


def test_patch_pipeline_error_decays_with_steps(spawned):
    """The staleness error falls along the trajectory: its increments
    shrink as the per-step updates do (``test_patch_pipelined_error_decays
    _with_steps``, run on the port)."""
    errs = []
    for n in DECAY_STEPS:
        patch = ranks_of(spawned, "pixart", f"decay-{n}")[0][0]
        errs.append(rel_err(patch, spawned[0]["pixart", f"one-{n}"][0]))
    assert all(e > 1e-7 for e in errs), errs
    assert errs[2] - errs[1] < 0.7 * (errs[1] - errs[0]), errs
    assert errs[2] < 0.05, errs
