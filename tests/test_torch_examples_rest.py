"""The port's last two examples, ``examples/per_layer_schedule_example.py``
and ``examples/external_usp_example.py``, in one spawn of 4 gloo processes.

The per-layer example runs on ``pixart-tiny`` at ring 2 (ranks 0 and 1)
with the JAX example's ``compress_func`` plan (warmup 2, then the first
layers IDENTITY and BINARY after; ``LOSSLESS_LAYERS`` set to 1 on both
sides, since the tiny model has 2 layers), the JAX runner's spiced weights
carried across in fp32 and its noise: within a tenth of JAX's own distance
from its lossless ring (as tests/test_torch_api.py holds the compressed
runner), equal on both ranks, EF deviation 0.  The external USP example
runs on all 4 ranks at U2 x R2 and meets its 2e-5.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from compactfusion_tpu.config import CompressType as JCompressType
from compactfusion_tpu_torch.examples import external_usp_example
from compactfusion_tpu_torch.parallel import mesh as tmesh
from tests.helpers import rel_err
from tests.test_torch_api import jax_noise, jax_runner
from tests.test_torch_rank_fns import examples_outputs

REPO = Path(__file__).resolve().parent.parent
RING2 = ["--model", "pixart-tiny", "--height", "64", "--width", "64", "--num_inference_steps", "4",
         "--max_sequence_length", "8", "--prompt", "a cat", "--seed", "5", "--ring_degree", "2"]
LOSSLESS_LAYERS = 1


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_per_layer_example",
                                                  REPO / "examples" / "per_layer_schedule_example.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LOSSLESS_LAYERS = LOSSLESS_LAYERS
    return mod


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    """JAX's lossless ring 2 and its per-layer example's runner (the
    example's own config edit), and the port's examples in 4 processes."""
    jax_example = _jax_example()

    def per_layer(engine, inp):  # the JAX example's main, up to the runner
        return dataclasses.replace(engine, compact_config=dataclasses.replace(
            engine.compact_config, enabled=True, compress_type=JCompressType.BINARY,
            warmup_steps=jax_example.WARMUP_STEPS, residual=1, error_feedback=True,
            compress_func=jax_example.compress_func)), inp

    jl, weights = jax_runner(RING2, spice=True)
    jp, _ = jax_runner(RING2 + ["--compact"], spice=True, configure=per_layer)
    jp.pipeline = type(jp.pipeline)(jl.pipeline.params, jl.pipeline.vae_params, jp.pipeline_config,
                                    jp.pipeline.mesh)
    noise = jax_noise(jl)
    want = {"lossless": np.asarray(jl(decode=False)), "per_layer": np.asarray(jp(decode=False))}
    out_dir = tmp_path_factory.mktemp("examples")
    ranks = tmesh.spawn_local(examples_outputs, 4, "gloo", RING2, weights, noise, LOSSLESS_LAYERS, str(out_dir),
                              threads=1, timeout=300)
    return want, ranks, out_dir


def test_per_layer_example_matches_the_jax_example(examples):
    want, ranks, out_dir = examples
    jax_err = rel_err(want["per_layer"], want["lossless"])
    assert jax_err > 0  # the plan's BINARY layer moves the latents
    for r in ranks[:2]:
        assert rel_err(r["latents"], want["per_layer"]) < 0.1 * jax_err
        assert r["consistency_dev"] == 0.0
        np.testing.assert_array_equal(np.load(Path(out_dir, r["saved"])), r["latents"])
    np.testing.assert_array_equal(ranks[0]["latents"], ranks[1]["latents"])
    assert "latents" not in ranks[2] and "latents" not in ranks[3]


def test_external_usp_example_meets_its_bound(examples):
    _, ranks, _ = examples
    errs = [r["usp_rel_err"] for r in ranks]
    assert all(0.0 <= e < external_usp_example.REL_MAX for e in errs), errs
    assert len(set(errs)) == 1  # every rank gathers the same full output
