"""The banded VAE decode on separate ranks (``parallel/vae.py``) vs the JAX
decoders, and the VAE ranks through ``xDiTParallel``.

One spawn of 4 gloo processes.  The tiny VAE decodes a (1, 16, 8, 4) latent
in 2 and 4 height bands (``tests/core/test_parallel_vae.py``): in fp32
within 3e-5 of JAX's ``vae_decode`` and of the port's one-process decode,
in bf16 within 0.04.  Then the runners from command lines, with their own
seeded weights and fixed noise: PixArt-tiny at Ulysses 2, and with
``--vae_parallel_size 2`` (4 processes): rank 0's image within 2e-2 of the
replicated decode and 2e-3 in the mean (``tests/core/test_parallel_api.
py::test_vae_parallel_size_through_api``), the other ranks hold no image
and ``save`` writes nothing there.  FLUX and CogVideoX have no VAE-rank
path, as in the JAX package: their tail ranks stay idle and the DiT ranks
decode the image of the run without them, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.models import vae as jvae
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import vae as tvae
from compactfusion_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_rank_fns import vae_outputs

BANDS = [(2, "fp32"), (4, "fp32"), (4, "bf16")]
TINY = ["--height", "64", "--width", "64", "--num_inference_steps", "2", "--max_sequence_length", "8",
        "--prompt", "a cat", "--seed", "5"]
U2 = ["--ulysses_degree", "2"]
VAE2 = ["--vae_parallel_size", "2"]
VIDEO = ["--model", "cogvideox-tiny", "--height", "32", "--width", "48", "--num_frames", "9",
         "--num_inference_steps", "2", "--max_sequence_length", "8", "--prompt", "a cat", "--seed", "5"]


def _noise(shape):
    return np.random.default_rng(4).standard_normal(shape).astype(np.float32)


RUNS = [("pixart-u2", ["--model", "pixart-tiny"] + TINY + U2, _noise((1, 16, 16))),
        ("pixart-u2-vae2", ["--model", "pixart-tiny"] + TINY + U2 + VAE2, _noise((1, 16, 16))),
        ("flux-u2", ["--model", "flux-tiny"] + TINY + U2, _noise((1, 16, 16))),
        ("flux-u2-vae2", ["--model", "flux-tiny"] + TINY + U2 + VAE2, _noise((1, 16, 16))),
        ("cogvideox-u2", VIDEO + U2, _noise((1, 18, 64))),
        ("cogvideox-u2-vae2", VIDEO + U2 + VAE2, _noise((1, 18, 64)))]


@pytest.fixture(scope="module")
def decoder():
    cfg = dataclasses.replace(jvae.tiny_vae(), dtype=jnp.float32)
    params = jvae.init_vae_decoder(jax.random.PRNGKey(0), cfg)
    lat = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 16, 8, cfg.latent_channels), jnp.float32))
    return jax.tree_util.tree_map(np.asarray, params), lat


@pytest.fixture(scope="module")
def spawned(decoder):
    params, lat = decoder
    return tmesh.spawn_local(vae_outputs, 4, "gloo", (BANDS, params, lat), RUNS, threads=1, timeout=600)


@pytest.mark.parametrize("bands,dtype", BANDS, ids=[f"{n}-{d}" for n, d in BANDS])
def test_banded_decode_matches_jax(spawned, decoder, bands, dtype):
    params, lat = decoder
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jcfg = dataclasses.replace(jvae.tiny_vae(), dtype=jdt)
    ref = np.asarray(jvae.vae_decode(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(lat), jcfg), np.float32)
    tcfg = dataclasses.replace(tvae.tiny_vae(), dtype=tdt)
    one = tvae.vae_decode(params_from_numpy(params, dtype=tdt), torch.from_numpy(lat), tcfg).float().numpy()
    got = np.concatenate([r[0][bands, dtype] for r in spawned[:bands]], axis=1)
    assert got.shape == ref.shape == (1, 32, 16, 3)
    atol = 3e-5 if dtype == "fp32" else 0.04
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    np.testing.assert_allclose(got, one, atol=atol, rtol=0)
    for r in spawned[bands:]:
        assert r[0][bands, dtype] is None


def test_vae_ranks_through_the_runner(spawned):
    """--vae_parallel_size 2: the image reaches rank 0 alone, within the
    JAX test's bounds of the replicated decode; the other ranks return
    None and ``save`` writes nothing there."""
    ref = spawned[0][1]["pixart-u2"][0]
    assert ref.shape == (1, 16, 16, 3)
    img, saved, files = spawned[0][1]["pixart-u2-vae2"]
    assert img.shape == ref.shape and img.dtype == ref.dtype
    np.testing.assert_allclose(img, ref, atol=2e-2, rtol=0)
    assert np.abs(img - ref).mean() < 2e-3
    assert saved and files == ["cftpu_rank0_0.png"]
    for r in spawned[1:]:
        assert r[1]["pixart-u2-vae2"] == (None, False, [])
    # without VAE ranks every rank decodes the same image and saves it
    np.testing.assert_array_equal(spawned[1][1]["pixart-u2"][0], ref)
    assert spawned[1][1]["pixart-u2"][2] == ["cftpu_rank1_0.png"]


@pytest.mark.parametrize("family", ["flux", "cogvideox"])
def test_vae_ranks_idle_without_a_vae_rank_path(spawned, family):
    """FLUX and CogVideoX decode on the DiT ranks, as the JAX pipelines
    ignore the VAE tail: the same outputs as without it; the tail ranks
    hold none and save nothing."""
    for rank in (0, 1):
        with_tail, without = spawned[rank][1][f"{family}-u2-vae2"], spawned[rank][1][f"{family}-u2"]
        np.testing.assert_array_equal(with_tail[0], without[0])
        assert with_tail[1]
    for rank in (2, 3):
        assert spawned[rank][1][f"{family}-u2-vae2"] == (None, False, [])
