"""The port's FLUX checkpoint converter (``io/hf.py::convert_flux``):

* equal to the JAX package's ``convert_flux`` bit for bit, in fp32 and
  bf16, on the state dict of ``tests/torch_ref.py::FluxRef`` (the diffusers
  ``FluxTransformer2DModel`` layout);
* the port's ``flux_forward`` on the converted weights against ``FluxRef``
  itself at 2e-4 (the fp32 bound of tests/io/test_backbone_parity.py);
* every key of the official FLUX.1-dev inventory
  (``tests/io/fixtures/flux.1-dev.keys.txt``: 19 double and 38 single
  blocks, 1160 tensors) read by the converter, and the converted tree that
  of ``init_flux``.  The names are the inventory's; each width is divided
  by 32 (3072 -> 96, head dim 128 -> 4) except the packed latent's 64
  channels and the 256 of the timestep sinusoid, so the whole depth
  converts in a few MB.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.io import hf as jhf
from compactfusion_tpu.models import flux as jflux
from compactfusion_tpu_torch.io import hf as thf
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import flux as tflux
from tests import torch_ref
from tests.io.test_real_keymaps import TrackingState
from tests.helpers import rel_err

BOUND = 2e-4
KEYS = Path(__file__).resolve().parent / "io" / "fixtures" / "flux.1-dev.keys.txt"
TINY = dict(dim=64, double_layers=2, single_layers=2, heads=4, in_channels=16, text_dim=32, pooled_dim=16,
            axes_dim=(4, 6, 6))


def _ref(guidance):
    torch.manual_seed(2)
    ref = torch_ref.FluxRef(**TINY, guidance=guidance).eval()
    return ref, {k: v.detach().numpy() for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("guidance", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_flux_matches_jax_bit_for_bit(guidance, dtype):
    _, state = _ref(guidance)
    jcfg = jflux.FluxConfig(**TINY, guidance_embeds=guidance, dtype=getattr(jnp, dtype))
    tcfg = tflux.FluxConfig(**TINY, guidance_embeds=guidance, dtype=getattr(torch, dtype))
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float32), jhf.convert_flux(state, jcfg))
    tp = thf.convert_flux(state, tcfg)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, tp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, jp))
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree_util.tree_leaves(jp)):
        assert t.dtype == getattr(torch, dtype), path
        np.testing.assert_array_equal(t.float().numpy(), j, err_msg=str(path))


@pytest.mark.parametrize("guidance", [True, False])
def test_port_forward_on_converted_weights_matches_flux_ref(guidance):
    ref, state = _ref(guidance)
    cfg = tflux.FluxConfig(**TINY, guidance_embeds=guidance, dtype=torch.float32)
    params = thf.convert_flux(state, cfg)
    rng = np.random.default_rng(3)
    hp = wp = 4
    img = rng.standard_normal((2, hp * wp, 16)).astype(np.float32)
    txt = rng.standard_normal((2, 5, 32)).astype(np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    t = np.array([311.0, 820.0], np.float32)
    g = torch.tensor([3500.0, 3500.0]) if guidance else None
    img_pos = tflux.flux_image_positions(hp, wp)
    txt_pos = torch.zeros((5, 3), dtype=torch.int64)
    with torch.no_grad():
        want = ref(torch.from_numpy(img), torch.from_numpy(txt), torch.from_numpy(pooled), torch.from_numpy(t),
                   g, img_pos, txt_pos).numpy()
        out, _, _ = tflux.flux_forward(params, torch.from_numpy(img), torch.from_numpy(txt),
                                       torch.from_numpy(pooled), torch.from_numpy(t), g, cfg,
                                       img_rope=tcm.rope_frequencies(img_pos, cfg.axes_dim),
                                       txt_rope=tcm.rope_frequencies(txt_pos, cfg.axes_dim))
    assert rel_err(out.numpy(), want) < BOUND


def _scaled(n: int) -> int:
    return n if n in (64, 256) else n // 32


def test_convert_flux_reads_every_key_of_the_flux1_dev_inventory():
    lines = [ln.split() for ln in KEYS.read_text().splitlines() if ln and not ln.startswith("#")]
    shapes = {name: tuple(_scaled(int(d)) for d in dims.split(",")) for name, dims in lines}
    assert len(shapes) == 1160
    cfg = dataclasses.replace(tflux.flux_dev(), dim=96, text_dim=128, pooled_dim=24, dtype=torch.float32)
    assert (cfg.head_dim, cfg.double_layers, cfg.single_layers, cfg.in_channels) == (4, 19, 38, 64)
    state = TrackingState(shapes)
    params = thf.convert_flux(state, cfg)
    assert not set(state) - state.read, sorted(set(state) - state.read)[:10]
    init = tflux.init_flux(torch.Generator().manual_seed(0), cfg)
    shape_of = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shape_of(params) == shape_of(init)
