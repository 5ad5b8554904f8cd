"""Tests of the benchmark harness.  ``card``-marked tests need an NVIDIA GPU
and skip without one; the decision is made inside the ``card`` fixture,
never while a module is imported.  Run them all with

    python -m pytest cfbench/tests -q -n 4
"""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda")


#: each cell's configuration and traffic cut to a size the CPU runs in seconds
TINY = {
    "flux-1024": (
        dict(num_attention_heads=4, attention_head_dim=16, num_layers=2, num_single_layers=2, joint_attention_dim=32,
             pooled_projection_dim=16, axes_dims_rope=[4, 6, 6]),
        dict(height=64, width=64, steps=3, text_tokens=8, pool=3),
    ),
    "hunyuanvideo-544p-129f": (
        dict(num_attention_heads=4, attention_head_dim=16, num_layers=2, num_single_layers=2, text_embed_dim=32,
             pooled_projection_dim=16, rope_axes_dim=[8, 4, 4]),
        dict(height=32, width=48, frames=9, text_tokens=8, text_lengths=[3, 5, 8], pool=3),
    ),
}


def tiny_cell(name, dtype="bfloat16"):
    """The cell of BENCHMARK.json with its configuration and traffic cut to
    :data:`TINY`, in ``dtype``."""
    from cfbench import spec

    cell = spec.load_cell(ROOT, name)
    cfg_cut, traffic_cut = TINY[name]
    cfg = dict(cell.cfg, **cfg_cut, dtype=dtype)
    if "vae" in cfg:
        cfg["vae"] = dict(cfg["vae"], block_out_channels=[8, 8, 16, 16], norm_num_groups=4, layers_per_block=1)
    return dataclasses.replace(cell, cfg=cfg, traffic=dict(cell.traffic, **traffic_cut))


@pytest.fixture
def tiny():
    return tiny_cell
