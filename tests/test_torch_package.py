"""Package-level checks of the PyTorch port: it never imports JAX, its
configuration matches the JAX package's, and weights carry over."""

import ast
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import compactfusion_tpu_torch
from compactfusion_tpu import config as jconfig
from compactfusion_tpu.cache import accel as jaccel
from compactfusion_tpu_torch import config as tconfig
from compactfusion_tpu_torch.cache import accel as taccel
from compactfusion_tpu_torch.io.from_jax import params_from_numpy

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(compactfusion_tpu_torch.__path__, "compactfusion_tpu_torch.")
    )


def test_importing_every_module_leaves_jax_out():
    mods = _modules()
    for m in ("pipelines.pixart", "compact.lowrank", "compact.codecs", "ops.quant", "cache.accel",
              "cache.fast_attn", "ops.merge", "ops.ring_flash", "parallel.mesh", "parallel.ring",
              "parallel.usp", "ops.probes", "probes.timing", "probes.flash_parts", "probes.block_parts"):
        assert f"compactfusion_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'compactfusion_tpu' or m.startswith('compactfusion_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    """Every module an ``import``/``from ... import`` names in a file, at any
    depth (inside functions too)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    return names


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/profile_torch.py", "tools/compare_kernel_builds.py",
                                    "compactfusion_tpu_torch/probes/flash_parts.py",
                                    "compactfusion_tpu_torch/probes/block_parts.py"])
def test_scripts_import_neither_jax_nor_the_jax_package(script):
    names = _imports(REPO / script)
    if script == "chip_smoke.py":  # its imports sit inside functions: the walk reaches them
        assert "compactfusion_tpu_torch.pipelines.pixart" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "compactfusion_tpu")]
    assert not bad, f"{script} imports {bad}"


@pytest.mark.parametrize(
    "name", ["CompactConfig", "ParallelConfig", "CacheAccelConfig"]
)
def test_config_fields_and_defaults_match_jax(name):
    jmod, tmod = (jaccel, taccel) if name == "CacheAccelConfig" else (jconfig, tconfig)
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jmod, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tmod, name))}
    assert list(jf) == list(tf)
    for key, jd in jf.items():
        td = tf[key]
        if isinstance(jd, jconfig.CompressType):
            assert td.value == jd.value, key
        else:
            assert td == jd, key


def test_compress_types_and_validation_match_jax():
    assert [t.value for t in jconfig.CompressType] == [t.value for t in tconfig.CompressType]
    for bad in (dict(residual=3), dict(residual=0), dict(residual=2, error_feedback=False),
                dict(comp_rank=0)):
        with pytest.raises(ValueError):
            jconfig.CompactConfig(**bad)
        with pytest.raises(ValueError):
            tconfig.CompactConfig(**bad)
    for par in (dict(ulysses_degree=3), dict(ring_degree=3), dict(pp_degree=5)):
        kw = dict(heads=16, tokens=1024, depth=28, family="pixart")
        with pytest.raises(ValueError) as jerr:
            jconfig.validate_parallel_geometry(jconfig.ParallelConfig(**par), **kw)
        with pytest.raises(ValueError) as terr:
            tconfig.validate_parallel_geometry(tconfig.ParallelConfig(**par), **kw)
        assert str(jerr.value) == str(terr.value)


def test_params_from_numpy_keeps_bf16_bits_and_tree():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4, 5)).astype(ml_dtypes.bfloat16)
    tree = {"blocks": {"w": w, "b": np.zeros(5, np.float32)},
            "up": [{"conv": np.asarray(jnp.ones((2, 2), jnp.bfloat16))}], "n": np.int32(7)}
    out = params_from_numpy(tree)
    assert out["blocks"]["w"].dtype == torch.bfloat16 and out["blocks"]["w"].shape == (3, 4, 5)
    np.testing.assert_array_equal(out["blocks"]["w"].view(torch.int16).numpy(), w.view(np.int16))
    assert isinstance(out["up"], list) and out["up"][0]["conv"].dtype == torch.bfloat16
    assert out["n"].dtype == torch.int32
    as32 = params_from_numpy(tree, dtype=torch.float32)
    assert as32["blocks"]["w"].dtype == torch.float32 and as32["n"].dtype == torch.int32
    np.testing.assert_array_equal(as32["blocks"]["w"].numpy(), w.astype(np.float32))
