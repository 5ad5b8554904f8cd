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
              "parallel.usp", "ops.probes", "probes.timing", "probes.flash_parts", "probes.block_parts",
              "models.flux", "pipelines.flux", "schedulers.flow_match", "io.hf", "args", "parallel_api",
              "models.prompt", "models.text_encoders", "io.tokenizers", "utils.logger", "utils.image",
              "utils.prof", "entrypoints.launch", "examples.configs", "examples.pixartalpha_example",
              "examples.flux_example", "models.cogvideox", "models.vae3d", "pipelines.cogvideox",
              "examples.cogvideox_example", "parallel.tp", "parallel.pipefusion", "parallel.vae",
              "pipelines.pixart_patch_pp", "pipelines.flux_patch_pp", "models.sd3", "pipelines.sd3",
              "pipelines.sd3_patch_pp", "models.hunyuandit", "pipelines.hunyuandit", "pipelines.hunyuandit_patch_pp",
              "examples.sd3_example", "examples.hunyuandit_example", "examples.pixartsigma_example",
              "compact.stats", "utils.collector", "models.face", "models.consisid", "pipelines.consisid",
              "models.latte", "pipelines.latte", "models.hunyuanvideo", "pipelines.hunyuanvideo",
              "examples.latte_example", "examples.consisid_example", "examples.hunyuanvideo_example",
              "models.stepvideo", "pipelines.stepvideo", "examples.stepvideo_example", "envs", "eval",
              "eval.metrics", "eval.vgg", "eval.inception", "eval.i3d", "utils.tensor_viz",
              "examples.per_layer_schedule_example", "examples.external_usp_example"):
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


#: JAX modules whose counterpart has another name in the port
PORT_NAMES = {"ops/flash_pallas.py": "ops/flash.py", "ops/quant_pallas.py": "ops/quant.py",
              "ops/ring_flash_pallas.py": "ops/ring_flash.py"}
#: JAX modules left out on purpose (ROADMAP.md's do-not-port list: TPU-only)
DO_NOT_PORT = {"utils/jax_cache.py"}
JAX_MODULES = sorted(str(p.relative_to(REPO / "compactfusion_tpu")) for p in (REPO / "compactfusion_tpu").rglob("*.py"))
JAX_EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("*.py"))


def test_every_jax_module_has_a_counterpart():
    """Each module of ``compactfusion_tpu/`` (and each script of the JAX
    ``examples/``) has its counterpart at the same path in the port, its
    port name in ``PORT_NAMES`` or its place on ``DO_NOT_PORT``."""
    assert not set(PORT_NAMES) & DO_NOT_PORT
    modules = JAX_MODULES + [f"examples/{name}" for name in JAX_EXAMPLES]
    assert len(modules) > 90 and set(PORT_NAMES) | DO_NOT_PORT <= set(modules)
    missing = [m for m in modules
               if m not in DO_NOT_PORT and not (REPO / "compactfusion_tpu_torch" / PORT_NAMES.get(m, m)).is_file()]
    assert missing == []


#: names a JAX ``__init__.py`` exports that the port leaves out on purpose:
#: the JAX mesh machinery its process-group ``Mesh`` replaced
DELIBERATELY_ABSENT = {"parallel": {"MeshSpec", "AXIS_SEQ"}}


def test_package_exports_match_jax():
    """``compactfusion_tpu_torch`` exports the config classes and
    ``make_mesh`` as ``compactfusion_tpu/__init__.py`` does (the port has no
    ``MeshSpec``); ``eval``, ``schedulers``, ``compact``, ``ops``, ``cache``,
    ``parallel`` and ``utils`` export JAX's names, each the port's own
    counterpart, but for :data:`DELIBERATELY_ABSENT`."""
    import importlib

    import compactfusion_tpu

    for name in ("CompactConfig", "EngineConfig", "InputConfig", "ModelConfig", "ParallelConfig", "RuntimeConfig",
                 "make_mesh"):
        assert getattr(compactfusion_tpu, name).__name__ == getattr(compactfusion_tpu_torch, name).__name__
        assert getattr(compactfusion_tpu_torch, name).__module__.startswith("compactfusion_tpu_torch.")
    assert not hasattr(compactfusion_tpu_torch, "MeshSpec")
    for sub in ("eval", "schedulers", "compact", "ops", "cache", "parallel", "utils"):
        jmod = importlib.import_module(f"compactfusion_tpu.{sub}")
        tmod = importlib.import_module(f"compactfusion_tpu_torch.{sub}")
        public = {n for n in dir(jmod) if not n.startswith("_") and not isinstance(getattr(jmod, n), type(jmod))}
        absent = DELIBERATELY_ABSENT.get(sub, set())
        assert absent <= public and not any(hasattr(tmod, n) for n in absent), sub
        assert sorted(n for n in public - absent if not hasattr(tmod, n)) == [], sub
        for n in public - absent:
            got = getattr(tmod, n)
            if callable(got):
                assert got.__module__.startswith("compactfusion_tpu_torch."), (sub, n)
            else:
                assert got == getattr(jmod, n), (sub, n)


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
                                    "tools/time_flash.py", "tools/time_cross_attn.py", "tools/time_chip_smoke.py",
                                    "tools/trace_split.py",
                                    "compactfusion_tpu_torch/probes/flash_parts.py",
                                    "compactfusion_tpu_torch/probes/block_parts.py"])
def test_scripts_import_neither_jax_nor_the_jax_package(script):
    names = _imports(REPO / script)
    if script == "chip_smoke.py":  # its imports sit inside functions: the walk reaches them
        assert "compactfusion_tpu_torch.pipelines.pixart" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "compactfusion_tpu")]
    assert not bad, f"{script} imports {bad}"


@pytest.mark.parametrize(
    "name", ["CompactConfig", "ParallelConfig", "CacheAccelConfig", "ModelConfig", "RuntimeConfig",
             "FastAttnConfig", "InputConfig", "EngineConfig"]
)
def test_config_fields_and_defaults_match_jax(name):
    jmod, tmod = (jaccel, taccel) if name == "CacheAccelConfig" else (jconfig, tconfig)
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jmod, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tmod, name))}
    assert list(jf) == list(tf)
    for key, jd in jf.items():
        td = tf[key]
        if jd is dataclasses.MISSING:  # a default_factory field: compare what each builds
            jd, td = getattr(getattr(jmod, name)(), key), getattr(getattr(tmod, name)(), key)
            if key == "compact_config":  # its CompressType members differ by class
                assert (td.enabled, td.compress_type.value) == (jd.enabled, jd.compress_type.value)
            else:
                assert dataclasses.asdict(td) == dataclasses.asdict(jd), key
        elif isinstance(jd, jconfig.CompressType):
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


def test_engine_helpers_match_jax():
    """``resolve_compress_schedule``, ``validate_against_device_count`` and
    ``round_up`` of the port's ``config.py`` against the JAX package's."""
    for steps, warm in ((6, 2), (3, 4)):
        kw = dict(enabled=True, warmup_steps=warm)
        j = jconfig.resolve_compress_schedule(jconfig.CompactConfig(**kw), steps)
        t = tconfig.resolve_compress_schedule(tconfig.CompactConfig(**kw), steps)
        assert [x.value for x in t] == [x.value for x in j]
    plan = lambda mod: lambda layer, step: mod.CompressType.INT2 if step % 2 else mod.CompressType.WARMUP  # noqa: E731
    assert [x.value for x in tconfig.resolve_compress_schedule(tconfig.CompactConfig(), 4, plan(tconfig))] == \
        [x.value for x in jconfig.resolve_compress_schedule(jconfig.CompactConfig(), 4, plan(jconfig))]
    for par, n in ((dict(ring_degree=4), 8), (dict(ring_degree=4), 2), (dict(ring_degree=3), 8),
                   (dict(ring_degree=2, vae_parallel_size=1), 3), (dict(ring_degree=2, vae_parallel_size=2), 3)):
        errs = []
        for mod in (jconfig, tconfig):
            try:
                mod.validate_against_device_count(mod.ParallelConfig(**par), n)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], (par, n)
    assert [tconfig.round_up(x, 8) for x in (0, 1, 8, 9, 120)] == [jconfig.round_up(x, 8) for x in (0, 1, 8, 9, 120)]
