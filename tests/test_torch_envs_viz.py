"""The port's environment registry (``envs.py``), the DDPM ancestral step
(``schedulers/diffusion.py::ddpm_step``) and the offline plots
(``utils/tensor_viz.py``) against the JAX package's."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu import envs as jenvs
from compactfusion_tpu.schedulers import diffusion as jdiff
from compactfusion_tpu.utils import tensor_viz as jviz
from compactfusion_tpu_torch import envs
from compactfusion_tpu_torch.schedulers import diffusion as tdiff
from compactfusion_tpu_torch.utils import tensor_viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# envs
# ---------------------------------------------------------------------------


def test_envs_registry(monkeypatch):
    """Lazy registry + capability probing (reference envs.py:22-129), as
    tests/core/test_observability.py::test_envs_registry holds JAX's."""
    monkeypatch.setenv("CFTPU_LOGGING_LEVEL", "DEBUG")
    assert envs.CFTPU_LOGGING_LEVEL == jenvs.CFTPU_LOGGING_LEVEL == "DEBUG"
    monkeypatch.delenv("CFTPU_LOGGING_LEVEL")
    monkeypatch.setenv("XDIT_LOGGING_LEVEL", "WARNING")  # reference fallback
    assert envs.CFTPU_LOGGING_LEVEL == jenvs.CFTPU_LOGGING_LEVEL == "WARNING"
    monkeypatch.delenv("XDIT_LOGGING_LEVEL")
    assert envs.CFTPU_LOGGING_LEVEL == "INFO"
    monkeypatch.setenv("CFTPU_COLLECT_DIR", "/x")
    assert envs.CFTPU_COLLECT_DIR == jenvs.CFTPU_COLLECT_DIR == "/x"
    # torchrun's variables take the place of JAX's PROCESS_ID & co.
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
        assert getattr(envs, name) is None
        monkeypatch.setenv(name, "3")
        assert getattr(envs, name) == 3
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert (envs.MASTER_ADDR, envs.MASTER_PORT) == ("localhost", "29500")
    for gone in ("NOT_A_VAR", "CFTPU_JAX_CACHE_DIR", "JAX_PLATFORMS", "PROCESS_ID"):
        with pytest.raises(AttributeError):
            getattr(envs, gone)

    info = envs.PACKAGES_CHECKER.get_env_info()
    assert envs.PackagesEnvChecker() is envs.PACKAGES_CHECKER
    assert info["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert info["device_count"] >= 1 and info["torch_version"] == torch.__version__
    assert isinstance(info["has_nvcc"], bool)
    assert envs.PACKAGES_CHECKER.check_platform(info["platform"])


def test_readers_go_through_the_registry(monkeypatch, tmp_path):
    """The logger's level, the collector's directory and torchrun's
    variables in ``init_distributed_environment`` read ``envs``."""
    from compactfusion_tpu_torch.parallel import mesh
    from compactfusion_tpu_torch.utils import collector, logger

    monkeypatch.setenv("CFTPU_LOGGING_LEVEL", "error")
    assert logger._level() == 40
    monkeypatch.setenv("CFTPU_COLLECT_DIR", str(tmp_path))
    assert collector.enabled()
    collector.collect(torch.ones(2), "t", step=0, layer=1, rank=0)
    assert os.path.exists(tmp_path / "t_s0_l1_r0.npy")
    monkeypatch.setenv("CFTPU_COLLECT_DIR", "")
    assert not collector.enabled()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_distributed_environment("gloo", "cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# ddpm_step
# ---------------------------------------------------------------------------


def _problem(n, spacing="leading"):
    """tests/core/test_schedulers.py's denoising problem: x0 known, the
    exact eps oracle."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 8)).astype(np.float32)
    eps = rng.standard_normal((4, 8)).astype(np.float32)
    sched = tdiff.ddpm_schedule(n, timestep_spacing=spacing)
    a0 = float(sched.alphas_cumprod[int(sched.timesteps[0])])
    x = (np.sqrt(a0) * x0 + np.sqrt(1 - a0) * eps).astype(np.float32)
    return sched, jdiff.ddpm_schedule(n, timestep_spacing=spacing), x0, x


def test_ddpm_step_matches_jax_but_for_the_noise():
    """Every step's posterior mean and deviation against JAX's step, with
    JAX's own noise put in (the port draws from a torch.Generator, a
    recorded divergence): 1e-6."""
    n = 10
    sched, jsched, x0, x = _problem(n)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(0)
    for i in range(n):
        eps = rng.standard_normal(x.shape).astype(np.float32)
        key, k = jax.random.split(key)
        want = np.array(jdiff.ddpm_step(jsched, jnp.int32(i), n, jnp.asarray(x), jnp.asarray(eps), k))
        noise = np.array(jax.random.normal(k, x.shape, jnp.float32))
        mean, std = tdiff.ddpm_posterior(sched, i, n, torch.from_numpy(x), torch.from_numpy(eps))
        got = (mean + std * torch.from_numpy(noise)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert (std == 0.0) == (i == n - 1)
        x = want


def test_ddpm_step_noise_from_the_generator_and_converges():
    n = 25
    sched, _, x0, x = _problem(n)
    xt = torch.from_numpy(x)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    eps = lambda x, t: (x - sched.alphas_cumprod[t].sqrt() * torch.from_numpy(x0)) / (1 - sched.alphas_cumprod[t]).sqrt()  # noqa: E731
    mean, std = tdiff.ddpm_posterior(sched, 0, n, xt, eps(xt, int(sched.timesteps[0])))
    step = tdiff.ddpm_step(sched, 0, n, xt, eps(xt, int(sched.timesteps[0])), g1)
    torch.testing.assert_close(step, mean + std * torch.randn(x.shape, generator=g2), rtol=0, atol=0)
    for i in range(n):
        xt = tdiff.ddpm_step(sched, i, n, xt, eps(xt, int(sched.timesteps[i])), g1)
    # ancestral sampling injects noise: a loose bound, as JAX's test holds
    assert float(torch.linalg.vector_norm(xt - torch.from_numpy(x0)) / np.linalg.norm(x0)) < 0.35


# ---------------------------------------------------------------------------
# tensor_viz
# ---------------------------------------------------------------------------


def _nonempty_png(path):
    assert os.path.isfile(path), path
    assert os.path.getsize(path) > 1000, path
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_write_pngs(tmp_path):
    rng = np.random.default_rng(0)
    for shape in [(64,), (32, 16), (2, 1024, 4, 72)]:
        _nonempty_png(tensor_viz.plot_3d(rng.normal(size=shape), f"t{len(shape)}",
                                         str(tmp_path / f"t{len(shape)}.png")))
    p = tensor_viz.plot_low_rank_factors(rng.normal(size=(128, 4)), rng.normal(size=(4, 96)), key="12-0-k",
                                         step=7, save_dir=str(tmp_path))
    _nonempty_png(p)
    assert "12-0-k_step7" in os.path.basename(p)
    sv = np.sort(rng.random(32))[::-1]
    spectra = {"flat-key": [sv.tolist(), (sv * 2).tolist()],
               "grouped-key": [[sv.tolist(), sv.tolist()], [sv.tolist(), sv.tolist()]]}
    paths = tensor_viz.plot_eigenvalue_cumsum(spectra, save_dir=str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jviz.plot_eigenvalue_cumsum(
        spectra, save_dir=str(tmp_path / "jax"))]
    for p in paths:
        _nonempty_png(p)


def test_cli_reads_the_collector_and_the_stats_dump(tmp_path):
    """The port's collector files and ``StatsLogger.dump_eigenvalues`` JSON
    through ``python -m compactfusion_tpu_torch.utils.tensor_viz``."""
    from compactfusion_tpu_torch.compact.stats import StatsLogger, log_spectrum_inside_jit
    from compactfusion_tpu_torch.utils import collector

    rng = np.random.default_rng(3)
    dump = tmp_path / "dump"
    os.environ["CFTPU_COLLECT_DIR"] = str(dump)
    collector._SEQ.clear()
    try:
        collector.collect(torch.from_numpy(rng.normal(size=(1, 64, 2, 8))), "k", step=0, layer=1, rank=0)
        collector.collect(torch.from_numpy(rng.normal(size=(1, 16, 8))), "latents", rank=0)
    finally:
        del os.environ["CFTPU_COLLECT_DIR"]
        collector._SEQ.clear()
    (dump / "ignore.txt").write_text("not a tensor")
    StatsLogger.reset()
    logger = StatsLogger.instance()
    for _ in range(2):
        log_spectrum_inside_jit("k", torch.from_numpy(rng.normal(size=(32, 16))).float(), top_k=8)
    spectra = tmp_path / "spectra.json"
    assert logger.dump_eigenvalues(str(spectra), depth=1)["_shapes"] == {"k": [32, 16]}
    StatsLogger.reset()
    out = tmp_path / "viz"
    proc = subprocess.run([sys.executable, "-m", "compactfusion_tpu_torch.utils.tensor_viz", "--collect_dir",
                           str(dump), "--eigenvalues", str(spectra), "--out", str(out),
                           "--names", "k", "latents"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    wrote = sorted(os.listdir(out))
    assert {"3d_k_s0_l1_r0.png", "3d_latents_n00000_r0.png", "svcumsum_k.png"} <= set(wrote)
    for w in wrote:
        _nonempty_png(str(out / w))


def test_empty_first_entry_is_skipped_where_jax_raises(tmp_path):
    """Recorded divergence (a): an empty spectrum or step group is skipped;
    JAX's layout sniffing (tensor_viz.py:141) raises IndexError on it."""
    sv = np.sort(np.random.default_rng(4).random(16))[::-1].tolist()
    for rows in ([[], sv, sv], [[], [sv, [], sv]]):
        with pytest.raises(IndexError):
            jviz.plot_eigenvalue_cumsum({"k": rows}, save_dir=str(tmp_path / "jax"))
        e = tensor_viz.energy_curves(rows)
        assert [label for label, _ in e["curves"]] == (["#1", "#2"] if len(rows) == 3 else ["s1l0", "s1l2"])
        assert e["k"] == 16
        paths = tensor_viz.plot_eigenvalue_cumsum({"k": rows, "empty": [[], []]}, save_dir=str(tmp_path))
        assert [os.path.basename(p) for p in paths] == ["svcumsum_k.png"]
        _nonempty_png(paths[0])


def test_top_k_spectrum_is_drawn_against_a_top_k_baseline(tmp_path):
    """Recorded divergence (b): a spectrum stored as its top 64 of 512
    singular values.  JAX normalises its curve over the 64 values and draws
    the full spectrum of a 64-column Gaussian beside it (tensor_viz.py:153,
    :156-160), as if the 64 held all the energy.  The port's StatsLogger
    dump records the (512, 1152) shape the spectrum was cut from, and the
    port normalises the curve and the baseline over the same recorded top
    64 (the baseline the top 64 of a (512, 1152) Gaussian) and labels the
    axis so; a dump without the shape gets JAX's baseline."""
    from compactfusion_tpu_torch.compact.stats import StatsLogger, log_spectrum_inside_jit

    rng = np.random.default_rng(5)
    x = rng.normal(size=(512, 1152)) * np.linspace(3, 0.1, 1152)
    full = np.linalg.svd(x, compute_uv=False)
    StatsLogger.reset()
    log_spectrum_inside_jit("k-delta", torch.from_numpy(x).float())
    dump = StatsLogger.instance().dump_eigenvalues(str(tmp_path / "eig.json"))
    StatsLogger.reset()
    assert dump["_shapes"] == {"k-delta": [512, 1152]}
    top = np.asarray(dump["k-delta"][0])
    np.testing.assert_allclose(top, full[:64], rtol=1e-4)
    e = tensor_viz.energy_curves(dump["k-delta"], dump["_shapes"]["k-delta"])
    np.testing.assert_allclose(e["curves"][0][1], np.cumsum(top) / top.sum())  # JAX's curve maths
    assert e["ylabel"] == "cumulative energy within the recorded top 64 of 512" and e["of"] == 512
    n = 64  # JAX's baseline: an iid Gaussian of (min(4n, 1024), n), all n of its values
    jgsv = np.linalg.svd(np.random.default_rng(0).normal(size=(min(4 * n, 1024), n)), compute_uv=False)[:n]
    jbase = np.cumsum(jgsv) / jgsv.sum()
    np.testing.assert_allclose(tensor_viz.energy_curves([top.tolist()])["baseline"], jbase)
    base = e["baseline"]
    assert base.shape == (64,) and base[-1] == pytest.approx(1.0)
    assert np.abs(base - jbase).max() > 1e-3  # the truncated baseline is another curve
    gsv = np.linalg.svd(np.random.default_rng(0).normal(size=(512, 1152)), compute_uv=False)[:64]
    np.testing.assert_allclose(base, np.cumsum(gsv) / gsv.sum())
    # the whole spectrum's energy in the top 64 is far below what the curve's 1.0 would claim
    assert top.sum() / full.sum() < 0.5
    paths = tensor_viz.plot_eigenvalue_cumsum(dump, save_dir=str(tmp_path / "viz"))
    assert [os.path.basename(p) for p in paths] == ["svcumsum_k-delta.png"]
    _nonempty_png(paths[0])


def test_curve_helper_and_import_need_no_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "from compactfusion_tpu_torch.utils import tensor_viz as v\n"
            "e = v.energy_curves([[3.0, 2.0, 1.0], [1.0, 1.0]])\n"
            "assert e['k'] == 3 and abs(e['curves'][0][1][-1] - 1.0) < 1e-12, e\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
