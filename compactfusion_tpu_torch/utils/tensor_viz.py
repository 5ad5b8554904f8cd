"""Offline tensor visualization for collector and stats dumps
(counterpart of ``compactfusion_tpu/utils/tensor_viz.py``).

The reference's plot helpers (``xfuser/compact/plot.py``: ``plot_3d`` at
:8, ``plot_low_rank_factors`` at :30, ``plot_eigenvalue_cumsum`` at :85),
host-side numpy on artifacts the port already writes:

  * ``utils/collector.py`` ``.npy`` dumps (``CFTPU_COLLECT_DIR``), one per
    (name, rank, step, layer) activation;
  * ``compact/stats.py::StatsLogger.dump_eigenvalues`` JSON, per-key
    singular-value spectra, flat or grouped ``[step][layer] -> [sv...]``.

matplotlib is imported only when a figure is drawn, with the Agg backend,
so importing this module needs neither matplotlib nor a display.  The
energy curves come from :func:`energy_curves`, which needs no matplotlib.

Two recorded divergences from the JAX module: an empty spectrum or step
group is skipped (JAX's layout sniffing raises ``IndexError`` on an empty
first entry), and a spectrum stored as its top k singular values (the
StatsLogger keeps 64) is drawn as what it is: each curve and the
iid-Gaussian baseline are normalised over the same recorded top k, the
baseline being the top k of a Gaussian of the [N, C] shape the dump
records for the key (``"_shapes"``), and the axis and title say so.

CLI::

    python -m compactfusion_tpu_torch.utils.tensor_viz --collect_dir dump \\
        --out plots/viz                      # 3D surface per dumped tensor
    python -m compactfusion_tpu_torch.utils.tensor_viz --eigenvalues spectra.json \\
        --out plots/viz                      # cumulative-energy curves
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _as_2d(arr: np.ndarray) -> np.ndarray:
    """Collapse an activation of any rank to (tokens, channels): the last
    axis is channels, every other folds into tokens (the (N, C) view the
    codecs compress)."""
    a = np.asarray(arr)
    if a.ndim == 1:
        return a[None, :]
    return a.reshape(-1, a.shape[-1])


def _decimate(a: np.ndarray, max_rows: int, max_cols: int) -> np.ndarray:
    """Strided downsample so surface plots stay renderable for video-scale
    tensors; a stride keeps the global shape, unlike a crop."""
    r = max(1, int(np.ceil(a.shape[0] / max_rows)))
    c = max(1, int(np.ceil(a.shape[1] / max_cols)))
    return a[::r, ::c]


def plot_3d(tensor, title: str, path: Optional[str] = None, max_tokens: int = 256,
            max_channels: int = 256) -> str:
    """3D surface of a (token, channel) activation (reference ``plot_3d``).
    Any array-like of any rank; big tensors are strided down to at most
    (max_tokens, max_channels) vertices.  Returns the written path."""
    plt = _plt()
    z = _decimate(_as_2d(np.asarray(tensor, dtype=np.float32)), max_tokens, max_channels)
    x, y = np.meshgrid(np.arange(z.shape[1]), np.arange(z.shape[0]))
    fig = plt.figure(figsize=(10, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(x, y, z, cmap="coolwarm", linewidth=0, antialiased=False)
    ax.set_xlabel("Channel")
    ax.set_ylabel("Token")
    ax.set_zlabel("Value")
    ax.set_title(title)
    if path is None:
        path = f"3d_{title}.png"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_low_rank_factors(u, v, key: str, step: int, save_dir: str = ".") -> str:
    """Side-by-side heatmaps of a rank-k factor pair (reference
    ``plot_low_rank_factors``): ``u`` (N, K), ``v`` (K, C), the LOW_RANK
    codec's payload (``compact/lowrank.py``)."""
    plt = _plt()
    u_np = _as_2d(np.asarray(u, dtype=np.float32))
    v_np = _as_2d(np.asarray(v, dtype=np.float32))
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    fig.suptitle(f"low-rank factors {key} step{step}")
    for ax, (m, name, xl, yl) in zip(axes, [(u_np, "U", "rank", "tokens"), (v_np, "V", "channels", "rank")]):
        im = ax.imshow(_decimate(m, 2048, 2048), aspect="auto", cmap="viridis")
        ax.set_title(f"{name} {m.shape}")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        fig.colorbar(im, ax=ax)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{key}_step{step}_uv.png")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def _flat_spectra(rows) -> List[Tuple[str, np.ndarray]]:
    """A key's dump -> [(label, spectrum)]: flat per-call spectra ("#i") or
    grouped ``[step][layer]`` ("s{step}l{layer}"); empty spectra and empty
    groups are skipped (the layout is read off the first non-empty one)."""
    first = next((r for r in rows if len(r)), None)
    if first is None:
        return []
    if isinstance(first[0], (list, tuple)):
        return [(f"s{si}l{li}", np.asarray(sv, np.float64))
                for si, layers in enumerate(rows) for li, sv in enumerate(layers) if len(sv)]
    return [(f"#{i}", np.asarray(sv, np.float64)) for i, sv in enumerate(rows) if len(sv)]


def gaussian_baseline(k: int, shape: Optional[Sequence[int]] = None) -> np.ndarray:
    """Cumulative energy over the top ``k`` singular values of an iid
    Gaussian matrix of ``shape`` [N, C] (each side at most 4096),
    normalised over those k: what "no structure" looks like on the same
    footing as a recorded top-k spectrum of such a matrix.  Without a shape
    the k values are taken as the whole spectrum and the baseline is the
    JAX module's, a (min(4k, 1024), k) Gaussian."""
    n, c = shape if shape is not None else (min(4 * k, 1024), k)
    gsv = np.linalg.svd(np.random.default_rng(0).normal(size=(min(n, 4096), min(c, 4096))), compute_uv=False)[:k]
    return np.cumsum(gsv) / gsv.sum()


def energy_curves(rows, shape: Optional[Sequence[int]] = None, max_curves: int = 32) -> Dict[str, object]:
    """The numbers of one key's figure, without matplotlib: ``curves``
    [(label, cumulative energy)] for at most about ``max_curves`` of the
    spectra (strided), each sorted descending and normalised over its
    recorded values; ``baseline`` (:func:`gaussian_baseline` at the longest
    recorded length ``k`` and the key's recorded ``shape``); ``k``;
    ``of``, the length of the whole spectrum where the shape is known; and
    the ``ylabel`` that says what the energy is relative to.  Empty when
    the key holds no spectrum."""
    flat = _flat_spectra(rows)
    if not flat:
        return {"curves": [], "baseline": None, "k": 0, "of": None, "ylabel": ""}
    stride = max(1, len(flat) // max_curves)
    curves = []
    for label, sv in flat[::stride]:
        sv = np.sort(sv)[::-1]
        tot = sv.sum()
        if tot > 0:
            curves.append((label, np.cumsum(sv) / tot))
    k = max(sv.size for _, sv in flat)
    of = min(shape) if shape is not None else None
    return {"curves": curves, "baseline": gaussian_baseline(k, shape), "k": k, "of": of,
            "ylabel": f"cumulative energy within the recorded top {k}{f' of {of}' if of else ''}"}


def plot_eigenvalue_cumsum(spectra: Dict[str, List], save_dir: str = ".", keys: Optional[Sequence[str]] = None,
                           log_scale: bool = True) -> List[str]:
    """Cumulative singular-value energy per key (reference
    ``plot_eigenvalue_cumsum``): how much of a delta's energy the top ranks
    capture, the plot behind the low-rank codec's rank choice.
    ``spectra`` is the ``StatsLogger.dump_eigenvalues`` dict, whose
    ``"_shapes"`` gives each key's matrix shape where it was recorded.  One
    figure a key with a curve per sample (see :func:`energy_curves`) and
    the iid-Gaussian baseline.  Returns the written paths."""
    plt = None
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    shapes = spectra.get("_shapes", {})
    for key, rows in spectra.items():
        if key == "_shapes" or (keys is not None and key not in keys):
            continue
        e = energy_curves(rows, shapes.get(key))
        if not e["curves"]:
            continue
        plt = plt or _plt()
        fig, ax = plt.subplots(figsize=(8, 5))
        few = len(e["curves"]) <= 8
        for label, cum in e["curves"]:
            ax.plot(np.arange(1, cum.size + 1), cum, alpha=0.6, label=label if few else None)
        base = e["baseline"]
        ax.plot(np.arange(1, base.size + 1), base, "k--", label="iid gaussian")
        if log_scale:
            ax.set_xscale("log")
        ax.set_xlabel("rank k")
        ax.set_ylabel(e["ylabel"])
        of = f" of {e['of']}" if e["of"] else ""
        ax.set_title(f"singular-value energy: {key} (top {e['k']}{of})")
        ax.legend(loc="lower right", fontsize=7)
        path = os.path.join(save_dir, f"svcumsum_{key.replace('/', '_')}.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def render_collector_dir(collect_dir: str, out_dir: str, names: Optional[Sequence[str]] = None,
                         limit: int = 64) -> List[str]:
    """Every ``.npy`` activation of a collector dump directory as a 3D
    surface (file stem -> ``3d_<stem>.png``); ``names`` filters by tensor
    name prefix, ``limit`` caps the number of figures."""
    paths = []
    for fn in sorted(os.listdir(collect_dir)):
        if not fn.endswith(".npy"):
            continue
        stem = fn[:-4]
        if names is not None and not any(stem.startswith(n) for n in names):
            continue
        arr = np.load(os.path.join(collect_dir, fn))
        paths.append(plot_3d(arr, stem, os.path.join(out_dir, f"3d_{stem}.png")))
        if len(paths) >= limit:
            break
    return paths


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--collect_dir", help="utils/collector.py dump directory")
    p.add_argument("--eigenvalues", help="StatsLogger.dump_eigenvalues JSON")
    p.add_argument("--out", default="plots/viz", help="output directory")
    p.add_argument("--names", nargs="*", default=None, help="tensor-name prefixes to render from --collect_dir")
    p.add_argument("--limit", type=int, default=64)
    a = p.parse_args(argv)
    written: List[str] = []
    if a.collect_dir:
        written += render_collector_dir(a.collect_dir, a.out, a.names, a.limit)
    if a.eigenvalues:
        with open(a.eigenvalues) as f:
            written += plot_eigenvalue_cumsum(json.load(f), a.out)
    for w in written:
        print(w)
    return 0 if written else 1


if __name__ == "__main__":
    raise SystemExit(main())
