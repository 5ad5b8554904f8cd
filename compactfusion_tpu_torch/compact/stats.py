"""Compression statistics (counterpart of ``compactfusion_tpu/compact/stats.py``).

Reference semantics: ``StatsLogger`` (``xfuser/compact/stats.py``): per
(cache key, step) reconstruction error, relative error, cosine similarity
and norm, a bytes-on-the-wire summary with the end-to-end compression
ratio, and the eigenvalue-spectrum and err-vs-step JSON dumps.

The JAX package ships values out of a compiled program through debug
callbacks; here the taps are plain host calls made where the values exist,
in stream order, so records arrive layer-major per denoise step as the JAX
package's ordered callbacks deliver them.  :func:`log_inside_jit` and
:func:`log_spectrum_inside_jit` keep the JAX names: ``rank`` tags the key
(``key@r{rank}``) as the JAX package tags it on a multi-device mesh, and is
left None on one device.

One divergence: the spectrum is computed on the tensor's device
(``torch.linalg.svdvals``) and only its top-k values reach the host, where
the JAX package ships the whole (N, C) activation to the host and
decomposes it with numpy (``_host_spectrum``).
``tests/test_torch_stats.py`` holds the two within 1e-4 relative.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Optional

import torch

from compactfusion_tpu_torch.compact.codecs import payload_nbytes


def compression_metrics(x: torch.Tensor, x_hat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-tensor reconstruction metrics, fp32 0-d tensors on x's device."""
    x32, r32 = x.float(), x_hat.float()
    x_norm = torch.linalg.vector_norm(x32)
    e_norm = torch.linalg.vector_norm(r32 - x32)
    cos = torch.sum(x32 * r32) / torch.clamp(x_norm * torch.linalg.vector_norm(r32), min=1e-12)
    return {"err_norm": e_norm, "rel_err": e_norm / torch.clamp(x_norm, min=1e-12), "cos_sim": cos,
            "x_norm": x_norm}


class StatsLogger:
    """Host-side accumulator, a process singleton like the reference's
    ``stats_log()``."""

    _instance: Optional["StatsLogger"] = None

    def __init__(self):
        self.records = collections.defaultdict(list)  # key -> [(step, metrics)]
        self.spectra = collections.defaultdict(list)  # key -> [[sv...], ...]
        self.shapes = {}  # key -> [N, C] of the matrix its spectra were cut from
        self.sent_bytes = 0
        self.raw_bytes = 0

    @classmethod
    def instance(cls) -> "StatsLogger":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls):
        cls._instance = StatsLogger()

    def log(self, key: str, step: int, metrics: Dict[str, float]):
        self.records[key].append((int(step), {k: float(v) for k, v in metrics.items()}))

    def log_volume(self, payload, raw: torch.Tensor):
        """Account one transfer (reference ``summary_compression_volume``)."""
        self.sent_bytes += payload_nbytes(payload)
        self.raw_bytes += raw.numel() * raw.element_size()

    def account_volume(self, sent: int, raw: int):
        self.sent_bytes += sent
        self.raw_bytes += raw

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / max(self.sent_bytes, 1)

    def dump_eigenvalues(self, path: str, depth: Optional[int] = None):
        """JSON eigenvalue dump (reference ``save_eigenvalues``): with
        ``depth``, each key's spectra grouped ``[step][layer] -> [sv...]``,
        else one flat list.  One divergence: where :func:`log_spectrum_inside_jit`
        recorded them, ``"_shapes"`` maps each key to the [N, C] of the
        matrix its top-k spectra were cut from, which ``utils/tensor_viz.py``
        needs to draw a top-k spectrum against the right baseline."""
        out = {}
        for key, rows in self.spectra.items():
            if depth and len(rows) % depth == 0:
                out[key] = [rows[i:i + depth] for i in range(0, len(rows), depth)]
            else:
                out[key] = rows
        if self.shapes:
            out["_shapes"] = dict(self.shapes)
        with open(path, "w") as f:
            json.dump(out, f)
        return out

    def dump_err_vs_steps(self, path: str, depth: Optional[int] = None):
        """JSON err-vs-step dump (reference ``dump_err_vs_steps``): per key,
        the layer-averaged metrics of every denoise step."""
        out = {}
        for key, recs in self.records.items():
            vals = [m for _, m in recs]
            if depth and len(vals) % depth == 0:
                steps = [vals[i:i + depth] for i in range(0, len(vals), depth)]
                out[key] = [{k: sum(m[k] for m in layer_ms) / len(layer_ms) for k in layer_ms[0]}
                            for layer_ms in steps]
            else:
                out[key] = vals
        with open(path, "w") as f:
            json.dump(out, f)
        return out

    def summary(self) -> str:
        lines = []
        for key in sorted(self.records):
            recs = self.records[key]
            last = recs[-1][1]
            mean_rel = sum(m["rel_err"] for _, m in recs) / len(recs)
            lines.append(f"{key}: steps={len(recs)} mean_rel_err={mean_rel:.4f} "
                         f"last_rel_err={last['rel_err']:.4f} last_cos={last['cos_sim']:.4f}")
        if self.raw_bytes:
            lines.append(f"volume: raw={self.raw_bytes/1e6:.1f}MB sent={self.sent_bytes/1e6:.3f}MB "
                         f"ratio={self.compression_ratio:.1f}x")
        return "\n".join(lines)


def _tagged(key: str, rank) -> str:
    return key if rank is None else f"{key}@r{int(rank)}"


def log_inside_jit(key: str, step, metrics: Dict[str, torch.Tensor], rank=None):
    """Record ``metrics`` (0-d tensors, read in one host transfer) under
    ``key`` at ``step``."""
    names = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in names]).tolist()
    StatsLogger.instance().log(_tagged(key, rank), int(step), dict(zip(names, vals)))


def spectrum(x: torch.Tensor, top_k: int = 64) -> torch.Tensor:
    """Top-k singular values of an (N, C) tensor, fp32, on its device."""
    s = torch.linalg.svdvals(x.float())
    return s[..., :min(top_k, s.shape[-1])]


def log_spectrum_inside_jit(key: str, x: torch.Tensor, top_k: int = 64, rank=None):
    """Record the top-k singular values of ``x`` under ``key``, and the
    shape of the matrix they were cut from."""
    log, key = StatsLogger.instance(), _tagged(key, rank)
    log.spectra[key].append([float(v) for v in spectrum(x, top_k).reshape(-1).tolist()])
    log.shapes[key] = [int(n) for n in x.shape[-2:]]
