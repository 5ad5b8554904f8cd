"""Environment-variable registry and capability probing
(counterpart of ``compactfusion_tpu/envs.py``).

A lazily evaluated registry (module ``__getattr__``: every read goes to the
environment at that moment) and a singleton capability checker.  The JAX
package's multi-host variables (``COORDINATOR_ADDRESS``, ``PROCESS_ID``,
``NUM_PROCESSES``) become torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; the XLA cache directory and
``JAX_PLATFORMS`` have no counterpart here.  The checker probes torch and
the CUDA device; it informs, and no entry point uses it to fall back to the
CPU.

Usage::

    from compactfusion_tpu_torch import envs
    envs.CFTPU_LOGGING_LEVEL        # lazy env read
    envs.PACKAGES_CHECKER.get_env_info()["platform"]   # "gpu" or "cpu"
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional


def _int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


environment_variables: Dict[str, Callable[[], Any]] = {
    # logging level (the reference's XDIT_LOGGING_LEVEL honoured as a fallback)
    "CFTPU_LOGGING_LEVEL": lambda: os.getenv("CFTPU_LOGGING_LEVEL", os.getenv("XDIT_LOGGING_LEVEL", "INFO")),
    # activation-collector dump directory (utils/collector.py); "" = off
    "CFTPU_COLLECT_DIR": lambda: os.getenv("CFTPU_COLLECT_DIR", ""),
    # torchrun's process-group description (parallel/mesh.py)
    "MASTER_ADDR": lambda: os.getenv("MASTER_ADDR", None),
    "MASTER_PORT": lambda: os.getenv("MASTER_PORT", None),
    "RANK": lambda: _int("RANK"),
    "WORLD_SIZE": lambda: _int("WORLD_SIZE"),
    "LOCAL_RANK": lambda: _int("LOCAL_RANK"),
}


class PackagesEnvChecker:
    """Singleton capability prober (reference ``PackagesEnvChecker``).

    Lazy: importing this module initialises no CUDA context; the first
    :meth:`get_env_info` call probes and caches."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._info = None
        return cls._instance

    def get_env_info(self) -> Dict[str, Any]:
        if self._info is None:
            self._info = self._probe()
        return self._info

    def _probe(self) -> Dict[str, Any]:
        import torch

        from compactfusion_tpu_torch.ops._build import _nvcc

        try:
            nvcc = _nvcc()
        except RuntimeError:
            nvcc = None
        gpu = torch.cuda.is_available()
        info: Dict[str, Any] = {
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "platform": "gpu" if gpu else "cpu",
            "device_kind": torch.cuda.get_device_name(0) if gpu else "cpu",
            "device_count": torch.cuda.device_count() if gpu else 1,
            "compute_capability": torch.cuda.get_device_capability(0) if gpu else None,
            "memory_bytes": torch.cuda.get_device_properties(0).total_memory if gpu else None,
            # the hand-written kernels build with nvcc at first use (ops/_build.py)
            "has_nvcc": nvcc is not None,
        }
        return info

    def check_platform(self, expected: str) -> bool:
        return self.get_env_info()["platform"] == expected


PACKAGES_CHECKER = PackagesEnvChecker()


def __getattr__(name):
    # lazy evaluation of environment variables (reference envs.py:123-129)
    if name in environment_variables:
        return environment_variables[name]()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
