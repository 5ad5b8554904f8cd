"""Low-rank approximation by subspace iteration
(counterpart of ``compactfusion_tpu/compact/lowrank.py``).

Given A (m, n), return U (m, k), V (k, n) with A ~= U @ V: a few rounds of
``Q <- qr(A^T (A Q))``, then ``U = qr(A Q)``, ``V = U^T A``, all in fp32.
It serves the LOW_RANK codecs and the rank-k scale model of the 1-bit
codec.  The QR is ``torch.linalg.qr``, as the JAX package leaves its QR to
XLA outside any kernel.

Recorded divergence: the JAX package starts the iteration from a draw of
``jax.random.PRNGKey(0)``, which torch cannot reproduce.  The port starts
from a fixed-seed ``torch.Generator`` draw (seed 0, on the CPU, then QR),
built once per (n, rank, device).  Subspace iteration converges for any
start that is not orthogonal to the top subspace, so the two packages give
different factors of the same kind; the parity tests hand the JAX start to
the port (``init_q`` or a patched ``_init_q``) and compare decoded products,
which do not change when QR flips column signs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch


@functools.lru_cache(maxsize=None)
def _init_q(n: int, rank: int, device: torch.device) -> torch.Tensor:
    """Deterministic orthonormal (n, rank) start.  Cached and shared by
    every caller, which only read it."""
    g = torch.Generator().manual_seed(0)
    q, _ = torch.linalg.qr(torch.randn((n, rank), generator=g, dtype=torch.float32))
    return q.to(device)


def subspace_iter(a: torch.Tensor, rank: int, num_iters: int = 2,
                  init_q: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-``rank`` approximation ``a ~= u @ v``, computed in fp32.

    Returns (u (m, k) orthonormal, v (k, n), q (n, k) final basis) in
    ``a.dtype``; ``q`` can start the next call as ``init_q``."""
    dtype = a.dtype
    a32 = a.float()
    q = _init_q(a.shape[1], rank, a.device) if init_q is None else init_q.float()
    for _ in range(num_iters):
        q, _ = torch.linalg.qr(a32.T @ (a32 @ q))
    u, _ = torch.linalg.qr(a32 @ q)
    v = u.T @ a32
    return u.to(dtype), v.to(dtype), q.to(dtype)


def svd_lowrank(a: torch.Tensor, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact truncated SVD: (u * s, vh), rank ``rank``."""
    u, s, vh = torch.linalg.svd(a.float(), full_matrices=False)
    return (u[:, :rank] * s[:rank][None, :]).to(a.dtype), vh[:rank, :].to(a.dtype)
