"""Port's subspace iteration (``compact/lowrank.py``) vs the JAX package.

The two packages start the iteration from different draws (``jax.random``
against a ``torch.Generator``; a recorded divergence), so these tests hand
the JAX start to the port, through ``init_q`` or by patching the port's
``_init_q`` (:func:`use_jax_init_q`, which the codec and pipeline tests
import).  QR may flip a column's sign between implementations, which
leaves ``U @ V`` and the projector ``Q Q^T`` unchanged, so those are what is
compared.  Bound 1e-4 relative (Frobenius): fp32 on both sides, with the
QR and matmul sums taken in other orders, which the iterations of
``A^T A q`` can amplify by the inverse gap of the singular values.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.compact import lowrank as jlr
from compactfusion_tpu_torch.compact import lowrank as tlr
from tests.helpers import rel_err

REL = 1e-4


@functools.lru_cache(maxsize=None)
def jax_init_q(n, rank, device=None):
    """The JAX package's fixed start basis, as a torch tensor (cached; the
    callers only read it)."""
    return torch.from_numpy(np.array(jlr._init_q(n, rank))).to(device)


def use_jax_init_q(monkeypatch):
    """Make the port start every subspace iteration from the JAX basis."""
    monkeypatch.setattr(tlr, "_init_q", jax_init_q)


def _matrix(m, n, seed, positive=False):
    """A decaying-spectrum matrix plus noise (``positive``: its absolute
    value, like the |delta| the rank-k scale model fits)."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((n, k)))[0]
    a = (u * 0.7 ** np.arange(k)) @ v.T + 0.01 * rng.standard_normal((m, n))
    a = a.astype(np.float32)
    return np.abs(a) if positive else a


@pytest.mark.parametrize("positive", [False, True])
@pytest.mark.parametrize("m,n,rank,iters", [(64, 128, 2, 2), (256, 1152, 4, 2), (48, 32, 1, 1)])
def test_subspace_iter_matches_jax(m, n, rank, iters, positive):
    a = _matrix(m, n, seed=m + rank, positive=positive)
    q0 = np.array(jlr._init_q(n, rank))
    ju, jv, jq = jlr.subspace_iter(jnp.asarray(a), rank, iters, init_q=jnp.asarray(q0))
    tu, tv, tq = tlr.subspace_iter(torch.from_numpy(a), rank, iters, init_q=torch.from_numpy(q0))
    assert tu.shape == (m, rank) and tv.shape == (rank, n) and tq.shape == (n, rank)
    assert rel_err((tu @ tv).numpy(), np.asarray(ju) @ np.asarray(jv)) < REL
    assert rel_err((tq @ tq.T).numpy(), np.asarray(jq) @ np.asarray(jq).T) < REL
    np.testing.assert_allclose((tu.T @ tu).numpy(), np.eye(rank), atol=1e-5)


def test_default_start_is_the_patched_init_q(monkeypatch):
    """Without ``init_q`` the port starts from ``_init_q``; with the JAX basis
    patched in it reproduces the JAX call that also passes none."""
    a = _matrix(100, 64, seed=5, positive=True)
    use_jax_init_q(monkeypatch)
    ju, jv, _ = jlr.subspace_iter(jnp.asarray(a), 2)
    tu, tv, _ = tlr.subspace_iter(torch.from_numpy(a), 2)
    assert rel_err((tu @ tv).numpy(), np.asarray(ju) @ np.asarray(jv)) < REL


def test_own_init_q_is_fixed_orthonormal_and_cached():
    """The port's start: a seed-0 draw, the same in every call and process,
    orthonormal, built once per (n, rank, device), in bf16 inputs' dtype."""
    q = tlr._init_q(96, 3, torch.device("cpu"))
    assert q is tlr._init_q(96, 3, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    ref, _ = torch.linalg.qr(torch.randn((96, 3), generator=g))
    assert torch.equal(q, ref)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(3), atol=1e-6)
    a = torch.from_numpy(_matrix(40, 96, seed=1)).to(torch.bfloat16)
    u, v, q_out = tlr.subspace_iter(a, 3)
    assert u.dtype == v.dtype == q_out.dtype == torch.bfloat16


def test_svd_lowrank_matches_jax():
    a = _matrix(80, 48, seed=3)
    ju, jv = jlr.svd_lowrank(jnp.asarray(a), 3)
    tu, tv = tlr.svd_lowrank(torch.from_numpy(a), 3)
    assert tu.shape == (80, 3) and tv.shape == (3, 48)
    assert rel_err((tu @ tv).numpy(), np.asarray(ju) @ np.asarray(jv)) < REL
