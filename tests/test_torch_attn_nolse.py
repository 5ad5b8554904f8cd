"""``sdpa``'s no-LSE route (``ops/attention.py::_attn_nolse``) vs the JAX
package's ``_xla_attn_nolse`` and ``attn_with_lse(impl="xla")``.

The same numpy inputs go through both packages, as
``tests/core/test_attn_nolse.py`` holds the JAX function to its reference
path.  Tolerances: fp32 at 2e-5 absolute, the JAX test's own bound (the
port shifts by the row max where JAX shifts by a Cauchy-Schwarz bound; the
uniform scaling that separates them divides out, so only fp32 rounding
differs).  bf16 at 2e-2 absolute, the port's bf16 bound
(``chip_smoke.py::FLASH_OUT_ATOL``): the two shifts round different p to
bf16, and the output is rounded to bf16 (an ulp is 2^-7 at 1-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.ops import attention as jattn
from compactfusion_tpu_torch.ops import attention as tattn

FP32_ATOL = 2e-5
BF16_ATOL = 2e-2


def _qkv(b, sq, sk, h, d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, sq, h, d)) * scale).astype(np.float32),
            (rng.standard_normal((b, sk, h, d)) * scale).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32))


def _port(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _jax(arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrays)


# d=72 is the JAX function's ones-column row sum, d=128 its separate sum
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [72, 128])
@pytest.mark.parametrize("lens", [None, (120, 37), (64, 0)], ids=["nomask", "prefix", "deadrow"])
def test_nolse_matches_jax(d, lens, dtype):
    arrays = _qkv(2, 256, 120, h=4, d=d, seed=d)
    tq, tk, tv = _port(arrays, getattr(torch, dtype))
    jq, jk, jv = _jax(arrays, getattr(jnp, dtype))
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    out = tattn._attn_nolse(tq, tk, tv, None, tl)
    assert out.dtype == tq.dtype and tuple(out.shape) == (2, 256, 4, d) and out.is_contiguous()
    atol = FP32_ATOL if dtype == "float32" else BF16_ATOL
    got = out.float().numpy()
    refs = (jattn._xla_attn_nolse(jq, jk, jv, None, jl), jattn.attn_with_lse(jq, jk, jv, kv_lens=jl, impl="xla")[0])
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)), atol=atol, rtol=0)


def test_nolse_large_logits_stable():
    """At logits of thousands, JAX's bound-shifted exps all underflow and its
    ``lax.cond`` reruns the exact path; the row-max shift is exact without
    it.  Held, as the JAX test holds its fallback, against an fp64 ground
    truth within 5x the reference path's own error (at these magnitudes the
    fp32 rounding of the scores moves the softmax weights by ~1e-3)."""
    q, k, v = _qkv(1, 64, 64, h=2, d=72, seed=1, scale=40.0)
    out = tattn._attn_nolse(*_port((q, k, v)), None, None).double().numpy()
    assert np.isfinite(out).all() and np.abs(out).max() > 0.0

    qq, kk, vv = (t.astype(np.float64) for t in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", qq, kk) * 72**-0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    gt = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vv)
    ref, _ = jattn.attn_with_lse(*_jax((q, k, v)), impl="xla")
    err_ref = float(np.max(np.abs(np.asarray(ref, np.float64) - gt)))
    err_out = float(np.max(np.abs(out - gt)))
    assert err_out < max(5 * err_ref, 1e-4), (err_out, err_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nolse_dead_rows_are_zero(dtype):
    q, k, v = _port(_qkv(2, 32, 16, h=2, d=72, seed=2), dtype)
    out = tattn._attn_nolse(q, k, v, None, torch.tensor([0, 16]))
    assert torch.isfinite(out).all()
    assert out[0].abs().max().item() == 0.0
    assert out[1].abs().max().item() > 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_auto_routes_through_nolse(dtype):
    """``sdpa``'s mask-free call equals the direct no-LSE call bit for bit
    (the route engages), and differs from the math path's bits."""
    q, k, v = _port(_qkv(1, 128, 120, h=2, d=72, seed=3), dtype)
    kl = torch.tensor([100], dtype=torch.int32)
    auto = tattn.sdpa(q, k, v, kv_lens=kl)
    assert torch.equal(auto, tattn._attn_nolse(q, k, v, None, kl))
    assert not torch.equal(auto, tattn._attn_math(q, k, v, None, False, None, kl)[0])


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_nolse_takes_operands_of_different_dtypes(q_dtype, kv_dtype, monkeypatch):
    """q and k/v of different dtypes (DiTFastAttn's calibration forward
    meets them) agree with JAX, which promotes them to fp32; the scores
    product never hands them to the CUDA branch's bf16 ``bmm``: with every
    tensor reporting CUDA, it still takes the upcast and gives the same
    bits."""
    arrays = _qkv(2, 64, 24, h=2, d=72, seed=7)
    q = torch.from_numpy(arrays[0]).to(q_dtype)
    k, v = (torch.from_numpy(a).to(kv_dtype) for a in arrays[1:])
    kl = torch.tensor([24, 9], dtype=torch.int32)
    want = tattn._attn_nolse(q, k, v, None, kl)
    assert want.dtype == q_dtype
    jq = jnp.asarray(arrays[0]).astype(jnp.bfloat16 if q_dtype == torch.bfloat16 else jnp.float32)
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16 if kv_dtype == torch.bfloat16 else jnp.float32) for a in arrays[1:])
    ref = jattn._xla_attn_nolse(jq, jk, jv, None, jnp.asarray([24, 9], jnp.int32))
    np.testing.assert_allclose(want.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=BF16_ATOL, rtol=0)
    qh, kh = q.transpose(1, 2), k.permute(0, 2, 3, 1)
    scores = tattn._bmm_f32(qh, kh)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert torch.equal(tattn._bmm_f32(qh, kh), scores)


def test_sdpa_masked_and_causal_keep_the_math_path():
    q, k, v = _port(_qkv(1, 64, 64, h=2, d=72, seed=4))
    mask = torch.ones(64, 64, dtype=torch.bool).tril()
    assert torch.equal(tattn.sdpa(q, k, v, mask=mask), tattn._attn_math(q, k, v, None, False, mask, None)[0])
    assert torch.equal(tattn.sdpa(q, k, v, causal=True), tattn._attn_math(q, k, v, None, True, None, None)[0])
    jq, jk, jv = _jax(_qkv(1, 64, 64, h=2, d=72, seed=4))
    ref, _ = jattn.attn_with_lse(jq, jk, jv, mask=jnp.asarray(mask.numpy()), impl="xla")
    np.testing.assert_allclose(tattn.sdpa(q, k, v, mask=mask).numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_sdpa_reads_nothing_back_to_the_host(monkeypatch):
    """No call of the route reads a tensor's value on the host (JAX's
    fallback is a ``lax.cond``; an eager branch would be one host read per
    call, 560 an image)."""
    q, k, v = _port(_qkv(2, 64, 24, h=2, d=72, seed=6), torch.bfloat16)
    kl = torch.tensor([24, 0], dtype=torch.int32)
    want = tattn._attn_nolse(q, k, v, None, kl)

    def host_read(*args, **kwargs):
        raise AssertionError("a host read in sdpa's no-LSE route")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    got = tattn.sdpa(q, k, v, kv_lens=kl)
    monkeypatch.undo()
    assert torch.equal(got, want)
