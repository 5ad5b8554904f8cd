"""Port's flash attention (plain twin on the CPU) vs the JAX package.

The same numpy inputs go through JAX ``flash_attn_with_lse`` in Pallas
interpret mode, JAX ``attn_with_lse`` (XLA math) and the port's twin, all
in fp32.  Tolerance 2e-4 absolute on out and LSE: the bound the JAX
package's own flash tests hold the Pallas kernel to against XLA
(tests/core/test_flash_pallas.py); the three differ only in fp32
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.ops import attention as jattn
from compactfusion_tpu.ops.flash_pallas import flash_attn_with_lse as jflash
from compactfusion_tpu_torch.ops import attention as tattn
from compactfusion_tpu_torch.ops import flash as tflash

ATOL = 2e-4


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))
    )


def _close(t, ref):
    """-inf entries (rows with no valid key) must match exactly."""
    t, ref = np.asarray(t), np.asarray(ref)
    np.testing.assert_array_equal(np.isneginf(t), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(t[fin], ref[fin], atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "b,sq,sk,h,d,lens",
    [
        (2, 64, 128, 2, 72, None),        # PixArt head dim
        (1, 40, 200, 3, 72, None),        # ragged Sq and Sk
        (2, 64, 120, 2, 72, (0, 77)),     # kv_lens with a fully masked row
        (1, 32, 96, 1, 512, None),        # VAE mid-block head dim
        (2, 16, 50, 1, 512, (50, 13)),    # d=512 with kv_lens, ragged
    ],
)
def test_twin_matches_jax_flash_and_math(b, sq, sk, h, d, lens):
    q, k, v = _qkv(b, sq, sk, h, d, seed=sq + sk + d)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    ref_o, ref_l = jattn.attn_with_lse(*map(jnp.asarray, (q, k, v)), impl="xla", kv_lens=jl)
    pal_o, pal_l = jflash(*map(jnp.asarray, (q, k, v)), block_q=32, block_k=128,
                          interpret=True, kv_lens=jl)
    out, lse = tflash.flash_attn_with_lse_ref(*map(torch.from_numpy, (q, k, v)), kv_lens=tl)
    assert out.dtype == torch.float32 and lse.shape == (b, h, sq)
    _close(out.numpy(), ref_o)
    _close(lse.numpy(), ref_l)
    # a row with no valid key follows attn_with_lse (0, LSE -inf); the Pallas
    # kernel leaves such rows undefined, so it is compared on the others
    live = slice(None) if lens is None else np.asarray(lens) > 0
    _close(out.numpy()[live], np.asarray(pal_o)[live])
    _close(lse.numpy()[live], np.asarray(pal_l)[live])


def test_wrapper_on_cpu_runs_the_twin_without_counting():
    q, k, v = map(torch.from_numpy, _qkv(1, 32, 64, 2, 72, seed=5))
    tflash.flash_attn_with_lse.launches = 0
    out, lse = tflash.flash_attn_with_lse(q, k, v)
    ref_o, ref_l = tflash.flash_attn_with_lse_ref(q, k, v)
    assert torch.equal(out, ref_o) and torch.equal(lse, ref_l)
    assert tflash.flash_attn_with_lse.launches == 0
    # window= delegates to the banded wrapper, which runs its twin here
    win_o, win_l = tflash.flash_attn_with_lse(q, k[:, :32], v[:, :32], window=8)
    ref_o, ref_l = tflash.flash_attn_window_with_lse_ref(q, k[:, :32], v[:, :32], 8)
    assert torch.equal(win_o, ref_o) and torch.equal(win_l, ref_l)
    assert tflash.flash_attn_with_lse.launches == 0


def test_math_path_matches_jax_with_mask_and_causal():
    q, k, v = _qkv(1, 24, 24, 2, 16, seed=9)
    mask = np.random.default_rng(1).random((24, 24)) > 0.3
    mask[3] = False  # a fully masked row
    for kw_j, kw_t in (
        ({"causal": True}, {"causal": True}),
        ({"mask": jnp.asarray(mask)}, {"mask": torch.from_numpy(mask)}),
    ):
        ro, rl = jattn.attn_with_lse(*map(jnp.asarray, (q, k, v)), impl="xla", **kw_j)
        out, lse = tattn.attn_with_lse(*map(torch.from_numpy, (q, k, v)), **kw_t)
        _close(out.numpy(), ro)
        _close(lse.numpy(), rl)


@pytest.mark.parametrize(
    "q_shape,k_shape",
    [
        ((2, 1024, 16, 72), (2, 1024, 16, 72)),   # PixArt self-attention
        ((2, 128, 16, 72), (2, 1024, 16, 72)),    # ring-8 query chunk
        ((1, 4096, 1, 512), (1, 4096, 1, 512)),   # VAE mid-block
        ((2, 1024, 16, 72), (2, 120, 16, 72)),    # cross-attention to text
        ((2, 256, 4, 64), (2, 256, 4, 64)),       # Sq*Sk = 256^2 but Sk < 512
        ((1, 128, 2, 60), (1, 1024, 2, 60)),      # d % 8 != 0
        ((1, 64, 2, 64), (1, 1024, 2, 64)),       # Sq*Sk < 256^2
    ],
)
def test_routing_matches_jax_flash_eligible(monkeypatch, q_shape, k_shape):
    """Same routing decision as the JAX contract once the JAX side believes
    it runs on a TPU (the port's counterpart of that is a CUDA tensor)."""
    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    q = jax.ShapeDtypeStruct(q_shape, jnp.bfloat16)
    k = jax.ShapeDtypeStruct(k_shape, jnp.bfloat16)
    want = jattn._flash_eligible(q, k, False, None)
    assert tattn._flash_shape_ok(q_shape, k_shape) == want
    # on CPU tensors the port always takes the math path
    tq = torch.empty(q_shape, device="meta")
    tk = torch.empty(k_shape, device="meta")
    assert not tattn._flash_eligible(tq, tk, False, None)
    assert not tattn._flash_eligible(tq, tk, True, None)
