"""The port's banded (window) flash attention vs the JAX package.

The same numpy inputs go through JAX ``flash_attn_with_lse(window=w)`` in
Pallas interpret mode (as tests/models/test_fast_attn.py runs it), JAX
``attn_with_lse`` with the band mask (XLA math) and the port's twin
``flash_attn_window_with_lse_ref``, all in fp32.  Tolerance 2e-5 absolute on
out and LSE: the bound the JAX package's own window test holds the Pallas
kernel to against masked sdpa; the three differ only in fp32 summation
order.

The CUDA kernel cannot run here.  Its tile schedule (which KV tiles a
q-tile visits) and the online softmax over those tiles are modelled in
torch below, so the two traps of the band (off-band tiles are skipped, and
a visited tile may hold no key of a row) are checked against the twin; the
kernel itself is held against the twin on the card by ``chip_smoke.py``.
The register body (``csrc/flash_reg.cuh``, BAND) adds a per-warp schedule:
its 16-row warps skip a visited tile that holds none of their keys and mask
only the tiles not wholly inside their rows' bands; the model follows it at
every tile height the plan can build (32, 64 and 128 rows of 64-key tiles).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.cache.fast_attn import window_mask as jwindow_mask
from compactfusion_tpu.ops import attention as jattn
from compactfusion_tpu.ops.flash_pallas import flash_attn_with_lse as jflash
from compactfusion_tpu_torch.ops import flash as tflash

ATOL = 2e-5


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))


def _close(t, ref):
    np.testing.assert_allclose(np.asarray(t), np.asarray(ref), atol=ATOL, rtol=0)


@contextlib.contextmanager
def _pinned():
    """One torch thread, and the Pallas kernel compiled in this process at
    the highest matmul precision rather than loaded from the persistent
    compilation cache: nothing the rest of the run or another worker left
    behind reaches the comparison."""
    threads, cache = torch.get_num_threads(), jax.config.jax_enable_compilation_cache
    torch.set_num_threads(1)
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)
        jax.config.update("jax_enable_compilation_cache", cache)


def _window_f64(q, k, v, w):
    """Banded attention (|i - j| <= w) and its LSE in float64 (numpy)."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    i = np.arange(q.shape[1])
    s = np.where(np.abs(i[:, None] - i[None, :]) <= w, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    lse = np.log(p.sum(-1)) + m[..., 0]
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v), lse


@pytest.mark.parametrize("w,bq,bk", [(32, 64, 128), (100, 128, 128)])
def test_twin_matches_pallas_window_kernel(w, bq, bk):
    q, k, v = _qkv(1, 256, 2, 64, seed=w)
    with _pinned():
        pal_o, pal_l = jflash(*map(jnp.asarray, (q, k, v)), block_q=bq, block_k=bk,
                              interpret=True, window=w)
        out, lse = tflash.flash_attn_window_with_lse_ref(*map(torch.from_numpy, (q, k, v)), w)
    assert out.dtype == torch.float32 and lse.shape == (1, 2, 256)
    _close(out.numpy(), pal_o)
    _close(lse.numpy(), pal_l)
    # both against the float64 value, so a fault on either side shows as such
    ref_o, ref_l = _window_f64(q, k, v, w)
    for o, l in ((out.numpy(), lse.numpy()), (pal_o, pal_l)):
        _close(o, ref_o)
        _close(l, ref_l)


@pytest.mark.parametrize("w", [0, 4, 64, 300])
def test_twin_matches_jax_masked_sdpa(w):
    """w=0 is the diagonal (out == v, LSE == the scaled q.k of each row);
    w >= S - 1 is full attention."""
    s = 96 if w == 300 else 128
    q, k, v = _qkv(2, s, 2, 72, seed=100 + w)
    ro, rl = jattn.attn_with_lse(*map(jnp.asarray, (q, k, v)), impl="xla",
                                 mask=jwindow_mask(s, w))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = tflash.flash_attn_window_with_lse_ref(tq, tk, tv, w)
    _close(out.numpy(), ro)
    _close(lse.numpy(), rl)
    if w == 0:
        _close(out.numpy(), v)
        _close(lse.numpy(), np.einsum("bshd,bshd->bhs", q, k) * 72**-0.5)
    if w >= s - 1:
        fo, fl = tflash.flash_attn_with_lse_ref(tq, tk, tv)
        _close(out.numpy(), fo.numpy())
        _close(lse.numpy(), fl.numpy())


def test_window_argument_delegates_on_cpu_without_counting():
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 2, 72, seed=5))
    tflash.flash_attn_with_lse.launches = 0
    tflash.flash_attn_window_with_lse.launches = 0
    out, lse = tflash.flash_attn_with_lse(q, k, v, window=8)
    ref_o, ref_l = tflash.flash_attn_window_with_lse_ref(q, k, v, 8)
    assert torch.equal(out, ref_o) and torch.equal(lse, ref_l)
    out2, _ = tflash.flash_attn_window_with_lse(q, k, v, 8, scale=0.1)
    assert torch.equal(out2, tflash.flash_attn_window_with_lse_ref(q, k, v, 8, scale=0.1)[0])
    assert tflash.flash_attn_with_lse.launches == 0
    assert tflash.flash_attn_window_with_lse.launches == 0


def test_window_contract_raises_where_the_kernel_does_not_apply():
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 2, 72, seed=6))
    with pytest.raises(ValueError, match="Sq == Sk"):
        tflash.flash_attn_window_with_lse(q[:, :32], k, v, 8)
    with pytest.raises(ValueError, match="kv_lens"):
        tflash.flash_attn_with_lse(q, k, v, kv_lens=torch.tensor([10]), window=8)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attn_window_with_lse(q, k, v, -1)
    # the checks the wrapper runs before a launch on a CUDA tensor
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    tflash._check_qkv(qb, kb, vb)
    tflash._check_qkv(q, k, v)  # fp32 too, as the Pallas kernel takes the input dtype
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tflash._check_qkv(*(t.half() for t in (q, k, v)))
    with pytest.raises(ValueError, match="multiple of 8"):
        tflash._check_qkv(qb[..., :60], kb[..., :60], vb[..., :60])
    qkv = torch.zeros((1, 64, 3 * 2 * 72 + 4), dtype=torch.bfloat16)  # a row stride of 436
    bad = qkv[..., 4:4 + 144].view(1, 64, 2, 72)
    with pytest.raises(ValueError, match="strides"):
        tflash._check_qkv(bad, kb, vb)


def _band_tiles(q0, bq, bk, w, s):
    """The KV tiles the kernel visits for the q-tile at q0 (its loop bounds)."""
    lo = max(0, q0 - w) // bk
    end = min(s - 1, q0 + bq - 1 + w) // bk + 1
    return range(lo, end)


#: q-tile heights of the register body (16 rows per warp; ops/flash.REG_WARPS)
REG_BQ = (32, 64, 128)


def _warp_tiles(q0, bq, bk, w, s):
    """The register body's per-warp schedule for the q-tile at q0: (first
    row of the warp, tile, whether the tile is masked) for every visited
    tile where the warp's 16 rows have a key; the others it skips.  A tile
    is masked unless it lies wholly inside every one of the warp's bands
    and below S (``flash_reg.cuh``, BAND)."""
    for t in _band_tiles(q0, bq, bk, w, s):
        k0 = t * bk
        for w0 in range(q0, q0 + bq, 16):
            if k0 > w0 + 15 + w or k0 + bk - 1 < w0 - w:
                continue
            yield w0, t, w0 + 15 - k0 > w or k0 + bk - 1 - w0 > w or k0 + bk > s


def _tiled_band(q, k, v, w, bq, bk, guard=True, per_warp=False):
    """The kernel's online softmax (exp2 domain, running max m and sum l per
    row) over the visited tiles only, in fp32: a model of its arithmetic.
    ``per_warp``: the register body's schedule (:func:`_warp_tiles`), each
    16-row strip over its own tiles, masked only where that marks it."""
    b, s, h, d = q.shape
    scale = d**-0.5 * 1.4426950408889634
    out = torch.zeros_like(q)
    lse = torch.zeros((b, h, s))
    idx = torch.arange(s)
    if per_warp:
        strips = {}
        for q0 in range(0, s, bq):
            for w0, t, masked in _warp_tiles(q0, bq, bk, w, s):
                strips.setdefault(w0, []).append((t, masked))
        schedule = [(idx[w0:w0 + 16], tiles) for w0, tiles in sorted(strips.items())]
    else:
        schedule = [(idx[q0:q0 + bq], [(t, True) for t in _band_tiles(q0, bq, bk, w, s)])
                    for q0 in range(0, s, bq)]
    for rows, tiles in schedule:
        m = torch.full((b, h, len(rows)), float("-inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, len(rows), d))
        for t, masked in tiles:
            cols = idx[t * bk:(t + 1) * bk]
            sc = torch.einsum("bqhd,bkhd->bhqk", q[:, rows], k[:, cols]) * scale
            if masked:
                keep = (rows[:, None] - cols[None, :]).abs() <= w
                sc = torch.where(keep, sc, torch.tensor(float("-inf")))
            m_new = torch.maximum(m, sc.amax(-1))
            m_ref = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new) if guard else m_new
            p = torch.exp2(sc - m_ref[..., None])
            alpha = torch.exp2(m - m_ref)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v[:, cols])
            m = m_new
        out[:, rows] = (acc / l[..., None]).permute(0, 2, 1, 3)
        lse[..., rows] = (m + torch.log2(l)) / 1.4426950408889634
    return out, lse


def test_band_tile_schedule_skips_off_band_tiles():
    """At w=64, S=1024, 64x64 tiles an inner q-tile visits 3 of 16 KV tiles,
    so the work scales with S * w; the edges visit 2, w=0 one tile, and
    w >= S every tile."""
    counts = [len(_band_tiles(q0, 64, 64, 64, 1024)) for q0 in range(0, 1024, 64)]
    assert counts == [2] + [3] * 14 + [2]
    assert all(len(_band_tiles(q0, 64, 64, 0, 1024)) == 1 for q0 in range(0, 1024, 64))
    assert all(len(_band_tiles(q0, 64, 64, 1024, 1024)) == 16 for q0 in range(0, 1024, 64))
    # a ragged S=1000: the last q-tile stops at the last real key tile
    assert _band_tiles(960, 64, 64, 64, 1000) == range(14, 16)
    # every in-band pair lies in a visited tile
    for s, w in ((1000, 64), (1024, 4), (256, 100)):
        for q0 in range(0, s, 64):
            tiles = _band_tiles(q0, 64, 64, w, s)
            for i in range(q0, min(q0 + 64, s)):
                assert max(0, i - w) // 64 in tiles and min(s - 1, i + w) // 64 in tiles
    # the register body's tile heights: at w=64, S=1024 a 128-row tile
    # visits 4 tiles (256 keys, where a row needs 129), a 32-row tile 3
    assert [len(_band_tiles(q0, 128, 64, 64, 1024)) for q0 in range(0, 1024, 128)] == [3] + [4] * 6 + [3]
    assert [len(_band_tiles(q0, 32, 64, 64, 1024)) for q0 in range(0, 1024, 32)] == [2, 2] + [3] * 28 + [2, 2]
    # its warps skip a tile with none of their keys: at w=64 each 16-row
    # warp of a 128-row tile computes 3 of the 4 visited tiles, or 2
    per_warp = [sum(1 for w0, _, _ in _warp_tiles(q0, 128, 64, 64, 1024) if w0 == r)
                for q0 in range(128, 896, 128) for r in range(q0, q0 + 128, 16)]
    assert set(per_warp) == {3}
    assert all(len(list(_warp_tiles(q0, bq, 64, 1024, 1024))) == 16 * bq // 16
               for bq in REG_BQ for q0 in range(0, 1024, bq))


def test_first_visited_tile_without_a_key_needs_the_guard():
    """w=4, the q-tile at q0=64 visits tiles 0-2; its row 127 has no key in
    tile 0, so its running max is -inf after it.  With the guard the tiled
    online softmax equals the twin; taking exp2(-inf - -inf) gives NaN."""
    q, k, v = map(torch.from_numpy, _qkv(1, 192, 2, 16, seed=8))
    assert list(_band_tiles(64, 64, 64, 4, 192)) == [0, 1, 2]
    out, lse = _tiled_band(q, k, v, 4, 64, 64)
    ref_o, ref_l = tflash.flash_attn_window_with_lse_ref(q, k, v, 4)
    _close(out.numpy(), ref_o.numpy())
    _close(lse.numpy(), ref_l.numpy())
    bad, _ = _tiled_band(q, k, v, 4, 64, 64, guard=False)
    assert torch.isnan(bad[0, 127]).all() and not torch.isnan(bad[0, 64]).any()
    # the register body at w=4: the warp of rows 112-127 skips tile 0 (no
    # key), but a 32-row tile at q0=96 still visits tile 1 where row 127 has
    # none, and rows 16-31 of a 128-row tile visit tile 0 then 1 at w=0 only
    # where their keys are; the guard keeps each equal to the twin
    assert [t for w0, t, _ in _warp_tiles(64, 64, 64, 4, 192) if w0 == 112] == [1, 2]
    for bq in REG_BQ:
        for w in (0, 4):
            out, lse = _tiled_band(q, k, v, w, bq, 64, per_warp=True)
            ref_o, ref_l = tflash.flash_attn_window_with_lse_ref(q, k, v, w)
            _close(out.numpy(), ref_o.numpy())
            _close(lse.numpy(), ref_l.numpy())


@pytest.mark.parametrize("bq", REG_BQ)
@pytest.mark.parametrize("s,w", [(1024, 64), (1024, 4), (1024, 0), (1000, 64), (256, 100), (192, 1024)])
def test_register_band_schedule_visits_every_band_pair_once(bq, s, w):
    """The register body's per-warp schedule: every in-band (i, j) pair is
    in exactly one (warp, tile) visit, every visit holds an in-band pair of
    its warp, and a tile left unmasked holds only in-band pairs below S (of
    the rows below S)."""
    hits = {}
    for q0 in range(0, s, bq):
        for w0, t, masked in _warp_tiles(q0, bq, 64, w, s):
            rows = np.arange(w0, w0 + 16)[:, None]
            cols = np.arange(t * 64, t * 64 + 64)[None, :]
            band = (np.abs(rows - cols) <= w) & (rows < s) & (cols < s)
            assert (w0, t) not in hits and (band.any() or w0 >= s)
            if not masked:  # rows at or past S are computed, never written
                assert band[rows[:, 0] < s].all()
            hits[(w0, t)] = int(band.sum())
    assert sum(hits.values()) == sum(min(s - 1, i + w) - max(0, i - w) + 1 for i in range(s))


@pytest.mark.parametrize("bq", REG_BQ)
@pytest.mark.parametrize("s,w", [(1024, 0), (1024, 4), (1000, 64), (1000, 0)])
def test_no_visited_tile_is_off_band_for_the_cta(bq, s, w):
    """At w=0, w=4 and S=1000 a q-tile visits only K/V tiles that hold an
    in-band key of one of its rows below S."""
    for q0 in range(0, s, bq):
        rows = np.arange(q0, min(q0 + bq, s))[:, None]
        for t in _band_tiles(q0, bq, 64, w, s):
            cols = np.arange(t * 64, min(t * 64 + 64, s))[None, :]
            assert (np.abs(rows - cols) <= w).any(), (q0, t)


@pytest.mark.parametrize("bq", REG_BQ)
@pytest.mark.parametrize("w", [0, 4, 20, 200])
def test_register_band_model_matches_the_twin(bq, w):
    """The online softmax over the register body's schedule (per-warp skip,
    masks on the ragged tiles only) equals the banded twin, ragged S
    included."""
    q, k, v = map(torch.from_numpy, _qkv(1, 200, 2, 16, seed=20 + w))
    out, lse = _tiled_band(q, k, v, w, bq, 64, per_warp=True)
    ref_o, ref_l = tflash.flash_attn_window_with_lse_ref(q, k, v, w)
    _close(out.numpy(), ref_o.numpy())
    _close(lse.numpy(), ref_l.numpy())
