"""The wgmma flash body's routing and host-side geometry, decided before a
launch (``ops/flash.py``: ``flash_plan``'s kernel argument,
``wgmma_layout``, ``tma_view``) against ``csrc/flash_wgmma.cuh``; pure
Python, no card."""

import math
import re
from pathlib import Path

import pytest
import torch

from compactfusion_tpu_torch.ops import flash, probes
from tests.test_torch_flash_plan import c_struct

REPO = Path(__file__).resolve().parent.parent
HEADER = "flash_wgmma.cuh"


@pytest.mark.parametrize("d,dp", [(8, 64), (64, 64), (72, 80), (80, 80), (88, 96), (96, 96), (104, 128), (128, 128)])
@pytest.mark.parametrize("kernel", [1, 7])
def test_bf16_kernels_1_and_7_take_the_wgmma_body(kernel, d, dp):
    """Kernels 1 and 7 (and so kernel 8's flash partial) on bf16 up to d =
    128 take the wgmma body at the register body's padded head dim."""
    plan = flash.flash_plan(2, 16, 1024, d, kernel=kernel)
    assert plan == ("flash_wgmma_tile", dp, 8) and plan[1:] in flash.WG_BUILT
    assert flash.plan_args(plan) == (3, dp, 8)


@pytest.mark.parametrize("kernel,elem,d,body", [
    (4, 2, 72, "flash_reg_tile"),      # banded: the register body
    (None, 2, 72, "flash_reg_tile"),   # the stage probe's rule
    (1, 4, 72, "flash_reg_tile"),      # fp32: 3xTF32 on the register body
    (7, 4, 128, "flash_reg_tile"),
    (1, 2, 136, "flash_wide_tile"),    # above d 128: the wide body
    (7, 2, 256, "flash_wide_tile"),
    (1, 2, 1024, "flash_wide_tile"),
    (4, 2, 512, "flash_wide_tile"),
])
def test_other_launches_keep_their_bodies(kernel, elem, d, body):
    plan = flash.flash_plan(2, 16, 1024, d, elem=elem, kernel=kernel)
    assert plan[0] == body
    assert plan == flash.flash_plan(2, 16, 1024, d, elem=elem)  # the rule without the kernel


#: (kernel, B, H, Sq, d) of the table of launches that lose to cuDNN, the
#: consumer warps and CTAs the plan gives each
TABLE = [
    (7, 1, 24, 2560, 128, 8, 480),     # FLUX ring 2 hop
    (7, 1, 12, 3072, 128, 8, 288),     # FLUX U2 x R2 hop
    (7, 1, 24, 2296, 128, 8, 432),     # HunyuanVideo ring 2 hop
    (7, 1, 30, 9001, 64, 8, 2130),     # CogVideoX ring 2 hop
    (1, 1, 24, 4608, 128, 8, 864),     # FLUX self-attention
    (1, 1, 24, 18616, 128, 8, 3504),   # HunyuanVideo
    (1, 2, 30, 17776, 64, 8, 8340),    # CogVideoX-2b
    (1, 2, 24, 4293, 64, 8, 1632),     # SD3-medium
    (1, 2, 48, 17776, 64, 8, 13344),   # ConsisID
    (1, 2, 16, 4096, 88, 8, 1024),     # HunyuanDiT
    (1, 2, 16, 16384, 72, 8, 4096),    # PixArt-Sigma 2K
    (1, 2, 48, 18972, 128, 8, 14304),  # Step-Video
    (1, 2, 16, 1024, 72, 8, 256),      # PixArt-alpha
    (7, 2, 16, 512, 72, 8, 128),       # PixArt's ring 2 hop
    (7, 1, 16, 512, 72, 4, 128),       # the same at B1: 128-row tiles would give 64 CTAs
    (7, 2, 16, 128, 72, 4, 64),        # a ring-8 hop (and kernel 1's ring-8 chunk)
    (1, 2, 16, 128, 72, 4, 64),
]


@pytest.mark.parametrize("kernel,b,h,sq,d,warps,ctas", TABLE)
def test_tile_height_and_ctas_at_the_path_shapes(kernel, b, h, sq, d, warps, ctas):
    """128-row tiles (two consumer warpgroups) where they give at least 128
    CTAs, else 64-row tiles, however few CTAs those give."""
    plan = flash.flash_plan(b, h, sq, d, kernel=kernel)
    assert plan[0] == "flash_wgmma_tile" and plan[2] == warps
    assert flash.plan_rows(plan) == 16 * warps
    assert flash.plan_ctas(plan, b, h, sq) == ctas == b * h * math.ceil(sq / (16 * warps))
    if warps == 4:
        assert b * h * math.ceil(sq / 128) < flash.MIN_CTAS


def test_a_launch_with_no_key_keeps_the_register_body():
    """A tensor map cannot describe an empty K/V: kernel 1 with Sk = 0
    plans without the kernel (the register body), as the wrapper says."""
    src = (REPO / "compactfusion_tpu_torch" / "ops" / "flash.py").read_text()
    assert "kernel=1 if sk else None" in src
    ring = (REPO / "compactfusion_tpu_torch" / "ops" / "ring_flash.py").read_text()
    assert 'if plan[0] == "flash_wgmma_tile" and sk:' in ring


def _wg_layout(dp, warps):
    return c_struct(HEADER, "WgLayout", DP=dp, NWARPS=warps, cmin=min, csel=lambda c, a, b: a if c else b)


@pytest.mark.parametrize("dp,warps", sorted(flash.WG_BUILT))
def test_wgmma_layout_follows_the_c_source(dp, warps):
    """``wgmma_layout`` mirrors ``WgLayout``: 64-column blocks and a tail
    block of 16 or 32 columns (d 72 and 88 padded to 80 and 96, not 128), up
    to 4 stages within the 227 KB a CTA may take, two CTAs an SM where one
    consumer warpgroup leaves room."""
    env, mine = _wg_layout(dp, warps), flash.wgmma_layout(dp, warps)
    assert (env["kWide"], env["kTail"], env["kQBytes"], env["kTileBytes"], env["kStages"], env["kBytes"],
            bool(env["kTwoCtas"])) == (mine["wide"], mine["tail"], mine["q_bytes"], mine["tile_bytes"],
                                       mine["stages"], mine["bytes"], mine["two_ctas"])
    assert 2 <= mine["stages"] <= 4 and mine["bytes"] <= flash.SMEM_MAX
    assert 64 * mine["wide"] + mine["tail"] == dp and (mine["tail"] == 0 or mine["wide"] == 1)
    if mine["two_ctas"]:
        assert 2 * (mine["bytes"] + 1024) <= 228 * 1024
    assert {dp: flash.wgmma_layout(dp, 8)["tail"] for dp in flash.REG_DPS} == {64: 0, 80: 16, 96: 32, 128: 0}


def test_every_wgmma_plan_is_built():
    """``WG_BUILT`` lists the pairs of ``CF_WG_PLANS`` in
    ``csrc/flash_wgmma.cuh``: every (DP, consumer warps) the rule can choose
    for kernels 1 and 7, and nothing it cannot; the key tile is
    ``WG_BK``."""
    src = (REPO / "compactfusion_tpu_torch" / "csrc" / HEADER).read_text()
    macro = src[src.index("#define CF_WG_PLANS"):].split("\n", 1)[0]
    built = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
    assert built == flash.WG_BUILT
    chosen = set()
    for d in range(8, 129, 8):
        for b, h, sq in ((2, 16, 1024), (1, 16, 512), (1, 24, 4608), (2, 16, 200), (8, 16, 4096)):
            for kernel in (1, 7):
                plan = flash.flash_plan(b, h, sq, d, kernel=kernel)
                if plan[0] == "flash_wgmma_tile":
                    chosen.add(plan[1:])
    assert chosen == built
    assert int(re.search(r"constexpr int kWgBK = (\d+);", src).group(1)) == flash.WG_BK


def test_tma_view_of_qkv_column_slices():
    """PixArt's q/k/v as (B, S, H, D) column slices of one qkv tensor: the
    maps' dims (D, S, H, B), the byte strides of S, H and B through the
    slice (the qkv row is 3 x 1152 elements), at DP 80 boxes of 64 columns
    (128-byte swizzle) and of the 16-column tail (32-byte), by the tile's
    rows."""
    qkv = torch.zeros((2, 1024, 3 * 1152), dtype=torch.bfloat16)
    q, k, v = (t.view(2, 1024, 16, 72) for t in qkv.split(1152, dim=-1))
    for name, t in (("q", q), ("k", k), ("v", v)):
        view = flash.tma_view(name, t, 80, 128)
        assert view == {"dims": (72, 1024, 16, 2), "strides": (3456 * 2, 72 * 2, 1024 * 3456 * 2),
                        "boxes": ((64, 128, 1, 1), (16, 128, 1, 1)), "swizzles": (128, 32)}
    # FLUX's contiguous (B, S, H, D) at d 128: one map, two 64-column boxes a row
    x = torch.zeros((1, 4608, 24, 128), dtype=torch.bfloat16)
    assert flash.tma_view("k", x, 128, flash.WG_BK) == {
        "dims": (128, 4608, 24, 1), "strides": (24 * 128 * 2, 128 * 2, 4608 * 24 * 128 * 2),
        "boxes": ((64, 128, 1, 1),), "swizzles": (128,)}
    # d 88 on DP 96: a 32-column tail (64-byte swizzle); an empty key block still has a row
    y = torch.zeros((2, 0, 8, 88), dtype=torch.bfloat16)
    assert flash.tma_view("k", y, 96, flash.WG_BK)["dims"] == (88, 1, 8, 2)
    assert flash.tma_view("k", y, 96, 64)["boxes"] == ((64, 64, 1, 1), (32, 64, 1, 1))
    assert flash.tma_view("k", y, 96, 64)["swizzles"] == (128, 64)


@pytest.mark.parametrize("make", [
    lambda x: x[..., 1:89].unsqueeze(2),                                   # a start 2 bytes off
    lambda x: x[..., 4:180].unflatten(-1, (2, 88)),                        # a start 8 bytes off
    lambda x: x[..., :180].contiguous().unflatten(-1, (2, 90))[..., :88],  # strides of 180 and 90 elements
])
def test_tma_view_rejects_a_misaligned_view(make):
    """TMA reads 16-byte aligned rows through 16-byte multiples of strides:
    a view that breaks the kernels' contract is refused before any map is
    encoded."""
    x = torch.zeros((2, 64, 192), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash.tma_view("q", make(x), 96, 64)


def test_stage_probe_stays_on_the_register_body():
    """The stage probe takes kernel 1's register body apart: its plan is
    the register rule's at the self-attention shape, which kernel 1 takes
    when the probe passes it explicitly; the pipeline's own plan there is
    the wgmma body's."""
    assert probes.PLAN == ("flash_reg_tile", 80, 8) == flash.flash_plan(2, 16, 1024, 72)
    assert flash.flash_plan(2, 16, 1024, 72, kernel=1) == ("flash_wgmma_tile", 80, 8)
    src = (REPO / "compactfusion_tpu_torch" / "probes" / "flash_parts.py").read_text()
    assert "flash_attn_with_lse(q, k, v, plan=ops_probes.PLAN)" in src


def test_an_explicit_plan_runs_the_twin_on_the_cpu():
    """On CPU tensors the plan argument changes nothing: the twin runs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 40, 2, 64), generator=g).to(torch.bfloat16) for _ in range(3))
    out, lse = flash.flash_attn_with_lse(q, k, v, plan=flash.flash_plan(1, 2, 40, 64))
    ref_out, ref_lse = flash.flash_attn_with_lse_ref(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
