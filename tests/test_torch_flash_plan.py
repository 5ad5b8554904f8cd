"""The flash kernels' routing (``ops/flash.py::flash_plan``), decided on the
host before a launch, and the build comparison's filter
(``tools/compare_kernel_builds.py``); both pure Python, no card."""

import importlib.util
import math
import re
from pathlib import Path

import pytest

from compactfusion_tpu_torch.ops import flash, probes

REPO = Path(__file__).resolve().parent.parent


def _compare_tool():
    spec = importlib.util.spec_from_file_location("compare_kernel_builds",
                                                  REPO / "tools" / "compare_kernel_builds.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctas(plan, b, h, sq):
    return b * h * math.ceil(sq / flash.plan_rows(plan))


def test_self_attention_takes_the_register_body_at_dp_80():
    """128-row tiles (256 CTAs): 8 % faster than 64-row tiles on an H100."""
    plan = flash.flash_plan(2, 16, 1024, 72)
    assert plan == ("flash_reg_tile", 80, 8) and _ctas(plan, 2, 16, 1024) == 256
    assert plan == probes.PLAN  # the stage probe runs kernel 1's plan


def test_ring_8_chunk_fills_the_card():
    """Kernel 1 at the ring-8 chunk (B2 Sq128 against Sk1024) and kernel 7's
    ring-8 hop, one rule: 32-row tiles, 128 CTAs where 64-row tiles give 64."""
    plan = flash.flash_plan(2, 16, 128, 72)
    assert plan == ("flash_reg_tile", 80, 2) and _ctas(plan, 2, 16, 128) == 128
    # the shortest tile of a plan is 32 rows, however small the grid
    assert flash.flash_plan(1, 16, 128, 72) == ("flash_reg_tile", 80, 2)


@pytest.mark.parametrize("b,warps", [(2, 8), (1, 4)])
def test_ring_2_takes_the_tallest_tile_with_128_ctas(b, warps):
    plan = flash.flash_plan(b, 16, 512, 72)
    assert plan == ("flash_reg_tile", 80, warps) and _ctas(plan, b, 16, 512) == 128


@pytest.mark.parametrize("d,dp", [(8, 64), (64, 64), (72, 80), (80, 80), (88, 96), (96, 96),
                                  (104, 128), (120, 128), (128, 128)])
def test_head_dims_up_to_128_take_the_smallest_padded_dim(d, dp):
    body, got, warps = flash.flash_plan(2, 16, 1024, d)
    assert (body, got) == ("flash_reg_tile", dp) and (got, warps) in flash.REG_BUILT


@pytest.mark.parametrize("d,warps", [(136, 4), (256, 4), (264, 2), (512, 2)])
def test_wide_heads_keep_the_shared_memory_body(d, warps):
    """Kernels 4 and 7 (``wide=False``) keep ``flash_tile`` above d=128:
    64x64 tiles up to a padded head dim of 256, 32x32 tiles on 2 warps
    above; kernel 1 keeps it only above d=512, in 32x32 tiles."""
    assert flash.flash_plan(1, 1, 4096, d, wide=False) == ("flash_tile", -(-d // 16) * 16, warps)
    for d1 in (520, 1024):
        assert flash.flash_plan(1, 1, 4096, d1) == ("flash_tile", -(-d1 // 16) * 16, 2)


@pytest.mark.parametrize("d,dp,slices,warps,ctas", [(136, 160, 2, 4, 128), (256, 256, 2, 4, 128),
                                                    (264, 288, 3, 6, 128), (512, 512, 4, 8, 128)])
def test_kernel_1_takes_the_wide_body_above_128(d, dp, slices, warps, ctas):
    """Kernel 1 at 128 < d <= 512 on the VAE's B1 H1 S4096: the wide body,
    ceil(d / 128) slices of one of ``REG_DPS`` each, 2 row groups of 16
    (32-row tiles, 128 CTAs)."""
    plan = flash.flash_plan(1, 1, 4096, d)
    assert plan == ("flash_wide_tile", dp, warps) and (dp, warps) in flash.WIDE_BUILT
    assert flash.wide_slices(dp) == slices and flash.plan_rows(plan) == 32
    assert _ctas(plan, 1, 1, 4096) == ctas
    # a bigger grid keeps 32-row tiles: 64-row tiles measured slower at the VAE
    big = flash.flash_plan(2, 2, 4096, d)
    assert big == plan and _ctas(big, 2, 2, 4096) == 4 * ctas


@pytest.mark.parametrize("d", range(136, 513, 8))
def test_wide_slices_cover_the_head_dim(d):
    """Every wide head dim is cut into slices of 16..128 columns, a multiple
    of 16 each, none of them wholly padding."""
    _, dp, warps = flash.flash_plan(1, 1, 4096, d)
    slices = flash.wide_slices(dp)
    ds = dp // slices
    assert ds * slices == dp >= d and ds % 16 == 0 and ds <= flash.WIDE_SLICE
    assert ds * (slices - 1) < d and warps % slices == 0


@pytest.mark.parametrize("d", [64, 72, 512])
def test_banded_attention_keeps_the_shared_memory_body(d):
    """Only above a head dim of 128: the banded kernel takes ``flash_plan``'s
    plan, which keeps ``flash_tile`` there (d=512: 32x32 tiles on 2 warps)
    and takes the register body up to 128 (and the C entry of the banded
    kernel launches the plan of either body)."""
    body, dp, warps = flash.flash_plan(2, 16, 1024, d, wide=False)
    if d <= 128:
        assert body == "flash_reg_tile" and (dp, warps) in flash.REG_BUILT
    else:
        assert body == "flash_tile" and dp == -(-d // 16) * 16 and warps == 2
    src = (REPO / "compactfusion_tpu_torch" / "ops" / "flash.py").read_text()
    window = src[src.index("def flash_attn_window_with_lse("):]
    assert "launch_plan(b, h, s, d, q.dtype, wide=False)" in window
    # the ring hops (kernels 7 and 8's flash partial) take the same
    ring = (REPO / "compactfusion_tpu_torch" / "ops" / "ring_flash.py").read_text()
    assert ring.count("launch_plan(b, h, sq, d, q.dtype, wide=False)") == 2


@pytest.mark.parametrize("b,s,ctas", [(2, 1024, 256), (1, 1024, 128), (2, 1000, 256)])
def test_banded_pixart_takes_the_register_body(b, s, ctas):
    """Kernel 4 at phase 2's shapes (B2, the CFG half, a ragged S=1000):
    DP 80, 128-row tiles, at least 128 CTAs."""
    plan = flash.flash_plan(b, 16, s, 72)
    assert plan == ("flash_reg_tile", 80, 8) and _ctas(plan, b, 16, s) == ctas


def test_plans_the_kernels_do_not_take_raise():
    with pytest.raises(ValueError, match="multiple of 8"):
        flash.flash_plan(1, 1, 64, 60)


def _c_layout_bytes(d, bq, bk):
    """``flash_common.cuh::make_layout(d, bq, bk).bytes``, run from the C
    source: its statements are also Python once ``L.`` is a name prefix."""
    src = (REPO / "compactfusion_tpu_torch" / "csrc" / "flash_common.cuh").read_text()
    body = src[src.index("inline Layout make_layout("):].split("{", 1)[1].split("\n}", 1)[0]
    env = {"d": d, "bq": bq, "bk": bk, "round_up": lambda x, m: -(-x // m) * m,
           "align128": lambda x: (x + 127) & ~127}
    for stmt in body.replace("L.", "L_").split(";"):
        stmt = stmt.strip().removeprefix("int ")
        if "=" in stmt:
            exec(stmt, env)
    return env["L_bytes"]


def test_tile_64_max_dp_follows_the_c_layout():
    """``TILE_64_MAX_DP`` is the widest padded head dim whose 64x64 layout
    stays under 200 KB, and the VAE's d=512 fits the card in 32x32 tiles."""
    assert _c_layout_bytes(72, 64, 64) == 11264 * 3 + 17408 + 9216 + 21504 + 256 * 3
    assert _c_layout_bytes(flash.TILE_64_MAX_DP, 64, 64) <= 200 * 1024
    assert _c_layout_bytes(flash.TILE_64_MAX_DP + 16, 64, 64) > 200 * 1024
    assert _c_layout_bytes(512, 32, 32) == 33280 * 3 + 4608 + 2560 + 66048 + 128 * 3 <= 227 * 1024


def c_struct(header, name, **env):
    """The members of ``struct name`` in a ``csrc`` header, run from the C
    source: its statements are Python once comments and ``static constexpr
    int`` go, C's integer ``/`` is ``//`` and ``cdiv`` is a ceiling
    division; ``env`` holds its template arguments and the constants it
    reads (``kWideBK`` and ``kRegBK`` are read from the header)."""
    src = (REPO / "compactfusion_tpu_torch" / "csrc" / header).read_text()
    body = src[src.index(f"struct {name} {{"):].split("{", 1)[1].split("\n};", 1)[0]
    env = {"cdiv": lambda a, b: -(-a // b), **env}
    for const in re.findall(r"constexpr int (k\w+BK) = (\d+);", src):
        env.setdefault(const[0], int(const[1]))
    for stmt in re.sub(r"//[^\n]*", "", body).split(";"):
        stmt = stmt.strip().removeprefix("static constexpr int ")
        if "=" in stmt:
            exec(stmt.replace("/", "//"), env)
    return env


def _wide_layout_bytes(dp, warps, elem=2):
    """``flash_wide.cuh::WideLayout<dp, warps, elem>``'s members."""
    return c_struct("flash_wide.cuh", "WideLayout", DP=dp, NWARPS=warps, ELEM=elem)


def test_wide_layout_fits_the_card():
    """Every built wide plan's shared memory (Q tile, K/V ring, exchange)
    fits the 227 KB a CTA may take; the VAE's plan has room for 2 ring
    stages, and the narrower heads take 3 stages."""
    for dp, warps in flash.WIDE_BUILT:
        env = _wide_layout_bytes(dp, warps)
        assert env["kBytes"] <= 227 * 1024 and env["kStages"] in (2, 3)
        assert env["kSlices"] == flash.wide_slices(dp) and env["kGroups"] * env["kSlices"] == warps
    vae = _wide_layout_bytes(512, 8)
    assert (vae["kStages"], vae["kBytes"]) == (2, 33280 + 2 * 2 * 33280 + 16384)
    assert _wide_layout_bytes(160, 4)["kStages"] == 3


def test_every_wide_plan_is_built():
    """``WIDE_BUILT`` lists the pairs of ``CF_WIDE_PLANS`` in
    ``csrc/flash_wide.cuh``: every (DP, warps) the rule can choose at
    128 < d <= 512, and nothing it cannot."""
    src = (REPO / "compactfusion_tpu_torch" / "csrc" / "flash_wide.cuh").read_text()
    macro = src[src.index("#define CF_WIDE_PLANS"):].split("\n\n")[0]
    built = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
    assert built == flash.WIDE_BUILT
    chosen = {flash.flash_plan(b, h, sq, d)[1:] for d in range(136, 513, 8)
              for b, h, sq in ((1, 1, 4096), (1, 1, 64), (2, 2, 4096))}
    assert chosen == built


def test_every_plan_is_built():
    """``REG_BUILT`` lists the pairs of ``CF_REG_PLANS`` in
    ``csrc/flash_reg.cuh``: every (DP, warps) the rule can choose, and
    nothing it cannot."""
    src = (REPO / "compactfusion_tpu_torch" / "csrc" / "flash_reg.cuh").read_text()
    macro = src[src.index("#define CF_REG_PLANS"):].split("\n\n")[0]
    built = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
    assert built == flash.REG_BUILT
    chosen = {flash.flash_plan(b, h, sq, dp)[1:] for dp in flash.REG_DPS
              for b, h, sq in ((2, 16, 1024), (1, 16, 512), (2, 16, 128), (1, 1, 16), (8, 16, 4096))}
    assert chosen == built


def test_ef_tile_rows_follow_the_c_source():
    """``ops/ring_flash.py::EF_ROWS`` sizes the int8 EF pass's scratch (a
    min and a max per channel and row tile); ``kEfRows`` of
    ``csrc/ring_flash.cu`` tiles the grid."""
    from compactfusion_tpu_torch.ops import ring_flash

    src = (REPO / "compactfusion_tpu_torch" / "csrc" / "ring_flash.cu").read_text()
    assert int(re.search(r"constexpr int kEfRows = (\d+);", src).group(1)) == ring_flash.EF_ROWS


def _build(labels):
    """A made-up build: ({label: ptxas line}, {label: SASS hash})."""
    return ({k: f"Used {r} registers" for k, (r, _) in labels.items()},
            {k: h for k, (_, h) in labels.items()})


BEFORE = {"flash_fwd_kernel<4, 64>": (64, "a"), "flash_fwd_kernel<2, 32>": (40, "b"),
          "flash_window_kernel<4, 64>": (64, "c"), "flash_window_kernel<2, 32>": (40, "d"),
          "flash_window_reg_kernel<80, 8>": (130, "e"), "ring_flash_hop_kernel<4, 64>": (64, "f"),
          "flash_fwd_reg_kernel<80, 8>": (135, "g"), "ring_flash_hop_reg_kernel<80, 2>": (96, "h"),
          "flash_parts_kernel<31>": (135, "i"), "dma_only_kernel": (40, "j"), "plumb_kernel": (32, "p"),
          "ef_update_fp32_kernel": (40, "q"), "ef_minmax_int8_kernel": (40, "r"),
          "ef_codes_int8_kernel": (40, "s"),
          "binary_quant_kernel<float, float>": (32, "k"), "binary_dequant_kernel<float>": (30, "l"),
          "int2_quant_kernel<float, float>": (32, "m"), "int2_dequant_kernel<float>": (30, "n"),
          "flash_fwd_wide_kernel<512, 8>": (210, "o"), "binary_quant_vec_kernel<float, float>": (64, "t"),
          "binary_dequant_vec_kernel<float, 1>": (56, "v"), "int2_dequant_vec_kernel<float, 1>": (40, "w"),
          "int2_quant_vec_kernel<float, float, 1>": (48, "x"), "empty_kernel": (8, "u")}


def test_compare_tool_passes_when_only_redesigned_kernels_differ():
    """The fp32 instantiations of kernels 1, 4, 7 and 8 may come; every
    kernel the parent built (every bf16 flash body, the EF pass, the probes,
    every quant and dequant kernel, INT2 quant's two among them) must stay
    as it was, and a change to any of them fails."""
    tool = _compare_tool()
    new = {"flash_fwd_reg_f32_kernel<80, 8>": (150, "x1"), "flash_window_reg_f32_kernel<80, 8>": (150, "x2"),
           "ring_flash_hop_reg_f32_kernel<80, 2>": (120, "x3"), "flash_fwd_wide_f32_kernel<512, 8>": (200, "x4"),
           "ef_update_fp32_f32rec_kernel": (32, "x5"), "ef_codes_int8_f32rec_kernel": (40, "x6")}
    ok, report = tool.verdict(_build(dict(BEFORE, **new)), _build(BEFORE))
    assert ok and report["unmatched"] == []
    kernels = report["kernels"]
    for label in ("flash_fwd_reg_kernel<80, 8>", "flash_window_reg_kernel<80, 8>", "flash_fwd_kernel<4, 64>",
                  "flash_fwd_wide_kernel<512, 8>", "ef_update_fp32_kernel", "ef_codes_int8_kernel", "dma_only_kernel",
                  "binary_quant_kernel<float, float>", "binary_quant_vec_kernel<float, float>",
                  "binary_dequant_kernel<float>", "int2_dequant_kernel<float>", "binary_dequant_vec_kernel<float, 1>",
                  "int2_dequant_vec_kernel<float, 1>", "int2_quant_kernel<float, float>",
                  "int2_quant_vec_kernel<float, float, 1>", "empty_kernel"):
        assert kernels[label]["must_be_unchanged"] and kernels[label]["sass_equal"], label
    for label in new:
        assert not kernels[label]["must_be_unchanged"], label
    for label in ("int2_quant_vec_kernel<float, float, 1>", "int2_quant_kernel<float, float>"):
        changed = dict(BEFORE, **{label: (BEFORE[label][0], "changed")})
        assert not tool.verdict(_build(dict(changed, **new)), _build(BEFORE))[0], label


@pytest.mark.parametrize("label,change", [
    ("flash_fwd_reg_kernel<80, 8>", (135, "g2")),       # SASS
    ("flash_window_reg_kernel<80, 8>", (131, "e")),     # ptxas line
    ("ef_update_fp32_kernel", None),                    # missing on this side
    ("ring_flash_hop_reg_kernel<80, 2>", (96, "h2")),
    ("flash_parts_kernel<31>", (136, "i")),
    ("dma_only_kernel", (40, "j2")),
    ("int2_dequant_kernel<float>", None),
    ("binary_quant_vec_kernel<float, float>", (64, "t2")),
    ("int2_dequant_vec_kernel<float, 1>", (40, "w2")),
    ("flash_fwd_wide_kernel<512, 8>", (212, "o")),
    ("flash_fwd_kernel<4, 64>", None),
    ("int2_quant_vec_kernel<float, float, 1>", (48, "x2")),
    ("int2_quant_kernel<float, float>", (33, "m2")),
])
def test_compare_tool_fails_when_a_listed_kernel_changes(label, change):
    tool = _compare_tool()
    after = dict(BEFORE)
    if change is None:
        del after[label]
    else:
        after[label] = change
    ok, report = tool.verdict(_build(after), _build(BEFORE))
    assert not ok and report["kernels"][label]["must_be_unchanged"]


def test_compare_tool_patterns():
    tool = _compare_tool()
    assert tool.matches("flash_window_kernel<4, 64>", "flash_window_kernel<...>")
    assert not tool.matches("flash_fwd_reg_kernel<80, 4>", "flash_fwd_kernel<...>")
    assert not tool.matches("flash_window_reg_kernel<80, 8>", "flash_fwd_reg_kernel<...>")
    assert tool.matches("dma_only_kernel", "dma_only_kernel")
    assert tool.matches("flash_fwd_kernel<2, 32>", "flash_fwd_kernel<2, 32>")
    assert not tool.matches("flash_fwd_kernel<4, 64>", "flash_fwd_kernel<2, 32>")
    # a pattern that names nothing fails: a renamed kernel cannot pass unseen
    ok, report = tool.verdict(_build(BEFORE), _build(BEFORE), ["flash_tile_kernel<...>"])
    assert not ok and report["unmatched"] == ["flash_tile_kernel<...>"]
    assert tool.verdict(_build(BEFORE), _build(BEFORE))[0]


def test_compare_tool_reads_sass_without_the_sources_namespace_name():
    """An edit anywhere in a source renames its anonymous namespace; the
    instructions that name a symbol of it compare equal all the same."""
    tool = _compare_tool()
    before = "  /*0010*/  CALL.REL `(_ZN46_GLOBAL__N__0110b69f_13_flash_attn_cu_3b6b32e116foo) ;\n\n  EXIT ;"
    after = before.replace("0110b69f", "9a1c0d2e").replace("3b6b32e1", "77aa01f3")
    assert tool.sass_text(before) == tool.sass_text(after)
    assert "_GLOBAL__N_16foo" in tool.sass_text(after)
    # cuobjdump pads the columns of an object to its longest name
    assert tool.sass_text(before.replace("  CALL", "        CALL")) == tool.sass_text(before)
    assert tool.sass_text(before) != tool.sass_text(before.replace("EXIT", "BRA"))


def test_compare_tool_counts_the_loads_before_the_first_store():
    tool = _compare_tool()
    body = "\n".join(["  /*0000*/  LDG.E.128 R4, desc[UR4][R2.64] ;", "  /*0010*/  LDG.E R8, desc[UR4][R6.64] ;",
                      "  /*0020*/  FADD R4, R4, R8 ;", "  /*0030*/  STG.E.128 desc[UR4][R10.64], R4 ;",
                      "  /*0040*/  LDG.E R9, desc[UR4][R6.64+0x4] ;", "  /*0050*/  EXIT ;"])
    assert tool.loads_before_store(body) == 2
    assert tool.loads_before_store(body.replace("STG", "STS")) == 3
