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


@pytest.mark.parametrize("d,warps", [(136, 4), (256, 4), (264, 6), (512, 8)])
def test_wide_heads_keep_the_shared_memory_body(d, warps):
    """Kernels 4 and 7 take kernel 1's plan: the wide body above d=128,
    whose CTA keeps the Q tile, the K/V ring and the exchange in shared
    memory and the accumulator in registers, on one CTA up to d=512 and on
    a cluster above."""
    plan = flash.flash_plan(1, 1, 4096, d)
    assert plan[0] == "flash_wide_tile" and plan[2] == warps and plan[1:] in flash.WIDE_BUILT
    assert flash.wide_parts(plan[1]) == 1
    for d1, dp, warps1 in ((520, 576, 6), (1024, 1024, 8)):
        assert flash.flash_plan(1, 1, 4096, d1) == ("flash_wide_tile", dp, warps1)
        assert flash.wide_parts(dp) == 2


@pytest.mark.parametrize("d,dp,parts,warps", [(520, 576, 2, 6), (576, 576, 2, 6), (768, 768, 2, 6),
                                              (1024, 1024, 2, 8), (1032, 1152, 3, 6), (1536, 1536, 3, 8),
                                              (1544, 2048, 4, 8), (1552, 2048, 4, 8), (2048, 2048, 4, 8)])
def test_heads_above_512_split_over_a_cluster(d, dp, parts, warps):
    """Above d=512 the head dim is cut into ceil(d / 512) parts, one CTA of
    a cluster each, every part a plan of one CTA of the wide body
    (``WIDE_SPLIT_BUILT``) with at least one column of d, and the grid has
    one CTA per (query tile, part)."""
    for elem in (2, 4):
        plan = flash.flash_plan(1, 2, 1000, d, elem=elem)
        assert plan == ("flash_wide_tile", dp, warps)
        assert flash.wide_parts(dp) == parts and (dp // parts, warps) in flash.WIDE_SPLIT_BUILT
        assert (parts - 1) * (dp // parts) < d <= dp
        assert flash.plan_rows(plan) == 32 and flash.plan_ctas(plan, 1, 2, 1000) == 2 * 32 * parts


def test_head_dims_past_the_widest_plan_raise():
    """The widest head dim is 4 CTAs of 512 columns; wider ones raise before
    a launch, naming the limit."""
    assert flash.WIDE_MAX_D == 2048 and flash.flash_plan(1, 1, 64, 2048)[0] == "flash_wide_tile"
    for elem in (2, 4):
        with pytest.raises(ValueError, match="head dim at most 2048"):
            flash.flash_plan(1, 1, 64, 2056, elem=elem)


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


@pytest.mark.parametrize("d", range(136, flash.WIDE_MAX_D + 1, 8))
def test_wide_slices_cover_the_head_dim(d):
    """Every wide head dim is cut into parts of at most 512 columns, one CTA
    each, every CTA with at least one column of d, and each part into
    slices of 16..128 columns, a multiple of 16 each; on one CTA none of
    them is wholly padding (a cluster's parts are one of the three built
    widths, so its last CTA may hold padded slices: d = 584 takes 2 x 384)."""
    _, dp, warps = flash.flash_plan(1, 1, 4096, d)
    parts, slices = flash.wide_parts(dp), flash.wide_slices(dp)
    ds = dp // parts // slices
    assert ds * slices * parts == dp >= d and ds % 16 == 0 and ds <= flash.WIDE_SLICE
    assert dp // parts <= flash.WIDE_PART and (parts - 1) * (dp // parts) < d and warps % slices == 0
    if parts == 1:
        assert ds * (slices - 1) < d


@pytest.mark.parametrize("d", [64, 72, 512])
def test_banded_attention_keeps_the_shared_memory_body(d):
    """The banded kernel and the ring hops (kernels 7 and 8's flash partial)
    plan as kernel 1 does: the register body up to d=128, the wide body
    above (d=512: 4 slices of 128, 8 warps, one CTA); the wrappers call
    ``launch_plan`` with no other argument."""
    body, dp, warps = flash.flash_plan(2, 16, 1024, d)
    if d <= 128:
        assert body == "flash_reg_tile" and (dp, warps) in flash.REG_BUILT
    else:
        assert (body, dp, warps) == ("flash_wide_tile", 512, 8)
    src = (REPO / "compactfusion_tpu_torch" / "ops" / "flash.py").read_text()
    window = src[src.index("def flash_attn_window_with_lse("):]
    assert "launch_plan(b, h, s, d, q.dtype)" in window
    ring = (REPO / "compactfusion_tpu_torch" / "ops" / "ring_flash.py").read_text()
    # the ring hops ask as kernel 7, whose bf16 launches up to d=128 take the
    # wgmma body (tests/test_torch_flash_wgmma_plan.py); fp32 keeps this rule
    assert ring.count("launch_plan(b, h, sq, d, q.dtype, kernel=7)") == 2
    for d1 in (64, 72):
        assert flash.flash_plan(2, 16, 1024, d1, elem=4, kernel=7)[0] == "flash_reg_tile"
    assert "wide=" not in src + ring


@pytest.mark.parametrize("b,s,ctas", [(2, 1024, 256), (1, 1024, 128), (2, 1000, 256)])
def test_banded_pixart_takes_the_register_body(b, s, ctas):
    """Kernel 4 at phase 2's shapes (B2, the CFG half, a ragged S=1000):
    DP 80, 128-row tiles, at least 128 CTAs."""
    plan = flash.flash_plan(b, 16, s, 72)
    assert plan == ("flash_reg_tile", 80, 8) and _ctas(plan, b, 16, s) == ctas


def test_plans_the_kernels_do_not_take_raise():
    with pytest.raises(ValueError, match="multiple of 8"):
        flash.flash_plan(1, 1, 64, 60)


def c_struct(header, name, **env):
    """The members of ``struct name`` in a ``csrc`` header, run from the C
    source: its statements are Python once comments and ``static constexpr
    int`` (or ``bool``) go, C's integer ``/`` is ``//``, ``&&`` and ``!`` are
    ``and`` and ``not``, and ``cdiv`` is a ceiling division; ``env`` holds
    its template arguments and the constants it reads (``kWideBK`` and
    ``kRegBK`` are read from the header)."""
    src = (REPO / "compactfusion_tpu_torch" / "csrc" / header).read_text()
    body = src[src.index(f"struct {name} {{"):].split("{", 1)[1].split("\n};", 1)[0]
    env = {"cdiv": lambda a, b: -(-a // b), **env}
    for const in re.findall(r"constexpr int (k\w+BK) = (\d+);", src):
        env.setdefault(const[0], int(const[1]))
    for stmt in re.sub(r"//[^\n]*", "", body).split(";"):
        stmt = re.sub(r"^static constexpr (int|bool) ", "", stmt.strip())
        if "=" in stmt:
            stmt = re.sub(r"!(?!=)", " not ", stmt.replace("&&", " and ").replace("/", "//"))
            exec(stmt, env)
    return env


def _wide_layout_bytes(dp, warps, elem=2, split=False):
    """``flash_wide.cuh::WideLayout<dp, warps, elem, split>``'s members."""
    return c_struct("flash_wide.cuh", "WideLayout", DP=dp, NWARPS=warps, ELEM=elem, SPLIT=split)


@pytest.mark.parametrize("split", [False, True])
def test_wide_layout_fits_the_card(split):
    """Every built wide plan's shared memory (Q tile, K/V ring, exchange;
    the split kernels' also the row groups' sums) fits the 227 KB a CTA may
    take, as ``ops/flash.py::wide_layout`` mirrors it; the VAE's plan has
    room for 2 ring stages, the narrower heads take 3, and the split
    kernels 2 where two CTAs then share an SM."""
    for dp, warps in flash.WIDE_BUILT:
        for elem in (2, 4):
            env = _wide_layout_bytes(dp, warps, elem, split)
            mine = flash.wide_layout(dp, warps, elem, split)
            assert env["kBytes"] <= 227 * 1024 and env["kStages"] in (2, 3)
            assert (env["kBytes"], env["kStages"], env["kXchBytes"], bool(env["kTwoCtas"])) == \
                (mine["bytes"], mine["stages"], mine["xch_bytes"], mine["two_ctas"])
            assert env["kSlices"] == flash.wide_slices(dp) and env["kGroups"] * env["kSlices"] == warps
            if mine["two_ctas"]:
                assert 2 * (mine["bytes"] + 1024) <= 228 * 1024
    vae = _wide_layout_bytes(512, 8)
    assert (vae["kStages"], vae["kBytes"]) == (2, 33280 + 2 * 2 * 33280 + 16384)
    assert _wide_layout_bytes(160, 4)["kStages"] == 3
    assert [flash.wide_layout(dp, 2 * flash.wide_slices(dp), 2, True)["two_ctas"] for dp in flash.WIDE_DPS] == \
        [True, True, True, True, False, False]


def test_every_wide_plan_is_built():
    """``WIDE_BUILT`` lists the pairs of ``CF_WIDE_PLANS`` and
    ``WIDE_SPLIT_BUILT`` those of ``CF_WIDE_SPLIT_PLANS`` in
    ``csrc/flash_wide.cuh``: every (DP, warps) of one CTA the rule can
    choose at 128 < d <= 512 (every flash kernel) and above (kernel 1's
    split kernels), and nothing it cannot."""
    src = (REPO / "compactfusion_tpu_torch" / "csrc" / "flash_wide.cuh").read_text()
    for macro_name, want, ds in (("CF_WIDE_PLANS", flash.WIDE_BUILT, range(136, 513, 8)),
                                 ("CF_WIDE_SPLIT_PLANS", flash.WIDE_SPLIT_BUILT, range(520, flash.WIDE_MAX_D + 1, 8))):
        macro = src[src.index(f"#define {macro_name}("):].split("\n", 1)[0]
        built = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
        assert built == want, macro_name
        chosen = set()
        for d in ds:
            for b, h, sq in ((1, 1, 4096), (1, 1, 64), (2, 2, 4096)):
                _, dp, warps = flash.flash_plan(b, h, sq, d)
                chosen.add((dp // flash.wide_parts(dp), warps))
        assert chosen == built, macro_name
    assert flash.WIDE_SPLIT_BUILT < flash.WIDE_BUILT
    assert int(re.search(r"constexpr int kWidePart = (\d+);", src).group(1)) == flash.WIDE_PART
    assert int(re.search(r"constexpr int kWideMaxParts = (\d+);", src).group(1)) == flash.WIDE_MAX_PARTS


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


BEFORE = {"flash_fwd_kernel<2, 32>": (40, "b"), "flash_window_kernel<4, 64>": (64, "c"),
          "flash_window_kernel<2, 32>": (40, "d"), "ring_flash_hop_kernel<4, 64>": (64, "f"),
          "flash_fwd_f32_kernel<2, 32>": (48, "b4"), "flash_window_f32_kernel<4, 64>": (72, "c4"),
          "ring_flash_hop_f32_kernel<4, 64>": (64, "f4"),
          "flash_window_reg_kernel<80, 8>": (130, "e"), "flash_fwd_reg_kernel<80, 8>": (135, "g"),
          "ring_flash_hop_reg_kernel<80, 2>": (96, "h"), "flash_fwd_reg_f32_kernel<80, 8>": (142, "g4"),
          "flash_window_reg_f32_kernel<80, 8>": (146, "e4"), "ring_flash_hop_reg_f32_kernel<80, 2>": (140, "h4"),
          "flash_parts_kernel<31>": (135, "i"), "dma_only_kernel": (40, "j"), "plumb_kernel": (32, "p"),
          "ef_update_fp32_kernel": (40, "q"), "ef_minmax_int8_kernel": (40, "r"),
          "ef_codes_int8_kernel": (40, "s"), "ef_update_fp32_f32rec_kernel": (32, "q4"),
          "ef_codes_int8_f32rec_kernel": (40, "s4"),
          "binary_quant_kernel<float, float>": (32, "k"), "binary_dequant_kernel<float>": (30, "l"),
          "int2_quant_kernel<float, float>": (32, "m"), "int2_dequant_kernel<float>": (30, "n"),
          "flash_fwd_wide_kernel<512, 8>": (210, "o"), "flash_fwd_wide_f32_kernel<512, 8>": (157, "o4"),
          "binary_quant_vec_kernel<float, float>": (64, "t"),
          "binary_dequant_vec_kernel<float, 1>": (56, "v"), "int2_dequant_vec_kernel<float, 1>": (40, "w"),
          "int2_quant_vec_kernel<float, float, 1>": (48, "x"), "empty_kernel": (8, "u")}
#: the wide body's banded, ring and split kernels, which the parent added
WIDE_NEW = {"flash_window_wide_kernel<256, 4>": (174, "y1"), "ring_flash_hop_wide_kernel<256, 4>": (176, "y2"),
            "flash_fwd_wide_split_kernel<512, 8>": (233, "y3"), "flash_window_wide_f32_kernel<256, 4>": (164, "y4"),
            "ring_flash_hop_wide_f32_kernel<256, 4>": (191, "y5"),
            "flash_fwd_wide_split_f32_kernel<512, 8>": (156, "y6")}
#: the shared-memory body's kernels, which the wide body's took the place of
REDESIGNED = {k for k in BEFORE if re.match(r"(flash_fwd|flash_window|ring_flash_hop)(_f32)?_kernel<", k)}
#: the parent of the wgmma body: the register, wide and split kernels
PARENT = {k: v for k, v in BEFORE.items() if k not in REDESIGNED} | WIDE_NEW
#: the wgmma body's kernels, new on this side
NEW = {"flash_fwd_wgmma_kernel<128, 8>": (168, "z1"), "flash_fwd_wgmma_kernel<64, 4>": (128, "z2"),
       "ring_flash_hop_wgmma_kernel<128, 8>": (168, "z3"), "ring_flash_hop_wgmma_kernel<80, 4>": (128, "z4")}


def test_compare_tool_passes_when_only_redesigned_kernels_differ():
    """The wgmma body's kernels may come; every other kernel the parent
    built (every register-body and wide-body kernel in bf16 and fp32, the
    wide body's banded, ring and split kernels among them, the EF pass, the
    probes, every quant and dequant kernel, INT2 quant's two among them)
    must stay as it was, and a change to any of them fails."""
    tool = _compare_tool()
    after = PARENT | NEW
    ok, report = tool.verdict(_build(after), _build(PARENT))
    assert len(REDESIGNED) == 7 and ok and report["unmatched"] == []
    kernels = report["kernels"]
    for label in ("flash_fwd_reg_kernel<80, 8>", "flash_window_reg_kernel<80, 8>", "flash_fwd_wide_kernel<512, 8>",
                  "flash_fwd_reg_f32_kernel<80, 8>", "flash_window_reg_f32_kernel<80, 8>",
                  "ring_flash_hop_reg_f32_kernel<80, 2>", "flash_fwd_wide_f32_kernel<512, 8>",
                  *WIDE_NEW, "ef_update_fp32_kernel", "ef_codes_int8_kernel", "ef_update_fp32_f32rec_kernel",
                  "ef_codes_int8_f32rec_kernel", "dma_only_kernel",
                  "binary_quant_kernel<float, float>", "binary_quant_vec_kernel<float, float>",
                  "binary_dequant_kernel<float>", "int2_dequant_kernel<float>", "binary_dequant_vec_kernel<float, 1>",
                  "int2_dequant_vec_kernel<float, 1>", "int2_quant_kernel<float, float>",
                  "int2_quant_vec_kernel<float, float, 1>", "empty_kernel"):
        assert kernels[label]["must_be_unchanged"] and kernels[label]["sass_equal"], label
    for label in NEW:
        assert not kernels[label]["must_be_unchanged"], label
    for label in ("int2_quant_vec_kernel<float, float, 1>", "int2_quant_kernel<float, float>", *WIDE_NEW):
        changed = dict(after, **{label: (PARENT[label][0], "changed")})
        assert not tool.verdict(_build(changed), _build(PARENT))[0], label


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
    ("flash_fwd_wide_f32_kernel<512, 8>", None),
    ("int2_quant_vec_kernel<float, float, 1>", (48, "x2")),
    ("int2_quant_kernel<float, float>", (33, "m2")),
    ("ring_flash_hop_reg_f32_kernel<80, 2>", (140, "h5")),
    ("ef_codes_int8_f32rec_kernel", (41, "s4")),
    ("flash_window_wide_kernel<256, 4>", (175, "y1")),
    ("ring_flash_hop_wide_f32_kernel<256, 4>", (191, "y5b")),
    ("flash_fwd_wide_split_kernel<512, 8>", None),
])
def test_compare_tool_fails_when_a_listed_kernel_changes(label, change):
    tool = _compare_tool()
    after = dict(PARENT)
    if change is None:
        del after[label]
    else:
        after[label] = change
    ok, report = tool.verdict(_build(after), _build(PARENT))
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
    ok, report = tool.verdict(_build(PARENT), _build(PARENT), ["flash_tile_kernel<...>"])
    assert not ok and report["unmatched"] == ["flash_tile_kernel<...>"]
    assert tool.verdict(_build(PARENT), _build(PARENT))[0]


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
