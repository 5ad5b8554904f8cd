"""The port's prompt path against the JAX package: tokenizers, the T5 and
CLIP encoders, int8 weights, the checkpoint converters and reader, and the
family assemblies of ``models/prompt.py``.

* Token ids bit-equal: the byte-level tokenizers, a CLIP BPE vocab and a
  SentencePiece ``.model`` built here as ``tests/io/test_tokenizers.py``
  builds them; unicode, the empty string, truncation.
* ``_t5_rel_buckets`` bit-equal to JAX's fp32 table (S <= 512 as the
  encoder builds it, and every |n| < 4096).
* ``t5_encode`` / ``clip_encode`` at tiny sizes in fp32 within 2e-4 (the
  fp32 bound of tests/io/test_backbone_parity.py), with and without the
  mask, on int8 T5 trees, with CLIP-G's projection, pooled at the first
  maximal token id.
* ``quantize_t5_int8`` / ``quantize_params_int8`` codes and scales bit-equal.
* ``convert_t5``, ``convert_clip``, ``convert_pixart`` and
  ``convert_vae_decoder`` bit for bit against JAX's on state dicts drawn at
  every key of the vendored inventories (``tests/io/fixtures``; widths
  divided by 32 where the inventory is large), each key read.
* ``load_safetensors`` against ``safetensors.numpy.load_file``.
* ``encode_for_pixart`` / ``encode_for_flux`` / ``encode_for_sd3`` with the
  JAX encoders' weights carried across (fp32).
"""

import dataclasses
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compactfusion_tpu.io import hf as jhf
from compactfusion_tpu.io import tokenizers as jtok
from compactfusion_tpu.models import common as jcm
from compactfusion_tpu.models import pixart as jpixart
from compactfusion_tpu.models import prompt as jprompt
from compactfusion_tpu.models import text_encoders as jte
from compactfusion_tpu.models import vae as jvae
from compactfusion_tpu_torch.io import hf as thf
from compactfusion_tpu_torch.io import tokenizers as ttok
from compactfusion_tpu_torch.io.from_jax import params_from_numpy
from compactfusion_tpu_torch.models import common as tcm
from compactfusion_tpu_torch.models import pixart as tpixart
from compactfusion_tpu_torch.models import prompt as tprompt
from compactfusion_tpu_torch.models import text_encoders as tte
from compactfusion_tpu_torch.models import vae as tvae
from tests.helpers import rel_err
from tests.io.test_real_keymaps import TrackingState

BOUND = 2e-4
FIXTURES = Path(__file__).resolve().parent / "io" / "fixtures"
TEXTS = ["a photo of a cat", "", "héllo wörld ✓ — naïve café 東京", "A  LONG   prompt, " * 12,
         "numbers 123 and symbols #$%&!"]


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float32)
                                  if np.asarray(a).dtype.kind == "f" else np.asarray(a), tree)


def _f32_jax(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree) for p, x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [(f"{i}/{p}", x) for i, t in enumerate(tree) for p, x in _leaves(t)]
    return [("", tree)]


def _assert_trees_equal(port, ref):
    """Same structure and every leaf bit for bit (``ref`` a JAX tree)."""
    t, j = _leaves(port), _leaves(jax.tree_util.tree_map(np.asarray, ref))
    assert [p for p, _ in t] == [p for p, _ in j]
    for (path, a), (_, b) in zip(t, j):
        a = a.float().numpy() if a.is_floating_point() else a.numpy()
        b = b.astype(np.float32) if b.dtype.kind == "f" else b
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_length", [8, 77])
def test_byte_tokenizers_match_jax(max_length):
    jt5, tt5 = jprompt.byte_unigram_tokenizer(), tprompt.byte_unigram_tokenizer()
    jc, tc = jprompt.byte_clip_tokenizer(), tprompt.byte_clip_tokenizer()
    ji, jm = jt5(TEXTS, max_length=max_length)
    ti, tm = tt5(TEXTS, max_length=max_length)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc(TEXTS, max_length=max_length), jc(TEXTS, max_length=max_length))
    # truncation keeps eos last; the empty prompt is the dummy prefix and eos
    assert ti[3, max_length - 1] == 1 and ti[1, :2].tolist() == [3, 1] and tm[1].sum() == 2
    assert [tt5.decode(ti[0].tolist())] == [jt5.decode(ji[0].tolist())]


CLIP_VOCAB = ["l", "o", "w", "e", "r", "s", "t", "i", "d", "n", "lo", "l</w>", "w</w>", "r</w>", "t</w>",
              "low</w>", "er</w>", "lowest</w>", "newer</w>", "wider", "<unk>", "<|startoftext|>",
              "<|endoftext|>"]
CLIP_MERGES = ["#version: 0.2", "l o", "lo w</w>", "e r</w>"]


@pytest.mark.parametrize("text", ["lower newer", "LOWER   NeWeR", "unknownword lower", "", "lo" * 40,
                                  "wörld 12 low"])
def test_clip_bpe_matches_jax(tmp_path, text):
    (tmp_path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(CLIP_VOCAB)}))
    (tmp_path / "merges.txt").write_text("\n".join(CLIP_MERGES))
    j, t = jtok.load_clip_tokenizer(str(tmp_path)), ttok.load_clip_tokenizer(str(tmp_path))
    assert t.tokenize(text) == j.tokenize(text)
    np.testing.assert_array_equal(t([text], max_length=16), j([text], max_length=16))
    assert t.decode(t.encode(text)) == j.decode(j.encode(text))


def _spm_model(path):
    """A serialized sentencepiece ModelProto, written by hand."""

    def varint(v):
        out = b""
        while True:
            b7, v = v & 0x7F, v >> 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    def field(num, wire, payload):
        return varint((num << 3) | wire) + payload

    def piece(text, score, ptype=1):
        body = field(1, 2, varint(len(text.encode())) + text.encode())
        body += field(2, 5, struct.pack("<f", score)) + field(3, 0, varint(ptype))
        return field(1, 2, varint(len(body)) + body)

    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -2.0, 1), ("▁the", -1.0, 1),
              ("▁a", -1.5, 1), ("▁photo", -2.5, 1), ("▁of", -1.2, 1), ("▁cat", -2.1, 1), ("photo", -3.0, 1),
              ("graph", -2.8, 1), ("c", -5.0, 1), ("a", -4.9, 1), ("t", -4.8, 1), ("th", -4.5, 1),
              ("e", -4.7, 1), ("he", -4.4, 1), ("o", -5.1, 1), ("é", -3.3, 1)]
    path.write_bytes(b"".join(piece(*p) for p in pieces) + field(2, 2, varint(0)))


@pytest.mark.parametrize("text", ["the cat", "a photo of the photograph", "tthheo", "", "xyz é ✓ the",
                                  "the " * 40])
def test_sentencepiece_model_matches_jax(tmp_path, text):
    _spm_model(tmp_path / "spiece.model")
    j, t = jtok.load_t5_tokenizer(str(tmp_path)), ttok.load_t5_tokenizer(str(tmp_path))
    assert ttok.parse_sentencepiece_model((tmp_path / "spiece.model").read_bytes()) == \
        jtok.parse_sentencepiece_model((tmp_path / "spiece.model").read_bytes())
    assert t.tokenize_ids(text) == j.tokenize_ids(text)
    for a, b in zip(t([text], max_length=12), j([text], max_length=12)):
        np.testing.assert_array_equal(a, b)
    assert t.decode(t.encode(text)) == j.decode(j.encode(text))


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 7, 77, 120, 512])
def test_t5_rel_buckets_bit_equal(s):
    pos = np.arange(s)
    want = np.asarray(jte._t5_rel_buckets(jnp.asarray(pos)[None, :] - jnp.asarray(pos)[:, None], 32, 128))
    np.testing.assert_array_equal(tte._t5_rel_buckets(pos[None, :] - pos[:, None], 32, 128), want)
    if s == 512:  # every distance a 4096-token prompt could give
        r = np.arange(-4095, 4096)
        np.testing.assert_array_equal(tte._t5_rel_buckets(r, 32, 128),
                                      np.asarray(jte._t5_rel_buckets(jnp.asarray(r), 32, 128)))


def _t5(num_layers=2):
    jcfg = dataclasses.replace(jte.t5_tiny(), num_layers=num_layers, dtype=jnp.float32)
    tcfg = dataclasses.replace(tte.t5_tiny(), num_layers=num_layers, dtype=torch.float32)
    jp = jcm.jit_init(jte.init_t5, jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    # a non-zero relative bias, so the buckets reach the scores
    jp["rel_bias"] = jnp.asarray(rng.standard_normal((32, jcfg.num_heads)), jnp.float32)
    return jcfg, tcfg, jp


def _ids(vocab, b=2, s=17, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("variant", ["no-mask", "mask", "int8"])
def test_t5_encode_matches_jax(variant):
    jcfg, tcfg, jp = _t5(3 if variant == "int8" else 2)
    tp = params_from_numpy(_np(jp))
    ids = _ids(128)
    mask = np.random.default_rng(1).random((2, 17)) > 0.3 if variant != "no-mask" else None
    jmask, tmask = (None, None) if mask is None else (jnp.asarray(mask), torch.from_numpy(mask))
    tids = torch.from_numpy(ids).long()
    if variant == "int8":
        full = tte.t5_encode(tp, tids, tcfg, mask=tmask).numpy()
        jp, tp = jte.quantize_t5_int8(jp), tte.quantize_t5_int8(tp)
        _assert_trees_equal(tp, jp)
    want = np.asarray(jte.t5_encode(jp, jnp.asarray(ids), jcfg, mask=jmask))
    got = tte.t5_encode(tp, tids, tcfg, mask=tmask).numpy()
    assert rel_err(got, want) < BOUND
    if variant == "int8":
        # tests/io/test_t5_int8.py's bounds: close, and not the full weights
        assert 1e-6 < rel_err(got, full) < 0.05


@pytest.mark.parametrize("which", ["clip-l", "clip-g-proj"])
def test_clip_encode_matches_jax(which):
    if which == "clip-l":
        jcfg, tcfg = jte.clip_tiny(), tte.clip_tiny()
    else:
        kw = dict(hidden_act="gelu", projection_dim=48)
        jcfg, tcfg = dataclasses.replace(jte.clip_tiny(), **kw), dataclasses.replace(tte.clip_tiny(), **kw)
    jcfg, tcfg = dataclasses.replace(jcfg, dtype=jnp.float32), dataclasses.replace(tcfg, dtype=torch.float32)
    jp = jcm.jit_init(jte.init_clip, jax.random.PRNGKey(1), jcfg)
    jp["pos_embed"] = jnp.asarray(np.random.default_rng(2).standard_normal((16, 64)) * 0.1, jnp.float32)
    ids = _ids(100, 3, 12, seed=4)
    ids[0, [3, 8]] = 127  # two maximal ids: the first one pools
    ids[1, -1] = 127
    jh, jpool = jte.clip_encode(jp, jnp.asarray(ids), jcfg)
    th, tpool = tte.clip_encode(params_from_numpy(_np(jp)), torch.from_numpy(ids).long(), tcfg)
    assert rel_err(th.numpy(), np.asarray(jh)) < BOUND
    assert rel_err(tpool.numpy(), np.asarray(jpool)) < BOUND
    assert tpool.shape == (3, 48 if which != "clip-l" else 64)
    if which == "clip-l":
        np.testing.assert_allclose(tpool[0].numpy(), th[0, 3].numpy(), rtol=0, atol=0)


def test_quantize_int8_codes_and_scales_bit_equal():
    from compactfusion_tpu.models.flux import flux_tiny, init_flux

    jp = jcm.jit_init(init_flux, jax.random.PRNGKey(0), dataclasses.replace(flux_tiny(), dtype=jnp.float32))
    keys = ("double_blocks", "single_blocks")
    # eager, as xDiTParallel quantizes (under jit XLA turns the division by
    # 127 into a product, one ulp off in some scales)
    jq = jcm.quantize_params_int8(jp, keys=keys)
    tq = tcm.quantize_params_int8(params_from_numpy(_np(jp)), keys=keys)
    _assert_trees_equal(tq, jq)
    assert tq["double_blocks"]["img_qkv"]["w_q"].dtype == torch.int8
    assert "w" in tq["x_embedder"]  # outside the keys: untouched
    # bf16 weights, as the runner quantizes them; every linear of T5's tree
    jcfg, _, jt = _t5()
    jt = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jt)
    _assert_trees_equal(tte.quantize_t5_int8(params_from_numpy(jax.tree_util.tree_map(np.asarray, jt))),
                        jte.quantize_t5_int8(jt))


# ---------------------------------------------------------------------------
# converters and the safetensors reader
# ---------------------------------------------------------------------------


def _inventory(name, scale):
    lines = [ln.split() for ln in (FIXTURES / f"{name}.keys.txt").read_text().splitlines()
             if ln and not ln.startswith("#")]
    return {k: tuple(scale(int(d)) for d in dims.split(",")) for k, dims in lines}


def _by32(keep):
    return lambda n: n if n in keep or n % 32 else n // 32


CONVERTERS = {
    # (inventory, width rule, JAX config, port config, converter name, keys left unread)
    "t5": ("t5-v1_1-xxl-encoder", _by32((32, 64)), lambda m, dt: dataclasses.replace(
        m.t5_xxl(), d_model=128, d_ff=320, d_kv=2, vocab_size=1004, dtype=dt), "convert_t5",
        {"encoder.embed_tokens.weight"}),
    "clip": ("clip-vit-large-text", _by32(()), lambda m, dt: dataclasses.replace(
        m.clip_l(), d_model=24, vocab_size=1544, dtype=dt), "convert_clip", set()),
    "pixart": ("pixart-xl-2", lambda n: n if n <= 256 or n % 32 else n // 32, lambda m, dt: dataclasses.replace(
        m.pixart_alpha_512(), dim=36, text_dim=128, dtype=dt), "convert_pixart", set()),
    "vae": ("sd-vae-ft-ema-decoder", lambda n: n, lambda m, dt: dataclasses.replace(m.sd_vae(), dtype=dt),
            "convert_vae_decoder", set()),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", list(CONVERTERS))
def test_converters_match_jax_and_read_every_key(which, dtype):
    inv, scale, make, fn, unread_ok = CONVERTERS[which]
    shapes = _inventory(inv, scale)
    rng = np.random.default_rng(5)
    state = TrackingState(shapes)
    for k in state:
        dict.__setitem__(state, k, rng.standard_normal(shapes[k]).astype(np.float32))
    jmod = {"t5": jte, "clip": jte, "pixart": jpixart, "vae": jvae}[which]
    tmod = {"t5": tte, "clip": tte, "pixart": tpixart, "vae": tvae}[which]
    got = getattr(thf, fn)(state, make(tmod, getattr(torch, dtype)))
    assert not set(state) - state.read - unread_ok, sorted(set(state) - state.read)[:10]
    _assert_trees_equal(got, getattr(jhf, fn)(dict(state), make(jmod, getattr(jnp, dtype))))
    assert all(x.dtype == getattr(torch, dtype) for _, x in _leaves(got))


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(6)
    one = {"a.weight": rng.standard_normal((3, 5)).astype(np.float32),
           "b": rng.standard_normal(7).astype(np.float16), "c": rng.integers(-9, 9, (2, 2, 2)).astype(np.int64),
           "d": rng.integers(0, 255, 4).astype(np.uint8), "e": rng.integers(-9, 9, 3).astype(np.int8),
           "f": np.zeros((0, 4), np.float32), "g": np.float64(2.5) * np.ones((2,))}
    save_file(one, str(tmp_path / "one.safetensors"), metadata={"format": "pt"})
    for path in (tmp_path / "one.safetensors",):
        got, want = thf.load_safetensors(str(path)), load_file(str(path))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
    shards = tmp_path / "sharded"
    shards.mkdir()
    save_file({k: one[k] for k in ("a.weight", "b")}, str(shards / "model-00001-of-00002.safetensors"))
    save_file({k: one[k] for k in ("c", "d")}, str(shards / "model-00002-of-00002.safetensors"))
    (shards / "model.safetensors.index.json").write_text("{}")
    got = thf.load_safetensors(str(shards))
    want = {**load_file(str(shards / "model-00001-of-00002.safetensors")),
            **load_file(str(shards / "model-00002-of-00002.safetensors"))}
    assert sorted(got) == sorted(want) == ["a.weight", "b", "c", "d"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # bf16 (numpy has none): read back as the exact fp32 values
    from safetensors.torch import save_file as save_torch

    w = torch.randn(4, 6).to(torch.bfloat16)
    save_torch({"w": w}, str(tmp_path / "bf16.safetensors"))
    got = thf.load_safetensors(str(tmp_path / "bf16.safetensors"))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, w.float().numpy())


# ---------------------------------------------------------------------------
# the family assemblies
# ---------------------------------------------------------------------------


def _carry(jbundle, tcfg_cls, bundle_cls, ttok_fn):
    """Cast a JAX encoder bundle to fp32 in place; its port twin with the
    same weights and the port's own tokenizer."""
    cfg = dataclasses.replace(jbundle.cfg, dtype=jnp.float32)
    jbundle.params, jbundle.cfg = _f32_jax(jbundle.params), cfg
    tcfg = tcfg_cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"},
                    dtype=torch.float32)
    return bundle_cls(ttok_fn(), params_from_numpy(_np(jbundle.params)), tcfg)


@pytest.fixture(scope="module")
def encoders():
    # PromptEncoder.random's configs at tiny widths, its initialisers under jit
    ks = jax.random.split(jax.random.PRNGKey(7), 3)
    vocab = len(jprompt.byte_clip_tokenizer().encoder)
    t5 = jte.T5Config(vocab_size=128, d_model=96, d_kv=64, d_ff=192, num_layers=2, num_heads=1)
    cl = jte.CLIPTextConfig(vocab_size=vocab, d_model=32, num_layers=2, num_heads=1)
    cg = jte.CLIPTextConfig(vocab_size=vocab, d_model=48, num_layers=2, num_heads=1, hidden_act="gelu",
                            projection_dim=48)
    j = jprompt.PromptEncoder(
        jprompt._T5Bundle(jprompt.byte_unigram_tokenizer(), jcm.jit_init(jte.init_t5, ks[0], t5), t5),
        jprompt._CLIPBundle(jprompt.byte_clip_tokenizer(), jcm.jit_init(jte.init_clip, ks[1], cl), cl),
        jprompt._CLIPBundle(jprompt.byte_clip_tokenizer(), jcm.jit_init(jte.init_clip, ks[2], cg), cg))
    t = tprompt.PromptEncoder(
        _carry(j.t5, tte.T5Config, tprompt._T5Bundle, tprompt.byte_unigram_tokenizer),
        _carry(j.clip_l, tte.CLIPTextConfig, tprompt._CLIPBundle, tprompt.byte_clip_tokenizer),
        _carry(j.clip_g, tte.CLIPTextConfig, tprompt._CLIPBundle, tprompt.byte_clip_tokenizer))
    j._jit_t5, j._jit_clip = None, {}
    return j, t


PROMPTS = ["a photo of a cat", "héllo ✓ wörld"]


@pytest.mark.parametrize("family", ["pixart", "flux", "sd3"])
def test_family_encodes_match_jax(encoders, family):
    j, t = encoders
    if family == "pixart":
        want = j.encode_for_pixart(PROMPTS, ["blurry", ""], max_length=12)
        got = t.encode_for_pixart(PROMPTS, ["blurry", ""], max_length=12)
        assert got[0].shape == (2, 2, 12, 96) and got[1].dtype == torch.bool
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    elif family == "flux":
        want, got = j.encode_for_flux(PROMPTS, max_length=20), t.encode_for_flux(PROMPTS, max_length=20)
        assert got[0].shape == (2, 20, 96) and got[1].shape == (2, 32)
    else:
        want, got = j.encode_for_sd3(PROMPTS, max_length=9), t.encode_for_sd3(PROMPTS, max_length=9)
        assert got[0].shape == (2, 2, 77 + 9, 96) and got[1].shape == (2, 2, 32 + 48)
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            assert rel_err(g.numpy(), np.asarray(w)) < BOUND


def test_from_pretrained_matches_jax(tmp_path):
    """A diffusers-layout directory (T5 under ``tokenizer``/``text_encoder``,
    CLIP-L under the ``_2`` slots) read by both packages' loaders."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(8)
    for slot, inv, scale in (("", "t5-v1_1-xxl-encoder", _by32((32, 64))), ("_2", "clip-vit-large-text", _by32(()))):
        shapes = _inventory(inv, scale)
        (tmp_path / f"text_encoder{slot}").mkdir()
        save_file({k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in shapes.items()},
                  str(tmp_path / f"text_encoder{slot}" / "model.safetensors"))
        (tmp_path / f"tokenizer{slot}").mkdir()
    _spm_model(tmp_path / "tokenizer" / "spiece.model")
    (tmp_path / "tokenizer_2" / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(CLIP_VOCAB)}))
    (tmp_path / "tokenizer_2" / "merges.txt").write_text("\n".join(CLIP_MERGES))
    t5_make, clip_make = CONVERTERS["t5"][2], CONVERTERS["clip"][2]
    j = jprompt.PromptEncoder.from_pretrained(str(tmp_path), t5_cfg=t5_make(jte, jnp.float32),
                                              clip_l_cfg=clip_make(jte, jnp.float32))
    t = tprompt.PromptEncoder.from_pretrained(str(tmp_path), t5_cfg=t5_make(tte, torch.float32),
                                              clip_l_cfg=clip_make(tte, torch.float32), device="cpu")
    assert t.clip_g is None and t.t5.tokenizer.encode("the cat") == j.t5.tokenizer.encode("the cat")
    prompts = ["the photo of a cat", "lower newer"]
    want, got = j.encode_for_flux(prompts, max_length=10), t.encode_for_flux(prompts, max_length=10)
    assert got[0].shape == (2, 10, 128) and got[1].shape == (2, 24)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w)) < BOUND


def test_from_pretrained_defaults_to_the_gpu():
    """An entry point runs on the card unless the caller asks for the CPU:
    ``from_pretrained``'s default device is "cuda", as the family
    builders' (read from the signature; no GPU needed)."""
    import inspect

    from compactfusion_tpu_torch import parallel_api as tapi

    assert inspect.signature(tprompt.PromptEncoder.from_pretrained).parameters["device"].default == "cuda"
    assert inspect.signature(tapi._build_consisid).parameters["device"].default == "cuda"
    assert inspect.signature(tapi.xDiTParallel).parameters["device"].default == "cuda"
