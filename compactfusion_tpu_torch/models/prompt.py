"""Prompt encoding: tokenizers + text encoders per model family
(counterpart of ``compactfusion_tpu/models/prompt.py``).

    PromptEncoder.from_pretrained(root)   # diffusers-layout checkpoint dir,
                                          # weights on the GPU (device="cpu"
                                          # keeps them on the CPU)
    PromptEncoder.random(generator, ...)  # no checkpoint: byte-level
                                          # tokenizers + seeded random
                                          # encoder weights (the real
                                          # string -> tokens -> embeddings
                                          # path, untrained)

Encoding runs once per request, outside the denoise loop, on the device of
the encoders' weights; the states come back in fp32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch

from compactfusion_tpu_torch.io.tokenizers import (
    ClipBPETokenizer,
    UnigramTokenizer,
    _bytes_to_unicode,
    load_clip_tokenizer,
    load_t5_tokenizer,
)
from compactfusion_tpu_torch.models import common as cm
from compactfusion_tpu_torch.models.text_encoders import (
    CLIPTextConfig,
    T5Config,
    clip_encode,
    init_clip,
    init_t5,
    t5_encode,
)


# ---------------------------------------------------------------------------
# built-in byte-level tokenizers (checkpoint-free path)
# ---------------------------------------------------------------------------


def byte_unigram_tokenizer() -> UnigramTokenizer:
    """Char-level unigram over printable ASCII: full coverage, no files.

    Vocabulary: <pad>=0, </s>=1, <unk>=2, then "▁" and printable ASCII.
    """
    pieces: List[Tuple[str, float]] = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -1.0)]
    for code in range(33, 127):
        pieces.append((chr(code), -2.0))
    return UnigramTokenizer(pieces, unk_id=2, eos_id=1, pad_id=0, control_ids={0, 1})


def byte_clip_tokenizer(max_len: int = 77) -> ClipBPETokenizer:
    """Char-level CLIP vocab (every byte symbol +/- </w>), no merges."""
    symbols = list(_bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols)}
    for s in symbols:
        vocab[s + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return ClipBPETokenizer(vocab, [], model_max_length=max_len)


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _T5Bundle:
    tokenizer: UnigramTokenizer
    params: Any
    cfg: T5Config


@dataclasses.dataclass
class _CLIPBundle:
    tokenizer: ClipBPETokenizer
    params: Any
    cfg: CLIPTextConfig


def _device(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class PromptEncoder:
    """T5 and/or CLIP encoders with the family-specific assemblies: T5 alone
    for PixArt and the video families, T5 + CLIP-L's pooled vector for
    FLUX, CLIP-L + CLIP-G (+ T5) for SD3."""

    def __init__(self, t5: Optional[_T5Bundle] = None, clip_l: Optional[_CLIPBundle] = None,
                 clip_g: Optional[_CLIPBundle] = None):
        self.t5 = t5
        self.clip_l = clip_l
        self.clip_g = clip_g

    # -- constructors -------------------------------------------------------

    @classmethod
    def random(cls, generator: torch.Generator, text_dim: int = 4096, pooled_dim: Optional[int] = None,
               clip_g_dim: Optional[int] = None, depth: int = 2) -> "PromptEncoder":
        """Byte-level tokenizers + seeded random encoder weights, drawn on
        the generator's device in the JAX ``PromptEncoder.random``'s order of
        encoders (T5, CLIP-L, CLIP-G) and with its configs.  The string ->
        tokens -> embeddings path is the real one; only the weights are
        untrained."""
        t5_cfg = T5Config(vocab_size=128, d_model=text_dim, d_kv=64, d_ff=2 * text_dim,
                          num_layers=depth, num_heads=max(1, text_dim // 512), dtype=torch.bfloat16)
        t5 = _T5Bundle(byte_unigram_tokenizer(), init_t5(generator, t5_cfg), t5_cfg)
        clip_l = clip_g = None
        vocab = len(byte_clip_tokenizer().encoder)
        if pooled_dim is not None:
            c_cfg = CLIPTextConfig(vocab_size=vocab, d_model=pooled_dim, num_layers=depth,
                                   num_heads=max(1, pooled_dim // 64), dtype=torch.bfloat16)
            clip_l = _CLIPBundle(byte_clip_tokenizer(), init_clip(generator, c_cfg), c_cfg)
        if clip_g_dim is not None:
            g_cfg = CLIPTextConfig(vocab_size=vocab, d_model=clip_g_dim, num_layers=depth,
                                   num_heads=max(1, clip_g_dim // 64), hidden_act="gelu",
                                   projection_dim=clip_g_dim, dtype=torch.bfloat16)
            clip_g = _CLIPBundle(byte_clip_tokenizer(), init_clip(generator, g_cfg), g_cfg)
        return cls(t5, clip_l, clip_g)

    @classmethod
    def from_pretrained(cls, root: str, t5_cfg: Optional[T5Config] = None,
                        clip_l_cfg: Optional[CLIPTextConfig] = None,
                        clip_g_cfg: Optional[CLIPTextConfig] = None, device="cuda") -> "PromptEncoder":
        """Load from a diffusers-layout checkpoint directory: each of
        ``tokenizer{,_2,_3}/`` with its ``text_encoder{,_2,_3}/`` is T5 where
        it holds ``spiece.model`` and CLIP where it holds ``vocab.json``
        (the first CLIP is CLIP-L, a second CLIP-G), as the JAX loader reads
        them; the weights go to ``device``, the GPU unless the caller
        asks for the CPU, as the family builders' ``device="cuda"``."""
        from compactfusion_tpu_torch.io import hf

        t5 = clip_l = clip_g = None
        clip_cfgs = [c for c in (clip_l_cfg, clip_g_cfg) if c is not None]
        for i in (1, 2, 3):
            sfx = "" if i == 1 else f"_{i}"
            tok_dir, enc_dir = os.path.join(root, f"tokenizer{sfx}"), os.path.join(root, f"text_encoder{sfx}")
            if not os.path.isdir(tok_dir):
                continue
            if os.path.exists(os.path.join(tok_dir, "spiece.model")):
                cfg = t5_cfg or T5Config()
                params = cm.to_device(hf.convert_t5(hf.load_safetensors(enc_dir), cfg), device)
                t5 = _T5Bundle(load_t5_tokenizer(tok_dir), params, cfg)
            elif os.path.exists(os.path.join(tok_dir, "vocab.json")):
                cfg = clip_cfgs.pop(0) if clip_cfgs else CLIPTextConfig()
                params = cm.to_device(hf.convert_clip(hf.load_safetensors(enc_dir), cfg), device)
                bundle = _CLIPBundle(load_clip_tokenizer(tok_dir), params, cfg)
                if clip_l is None:
                    clip_l = bundle
                else:
                    clip_g = bundle
        return cls(t5, clip_l, clip_g)

    # -- primitive encodes --------------------------------------------------

    @torch.inference_mode()
    def encode_t5(self, prompts: Sequence[str], max_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, d_model) fp32 states + (B, S) bool mask."""
        assert self.t5 is not None, "no T5 encoder in this bundle"
        ids, mask = self.t5.tokenizer(list(prompts), max_length=max_length)
        dev = _device(self.t5.params)
        ids, mask = torch.from_numpy(ids).long().to(dev), torch.from_numpy(mask).to(dev)
        return t5_encode(self.t5.params, ids, self.t5.cfg, mask=mask).float(), mask

    @torch.inference_mode()
    def _encode_clip(self, which: str, prompts: Sequence[str]):
        bundle = getattr(self, which)
        assert bundle is not None, f"no {which} encoder in this bundle"
        ids = torch.from_numpy(bundle.tokenizer(list(prompts))).long().to(_device(bundle.params))
        return tuple(x.float() for x in clip_encode(bundle.params, ids, bundle.cfg))

    # -- family assemblies ---------------------------------------------------

    def encode_for_pixart(self, prompts: Sequence[str], negative: Optional[Sequence[str]] = None,
                          max_length: int = 120) -> Tuple[torch.Tensor, torch.Tensor]:
        """(2, B, S, D) cond/uncond states + (2, B, S) mask."""
        negative = list(negative or [""] * len(prompts))
        cond, m_c = self.encode_t5(prompts, max_length)
        un, m_u = self.encode_t5(negative, max_length)
        return torch.stack([cond, un]), torch.stack([m_c, m_u])

    # T5-only DiT families share the PixArt shape
    encode_for_hunyuandit = encode_for_pixart

    def encode_for_video(self, prompts: Sequence[str], negative: Optional[Sequence[str]] = None,
                         max_length: int = 226) -> torch.Tensor:
        """(2, B, S, D) cond/uncond states (padded fixed length, no mask)."""
        txt, _ = self.encode_for_pixart(prompts, negative, max_length)
        return txt

    def encode_for_flux(self, prompts: Sequence[str], max_length: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
        """T5 sequence states (B, S, D) + CLIP-L's pooled vector (B, P), no
        projection (reference ``pipeline_flux.py:246-259``)."""
        txt, _ = self.encode_t5(prompts, max_length)
        _, pooled = self._encode_clip("clip_l", prompts)
        return txt, pooled

    def encode_for_sd3(self, prompts: Sequence[str], negative: Optional[Sequence[str]] = None,
                       max_length: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
        """SD3: CLIP-L ++ CLIP-G hidden states (channels, zero-padded to the
        T5 width), then the T5 states appended along the sequence; pooled =
        the two projected pooled vectors side by side.  Returns ((2, B, S,
        D) states, (2, B, P) pooled)."""
        negative = list(negative or [""] * len(prompts))

        def one(batch):
            h_l, p_l = self._encode_clip("clip_l", batch)
            h_g, p_g = self._encode_clip("clip_g", batch)
            clip_h = torch.cat([h_l, h_g], dim=-1)
            pooled = torch.cat([p_l, p_g], dim=-1)
            if self.t5 is not None:
                t5_h, _ = self.encode_t5(batch, max_length)
                clip_h = torch.nn.functional.pad(clip_h, (0, t5_h.shape[-1] - clip_h.shape[-1]))
                states = torch.cat([clip_h, t5_h], dim=1)
            else:
                states = clip_h
            return states, pooled

        s_c, p_c = one(list(prompts))
        s_u, p_u = one(negative)
        return torch.stack([s_c, s_u]), torch.stack([p_c, p_u])

