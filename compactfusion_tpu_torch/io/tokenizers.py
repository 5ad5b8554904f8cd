"""Pure-Python tokenizers: CLIP byte-pair encoding + SentencePiece unigram
(the port's own copy of ``compactfusion_tpu/io/tokenizers.py``; stdlib and
numpy only, held bit for bit against it by ``tests/test_torch_text_encoders.py``).

The reference gets tokenization for free from ``transformers`` inside the
diffusers pipelines (``pipeline_flux.py:246-259`` tokenizes with CLIP + T5
before encode_prompt).  The rebuild implements both algorithms first-class so
the prompt -> ids path has no heavyweight dependency:

* ``ClipBPETokenizer`` — the GPT-2-style byte-level BPE with ``</w>``
  end-of-word markers used by every CLIP text tower (vocab.json +
  merges.txt, the files shipped in HF checkpoints under ``tokenizer/``).
* ``UnigramTokenizer`` — SentencePiece unigram-LM Viterbi segmentation used
  by T5 (XXL for FLUX/SD3/PixArt prompts).  Loads either a raw
  ``spiece.model`` protobuf (parsed with a minimal varint walker — no
  sentencepiece dependency) or an explicit ``[(piece, score), ...]`` vocab.

Both are validated against the HuggingFace implementations in
``tests/io/test_tokenizers.py``.
"""

from __future__ import annotations

import functools
import html
import json
import os
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ClipBPETokenizer",
    "UnigramTokenizer",
    "load_clip_tokenizer",
    "load_t5_tokenizer",
]


# ---------------------------------------------------------------------------
# CLIP BPE
# ---------------------------------------------------------------------------


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _whitespace_clean(text: str) -> str:
    import re

    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    """CLIP text tokenizer (vocab.json + merges.txt).

    Matches ``transformers.CLIPTokenizer`` output for cleaned input; the
    ftfy mojibake-repair pre-pass is replaced with ``html.unescape`` (same
    as HF without ftfy installed) since prompts are expected to be sane
    unicode already.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        pad_token: Optional[str] = None,
        model_max_length: int = 77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        self.pad_token_id = (
            self.encoder[pad_token] if pad_token else self.eos_token_id
        )
        self.model_max_length = model_max_length
        self._cache = {bos_token: bos_token, eos_token: eos_token}
        import re

        # HF CLIPTokenizer pattern (re.IGNORECASE; python re lacks \p{...},
        # use unicode-aware shorthand via the regex module when available)
        try:
            import regex

            self._pat = regex.compile(
                r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
                regex.IGNORECASE,
            )
        except ImportError:  # pragma: no cover
            # ASCII approximation of \p{L}/\p{N}: letters must NOT swallow
            # digit runs or underscores (\w+ would tokenize "abc123" as one
            # OOV piece -> eos fallback id, which also corrupts the argmax
            # pooling position in clip_encode)
            self._pat = re.compile(
                r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
                re.IGNORECASE,
            )

    # -- BPE core -----------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(a, b) for a, b in zip(word, word[1:])}
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(a, b) for a, b in zip(word, word[1:])}
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        toks: List[str] = []
        for token in self._pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            toks.extend(self._bpe(token).split(" "))
        return toks

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """ids WITH bos/eos, truncated to ``max_length``."""
        max_length = max_length or self.model_max_length
        # HF CLIPTokenizer maps out-of-vocab pieces to unk (= eos for CLIP)
        ids = [
            self.encoder.get(t, self.eos_token_id) for t in self.tokenize(text)
        ]
        ids = ids[: max_length - 2]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def __call__(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> np.ndarray:
        """(B, max_length) int32, padded with ``pad_token_id``."""
        max_length = max_length or self.model_max_length
        out = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_length)
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(
            self.decoder[i]
            for i in ids
            if i not in (self.bos_token_id, self.eos_token_id)
        )
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()


def load_clip_tokenizer(path: str, **kw) -> ClipBPETokenizer:
    """Load from a HF ``tokenizer/`` dir (vocab.json + merges.txt)."""
    with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    merges: List[Tuple[str, str]] = []
    with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
        for line in f.read().split("\n"):
            if line.startswith("#version") or not line.strip():
                continue
            a, b = line.split()
            merges.append((a, b))
    return ClipBPETokenizer(vocab, merges, **kw)


# ---------------------------------------------------------------------------
# SentencePiece unigram (T5)
# ---------------------------------------------------------------------------

_UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty


def _parse_proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) from a protobuf message."""
    i, n = 0, len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, buf[i : i + 8]
            i += 8
        elif wire == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, buf[i : i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            yield field, wire, buf[i : i + 4]
            i += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")


def parse_sentencepiece_model(
    data: bytes,
) -> Tuple[List[Tuple[str, float, int]], int]:
    """Parse a serialized sentencepiece ``ModelProto``.

    Returns (pieces [(text, score, type)], unk_id).  Piece types:
    1=NORMAL 2=UNKNOWN 3=CONTROL 4=USER_DEFINED 6=BYTE.
    """
    pieces: List[Tuple[str, float, int]] = []
    unk_id = 0
    for field, wire, val in _parse_proto_fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece
            text, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _parse_proto_fields(val):
                if f2 == 1 and w2 == 2:
                    text = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            if ptype == 2:
                unk_id = len(pieces)
            pieces.append((text, score, ptype))
    return pieces, unk_id


class UnigramTokenizer:
    """SentencePiece unigram-LM tokenizer (T5 family).

    Viterbi segmentation over the piece vocabulary; consecutive unknown
    characters fuse into a single ``<unk>`` (sentencepiece semantics).
    """

    def __init__(
        self,
        pieces: Sequence[Tuple[str, float]],
        unk_id: int = 2,
        eos_id: int = 1,
        pad_id: int = 0,
        add_dummy_prefix: bool = True,
        control_ids: Optional[set] = None,
    ):
        self.pieces = list(pieces)
        self.vocab = {p: (i, s) for i, (p, s) in enumerate(self.pieces)}
        self.unk_id = unk_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.add_dummy_prefix = add_dummy_prefix
        self._control = control_ids or {pad_id, eos_id}
        scores = [s for _, s in self.pieces]
        self._min_score = min(scores) if scores else 0.0
        self._max_piece_len = max((len(p) for p, _ in self.pieces), default=1)

    @classmethod
    def from_model_file(cls, path: str) -> "UnigramTokenizer":
        with open(path, "rb") as f:
            pieces, unk_id = parse_sentencepiece_model(f.read())
        control = {i for i, (_, _, t) in enumerate(pieces) if t == 3}
        return cls(
            [(p, s) for p, s, _ in pieces],
            unk_id=unk_id,
            control_ids=control,
        )

    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = _whitespace_clean(text)
        if self.add_dummy_prefix:
            text = " " + text
        return text.replace(" ", "▁")

    def tokenize_ids(self, text: str) -> List[int]:
        s = self._normalize(text)
        n = len(s)
        # Viterbi over character positions
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)  # (prev_pos, id)
        best[0] = 0.0
        unk_score = self._min_score - _UNK_PENALTY
        for i in range(n):
            if best[i] == NEG:
                continue
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                ent = self.vocab.get(s[i:j])
                if ent is None:
                    continue
                pid, score = ent
                if pid in self._control or pid == self.unk_id:
                    continue
                if best[i] + score > best[j]:
                    best[j] = best[i] + score
                    back[j] = (i, pid)
            # single unknown char fallback
            j = i + 1
            if best[i] + unk_score > best[j]:
                best[j] = best[i] + unk_score
                back[j] = (i, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            ids.append(pid)
            pos = prev
        ids.reverse()
        # fuse consecutive unks
        fused: List[int] = []
        for pid in ids:
            if pid == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(pid)
        return fused

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """ids + eos, truncated to ``max_length`` (T5 convention: no bos)."""
        ids = self.tokenize_ids(text)
        if max_length is not None:
            ids = ids[: max_length - 1]
        return ids + [self.eos_id]

    def __call__(
        self, texts: Sequence[str], max_length: int = 512
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, max_length) int32 ids padded with pad_id + bool mask."""
        out = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), bool)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_length)
            out[i, : len(ids)] = ids
            mask[i, : len(ids)] = True
        return out, mask

    def decode(self, ids: Sequence[int]) -> str:
        toks = [
            self.pieces[i][0]
            for i in ids
            if i < len(self.pieces) and i not in self._control
        ]
        return "".join(toks).replace("▁", " ").strip()


def load_t5_tokenizer(path: str) -> UnigramTokenizer:
    """Load from a HF ``tokenizer/`` dir (spiece.model) or a .model file."""
    if os.path.isdir(path):
        path = os.path.join(path, "spiece.model")
    return UnigramTokenizer.from_model_file(path)
