"""Self-contained CLIP-style byte-level BPE tokenizer.

The port's own copy of holoagent_tpu/models/tokenizer.py (the port imports
nothing of the JAX package); the two give the same ids.  Without the
``regex`` package the pattern falls back to ``re`` with ASCII letter and
digit classes, as the reference's does: ASCII prompts tokenize the same
either way.

The reference tokenizes with `open_clip.tokenize`
(reference fsr_vln/memory/hmsg/utils/clip_utils.py:150), whose merge table
ships as `bpe_simple_vocab_16e6.txt.gz`.  This module reimplements the same
algorithm from its public specification; when a merges file is supplied the
token ids match the original vocabulary layout (256 byte tokens, 256
byte+'</w>' tokens, one token per merge, then <start_of_text>/<end_of_text>).
With no merges file it degrades to pure byte-level tokenization over the same
id space — deterministic and checkpoint-free, which is what the hermetic test
environment uses.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np

try:
    import regex as _re

    _PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is present in the target env
    import re as _re

    _PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+""",
        _re.IGNORECASE,
    )

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@lru_cache()
def bytes_to_unicode():
    """Reversible mapping byte -> printable unicode char (GPT-2 scheme)."""
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
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Sequence[str]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.strip().split()).lower()


class SimpleTokenizer:
    """CLIP BPE tokenizer. ``merges_path`` optional (see module docstring)."""

    def __init__(self, merges_path: Optional[str | Path] = None):
        byte_enc = bytes_to_unicode()
        self.byte_encoder = byte_enc
        self.byte_decoder = {v: k for k, v in byte_enc.items()}
        vocab: List[str] = list(byte_enc.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        merges: List[tuple] = []
        if merges_path:
            p = Path(merges_path)
            raw = gzip.open(p, "rt", encoding="utf-8").read() if p.suffix == ".gz" else p.read_text()
            lines = raw.split("\n")
            # standard layout: first line is a version header; 48894 merges follow
            for line in lines[1 : 49152 - 256 - 2 + 1]:
                parts = tuple(line.split())
                if len(parts) == 2:
                    merges.append(parts)
            for m in merges:
                vocab.append("".join(m))
        self.sot_text = "<|startoftext|>"
        self.eot_text = "<|endoftext|>"
        # pad the vocab so the special ids sit at the standard positions
        while len(vocab) < VOCAB_SIZE - 2:
            vocab.append(f"<|unused{len(vocab)}|>")
        vocab = vocab[: VOCAB_SIZE - 2] + [self.sot_text, self.eot_text]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            self.sot_text: self.sot_text,
            self.eot_text: self.eot_text,
        }
        self.sot = self.encoder[self.sot_text]
        self.eot = self.encoder[self.eot_text]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PATTERN.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(
        self, texts: str | Sequence[str], context_length: int = CONTEXT_LENGTH
    ) -> np.ndarray:
        """Tokenize to a fixed (N, context_length) int32 array:
        <sot> tokens... <eot> zero-padding, truncating long inputs with <eot>
        preserved (open_clip semantics)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out
