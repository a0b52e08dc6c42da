"""Minimal CLIP BPE tokenizer (offline; loads local vocab/merges files).

Implements the OpenAI CLIP tokenization scheme — byte-to-unicode
mapping, lowercasing, end-of-word `</w>` markers, rank-ordered BPE
merges, `<|startoftext|>`/`<|endoftext|>` wrapping — from the standard
`vocab.json` + `merges.txt` files that ship next to CLIP/PE checkpoints.
No network access and no tokenizer package needed.

Search-by-text is a beyond-reference capability (the reference app has
no text search; its CLIP text tower is simply never used,
reference core_system.py:181). Tokenization must still match OpenAI
CLIP's simple_tokenizer EXACTLY or text embeddings from real
checkpoints are silently wrong for any query the pattern splits
differently.
"""
from __future__ import annotations

import functools
import json
from typing import Sequence

try:
    # CLIP's exact pattern needs \p{L}/\p{N} Unicode classes (the
    # `regex` package). An ASCII-only approximation tokenizes "café"
    # as 'caf' + 'é'-as-punctuation — different BPE pieces than every
    # checkpoint's training tokenization.
    import regex as _re
    _PATTERN = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")
except ImportError:       # stdlib fallback: [^\W\d_]+ == Unicode letters
    import re as _re
    _PATTERN = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\w\s]|_)+")


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ClipBPETokenizer:
    def __init__(self, vocab_path: str, merges_path: str,
                 context_length: int = 77):
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # merges.txt usually starts with a version header line
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#") and len(l.split()) == 2]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.context_length = context_length
        self.sot = self.encoder.get("<|startoftext|>")
        self.eot = self.encoder.get("<|endoftext|>")
        self._cache: dict[str, list[str]] = {}

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._cache[token] = word
        return word

    def encode_text(self, text: str) -> list[int]:
        text = _re.sub(r"\s+", " ", text.strip().lower())
        ids: list[int] = []
        for tok in _PATTERN.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok):
                ids.append(self.encoder.get(piece, 0))
        return ids

    def __call__(self, texts: str | Sequence[str]):
        """Tokenize to padded [B, context_length] int arrays (CLIP style:
        <sot> tokens <eot>, truncated keeping the final <eot>)."""
        import numpy as np
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode_text(text) + [self.eot]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out
