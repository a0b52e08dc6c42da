"""Tokenized full-text inverted index for payload text/phrase match.

The qdrant full-text payload index role (qdrant `create_payload_index`
with `field_schema="text"`, plus 1.15's `phrase_matching: true`): the
reference app had no payload filtering at all (its qdrant local mode
was only ever searched unfiltered, core_system.py:659-664); this
framework's `match {"text": q}` / `{"phrase": q}` conditions already
carry qdrant's word-tokenizer semantics in `store/filter.py`, evaluated
per UNIQUE string through the dictionary-coded TypedView. That
evaluation is vectorized but still O(unique strings) of Python
tokenization per query — this module replaces it with a classic
inverted index over the SAME unique-string dictionary:

  * build: tokenize every unique string ONCE (`_TOKEN_RE.findall` on
    the lowercased string — byte-identical tokens to the fallback
    evaluator), store each string's token-code sequence (CSR) and the
    token -> unique-string postings lists (CSR, deduplicated);
  * text match: vocabulary binary-search per query token + sorted
    postings intersection (any token absent from the vocabulary means
    zero matches — subset semantics);
  * phrase match: postings intersection for the candidate set, then an
    exact consecutive-run check against the stored token sequences
    (sliding-window compare; candidates are few after intersection).

Both return the `ok_uniq` mask the filter evaluator scatters onto rows
and array elements, so semantics are pinned to the fallback by
construction (and by `tests/test_filter.py` parity fuzz).

The index is built lazily in-process on the first text/phrase query
against a key (costing about one legacy evaluation) and memoized per
(store version, key). `reverso index-payload NAME --text KEY` persists
it into the store's typed-column cache file next to the key's view
members, so later processes mmap-load it; a 16-byte digest of the
unique-string dictionary guards against ever pairing the postings with
a different dictionary ordering.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from .filter import _TOKEN_RE  # single source of tokenizer truth


def uniq_digest(uniq) -> np.ndarray:
    """16-byte blake2b digest of a unique-string dictionary (order-
    and content-sensitive, length-prefixed so concatenations can't
    collide). Uint8 array for npz-without-pickle storage."""
    h = hashlib.blake2b(digest_size=16)
    for u in uniq:
        b = u.encode("utf-8")
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    return np.frombuffer(h.digest(), np.uint8).copy()


class TextIndex:
    """Inverted index over one key's unique-string dictionary."""

    def __init__(self, vocab: list, tok_flat: np.ndarray,
                 tok_indptr: np.ndarray, post_indptr: np.ndarray,
                 post_uniq: np.ndarray, n_uniq: int,
                 digest: Optional[np.ndarray] = None):
        self.vocab = vocab                     # [V] sorted token strings
        self.tok_flat = tok_flat               # [T] int32 token codes
        self.tok_indptr = tok_indptr           # [U+1] int64
        self.post_indptr = post_indptr         # [V+1] int64
        self.post_uniq = post_uniq             # [P] int32 sorted per token
        self.n_uniq = n_uniq
        self.digest = digest
        self._vindex = {t: i for i, t in enumerate(vocab)}

    @classmethod
    def build(cls, uniq) -> "TextIndex":
        seqs = []
        vindex: dict = {}
        flat: list = []
        indptr = np.zeros(len(uniq) + 1, np.int64)
        for i, u in enumerate(uniq):
            toks = _TOKEN_RE.findall(u.lower())
            codes = []
            for t in toks:
                c = vindex.get(t)
                if c is None:
                    c = vindex[t] = len(vindex)
                codes.append(c)
            seqs.append(codes)
            flat.extend(codes)
            indptr[i + 1] = len(flat)
        # re-sort the vocabulary so lookups are a searchsorted and the
        # postings layout is deterministic
        vocab = sorted(vindex)
        remap = np.zeros(len(vocab), np.int32)
        for new, t in enumerate(vocab):
            remap[vindex[t]] = new
        tok_flat = (remap[np.asarray(flat, np.int32)]
                    if flat else np.zeros(0, np.int32))
        # postings: for each token, the sorted unique uniq-codes that
        # contain it (dedup via unique over (token, uniq) pairs)
        if len(tok_flat):
            owner = np.repeat(np.arange(len(uniq), dtype=np.int64),
                              np.diff(indptr))
            pairs = np.unique(
                np.stack([tok_flat.astype(np.int64), owner], 1), axis=0)
            counts = np.bincount(pairs[:, 0], minlength=len(vocab))
            post_indptr = np.zeros(len(vocab) + 1, np.int64)
            np.cumsum(counts, out=post_indptr[1:])
            post_uniq = pairs[:, 1].astype(np.int32)
        else:
            post_indptr = np.zeros(len(vocab) + 1, np.int64)
            post_uniq = np.zeros(0, np.int32)
        return cls(vocab, tok_flat, indptr, post_indptr, post_uniq,
                   len(uniq), uniq_digest(uniq))

    # -- queries -------------------------------------------------------

    def _postings(self, token: str) -> Optional[np.ndarray]:
        c = self._vindex.get(token)
        if c is None:
            return None
        return self.post_uniq[self.post_indptr[c]:self.post_indptr[c + 1]]

    def _candidates(self, tokens) -> np.ndarray:
        """Sorted uniq codes containing EVERY token (None on a
        vocabulary miss is an immediate empty set)."""
        posts = []
        for t in set(tokens):
            p = self._postings(t)
            if p is None or not len(p):
                return np.zeros(0, np.int32)
            posts.append(p)
        if not posts:          # no tokens: callers handle vacuous-match
            return np.zeros(0, np.int32)
        posts.sort(key=len)
        acc = posts[0]
        for p in posts[1:]:
            acc = np.intersect1d(acc, p, assume_unique=True)
            if not len(acc):
                break
        return acc

    def text_match(self, query: str) -> np.ndarray:
        """ok_uniq [n_uniq] bool: query tokens ⊆ string tokens. A
        token-less query vacuously matches every string (the legacy
        evaluator's empty-subset semantics; parse_filter rejects such
        filters before they reach here, but this surface must not
        depend on that remote guard)."""
        toks = _TOKEN_RE.findall(query.lower())
        if not toks:
            return np.ones(self.n_uniq, np.bool_)
        out = np.zeros(self.n_uniq, np.bool_)
        out[self._candidates(toks)] = True
        return out

    def _owner(self) -> np.ndarray:
        """[T] int32 uniq id per flat token (derived once, lazily)."""
        o = getattr(self, "_owner_arr", None)
        if o is None:
            o = self._owner_arr = np.repeat(
                np.arange(self.n_uniq, dtype=np.int32),
                np.diff(self.tok_indptr))
        return o

    def phrase_match(self, query: str) -> np.ndarray:
        """ok_uniq [n_uniq] bool: query tokens appear as one
        CONSECUTIVE in-order run (qdrant MatchPhrase). One vectorized
        sliding compare over the whole flat token array per query
        token (plus an owner check so runs never straddle strings) —
        no per-candidate python loop, O(T·span) element ops."""
        qseq = _TOKEN_RE.findall(query.lower())
        if not qseq:
            # a zero-token run is vacuously present everywhere — same
            # edge contract as text_match above (parse_filter rejects
            # these, but the two surfaces must agree without it)
            return np.ones(self.n_uniq, np.bool_)
        out = np.zeros(self.n_uniq, np.bool_)
        codes = [self._vindex.get(t) for t in qseq]
        if any(c is None for c in codes):
            return out
        qarr = np.asarray(codes, np.int32)
        span = len(qarr)
        T = len(self.tok_flat)
        if T < span:
            return out
        w = T - span + 1
        m = self.tok_flat[:w] == qarr[0]
        for j in range(1, span):
            m &= self.tok_flat[j:w + j] == qarr[j]
        owner = self._owner()
        if span > 1:
            m &= owner[:w] == owner[span - 1:]
        out[owner[:w][m]] = True
        return out

    # -- persistence (members inside the typed-column cache npz) -------

    def to_arrays(self, key: str) -> dict:
        enc = [t.encode("utf-8") for t in self.vocab]
        blob = (np.frombuffer(b"".join(enc), np.uint8).copy() if enc
                else np.zeros(0, np.uint8))
        lens = np.asarray([len(e) for e in enc], np.int64)
        return {f"{key}::txt_vocab_blob": blob,
                f"{key}::txt_vocab_lens": lens,
                f"{key}::txt_flat": self.tok_flat,
                f"{key}::txt_indptr": self.tok_indptr,
                f"{key}::txt_postptr": self.post_indptr,
                f"{key}::txt_postuniq": self.post_uniq,
                f"{key}::txt_digest": self.digest}

    @classmethod
    def from_arrays(cls, z, key: str,
                    uniq) -> Optional["TextIndex"]:
        """Load the key's text members; None when absent or when the
        stored dictionary digest does not match `uniq` (a different
        extraction ordering must never be paired with these
        postings)."""
        try:
            digest = np.asarray(z[f"{key}::txt_digest"], np.uint8)
        except KeyError:
            return None
        if not np.array_equal(digest, uniq_digest(uniq)):
            return None
        blob = bytes(np.asarray(z[f"{key}::txt_vocab_blob"], np.uint8))
        lens = np.asarray(z[f"{key}::txt_vocab_lens"], np.int64).tolist()
        vocab, pos = [], 0
        for ln in lens:
            vocab.append(blob[pos:pos + ln].decode("utf-8"))
            pos += ln
        return cls(vocab,
                   np.asarray(z[f"{key}::txt_flat"], np.int32),
                   np.asarray(z[f"{key}::txt_indptr"], np.int64),
                   np.asarray(z[f"{key}::txt_postptr"], np.int64),
                   np.asarray(z[f"{key}::txt_postuniq"], np.int32),
                   len(uniq), digest)
