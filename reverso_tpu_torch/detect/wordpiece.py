"""Minimal BERT WordPiece tokenizer (offline, self-contained).

GroundingDINO conditions on BERT token ids; the stock stack gets them
from `transformers.AutoTokenizer`, which needs a downloaded vocab. This
implementation reads a local `vocab.txt` (the standard bert-base-uncased
format shipped next to GroundingDINO checkpoints) so the whole detector
works with no network access. Lowercase + basic punctuation splitting +
greedy longest-match WordPiece, matching BertTokenizer's uncased
behavior for the simple prompt strings this pipeline feeds it.
"""
from __future__ import annotations

import unicodedata
from typing import Sequence


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    def __init__(self, vocab_path: str):
        self.vocab: dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.unk_id = self.vocab["[UNK]"]

    def basic_tokenize(self, text: str) -> list[str]:
        text = unicodedata.normalize("NFC", text.lower())
        out: list[str] = []
        word = ""
        for ch in text:
            if ch.isspace():
                if word:
                    out.append(word)
                    word = ""
            elif _is_punct(ch):
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    def wordpiece(self, word: str) -> list[int]:
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, *, add_special: bool = True) -> list[int]:
        ids: list[int] = []
        for tok in self.basic_tokenize(text):
            ids.extend(self.wordpiece(tok))
        if add_special:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def token_spans(self, prompts: Sequence[str]) -> tuple[list[int], list[tuple[int, int]]]:
        """Encode "p1 . p2 . ..." as GroundingDINO captions and return
        (input_ids, [(start, end) token span per prompt]) — spans exclude
        the trailing '.' and special tokens."""
        ids = [self.cls_id]
        spans = []
        dot = self.vocab.get(".", self.unk_id)
        for p in prompts:
            start = len(ids)
            for tok in self.basic_tokenize(p):
                ids.extend(self.wordpiece(tok))
            spans.append((start, len(ids)))
            ids.append(dot)
        ids.append(self.sep_id)
        return ids, spans
