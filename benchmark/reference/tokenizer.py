"""BERT's uncased WordPiece tokenization, written plainly: clean the text,
space out CJK ideographs, split on whitespace, lower-case and strip accents,
split off punctuation, then greedy longest-match-first WordPiece with
``##`` continuations, wrapped in [CLS] ... [SEP] and cut to the length."""

from __future__ import annotations

import unicodedata

MAX_CHARS_PER_WORD = 100


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokens(text: str) -> list[str]:
    chars = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        if cp == 0 or cp == 0xFFFD or (cat.startswith("C") and ch not in "\t\n\r"):
            continue
        if _is_cjk(cp):
            chars.append(f" {ch} ")
        elif ch in " \t\n\r" or cat == "Zs":
            chars.append(" ")
        else:
            chars.append(ch)
    text = unicodedata.normalize("NFC", "".join(chars))
    out = []
    for word in text.split():
        word = unicodedata.normalize("NFD", "".join(c.lower() for c in word))
        word = "".join(c for c in word if unicodedata.category(c) != "Mn")
        current = ""
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    out.append(current)
                    current = ""
                out.append(ch)
            else:
                current += ch
        if current:
            out.append(current)
    return out


class Tokenizer:
    def __init__(self, vocab: dict[str, int]):
        self.vocab = vocab
        self.pad, self.unk = vocab["[PAD]"], vocab["[UNK]"]
        self.cls, self.sep = vocab["[CLS]"], vocab["[SEP]"]

    def wordpiece(self, word: str) -> list[int]:
        if len(word) > MAX_CHARS_PER_WORD:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if end == start:
                return [self.unk]
            start = end
        return ids

    def encode(self, text: str, max_len: int) -> list[int]:
        ids = []
        for word in basic_tokens(text):
            ids += self.wordpiece(word)
        return [self.cls] + ids[: max_len - 2] + [self.sep]
