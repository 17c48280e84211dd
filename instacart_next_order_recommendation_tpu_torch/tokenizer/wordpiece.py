"""BERT-compatible WordPiece tokenizer, with a C++ batch path.

The port's own copy of the JAX package's tokenizer: it loads a standard BERT
``vocab.txt`` or trains a domain vocab from the corpus, and its output is
identical to the JAX package's tokenizer for the same vocab and text.
Batches encode through ``native/wordpiece.cpp`` (``tokenizer/native.py``),
built at first use; ``encode_batch_reference`` is the pure-Python batch
encode, the native path's plain version.

Outputs are fixed-shape int32 ``(input_ids, attention_mask)`` batches padded to
bucketed lengths, so the kernels see a small set of sequence lengths.
"""

from __future__ import annotations

import collections
import json
import threading
import unicodedata
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
MASK_TOKEN = "[MASK]"
SPECIAL_TOKENS = [PAD_TOKEN, UNK_TOKEN, CLS_TOKEN, SEP_TOKEN, MASK_TOKEN]

# Static sequence-length buckets up to BERT's positional limit. Finer than
# powers of two in the 64-256 range: the fused encoder layer accepts any
# multiple of 16, and tower FLOPs scale with the padded length, so a
# 150-token query pays 160 instead of 256.
LENGTH_BUCKETS = (16, 32, 48, 64, 96, 128, 160, 192, 224, 256, 512)


def bucket_length(max_token_len: int, max_seq_length: int = 256) -> int:
    """Smallest bucket that fits ``max_token_len`` (capped at max_seq_length)."""
    for b in LENGTH_BUCKETS:
        if b >= min(max_token_len, max_seq_length):
            return min(b, max_seq_length)
    return max_seq_length


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


# CJK Unified Ideograph blocks (BERT tokenizes these one character per token).
_CJK_RANGES = (
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DBF),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF),
    (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """BERT basic tokenization, matching HF's ``BasicTokenizer`` semantics:
    clean text (drop controls/U+0000/U+FFFD, canonicalize whitespace), space
    out CJK ideographs, NFC-normalize, whitespace-split, then per token
    lowercase + NFD accent-strip (when ``lowercase``) and punctuation-split.
    """
    cleaned: list[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(f" {ch} ")
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    text = unicodedata.normalize("NFC", "".join(cleaned))

    tokens: list[str] = []
    for token in text.split():
        if lowercase:
            # Per-character lowercase (no Final_Sigma context): matches both
            # HF's slow BertTokenizer (regex chunks of length 1) and the Rust
            # fast tokenizers (char-wise to_lowercase).
            token = "".join(ch.lower() for ch in token)
            token = unicodedata.normalize("NFD", token)
            token = "".join(ch for ch in token if unicodedata.category(ch) != "Mn")
        current: list[str] = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT-format vocab."""

    def __init__(
        self,
        vocab: dict[str, int],
        lowercase: bool = True,
        max_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = vocab[PAD_TOKEN]
        self.unk_id = vocab[UNK_TOKEN]
        self.cls_id = vocab[CLS_TOKEN]
        self.sep_id = vocab[SEP_TOKEN]
        # Per-word memo, bounded: a serving process tokenizes arbitrary
        # free-text queries, and an uncapped dict would grow RSS without
        # limit. At the cap the memo resets (the common grocery vocabulary
        # re-fills it almost immediately; amortized cost is negligible).
        self._cache: dict[str, list[int]] = {}
        self._cache_max = 262_144
        # The C++ handle, made at the first batch; False where the native
        # code cannot represent this vocab (the batch takes the Python path).
        self._native = None
        self._native_lock = threading.Lock()
        # Which route each encode_batch took, and the rows the native path
        # handed back to Python (context-sensitive codepoints).
        self.native_batches = 0
        self.python_batches = 0
        self.bailed_rows = 0

    # ------------------------------------------------------------------ vocab IO

    @classmethod
    def load(cls, model_dir: Path | str) -> "WordPieceTokenizer":
        """Load from a directory containing ``vocab.txt`` (BERT format).

        Reads ``tokenizer_config.json`` for the lowercase flag when present
        (HF checkpoints ship one; our saved checkpoints do too).
        """
        model_dir = Path(model_dir)
        vocab_path = model_dir / "vocab.txt" if model_dir.is_dir() else model_dir
        vocab: dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        lowercase = True
        cfg_path = vocab_path.parent / "tokenizer_config.json"
        if cfg_path.exists():
            try:
                cfg = json.loads(cfg_path.read_text())
                lowercase = bool(cfg.get("do_lower_case", True))
            except (json.JSONDecodeError, OSError):
                pass
        return cls(vocab, lowercase=lowercase)

    def save(self, model_dir: Path | str) -> None:
        model_dir = Path(model_dir)
        model_dir.mkdir(parents=True, exist_ok=True)
        ordered = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(model_dir / "vocab.txt", "w", encoding="utf-8") as f:
            for token, _ in ordered:
                f.write(token + "\n")
        with open(model_dir / "tokenizer_config.json", "w") as f:
            json.dump({"do_lower_case": self.lowercase, "tokenizer_class": "WordPiece"}, f)

    # ------------------------------------------------------------------ training

    @classmethod
    def train(
        cls,
        texts: Iterable[str],
        vocab_size: int = 30_000,
        lowercase: bool = True,
        min_frequency: int = 2,
    ) -> "WordPieceTokenizer":
        """Induce a WordPiece vocab from a text corpus.

        Strategy: all observed characters (word-initial and ``##``-continuation
        forms) are always included so no word ever degenerates to [UNK]; the
        remaining budget goes to the most frequent whole words, then the most
        frequent continuation suffixes (length-capped), which keeps rare
        morphology segmentable.
        """
        word_freq: collections.Counter[str] = collections.Counter()
        for text in texts:
            word_freq.update(basic_tokenize(text, lowercase=lowercase))

        # Seed with full ASCII alphanumerics so unseen-at-train-time words still
        # segment to characters instead of [UNK].
        base_chars = "abcdefghijklmnopqrstuvwxyz0123456789"
        char_tokens: set[str] = {c for c in base_chars} | {f"##{c}" for c in base_chars}
        for word in word_freq:
            for i, ch in enumerate(word):
                char_tokens.add(ch if i == 0 else f"##{ch}")

        suffix_freq: collections.Counter[str] = collections.Counter()
        for word, freq in word_freq.items():
            for start in range(1, len(word)):
                for ln in (2, 3, 4):
                    if start + ln <= len(word):
                        suffix_freq[f"##{word[start:start + ln]}"] += freq

        vocab: dict[str, int] = {}
        for tok in SPECIAL_TOKENS:
            vocab[tok] = len(vocab)
        for tok in sorted(char_tokens):
            if tok not in vocab:
                vocab[tok] = len(vocab)
        for word, freq in word_freq.most_common():
            if len(vocab) >= vocab_size:
                break
            if freq >= min_frequency and word not in vocab:
                vocab[word] = len(vocab)
        for piece, freq in suffix_freq.most_common():
            if len(vocab) >= vocab_size:
                break
            if freq >= min_frequency and piece not in vocab:
                vocab[piece] = len(vocab)
        return cls(vocab, lowercase=lowercase)

    # ------------------------------------------------------------------ encoding

    def _wordpiece(self, word: str) -> list[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if len(word) > self.max_chars_per_word:
            out = [self.unk_id]
            self._memoize(word, out)
            return out
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur_id = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                pid = self.vocab.get(piece)
                if pid is not None:
                    cur_id = pid
                    break
                end -= 1
            if cur_id is None:
                ids = [self.unk_id]
                break
            ids.append(cur_id)
            start = end
        self._memoize(word, ids)
        return ids

    def _memoize(self, word: str, ids: list[int]) -> None:
        if len(self._cache) >= self._cache_max:
            self._cache.clear()
        self._cache[word] = ids

    def encode(self, text: str, max_seq_length: int = 256) -> list[int]:
        """Token ids with [CLS]/[SEP], truncated to max_seq_length."""
        ids = [self.cls_id]
        for word in basic_tokenize(text, lowercase=self.lowercase):
            ids.extend(self._wordpiece(word))
            if len(ids) >= max_seq_length - 1:
                ids = ids[: max_seq_length - 1]
                break
        ids.append(self.sep_id)
        return ids

    def encode_batch(
        self,
        texts: Sequence[str],
        max_seq_length: int = 256,
        pad_to: int | None = None,
        pad_batch_to: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Encode a batch into fixed-shape int32 (input_ids, attention_mask).

        ``pad_to=None`` pads to the smallest static length bucket that fits the
        batch (recompile-free across batches); a fixed ``pad_to`` pins the
        shape entirely. ``pad_batch_to`` pads the batch dimension with empty
        rows (mask 0) to a fixed batch size.

        The batch encodes through the C++ path; rows it flags as
        context-sensitive are re-encoded here in Python. Where the native
        code cannot take the vocab or the texts (ids not 0..n-1, text that
        is not valid UTF-8) the whole batch takes ``encode_batch_reference``.
        Either way the result equals ``encode_batch_reference``'s.
        """
        if pad_batch_to is not None and pad_batch_to < len(texts):
            # The C++ path writes len(texts) rows into buffers sized
            # pad_batch_to: refuse before any pointer is passed.
            raise ValueError(
                f"pad_batch_to={pad_batch_to} is smaller than the batch ({len(texts)} texts)"
            )
        native = self._get_native()
        if native is not None:
            full_len = pad_to if pad_to is not None else max_seq_length
            n_rows = pad_batch_to if pad_batch_to is not None else len(texts)
            # NUL bytes would truncate the C string; Python drops them, so
            # stripping first is output-identical.
            clean = [t.replace("\x00", "") if "\x00" in t else t for t in texts]
            result = native.encode_batch(clean, full_len, n_rows, self.pad_id)
            if result is not None:
                ids, mask, longest, bailed = result
                rows = np.flatnonzero(bailed)
                for i in rows:
                    row = self.encode(texts[i], max_seq_length)
                    if len(row) > full_len:
                        row = row[:full_len]
                        row[-1] = self.sep_id
                    ids[i, : len(row)] = row
                    mask[i, : len(row)] = 1
                    longest = max(longest, len(row))
                with self._native_lock:
                    self.native_batches += 1
                    self.bailed_rows += len(rows)
                if pad_to is None:
                    seq_len = bucket_length(longest, max_seq_length)
                    if seq_len < full_len:
                        return np.ascontiguousarray(ids[:, :seq_len]), np.ascontiguousarray(
                            mask[:, :seq_len]
                        )
                return ids, mask
        with self._native_lock:
            self.python_batches += 1
        return self.encode_batch_reference(texts, max_seq_length, pad_to, pad_batch_to)

    def encode_batch_reference(
        self,
        texts: Sequence[str],
        max_seq_length: int = 256,
        pad_to: int | None = None,
        pad_batch_to: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``encode_batch`` in pure Python, row by row: the native path's
        plain version."""
        if pad_batch_to is not None and pad_batch_to < len(texts):
            raise ValueError(
                f"pad_batch_to={pad_batch_to} is smaller than the batch ({len(texts)} texts)"
            )
        encoded = [self.encode(t, max_seq_length) for t in texts]
        longest = max((len(e) for e in encoded), default=2)
        seq_len = pad_to if pad_to is not None else bucket_length(longest, max_seq_length)
        n_rows = pad_batch_to if pad_batch_to is not None else len(encoded)

        input_ids = np.full((n_rows, seq_len), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((n_rows, seq_len), dtype=np.int32)
        for i, ids in enumerate(encoded):
            if len(ids) > seq_len:
                ids = ids[:seq_len]
                ids[-1] = self.sep_id  # rows always end with [SEP]
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
        return input_ids, attention_mask

    def _get_native(self):
        """The C++ handle, made at first use; None where this vocab takes
        the Python path. A library that does not build or load raises."""
        if self._native is None:
            with self._native_lock:
                if self._native is None:
                    from instacart_next_order_recommendation_tpu_torch.tokenizer.native import (
                        MAX_CHARS_PER_WORD,
                        NativeWordPiece,
                    )

                    handle = None
                    if self.max_chars_per_word == MAX_CHARS_PER_WORD:
                        handle = NativeWordPiece.create(
                            self.vocab,
                            self.lowercase,
                            self.pad_id,
                            self.unk_id,
                            self.cls_id,
                            self.sep_id,
                        )
                    self._native = handle if handle is not None else False
        return self._native or None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
