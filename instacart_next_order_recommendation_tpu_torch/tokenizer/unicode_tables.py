"""Unicode classification/transform tables for the native tokenizer.

The port's copy of the JAX package's ``tokenizer/unicode_tables.py``. The C++
fast path (``native/wordpiece.cpp``) is kept exactly equivalent to the
pure-Python tokenizer by construction: instead of reimplementing Unicode in
C++, the tables below are generated from the SAME ``unicodedata`` the Python
path uses and passed to the native tokenizer at create time.

Per BMP codepoint:
- ``flags``: SPACE / PUNCT / DROP / CJK / BAIL classification matching
  ``wordpiece.basic_tokenize`` (HF BasicTokenizer semantics),
- ``xform``: the NFC -> per-char-lowercase -> NFD-strip-accents transform
  (identity/single codepoint inline; multi-codepoint outputs in an
  exceptions list; -2 = empty output).

Astral codepoints are covered by run-length class ranges. Anything whose
behavior is context-sensitive — nonzero canonical combining class (NFC can
compose across characters), transforms that change a character's class —
is flagged BAIL: the native encoder rejects rows containing such codepoints
and the wrapper re-encodes them in Python. Tables are cached on disk keyed
by the Unicode database version, under ``<repo>/build/native/`` (the JAX
package caches its own under ``native/``); the cache is written to a
temporary name and moved into place, so concurrent processes never read a
half-written file.
"""

from __future__ import annotations

import logging
import os
import threading
import unicodedata
from pathlib import Path

import numpy as np

from instacart_next_order_recommendation_tpu_torch.tokenizer.wordpiece import (
    _is_cjk,
    _is_punctuation,
)

logger = logging.getLogger(__name__)

FLAG_SPACE = 1
FLAG_PUNCT = 2
FLAG_DROP = 4
FLAG_CJK = 8
FLAG_BAIL = 16

CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def _class_flags(cp: int) -> int:
    ch = chr(cp)
    cat = unicodedata.category(ch)
    if cp in (0, 0xFFFD) or (cat.startswith("C") and ch not in "\t\n\r"):
        return FLAG_DROP
    # Zl/Zp (U+2028/U+2029) are not HF-whitespace but survive cleaning and
    # then split at whitespace_tokenize's str.split() — net effect: space.
    if ch in (" ", "\t", "\n", "\r") or cat in ("Zs", "Zl", "Zp"):
        return FLAG_SPACE
    if _is_cjk(cp):
        return FLAG_CJK
    if _is_punctuation(ch):
        return FLAG_PUNCT
    return 0


def _transform_seq(cp: int, lowercase: bool) -> list[int]:
    """Per-char transform: NFC, then (when lowercasing) char-wise lower +
    NFD accent strip — the exact pipeline of ``basic_tokenize``."""
    s = unicodedata.normalize("NFC", chr(cp))
    if lowercase:
        s = "".join(c.lower() for c in s)
        s = unicodedata.normalize("NFD", s)
        s = "".join(c for c in s if unicodedata.category(c) != "Mn")
    return [ord(c) for c in s]


def _generate(lowercase: bool) -> dict[str, np.ndarray]:
    flags = np.zeros(0x10000, np.uint8)
    xform = np.full(0x10000, -2, np.int32)
    exc_cp: list[int] = []
    exc_seqs: list[list[int]] = []
    for cp in range(0x10000):
        if 0xD800 <= cp <= 0xDFFF:  # surrogates: cannot appear in UTF-8
            flags[cp] = FLAG_BAIL
            continue
        f = _class_flags(cp)
        if not f & (FLAG_DROP | FLAG_SPACE):
            if unicodedata.combining(chr(cp)) != 0:
                f |= FLAG_BAIL
            else:
                seq = _transform_seq(cp, lowercase)
                base = f & (FLAG_SPACE | FLAG_PUNCT | FLAG_DROP | FLAG_CJK)
                stable = all(oc < 0x110000 and _class_flags(oc) == base for oc in seq)
                if not stable:
                    f |= FLAG_BAIL
                elif len(seq) == 1:
                    xform[cp] = seq[0]
                elif len(seq) == 0:
                    xform[cp] = -2
                else:
                    xform[cp] = -1
                    exc_cp.append(cp)
                    exc_seqs.append(seq)
        flags[cp] = f

    # Astral plane: run-length classes. Word chars must be full identities
    # (no case mapping, no decomposition, ccc 0) or they bail to Python.
    starts: list[int] = []
    classes: list[int] = []
    prev = -1
    for cp in range(0x10000, 0x110000):
        f = _class_flags(cp)
        if not f & (FLAG_DROP | FLAG_SPACE):
            # Astral chars pass through the native path untransformed, so
            # anything with a case mapping or decomposition (e.g. CJK
            # compatibility ideographs, Deseret capitals) bails to Python.
            if unicodedata.combining(chr(cp)) != 0 or _transform_seq(cp, lowercase) != [cp]:
                f = FLAG_BAIL
        if f != prev:
            starts.append(cp)
            classes.append(f)
            prev = f

    exc_off = np.zeros(len(exc_cp) + 1, np.int32)
    for i, seq in enumerate(exc_seqs):
        exc_off[i + 1] = exc_off[i] + len(seq)
    return {
        "flags": flags,
        "xform": xform,
        "exc_cp": np.asarray(exc_cp, np.int32),
        "exc_off": exc_off,
        "exc_dat": np.asarray([oc for seq in exc_seqs for oc in seq], np.int32),
        "astral_starts": np.asarray(starts, np.int32),
        "astral_class": np.asarray(classes, np.uint8),
    }


def build_tables(lowercase: bool) -> dict[str, np.ndarray]:
    """Build (or load from cache) the table set for one lowercase mode."""
    cache = CACHE_DIR / (
        f".unicode_tables_v{unicodedata.unidata_version}_"
        f"{'lower' if lowercase else 'cased'}.npz"
    )
    if cache.exists():
        try:
            with np.load(cache) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError) as exc:  # corrupt cache: regenerate
            logger.info("regenerating unicode tables (%s unreadable: %s)", cache, exc)
    tables = _generate(lowercase)
    cache.parent.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_name(f"{cache.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **tables)
    os.replace(tmp, cache)
    return tables
