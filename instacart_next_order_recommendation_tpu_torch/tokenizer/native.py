"""ctypes bindings for the C++ WordPiece batch tokenizer (``native/wordpiece.cpp``).

Counterpart of the JAX package's ``tokenizer/native.py``. The shared library
is built with g++ (``native/Makefile``'s flags) at first use, into
``<repo>/build/native/libwordpiece-<hash>.so``: the hash covers the source
and the flags, so a changed source rebuilds. The build writes a temporary
file and moves it into place, under a file lock, so concurrent processes
build once and never load a half-written library; g++'s output is kept
beside the library (``.log``). Unlike the JAX package, a failed build or
load raises: there is no silent return to the pure-Python tokenizer.

Rows holding context-sensitive codepoints (combining marks, astral case
mappings) come back flagged in ``bailed``; the tokenizer re-encodes those
rows in Python. That per-row return is part of the native contract, which
is to give the pure-Python tokenizer's output for every input.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "wordpiece.cpp"
BUILD_DIR = REPO / "build" / "native"
COMPILER = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# The C++ side's word-length cap (``Tokenizer::max_chars_per_word``).
MAX_CHARS_PER_WORD = 100

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libwordpiece-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError with g++'s output when the compiler fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # one process compiles; the others wait, then load
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [COMPILER, *FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as exc:
            raise RuntimeError(f"native tokenizer: cannot run {COMPILER}: {exc}") from exc
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native tokenizer: {COMPILER} exit {proc.returncode}\n{log}")
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the library, declaring its entry points."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # tokens
            ctypes.c_int32,  # n
            ctypes.c_int32,  # pad_id
            ctypes.c_int32,  # unk_id
            ctypes.c_int32,  # cls_id
            ctypes.c_int32,  # sep_id
            _u8p,  # flags[65536]
            _i32p,  # xform[65536]
            _i32p,  # exc_cp
            _i32p,  # exc_off
            _i32p,  # exc_dat
            ctypes.c_int32,  # n_exc
            _i32p,  # astral_starts
            _u8p,  # astral_class
            ctypes.c_int32,  # n_astral
        ]
        lib.wp_destroy.restype = None
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_encode_batch.restype = ctypes.c_int32
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.c_int32,
            _i32p,
            _i32p,
            ctypes.POINTER(ctypes.c_int8),
        ]
        _lib = lib
        return lib


class NativeWordPiece:
    """Native tokenizer over a BERT-format vocab; see ``create``."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib = lib
        self._handle = handle

    @classmethod
    def create(
        cls,
        vocab: dict[str, int],
        lowercase: bool,
        pad_id: int,
        unk_id: int,
        cls_id: int,
        sep_id: int,
    ) -> "NativeWordPiece | None":
        """A handle over ``vocab``, or None where the native code cannot
        represent the vocab (ids not 0..n-1, or a token that is not valid
        UTF-8): the tokenizer then takes its Python path. Raises where the
        library does not build or load."""
        lib = load_library()
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        if [i for _, i in ordered] != list(range(len(ordered))):
            return None
        try:
            arr = (ctypes.c_char_p * len(ordered))(*[t.encode("utf-8") for t, _ in ordered])
        except UnicodeEncodeError:
            return None
        from instacart_next_order_recommendation_tpu_torch.tokenizer.unicode_tables import (
            build_tables,
        )

        t = build_tables(lowercase)
        flags = np.ascontiguousarray(t["flags"], np.uint8)
        xform = np.ascontiguousarray(t["xform"], np.int32)
        exc_cp = np.ascontiguousarray(t["exc_cp"], np.int32)
        exc_off = np.ascontiguousarray(t["exc_off"], np.int32)
        exc_dat = np.ascontiguousarray(t["exc_dat"], np.int32)
        astral_starts = np.ascontiguousarray(t["astral_starts"], np.int32)
        astral_class = np.ascontiguousarray(t["astral_class"], np.uint8)
        handle = lib.wp_create(
            arr,
            len(ordered),
            pad_id,
            unk_id,
            cls_id,
            sep_id,
            flags.ctypes.data_as(_u8p),
            xform.ctypes.data_as(_i32p),
            exc_cp.ctypes.data_as(_i32p),
            exc_off.ctypes.data_as(_i32p),
            exc_dat.ctypes.data_as(_i32p),
            len(exc_cp),
            astral_starts.ctypes.data_as(_i32p),
            astral_class.ctypes.data_as(_u8p),
            len(astral_starts),
        )
        if not handle:
            raise RuntimeError("native tokenizer: wp_create returned no handle")
        return cls(lib, handle)

    def encode_batch(
        self, texts: list[str], max_len: int, n_rows: int, pad_id: int
    ) -> tuple[np.ndarray, np.ndarray, int, np.ndarray] | None:
        """(ids [n_rows, max_len], mask, longest, bailed [len(texts)]).

        ``bailed[i]`` marks rows the native path could not prove identical to
        Python (context-sensitive codepoints); their ids/mask rows are
        pad-filled and the caller re-encodes them. Returns None when the
        texts cannot be UTF-8 encoded at all (lone surrogates).
        """
        if n_rows < len(texts):
            raise ValueError(f"n_rows={n_rows} is smaller than the batch ({len(texts)} texts)")
        ids = np.full((n_rows, max_len), pad_id, dtype=np.int32)
        mask = np.zeros((n_rows, max_len), dtype=np.int32)
        bailed = np.zeros(len(texts), dtype=np.int8)
        try:
            arr = (ctypes.c_char_p * len(texts))(*[t.encode("utf-8") for t in texts])
        except UnicodeEncodeError:
            return None
        longest = self._lib.wp_encode_batch(
            self._handle,
            arr,
            len(texts),
            max_len,
            ids.ctypes.data_as(_i32p),
            mask.ctypes.data_as(_i32p),
            bailed.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
        return ids, mask, int(longest), bailed

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle:
            self._lib.wp_destroy(handle)
