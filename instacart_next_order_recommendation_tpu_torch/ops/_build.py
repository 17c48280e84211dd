"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface under ``<repo>/build/kernels/``. The file name carries a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so a
changed source rebuilds and an unchanged one is loaded as it is. ``build`` starts one nvcc per missing library, all
at once, and waits for all of them, holding a file lock on the build
directory: the ranks of a multi-GPU job on a fresh machine build once, and
the others wait and load. Each library keeps nvcc's output beside it
(``.log``): ptxas's registers, shared memory and spills per kernel.

Every C entry point returns ``cudaGetLastError()`` after its launches; the
Python wrappers pass it to ``check``, which raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("attention", "fused_layer", "fused_layer_bwd", "modernbert", "pool_norm", "topk")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def start_nvcc(src: Path, out: Path, defines: tuple[str, ...] = ()) -> subprocess.Popen:
    """One nvcc of ``src`` into ``out`` with ptxas's per-kernel report
    (``-Xptxas -v``) in its output; ``defines`` are extra ``-D`` flags."""
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", *(f"-D{d}" for d in defines)]
    cmd += ["-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process each, all started together. Returns nvcc's output per name:
    this build's, or the one kept beside a library built before. Other
    processes building into the same directory wait for this one (a file
    lock), then find its libraries built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # released when the file closes
        return _build_locked(names)


def _build_locked(names: tuple[str, ...]) -> dict[str, str]:
    started, logs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists() and out.with_suffix(".log").exists():
            logs[name] = out.with_suffix(".log").read_text()
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        started[name] = (start_nvcc(CSRC_DIR / f"{name}.cu", tmp), tmp, out)
    failed = []
    for name, (proc, tmp, out) in started.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{logs[name]}")
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def _template_args(mangled: str) -> list[str] | None:
    """The arguments of a mangled template argument list (after its ``I``,
    up to its ``E``): integers, ``float`` and named types; None for any
    other form."""
    args, i = [], 0
    while i < len(mangled) and mangled[i] != "E":
        if m := re.match(r"L[ib](\d+)E", mangled[i:]):
            args.append(m.group(1))
        elif mangled[i] == "f":
            args.append("float")
            i += 1
            continue
        elif m := re.match(r"(\d+)", mangled[i:]):
            n = int(m.group(1))
            args.append(mangled[i + len(m.group(1)) : i + len(m.group(1)) + n])
            i += len(m.group(1)) + n
            continue
        else:
            return None
        i += len(m.group(0))
    return args


def _kernel_key(mangled: str) -> str | None:
    """``name`` or ``name<template args>`` of a mangled ``*_kernel``. The
    (nested) name's components are read in order, each by its decimal
    length prefix, so the digits inside one (nvcc's anonymous-namespace
    hash, which depends on the source's path) are never taken for a
    prefix."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else None
    while i is not None and (m := re.match(r"\d+", mangled[i:])):
        start = i + len(m.group(0))
        i = start + int(m.group(0))
        name = mangled[start:i]
        if not name.endswith("_kernel"):
            continue
        if not mangled[i:].startswith("I"):
            return name
        args = _template_args(mangled[i + 1 :])
        return None if args is None else f"{name}<{','.join(args)}>"
    return None


def ptxas_usage(log: str) -> dict[str, tuple[int, int]]:
    """(registers, spill-store bytes) per kernel in nvcc's output, keyed
    ``name`` or ``name<template args>``."""
    out, name, spills = {}, None, 0
    for line in log.splitlines():
        if "Function properties for" in line:
            name = _kernel_key(line.split("Function properties for", 1)[1].strip())
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spills = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name], name = (int(m.group(1)), spills), None
    return out


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Load (building first if needed) ``lib<name>`` and declare the
    argument types of its entry points. Every entry point returns an int
    (a ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def count(fn, attr: str = "launches") -> None:
    """Add one to the counter ``fn.<attr>``, under a lock: several host
    threads launch at once (the micro-batcher's leaders, the stage
    calibrator), and a bare ``+=`` on an attribute can lose an update
    between its read and its write."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.error_string(err).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
