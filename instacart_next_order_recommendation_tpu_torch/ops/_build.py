"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface under ``<repo>/build/kernels/``. The file name carries a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so a
changed source rebuilds and an unchanged one is loaded as it is. ``build`` starts one nvcc per missing library, all
at once, and waits for all of them.

Every C entry point returns ``cudaGetLastError()`` after its launches; the
Python wrappers pass it to ``check``, which raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_layer", "fused_layer_bwd", "pool_norm", "topk")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def build(names: tuple[str, ...] = SOURCES, ptxas_info: bool = False) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process each, all started together. Returns nvcc's output per name
    (with ``ptxas_info``, each kernel's registers and shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS]
        if ptxas_info:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in started.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


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


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.error_string(err).decode()})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
