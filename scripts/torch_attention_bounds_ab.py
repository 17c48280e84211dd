#!/usr/bin/env python3
"""Launch bounds of the attention backward (K7), compared on one NVIDIA GPU.

ptxas picks each kernel's register count from its ``__launch_bounds__``,
whose blocks-per-SM floors ``ops/csrc/attention.cu`` takes from two macros.
This script builds the source three ways and times K7 built each way, in
turns, in one process, at the unfused layer's shapes:

- ``committed``: the source as it stands (three blocks per SM asked of the
  dK/dV kernel at head_dim 32, ptxas's own choice elsewhere);
- ``none``: ptxas's own choice for both backward kernels everywhere;
- ``two``: a floor of two blocks per SM on both backward kernels.

For each variant it prints the backward kernels' registers and spill
stores from ``nvcc -Xptxas -v``; for each shape, every variant's median
milliseconds over four turns (each turn the median of five event-timed
runs of 20 launches). Each result is held against the plain version
(relative error under 1e-2). Run from the repository root on a machine
with nvcc:

    python3 scripts/torch_attention_bounds_ab.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import cuda_ms_median  # noqa: E402
from instacart_next_order_recommendation_tpu_torch.ops import _build  # noqa: E402
from instacart_next_order_recommendation_tpu_torch.ops import attention as attn  # noqa: E402

VARIANTS = {
    "committed": (),
    "none": ("ATTN_DKDV_MIN_BLOCKS_D32=0",),
    "two": ("ATTN_BWD_MIN_BLOCKS=2", "ATTN_DKDV_MIN_BLOCKS_D32=2"),
}
SHAPES = [(64, 256, 64), (256, 192, 64), (64, 512, 32), (64, 200, 32), (64, 136, 16)]
HEADS = 12


def build(out: Path) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once; prints the backward kernels'
    registers and spill stores."""
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC_DIR / "attention.cu"
    procs = {name: _build.start_nvcc(src, out / f"lib{name}.so", defines)
             for name, defines in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        for kernel, (regs, spills) in _build.ptxas_usage(log).items():
            if kernel.startswith("attn_bwd_"):
                print(f"{name}: {kernel} {regs} registers, {spills} bytes spill stores")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.attention_backward.argtypes = attn._SIGNATURES["attention_backward"]
        lib.attention_backward.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    libs = build(_build.BUILD_DIR / "bounds_ab")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    for b, s, d in SHAPES:
        q, k, v, do = (torch.randn((b, HEADS, s, d), generator=g).to(dev, torch.bfloat16)
                       for _ in range(4))
        lengths = torch.randint(1, s + 1, (b,), generator=g)
        lengths[-1] = 0  # an all-pad row
        mask = (torch.arange(s)[None] < lengths[:, None]).to(torch.int32).to(dev)
        bias = attn._kernel_inputs(q, k, v, mask, (("do", do),))
        grads = [attn._empty_like_heads(q) for _ in range(3)]
        stats = torch.empty((3, b, HEADS, s), dtype=torch.float32, device=dev)
        strides = attn._strides(q, k, v, do, *grads)
        refs = attn.multi_head_attention_backward_reference(q, k, v, mask, do, d**-0.5)
        ptr = _build.ptr

        def call(lib):
            err = lib.attention_backward(
                ptr(q), ptr(k), ptr(v), ptr(bias), ptr(do), *(ptr(t) for t in grads), ptr(stats),
                strides, b, HEADS, s, d, d**-0.5, _build.stream_of(q),
            )
            if err:
                raise RuntimeError(f"attention_backward: CUDA error {err}")

        times = {name: [] for name in libs}
        names = list(libs)
        for order in (names, names[::-1], names, names[::-1]):
            for name in order:
                call(libs[name])
                torch.cuda.synchronize()
                rel = max(((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                          for a, r in zip(grads, refs))
                if rel > 1e-2:
                    raise SystemExit(f"{name} at B={b} S={s} D={d}: relative error {rel:.3g}")
                times[name].append(cuda_ms_median(lambda: call(libs[name]), 20))
        print(f"K7 B={b} heads={HEADS} S={s} D={d}: " + "  ".join(
            f"{name} {np.median(t):.4f} ms" for name, t in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
