#!/usr/bin/env python3
"""Where K3's time goes inside the slice kernel, and the rate of its unit, on one NVIDIA GPU.

1. Builds an instrumented copy of ``csrc/topk.cu`` under ``build/topk_phases/``:
   ``clock64`` counters, summed over one thread of every block, around the
   ring wait (``cp.async`` wait and the barrier), the start of the next
   stage's copies, the tensor-core products of a stage, and the selection
   of a tile, and a count of merges (the merge kernel's among them). It
   runs that copy at the shapes ``chip_smoke.py`` times and prints each
   phase's cycles per block and share. The counters cost time themselves,
   so the shares are the reading, not the milliseconds.
2. Builds and runs a microbenchmark of ``mma.sync.m16n8k8`` in TF32 (eight
   warps a block, one block per SM, eight independent accumulators a warp):
   the unit's peak rate on this card and its cycles per product per
   scheduler, alone and with one split (``split_tf32``) per four products.

Run from the repository root on a machine with nvcc:

    python3 scripts/torch_topk_phases.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "topk_phases"
PHASES = ("ring wait", "copy start", "products", "selection")
SHAPES = (  # (B, N, D, k)
    (256, 50_000, 384, 16), (256, 50_000, 768, 16), (256, 50_000, 384, 100),
    (8, 1_000_000, 384, 10),
)

BENCH = r"""
#include <cuda_runtime.h>
#include <stdio.h>
#include "mma_common.cuh"
template <int SPLIT>
__global__ void bench(float* out, int iters, long long* cyc) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  float x = threadIdx.x * 1e-3f;
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (SPLIT) {
      uint32_t h, l;
      mmac::split_tf32(x, h, l);
      a[0] ^= h;
      a[1] ^= l;
      mmac::split_tf32(x + 1.0f, h, l);
      a[2] ^= h;
      a[3] ^= l;
      x += 1e-7f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) mmac::mma_tf32(acc[j], a, b0, b1);
  }
  const long long c1 = clock64();
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cyc = c1 - c0;
}
template <int SPLIT>
void run(const char* name) {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int iters = 20000, warps = 8;
  float* out;
  long long* cyc;
  cudaMalloc(&out, sms * warps * 32 * 4);
  cudaMalloc(&cyc, 8);
  bench<SPLIT><<<sms, warps * 32>>>(out, 100, cyc);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<SPLIT><<<sms, warps * 32>>>(out, iters, cyc);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c;
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  const double products = (double)sms * warps * iters * 8;
  printf("{\"bench\": \"%s\", \"tf32_tflops\": %.1f, \"sm_ghz\": %.3f, "
         "\"cycles_per_product_per_scheduler\": %.2f}\n",
         name, products * 2048 / (ms * 1e-3) / 1e12, c / (ms * 1e-3) / 1e9,
         (double)c / ((double)warps * iters * 8 / 4));
}
int main() {
  run<0>("mma.sync m16n8k8 tf32");
  run<1>("the same, one split_tf32 per four products");
  return cudaGetLastError() != cudaSuccess;
}
"""


def instrumented_source(src: str) -> str:
    """topk.cu with the phase counters; fails loudly if the source moved."""
    def put(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"torch_topk_phases: csrc/topk.cu changed near {old.strip()[:60]!r}")
        src = src.replace(old, new)

    put("namespace {\n", "__device__ unsigned long long g_phase[8];\nnamespace {\n")
    put("      cp_wait<STAGES - 2>();\n",
        "      const long long p0 = clock64();\n      cp_wait<STAGES - 2>();\n")
    put("      load_stage(step + STAGES - 1);\n",
        "      const long long p1 = clock64();\n      load_stage(step + STAGES - 1);\n"
        "      const long long p2 = clock64();\n")
    put("      mma_stage<TQ, KP>(acc, ring + (step % STAGES) * S::STAGE, wm, wn, g, t);\n",
        "      mma_stage<TQ, KP>(acc, ring + (step % STAGES) * S::STAGE, wm, wn, g, t);\n"
        "      if (tid == 0) {\n        atomicAdd(&g_phase[0], p1 - p0);\n"
        "        atomicAdd(&g_phase[1], p2 - p1);\n"
        "        atomicAdd(&g_phase[2], clock64() - p2);\n"
        "      }\n")
    put("    const int row0 = r_begin + tile * BM;\n",
        "    const long long p3 = clock64();\n    const int row0 = r_begin + tile * BM;\n")
    put("          cnt[warp + WARPS * i] = c[i];\n        }\n      }\n    }\n  }\n",
        "          cnt[warp + WARPS * i] = c[i];\n        }\n      }\n    }\n"
        "    if (tid == 0) atomicAdd(&g_phase[3], clock64() - p3);\n  }\n")
    put("  th = merge_pending<KP>(top, pq, PEND, k, lane);\n",
        "  if (lane == 0) atomicAdd(&g_phase[4], 1ull);\n"
        "  th = merge_pending<KP>(top, pq, PEND, k, lane);\n")
    put('extern "C" {\n',
        'extern "C" {\n\nint read_phases(unsigned long long* out) {\n'
        "  cudaDeviceSynchronize();\n  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n"
        "  const unsigned long long zero[8] = {};\n"
        "  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n}\n")
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from instacart_next_order_recommendation_tpu_torch.ops import _build
    from instacart_next_order_recommendation_tpu_torch.ops.topk import (
        _SIGNATURES,
        query_tile,
        slice_plan,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "topk_phases.cu"
    src.write_text(f'#include "{_build.CSRC_DIR / "mma_common.cuh"}"\n'
                   + instrumented_source((_build.CSRC_DIR / "topk.cu").read_text())
                   .replace('#include "mma_common.cuh"\n', ""))
    bench = OUT / "mma_bench.cu"
    bench.write_text(BENCH.replace('"mma_common.cuh"', f'"{_build.CSRC_DIR / "mma_common.cuh"}"'))
    lib_path = OUT / "libtopk_phases.so"
    executable_flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = [
        _build.start_nvcc(src, lib_path),
        subprocess.Popen(
            [_build._nvcc(), *executable_flags, "-o", str(OUT / "mma_bench"), str(bench)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ),
    ]
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            print(out, file=sys.stderr)
            return 1
    bench_out = subprocess.run([str(OUT / "mma_bench")], capture_output=True, text=True, check=True)
    print(bench_out.stdout, end="")

    lib = ctypes.CDLL(str(lib_path))
    lib.topk_slices.argtypes = _SIGNATURES["topk_slices"]
    lib.topk_slices.restype = ctypes.c_int
    lib.read_phases.argtypes = [ctypes.c_void_p]
    lib.read_phases.restype = ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counts = (ctypes.c_ulonglong * 8)()
    for b, n, d, k in SHAPES:
        c = torch.randn((n, d), generator=g, device=dev)
        c /= c.norm(dim=1, keepdim=True)
        q = torch.randn((b, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        rows, n_slices = slice_plan(b, n, k, sms)
        tq = query_tile(b, k)
        cand = torch.empty((b, n_slices * k), dtype=torch.int64, device=dev)
        out_s = torch.empty((b, k), device=dev)
        out_i = torch.empty((b, k), dtype=torch.int32, device=dev)

        def call():
            err = lib.topk_slices(
                _build.ptr(q), _build.ptr(c), None, _build.ptr(cand), _build.ptr(out_s),
                _build.ptr(out_i), b, n, d, n, k, 0, tq, rows, n_slices, _build.stream_of(q),
            )
            if err:
                raise RuntimeError(f"topk_slices: CUDA error {err}")

        call()
        lib.read_phases(counts)
        call()
        lib.read_phases(counts)
        blocks = n_slices * -(-b // tq)
        cycles = {name: counts[i] / blocks for i, name in enumerate(PHASES)}
        total = sum(cycles.values())
        print(json.dumps({
            "B": b, "N": n, "D": d, "k": k, "blocks": blocks,
            "cycles_per_block": {name: round(v) for name, v in cycles.items()},
            "share": {name: round(v / total, 3) for name, v in cycles.items()},
            "merges_per_block": counts[4] / blocks,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
