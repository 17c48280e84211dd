#!/usr/bin/env python3
"""K2 (masked mean-pool and L2 norm) timed on one NVIDIA GPU.

1. Builds ``csrc/pool_norm.cu`` (and, with ``--tma``, the variant below),
   prints ptxas's registers and spills per kernel, and holds every form of
   the kernel (load width and rows in flight x cluster size, at two warp
   counts) against the plain version, two launches bitwise equal.
2. ``chip_smoke.pool_reading`` at the main path's shapes (the serve batch,
   one recommend, a catalog batch, a train step) at H=384 and 768: the form
   ``pool_plan`` picks, cold and warm, in turns with the N-call yardstick.
3. ``--sweep``: every (cluster, warps, rows) at B in {1, 8, 32, 64, 128,
   256, 512, 1024}, S in {32, 96, 192, 256}, H in {384, 768}, each read
   cold (``chip_smoke.cold_ms``). Prints, per shape, the fastest plan, the
   fastest one-block plan and ``pool_plan``'s pick, then the whole table as
   one JSON line.
4. ``--tma``: a variant of the one-block form whose token rows arrive in
   shared memory by TMA bulk copies (``cp.async.bulk`` into a ring of
   stages behind ``mbarrier``s, issued by one thread), read cold in turns
   against the register-load kernel with the same warps and rows.

Exits 1 if any form disagrees with the plain version. Run from the
repository root on a machine with nvcc:

    python3 scripts/torch_pool_profile.py [--sweep] [--tma] [--package-root DIR]

``--package-root`` imports the port's package from another checkout (for
example a parent commit unpacked under ``build/tree/``); a checkout without
``pool_plan`` gets step 2 only.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "pool_variants"
MAIN_SHAPES = ((256, 192), (1, 64), (512, 32), (64, 256))  # (B, S)
SWEEP_B = (1, 8, 32, 64, 128, 256, 512, 1024)
SWEEP_S = (32, 96, 192, 256)
TMA_SHAPES = ((256, 192, 384), (256, 192, 768), (64, 256, 384), (64, 256, 768), (1024, 192, 384))
TMA_RINGS = ((4, 16384), (8, 8192), (4, 32768))  # (stages, bytes a stage)

TMA_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int MAX_STAGES = 8;
constexpr int MAX_S = 2048;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void issue(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"((uint64_t)src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n .reg .pred p;\n WAIT_%=:\n"
               " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
               " @!p bra WAIT_%=;\n}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per batch row; H % 8 == 0, H / 8 <= threads, S <= MAX_S.
template <int ROWS>
__global__ void __launch_bounds__(512)
pool_tma_kernel(const __nv_bfloat16* __restrict__ hidden, const int* __restrict__ mask,
                float* __restrict__ out, int S, int H, int stages, int stage_rows) {
  extern __shared__ __align__(128) unsigned char raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(raw + (size_t)stages * stage_rows * H * 2);
  float* wts = reinterpret_cast<float*>(bars + MAX_STAGES);
  const int C = H / 8, R = blockDim.x / C;
  float* red = wts + MAX_S;                // [R][H]
  float* scratch = red + R * H;            // [0, 32) per-warp sums, [32] count
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c_lane = tid % C, r_lane = tid / C;
  const __nv_bfloat16* x = hidden + (size_t)b * S * H;
  const int n = (S + stage_rows - 1) / stage_rows;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bars + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < n && k < stages; ++k) {
      const int rows = min(stage_rows, S - k * stage_rows);
      issue(ring + (size_t)k * stage_rows * H, x + (size_t)k * stage_rows * H, rows * H * 2, bars + k);
    }
  }
  for (int i = tid; i < S; i += blockDim.x) wts[i] = (float)mask[(size_t)b * S + i];
  __syncthreads();
  float count = 0.0f;
  if (warp == 0) {
    float c = 0.0f;
    for (int i = lane; i < S; i += 32) c += wts[i];
    count = warp_sum(c);
  }
  float acc[ROWS][8];
  for (int u = 0; u < ROWS; ++u)
    for (int j = 0; j < 8; ++j) acc[u][j] = 0.0f;
  const bool active = r_lane < R;
  for (int k = 0; k < n; ++k) {
    const int slot = k % stages, row0 = k * stage_rows, rows = min(stage_rows, S - row0);
    wait(bars + slot, (uint32_t)((k / stages) & 1));
    if (active) {
      const __nv_bfloat16* st = ring + (size_t)slot * stage_rows * H + c_lane * 8;
      for (int r = r_lane; r < rows; r += R * ROWS) {
        uint4 v[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
          if (r + u * R < rows) v[u] = *reinterpret_cast<const uint4*>(st + (size_t)(r + u * R) * H);
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          if (r + u * R >= rows) continue;
          const float w = wts[row0 + r + u * R];
          const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[u][2 * i] = fmaf(__uint_as_float(words[i] << 16), w, acc[u][2 * i]);
            acc[u][2 * i + 1] = fmaf(__uint_as_float(words[i] & 0xffff0000u), w, acc[u][2 * i + 1]);
          }
        }
      }
    }
    __syncthreads();  // the slot is consumed
    if (tid == 0 && k + stages < n) {
      const int nrow0 = (k + stages) * stage_rows, nrows = min(stage_rows, S - nrow0);
      issue(ring + (size_t)slot * stage_rows * H, x + (size_t)nrow0 * H, nrows * H * 2, bars + slot);
    }
  }
  if (active)
    for (int j = 0; j < 8; ++j) {
      float v = acc[0][j];
      for (int u = 1; u < ROWS; ++u) v += acc[u][j];
      red[r_lane * H + c_lane * 8 + j] = v;
    }
  if (tid == 0) scratch[32] = count;
  __syncthreads();
  const float cnt = scratch[32] < 1e-9f ? 1e-9f : scratch[32];
  float sq = 0.0f;
  for (int c = tid; c < H; c += blockDim.x) {
    float v = red[c];
    for (int r = 1; r < R; ++r) v += red[r * H + c];
    v /= cnt;
    red[c] = v;
    sq += v * v;
  }
  sq = warp_sum(sq);
  __syncthreads();
  if (lane == 0) scratch[warp] = sq;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  const float norm = sqrtf(total) < 1e-12f ? 1e-12f : sqrtf(total);
  for (int c = tid; c < H; c += blockDim.x) out[(size_t)b * H + c] = red[c] / norm;
}

template <int ROWS>
int launch(const void* h, const void* m, void* o, int B, int S, int H, int warps, int stages,
           int stage_bytes, cudaStream_t stream) {
  const int threads = warps * 32, C = H / 8;
  if (H % 8 || C > threads || S > MAX_S || stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  const int stage_rows = max(1, stage_bytes / (H * 2));
  const size_t smem = (size_t)stages * stage_rows * H * 2 + MAX_STAGES * 8 +
                      ((size_t)MAX_S + (threads / C) * H + 64) * 4;
  auto kernel = pool_tma_kernel<ROWS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, smem, stream>>>((const __nv_bfloat16*)h, (const int*)m, (float*)o, S, H,
                                        stages, stage_rows);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int pool_tma(const void* h, const void* m, void* o, int B, int S, int H, int warps,
                        int rows, int stages, int stage_bytes, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (rows) {
    case 2: return launch<2>(h, m, o, B, S, H, warps, stages, stage_bytes, st);
    case 4: return launch<4>(h, m, o, B, S, H, warps, stages, stage_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def random_input(b: int, s: int, h: int, g: torch.Generator, dev):
    import chip_smoke as cs

    return torch.randn((b, s, h), generator=g).to(dev, torch.bfloat16), cs.random_mask(b, s, g, dev)


def check_forms(pool_norm, dev) -> list[str]:
    """Every instance of the kernel against the plain version (K2_TOL) at
    shapes that take one and several mask tiles and column passes, two
    launches bitwise equal; the names of the forms that fail."""
    import chip_smoke as cs

    g = torch.Generator().manual_seed(31)
    failed = []
    for (b, s, h), cluster, warps, rows in itertools.product(
        ((3, 192, 384), (2, 77, 100), (2, 2500, 768), (1, 40, 12288)), (1, 2, 4, 8), (4, 16), (2, 4)
    ):
        y, m = random_input(b, s, h, g, dev)
        plan = pool_norm.PoolPlan(cluster, warps, rows, -(-s // cluster))
        out = pool_norm._launch(y, m, plan)
        again = pool_norm._launch(y, m, plan)
        ref = pool_norm.masked_mean_pool_l2norm_reference(y, m)
        err = (out - ref).abs().max().item()
        same = torch.equal(out.view(torch.int32), again.view(torch.int32))
        if not (err <= cs.K2_TOL and same):
            failed.append(f"{(b, s, h)} {plan} err={err:.3g} bitwise={same}")
    # H = 392 on 16-byte-aligned rows (16-byte loads), and one element in
    # (2-byte loads).
    y, m = random_input(4, 64, 392, g, dev)
    base = torch.empty(4 * 64 * 392 + 1, dtype=torch.bfloat16, device=dev)
    shifted = base[1:].view(4, 64, 392)
    shifted.copy_(y)
    for t in (y, shifted):
        err = (pool_norm._launch(t, m) - pool_norm.masked_mean_pool_l2norm_reference(t, m)).abs().max()
        if err.item() > cs.K2_TOL:
            failed.append(f"data_ptr % 16 = {t.data_ptr() % 16}: err={err.item():.3g}")
    return failed


def sweep(pool_norm, dev) -> list[dict]:
    import chip_smoke as cs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(32)
    table = []
    for h in (384, 768):
        for s in SWEEP_S:
            for b in SWEEP_B:
                y, m = random_input(b, s, h, g, dev)
                readings = {}
                for cluster, warps, rows in itertools.product((1, 2, 4, 8), (4, 8, 12, 16), (2, 4)):
                    if s < 4 * cluster:
                        continue
                    plan = pool_norm.PoolPlan(cluster, warps, rows, -(-s // cluster))
                    readings[plan] = cs.cold_ms(lambda: pool_norm._launch(y, m, plan), 10)
                pick = pool_norm.pool_plan(b, s, sms)
                if pick not in readings:
                    readings[pick] = cs.cold_ms(lambda: pool_norm._launch(y, m, pick), 10)
                best = min(readings, key=readings.get)
                one = min((p for p in readings if p.cluster == 1), key=readings.get)
                row = {
                    "b": b, "s": s, "h": h,
                    "best": best._asdict(), "best_ms": readings[best],
                    "one_block": one._asdict(), "one_block_ms": readings[one],
                    "pick": pick._asdict(), "pick_ms": readings[pick],
                    "bound_ms": cs.k2_bound(b, s, h)[0],
                    "all": [[*p[:3], ms] for p, ms in readings.items()],
                }
                cs.log(f"sweep B={b} S={s} H={h}: best {tuple(best[:3])} {readings[best]:.5f} ms, "
                       f"one block {tuple(one[:3])} {readings[one]:.5f}, pick {tuple(pick[:3])} "
                       f"{readings[pick]:.5f} ({readings[pick] / readings[best]:.3f}x best), "
                       f"bound {row['bound_ms']:.5f}")
                table.append(row)
                del y, m
    return table


def tma_variant(pool_norm, dev, lib) -> list[dict]:
    """The TMA variant against the register-load kernel, one block per
    row, the same warps and rows, read cold in turns."""
    import chip_smoke as cs

    g = torch.Generator().manual_seed(33)
    rows_out = []
    for b, s, h in TMA_SHAPES:
        y, m = random_input(b, s, h, g, dev)
        ref = pool_norm.masked_mean_pool_l2norm_reference(y, m)
        for warps, rows in ((8, 4), (12, 4), (16, 2)):
            plan = pool_norm.PoolPlan(1, warps, rows, s)
            fns = {"registers": lambda: pool_norm._launch(y, m, plan)}
            errs = {}
            for stages, nbytes in TMA_RINGS:
                out = torch.empty((b, h), device=dev)

                def run(out=out, stages=stages, nbytes=nbytes):
                    err = lib.pool_tma(y.data_ptr(), m.data_ptr(), out.data_ptr(), b, s, h, warps,
                                       rows, stages, nbytes,
                                       torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"pool_tma: CUDA error {err}")
                    return out

                run()
                torch.cuda.synchronize()
                errs[f"tma {stages}x{nbytes}"] = (out - ref).abs().max().item()
                fns[f"tma {stages}x{nbytes}"] = run
            ms = cs.ms_in_turns(fns, 20, turns=4, read=cs.cold_ms)
            row = {"b": b, "s": s, "h": h, "warps": warps, "rows": rows, "ms": ms, "max_abs_err": errs}
            cs.log(f"TMA variant {json.dumps(row)}")
            rows_out.append(row)
    return rows_out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", type=Path, default=REPO)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--tma", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    # chip_smoke's helpers import the package when called, so another
    # checkout's root goes first on the path from here on.
    sys.path.insert(0, str(args.package_root.resolve()))
    from instacart_next_order_recommendation_tpu_torch.ops import _build, pool_norm

    print(smi())
    cs.log(f"package from {Path(_build.__file__).resolve().parents[2]}")
    new = hasattr(pool_norm, "pool_plan")
    tma = None
    if args.tma and new:
        OUT.mkdir(parents=True, exist_ok=True)
        src = OUT / "pool_tma.cu"
        src.write_text(TMA_SOURCE)
        tma = _build.start_nvcc(src, OUT / "libpool_tma.so")
    logs = _build.build(("pool_norm",))
    cs.log(f"ptxas (registers, spill stores): {json.dumps(_build.ptxas_usage(logs['pool_norm']))}")
    if tma is not None:
        tma_log, _ = tma.communicate()
        cs.log(f"TMA variant: nvcc exit {tma.returncode}; ptxas "
               f"{json.dumps(_build.ptxas_usage(tma_log))}")
        if tma.returncode:
            print(tma_log, file=sys.stderr)
            return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    failed = []
    with torch.inference_mode():
        if new:
            failed = check_forms(pool_norm, dev)
            cs.log(f"every form against the plain version: {failed or 'all agree'}")
        g = torch.Generator().manual_seed(30)
        for h in (384, 768):
            for b, s in MAIN_SHAPES:
                y, m = random_input(b, s, h, g, dev)
                row = cs.pool_reading(y, m)
                cs.log(f"K2 at B={b} S={s} H={h}: {json.dumps(row)}")
                if not cs.pool_ok(row):
                    failed.append(f"reading at {(b, s, h)}")
        if args.sweep and new:
            table = sweep(pool_norm, dev)
            cs.log(f"sweep table {json.dumps(table)}")
            picks = np.array([r["pick_ms"] / r["best_ms"] for r in table])
            cs.log(f"pool_plan's pick against the fastest plan: median {np.median(picks):.3f}x, "
                   f"worst {picks.max():.3f}x")
        if tma is not None:
            lib = ctypes.CDLL(str(OUT / "libpool_tma.so"))
            lib.pool_tma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            lib.pool_tma.restype = ctypes.c_int
            rows = tma_variant(pool_norm, dev, lib)
            failed += [f"TMA variant {r}" for r in rows if max(r["max_abs_err"].values()) > cs.K2_TOL]
    print(smi())
    if failed:
        cs.log(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
