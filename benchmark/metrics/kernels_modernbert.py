"""The kernels of the ModernBERT layer (``ops/csrc/modernbert.cu``), by
demangled name, and the per-batch records its roofline readers take."""

from __future__ import annotations

import re

ATTN_GLOBAL = re.compile(r"(^|::)mb_attn_global_kernel\b")
ATTN_BAND = re.compile(r"(^|::)mb_attn_band_kernel\b")
# The layer's four products run on K1's GEMM core; in a ModernBERT cell no
# other launch of it runs.
GEMM = re.compile(r"(^|::)gemm_wgmma_kernel\b")
ROPE = re.compile(r"(^|::)mb_rope_kernel\b")
GEGLU = re.compile(r"(^|::)mb_geglu_kernel\b")
ROWNORM = re.compile(r"(^|::)mb_rownorm_kernel\b")


def calls(reading) -> list[tuple[int, int]]:
    """(rows, longest real row rounded up to 16) of every batch the window
    answered; empty where the run is not a ModernBERT serve run."""
    rec = reading.window.records
    if "all_batches" not in rec or "global_attn_every_n_layers" not in reading.ctx.config:
        return []
    return [(b["rows"], b["seq"]) for b in rec["all_batches"]]
