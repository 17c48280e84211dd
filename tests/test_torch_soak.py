"""Scaled-down run of the port's HTTP tail-latency soak
(``scripts/torch_bench_soak.py``) on the CPU, with the assertions of
``tests/test_soak.py``: bursts coalesce (no permanent batch-1), lone traffic
after bursts stops paying windows (no permanent window), and the bounded
server survives a connection flood."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_soak_no_latch(tmp_path):
    proc = subprocess.run(
        [
            sys.executable,
            str(REPO / "scripts" / "torch_bench_soak.py"),
            "--workdir", str(tmp_path / "ws"),
            "--products", "300",
            "--phase-seconds", "2.5",
            "--burst-threads", "8",
            "--port", "0",
            "--device", "cpu",
            # Scaled-down flood: 24 idle connections against 12 worker slots
            # with a 1 s socket timeout. The cap must exceed the burst
            # phase's 8 keep-alive connections (each holds a worker slot for
            # its lifetime).
            "--flood-connections", "24",
            "--max-concurrency", "12",
            "--socket-timeout", "1.0",
        ],
        # Two intra-op threads: the server's batches share the host's cores
        # with the test run's other workers.
        env=dict(os.environ, OMP_NUM_THREADS="2"),
        capture_output=True,
        text=True,
        timeout=600,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["metric"] == "serve_soak"

    phases = summary["phases"]
    for name in ("lone", "burst", "mixed", "lone_after_burst"):
        assert phases[name]["n"] > 0, f"phase {name} served nothing"
        assert phases[name]["p99_ms"] > 0

    # Bursts must coalesce: at least one multi-request drain during burst.
    assert summary["no_batch1_latch"], f"burst never coalesced: {phases['burst']}"
    # Lone traffic after bursts must disengage the window.
    assert summary.get("no_window_latch", True), (
        f"window latched on after bursts: {phases['lone_after_burst']}"
    )
    # Connection flood: the server sheds load (bounded pool) and recovers
    # after the socket timeout reclaims the flooded slots.
    flood = phases["flood"]
    assert summary["flood_survived"], f"server did not survive the flood: {flood}"
    assert flood["n_ok"] > 0 and flood["recovered_p50_ms"] is not None
