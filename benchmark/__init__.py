"""The port's benchmark: one cell of ``BENCHMARK.json`` run once by ``run.py``.

Everything that decides a number lives here, where a change to the program
cannot reach it: the traffic generator (``workgen.py``), the kinds of
traffic that drive the program (``drivers/``), the operation and byte
counts and the card's peaks (``counts.py``), the trace reduction
(``trace.py``), the per-layer metric readers (``metrics/``), the plain
reference (``reference/``) and the comparison that decides ``correct``
(``judge.py``). It imports the port, and never JAX or the JAX package.
"""
