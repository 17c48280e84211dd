"""Profiling hooks: ``torch.profiler`` traces gated by an env var.

The port's counterpart of the JAX package's ``utils/profiling.py`` (which
wraps ``jax.profiler``). Set ``ITOR_PROFILE_DIR`` and wrap a section with
:func:`maybe_trace`: a Chrome trace of its CPU and, on a CUDA device, its
kernel activity lands under ``<dir>/<name>``. Without the env var the
context manager does nothing. The trainer traces its first steps through
:func:`device_profiler`.
"""

from __future__ import annotations

import contextlib
import os

import torch

ENV_PROFILE_DIR = "ITOR_PROFILE_DIR"


def device_profiler(trace_dir: str | os.PathLike, cuda: bool) -> torch.profiler.profile:
    """A profiler (not yet started) that records CPU activity, and CUDA
    activity with ``cuda``, and writes a Chrome trace (``*.pt.trace.json``)
    into ``trace_dir`` when it stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(trace_dir)),
    )


@contextlib.contextmanager
def maybe_trace(name: str):
    """Trace the enclosed block when ``ITOR_PROFILE_DIR`` is set."""
    profile_dir = os.getenv(ENV_PROFILE_DIR)
    if not profile_dir:
        yield
        return
    with device_profiler(os.path.join(profile_dir, name), torch.cuda.is_available()):
        yield


def annotate(name: str):
    """A named span inside an active trace."""
    return torch.profiler.record_function(name)
