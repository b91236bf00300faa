"""``torch.profiler`` sessions: the CLI's ``--profile-dir``, the server's
``--xprof-dir`` and the roofline tool's ``--profile-dir``, the port of the
JAX package's ``jax.profiler`` traces.

A session records CPU activity (every thread's operators) always and, on
a CUDA device, CUDA activity too, and writes one Chrome trace (JSON, readable by Perfetto or
``chrome://tracing``) when it stops. On the card it never falls back to a
CPU-only trace: a profiler that cannot record CUDA activity raises at
start, and a trace with no kernel in it raises at stop.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch


def activities(device) -> list:
    """The profiler activities of a run on ``device`` (None: the CUDA
    default of the engines)."""
    from torch.profiler import ProfilerActivity, supported_activities

    acts = [ProfilerActivity.CPU]
    if device is None or torch.device(device).type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity in this "
                               "installation; a CPU-only trace would hide the device")
        acts.append(ProfilerActivity.CUDA)
    return acts


def kernel_names(path) -> set:
    """Names of the device kernels in a Chrome trace file."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return {e.get("name", "") for e in events if str(e.get("cat", "")).lower() == "kernel"}


class ProfileSession:
    """One profiler session that writes its Chrome trace to ``path`` when
    it stops (the directory is made as needed)."""

    def __init__(self, path, device):
        from torch.profiler import _ExperimentalConfig

        self.path = str(path)
        self._cuda = device is None or torch.device(device).type == "cuda"
        # Every thread's operators: the serve tier dispatches and extracts
        # on worker threads, which the profiler otherwise leaves out.
        self._prof = torch.profiler.profile(
            activities=activities(device),
            experimental_config=_ExperimentalConfig(profile_all_threads=True))

    def start(self) -> None:
        self._prof.start()

    def stop(self, *, check: bool = True) -> str:
        """Stop, write the trace and return its path. With ``check`` on a
        CUDA device, raise when the trace holds no kernel."""
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        if check and self._cuda and not kernel_names(self.path):
            raise RuntimeError(f"torch.profiler recorded no CUDA kernel in {self.path}")
        return self.path


@contextlib.contextmanager
def profiled(path, device):
    """A :class:`ProfileSession` around the ``with`` body. The kernel check
    runs only when the body succeeded, so it never masks the body's error."""
    session = ProfileSession(path, device)
    session.start()
    ok = False
    try:
        yield session
        ok = True
    finally:
        session.stop(check=ok)
