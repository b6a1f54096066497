"""Device profiling on demand: the coordinator's profiler hook, on
``torch.profiler``.

Port of ``CoordinatorServer.start_profile`` / ``stop_profile`` /
``list_profiles`` (``kuberay_tpu/runtime/coordinator_server.py``), whose
``jax.profiler`` trace becomes a ``torch.profiler`` capture of CPU and
CUDA activity: one capture at a time, each in ``<profile_dir>/trace-<unix
seconds>/`` holding a Chrome trace (``trace.json``), the same
``{"trace_dir": ...}`` and ``{"error": ...}`` answers, a
``threading.Timer`` for ``duration_s`` that stops only its own capture
(a stale timer finds a newer capture and answers the generation
mismatch), and ``list_profiles`` sorted.

``torch.profiler`` must stop on the thread that started it, and the
timer stops from its own thread, so every start and stop runs on one
thread the hook owns.  CUDA activity (kernels, copies, the runtime's
launch calls) is traced from every thread of the process; the CPU
operator events are that thread's only, so a capture shows the device's
work and its idle gaps, not the host's Python.

The JAX hook lives in the control plane's coordinator, which the port
does not run; nothing in the port's servers serves it over HTTP.
``chip_smoke.py`` calls it around decode steps on the card.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"


class ProfileHook:
    """``start_profile`` / ``stop_profile`` / ``list_profiles`` over
    ``profile_dir``."""

    def __init__(self, profile_dir: str):
        self.profile_dir = profile_dir
        self._lock = threading.Lock()
        self._profiling: Optional[str] = None
        self._prof: Optional[profile] = None
        self._thread = ThreadPoolExecutor(1, thread_name_prefix="profiler")

    def start_profile(self, duration_s: float = 0.0) -> Dict[str, Any]:
        """Start a capture; it stops after ``duration_s`` if given.
        Returns {"trace_dir": ...} or {"error": ...}."""
        with self._lock:
            if self._profiling:
                return {"error": "profile already running",
                        "trace_dir": self._profiling}
            trace_dir = os.path.join(self.profile_dir,
                                     f"trace-{int(time.time())}")
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            try:
                os.makedirs(trace_dir, exist_ok=True)
                prof = profile(activities=activities)
                self._thread.submit(prof.start).result()
            except Exception as e:          # as the JAX hook answers
                return {"error": f"profiler start failed: {e}"}
            self._profiling, self._prof = trace_dir, prof
        if duration_s > 0:
            # The timer only stops ITS OWN capture: a stale timer from an
            # earlier capture must not truncate a later one.
            t = threading.Timer(duration_s, self.stop_profile,
                                kwargs={"expected": trace_dir})
            t.daemon = True
            t.start()
        return {"trace_dir": trace_dir}

    def stop_profile(self, expected: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            if not self._profiling:
                return {"error": "no profile running"}
            if expected is not None and self._profiling != expected:
                return {"error": "profile generation mismatch (stale timer)"}
            trace_dir, self._profiling = self._profiling, None
            prof, self._prof = self._prof, None
        try:
            self._thread.submit(prof.stop).result()
            prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
        except Exception as e:              # as the JAX hook answers
            return {"error": f"profiler stop failed: {e}",
                    "trace_dir": trace_dir}
        return {"trace_dir": trace_dir}

    def list_profiles(self) -> list:
        try:
            return sorted(d for d in os.listdir(self.profile_dir)
                          if d.startswith("trace-"))
        except OSError:
            return []
