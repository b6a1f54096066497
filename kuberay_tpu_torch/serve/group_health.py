"""Serve-group failure detection: heartbeats + step watchdog.

A copy of ``kuberay_tpu/serve/group_health.py`` for the port (which
imports nothing of the JAX package); the heartbeat's wire format is the
same, so a port follower beats a JAX monitor and a JAX follower a port
monitor.  In the port the followers are ``serve/multihost.py``'s.

A multi-host serve slice runs in lockstep (serve/multihost.py); a dead
follower leaves host 0 blocked inside a collective with **no in-process
way to unblock** — the recovery unit is the whole slice, exactly the
invariant the cluster controller already enforces for unhealthy slices
(reference: unhealthy multi-host groups deleted whole,
raycluster_controller.go:1269-1289).  What the serve layer must supply
is *detection + drain + surfacing*:

- every follower runs a :func:`heartbeat_loop` daemon thread beating a
  tiny TCP listener on host 0 (address from the same
  ``TPU_WORKER_HOSTNAMES`` env contract the engines already use);
- host 0's :class:`GroupMonitor` declares the group **degraded** when a
  follower misses beats (process death) or a device step exceeds the
  watchdog budget (hang inside a collective — the failure mode a dead
  peer actually produces);
- on degradation the serve frontend fails pending waiters immediately
  (no hanging clients), flips ``/healthz`` to 503, and reports the app
  ``DEGRADED`` to the coordinator so the TpuService controller sets the
  ``ServeGroupDegraded`` condition and prepares a replacement cluster —
  whole-slice replacement, never partial repair.

Single-host groups never degrade through this module (no peers, and a
stuck step without peers is a model bug, not a group failure).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from kuberay_tpu_torch.utils.quantiles import quantile as _quantile

HEARTBEAT_INTERVAL = 1.0


class GroupMonitor:
    """Host-0 side: follower liveness + step watchdog.

    ``expected``: follower worker ids (1..n-1).  ``miss_timeout``: beats
    older than this mark the follower lost.  ``step_timeout``: a single
    device call running longer than this marks the group stuck (dead
    peer mid-collective).  Degradation is one-way; recovery is slice
    replacement, not rejoin.
    """

    # Adaptive-budget shape: once MIN_SAMPLES completed steps have been
    # observed, the budget becomes multiplier x the rolling p99 (floored
    # at miss_timeout) instead of the static cold-start default — a
    # model with legitimately long steps (big chunked-prefill batches)
    # raises its own budget, and a fast model gets far quicker hang
    # detection than any one-size constant.
    #
    # The feedback loop is bounded three ways (a slow-but-alive step
    # would otherwise enter the window, inflate p99, and ratchet the
    # budget upward without limit — each near-budget step buying the
    # next one a bigger allowance):
    # - samples are clamped to the budget that was in force when the
    #   step ran (a step can't teach the window more than it was given);
    # - the small-window p99 is interpolated, not a truncating index
    #   that collapses to the max sample;
    # - the adaptive budget is hard-capped at BUDGET_CAP_MULTIPLIER x
    #   step_timeout (the operator-set order of magnitude stays law).
    WINDOW = 256
    MIN_SAMPLES = 20
    BUDGET_CAP_MULTIPLIER = 2.0

    def __init__(self, expected: List[int], miss_timeout: float = 10.0,
                 step_timeout: float = 60.0,
                 on_degraded: Optional[Callable[[str], None]] = None,
                 grace: float = 30.0, compile_timeout: float = 900.0,
                 budget_multiplier: float = 20.0, clock=None):
        # Injectable monotonic clock (object with .now()) for the
        # timeout arithmetic — tests drive staleness/watchdog math with
        # a fake clock instead of real sleeps (the wire loops below stay
        # on real time regardless; they pace I/O, not verdicts).
        self._now = clock.now if clock is not None else time.monotonic
        self.expected = list(expected)
        self.miss_timeout = miss_timeout
        # Cold-start default only: used until the rolling window has
        # MIN_SAMPLES observations, then the adaptive budget takes over.
        self.step_timeout = step_timeout
        # Budget for steps flagged as compiling (first occurrence of a
        # program shape): XLA compilation of a large model can dwarf
        # step_timeout, and a false DEGRADED here would put the slice in
        # an infinite replace-recompile-replace loop.
        self.compile_timeout = compile_timeout
        self.budget_multiplier = budget_multiplier
        self.on_degraded = on_degraded
        self._lock = threading.Lock()
        now = self._now()
        # Followers get a startup grace: they begin beating only once
        # their engine is constructed (compile time included).
        self._last_beat: Dict[int, float] = {
            w: now + grace for w in self.expected}
        self._step_started: Optional[float] = None
        self._step_budget: float = step_timeout
        self._step_compiling: bool = False
        self._durations: List[float] = []     # rolling window (WINDOW)
        self._degraded: Optional[str] = None
        self._server: Optional[socket.socket] = None
        self._stop = threading.Event()

    # -- state ----------------------------------------------------------

    @property
    def degraded(self) -> Optional[str]:
        with self._lock:
            return self._degraded

    def _mark(self, reason: str) -> None:
        fire = False
        with self._lock:
            if self._degraded is None:
                self._degraded = reason
                fire = True
        if fire and self.on_degraded is not None:
            try:
                self.on_degraded(reason)
            except Exception:
                pass

    def mark_degraded(self, reason: str) -> None:
        """External degradation signal (e.g. a collective raised on the
        scheduling thread before any heartbeat missed)."""
        self._mark(reason)

    def beat(self, worker_id: int) -> None:
        with self._lock:
            # Only EXPECTED ids: a stray beat (misconfigured worker id,
            # stale process from a prior incarnation, any writer on the
            # unauthenticated port) must not create an entry that goes
            # stale and trips a bogus degradation.
            if worker_id in self._last_beat:
                self._last_beat[worker_id] = self._now()

    def current_step_budget(self) -> float:
        """The live (non-compile) step budget: adaptive once enough
        steps have been observed, the static cold-start default before
        that.  Never below miss_timeout — follower death is the
        heartbeat's job; the step watchdog exists for wedged-but-
        connected peers, where a few extra seconds is the right price
        for never degrading a slow-but-alive group.  Never above
        BUDGET_CAP_MULTIPLIER x step_timeout — the adaptive loop must
        not be able to ratchet itself arbitrarily high (see the class
        comment)."""
        with self._lock:
            samples = list(self._durations)
        if len(samples) < self.MIN_SAMPLES:
            return self.step_timeout
        p99 = _quantile(samples, 0.99)
        budget = min(self.budget_multiplier * p99,
                     self.BUDGET_CAP_MULTIPLIER * self.step_timeout)
        return max(self.miss_timeout, budget)

    def step_begin(self, compiling: bool = False) -> None:
        # Budget computed before taking the lock (current_step_budget
        # locks internally; threading.Lock is not reentrant).
        budget = (self.compile_timeout if compiling
                  else self.current_step_budget())
        with self._lock:
            self._step_budget = budget
            self._step_compiling = compiling
            self._step_started = self._now()

    def step_end(self) -> None:
        with self._lock:
            started = self._step_started
            budget = self._step_budget
            compiling = self._step_compiling
            self._step_started = None
            # Compile steps stay out of the distribution: one 10-minute
            # XLA compile would inflate p99 (and thus the budget) for
            # the next WINDOW steps.
            if started is None or compiling:
                return
            # Clamp at the budget that was in force while the step ran:
            # a long-but-allowed step must not teach the window a larger
            # tail than the watchdog had actually granted (the unbounded
            # feedback loop this clamp + the hard cap exist to prevent).
            dur = min(self._now() - started, budget)
            self._durations.append(dur)
            if len(self._durations) > self.WINDOW:
                del self._durations[:len(self._durations) - self.WINDOW]

    def check(self) -> Optional[str]:
        """One watchdog pass; returns the degradation reason (sticky)."""
        now = self._now()
        with self._lock:
            if self._degraded:
                return self._degraded
            stale = [w for w, t in self._last_beat.items()
                     if now - t > self.miss_timeout]
            started, budget = self._step_started, self._step_budget
        if stale:
            self._mark(f"follower(s) {sorted(stale)} missed heartbeats "
                       f"for >{self.miss_timeout:.0f}s")
        elif started is not None and now - started > budget:
            self._mark(f"device step stuck for >{budget:.0f}s "
                       "(peer dead mid-collective?)")
        return self.degraded

    def status(self) -> Dict[str, object]:
        now = self._now()
        with self._lock:
            ages = {str(w): round(max(0.0, now - t), 1)
                    for w, t in self._last_beat.items()}
            degraded = self._degraded
        return {"degraded": degraded, "beat_age_seconds": ages,
                "followers": self.expected,
                "step_budget_seconds": round(self.current_step_budget(),
                                             3)}

    # -- wire -----------------------------------------------------------

    def listen(self, host: str = "0.0.0.0", port: int = 0) -> int:
        """Start the heartbeat listener + watchdog thread; returns the
        bound port.  Protocol: followers hold one persistent connection
        and write a ``beat <worker_id>\\n`` line per interval."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(8)
        srv.settimeout(0.5)
        self._server = srv

        def accept_loop():
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                threading.Thread(target=self._conn_loop, args=(conn,),
                                 daemon=True,
                                 name="group-health-conn").start()

        def watchdog_loop():
            while not self._stop.is_set():
                self.check()
                self._stop.wait(min(1.0, self.miss_timeout / 3))

        threading.Thread(target=accept_loop, daemon=True,
                         name="group-health-accept").start()
        threading.Thread(target=watchdog_loop, daemon=True,
                         name="group-health-watchdog").start()
        return srv.getsockname()[1]

    def _conn_loop(self, conn: socket.socket) -> None:
        conn.settimeout(self.miss_timeout)
        buf = b""
        try:
            while not self._stop.is_set():
                chunk = conn.recv(256)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    parts = line.decode(errors="replace").split()
                    if len(parts) == 2 and parts[0] == "beat":
                        try:
                            self.beat(int(parts[1]))
                        except ValueError:
                            pass
        except OSError:
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass


def heartbeat_loop(host: str, port: int, worker_id: int,
                   interval: float = HEARTBEAT_INTERVAL,
                   stop: Optional[threading.Event] = None) -> None:
    """Follower side: beat host 0 forever (daemon thread).  Connection
    failures retry — host 0 may restart its listener; a follower must
    not die because the monitor blinked (the monitor's job is to notice
    *us* dying, not vice versa)."""
    stop = stop or threading.Event()
    while not stop.is_set():
        try:
            with socket.create_connection((host, port), timeout=5) as s:
                while not stop.is_set():
                    s.sendall(f"beat {worker_id}\n".encode())
                    if stop.wait(interval):
                        return
        except OSError:
            if stop.wait(interval):
                return


def start_heartbeat(host: str, port: int, worker_id: int,
                    interval: float = HEARTBEAT_INTERVAL
                    ) -> threading.Event:
    """Spawn the follower heartbeat daemon; returns its stop event."""
    stop = threading.Event()
    threading.Thread(target=heartbeat_loop,
                     args=(host, port, worker_id, interval, stop),
                     daemon=True, name="group-health-beat").start()
    return stop
