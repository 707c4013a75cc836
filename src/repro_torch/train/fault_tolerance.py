"""Fault tolerance: heartbeats, straggler mitigation, checkpoint/restart.

Three layers (all exercised by tests/test_torch_checkpoint.py):

  * ``HeartbeatMonitor`` — workers stamp a shared table; the monitor flags
    silent workers after ``timeout`` (node-death detection at pipeline level;
    core/pipeline.py re-issues their work items to a spare sampler).
  * ``StragglerMitigator`` — tracks per-task latency; tasks exceeding
    k × running-median are speculatively duplicated, first finisher wins
    (classic backup-requests; applied to host-side sampling/batch-gen).
  * ``TrainSupervisor`` — wraps the device train loop: periodic checkpoints
    (train/checkpoint.py), on failure restores the latest committed step and
    resumes (each restored leaf lands on its template's device).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager


class HeartbeatMonitor:
    def __init__(self, n_workers: int, timeout: float = 5.0):
        self.table = {w: time.time() for w in range(n_workers)}
        self.timeout = timeout
        self._lock = threading.Lock()

    def beat(self, worker: int):
        with self._lock:
            self.table[worker] = time.time()

    def mark_dead(self, worker: int):
        with self._lock:
            self.table[worker] = -1.0

    def dead_workers(self) -> List[int]:
        now = time.time()
        with self._lock:
            return [w for w, t in self.table.items()
                    if t < 0 or now - t > self.timeout]

    def alive(self) -> List[int]:
        dead = set(self.dead_workers())
        return [w for w in self.table if w not in dead]


class StragglerMitigator:
    """Backup-request policy: duplicate tasks slower than k× median."""

    def __init__(self, factor: float = 3.0, min_history: int = 5):
        self.factor = factor
        self.min_history = min_history
        self.durations: List[float] = []
        self._lock = threading.Lock()

    def record(self, duration: float):
        with self._lock:
            self.durations.append(duration)

    def median(self) -> float:
        with self._lock:
            if not self.durations:
                return float("inf")
            return float(np.median(self.durations))

    def is_straggling(self, elapsed: float) -> bool:
        if len(self.durations) < self.min_history:
            return False
        return elapsed > self.factor * self.median()

    def run_speculative(self, fn: Callable[[], Any],
                        elapsed_provider: Optional[Callable[[], float]] = None):
        """Run fn; if it exceeds the straggler bound, race a duplicate.
        (Thread-based — fn must be re-executable / idempotent.)"""
        result: Dict[str, Any] = {}
        done = threading.Event()

        def runner(tag):
            t0 = time.perf_counter()
            try:
                r = fn()
            except Exception as e:  # noqa: BLE001
                r = e
            if not done.is_set():
                result.setdefault("value", r)
                result.setdefault("winner", tag)
                done.set()
            self.record(time.perf_counter() - t0)

        t1 = threading.Thread(target=runner, args=("primary",), daemon=True)
        t1.start()
        bound = self.factor * self.median() if len(self.durations) >= self.min_history else None
        if bound is not None and bound != float("inf"):
            if not done.wait(timeout=bound):
                t2 = threading.Thread(target=runner, args=("backup",), daemon=True)
                t2.start()
        done.wait()
        v = result["value"]
        if isinstance(v, Exception):
            raise v
        return v, result["winner"]


@dataclass
class SupervisorReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    checkpoints: int = 0
    final_step: int = 0


class TrainSupervisor:
    """Checkpoint/restart loop around an arbitrary step function.

    ``step_fn(state, step) -> state`` may raise (simulated node failure /
    real OOM); the supervisor restores the latest committed checkpoint and
    resumes.  ``max_restarts`` bounds the retry loop.
    """

    def __init__(self, ckpt: CheckpointManager, ckpt_every: int = 10,
                 max_restarts: int = 3,
                 extra_fn: Optional[Callable[[], Dict]] = None):
        self.ckpt = ckpt
        self.every = ckpt_every
        self.max_restarts = max_restarts
        # attached to every checkpoint manifest (e.g. the multi-partition
        # trainer records its partition topology + cache hit accounting)
        self.extra_fn = extra_fn

    def run(self, state: Dict[str, Any], step_fn: Callable[[Dict, int], Dict],
            n_steps: int, start_step: int = 0
            ) -> tuple[Dict, SupervisorReport]:
        rep = SupervisorReport()
        step = start_step
        restarts = 0
        while step < n_steps:
            try:
                state = step_fn(state, step)
                rep.steps_run += 1
                step += 1
                if step % self.every == 0 or step == n_steps:
                    self.ckpt.save(step, state,
                                   extra=(self.extra_fn()
                                          if self.extra_fn else None))
                    rep.checkpoints += 1
            except Exception:  # noqa: BLE001 — node failure path
                rep.failures += 1
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step     # nothing committed yet: restart cold
                    continue
                state, step = self.ckpt.restore(state, latest)
                rep.restores += 1
        self.ckpt.wait()
        rep.final_step = step
        return state, rep
