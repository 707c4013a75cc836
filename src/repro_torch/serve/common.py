"""Shared serving machinery — the seam between engines and the fabric.

``serve/engine.py`` (token decode), ``serve/gnn_engine.py`` (online GNN
node inference) and ``serve/fabric.py`` (the partition-routed fleet) all
face callers through ONE contract, the ``ServingEngine`` protocol:
``submit / step / pending / running / free_slots / utilization / stats``.
The concrete machinery behind it lives HERE so implementations cannot
drift apart:

  * ``EngineBase`` — slot accounting (``free_slots`` / ``utilization``),
    submit timestamping, retirement bookkeeping (bounded history + the
    rolling ``LatencyWindow`` + the ``retire_hook`` the fabric uses to
    observe its replicas), and the ``run_to_completion`` drive loop over
    the shared ``drain``;
  * ``admit_pending`` — FIFO slot admission;
  * ``LatencyStats`` / ``latency_stats`` / ``LatencyWindow`` — typed
    latency accounting, both whole-window and rolling;
  * ``SLOAdmission`` — the windowed shed-or-defer scheduler the fabric
    runs admission through.

An admission-policy change (priorities, backpressure, fairness, SLO
targets) lands in one place and every engine inherits it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Deque, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np


# ---------------------------------------------------------------------------
# latency accounting
# ---------------------------------------------------------------------------

@dataclass
class LatencyStats:
    """Typed latency summary (milliseconds) over a set of retired requests.

    ``p50_ms``/``p99_ms`` cover submit → done (queue wait included — the
    number a caller of the serving endpoint experiences); ``ttft_*``
    cover submit → first progress (first emitted token for the decode
    engine, slot admission for the single-shot GNN engine — i.e. queue
    wait).  ``qps`` is retirements over the window's wall-clock span and
    ``window`` is the sample count.  ``asdict()`` flattens into the
    benchmark-JSON dict shape the pre-typed ``latency_stats`` returned.
    """
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    ttft_p50_ms: float = 0.0
    ttft_p99_ms: float = 0.0
    # first-progress → done: time IN a slot, queue wait excluded — the
    # congestion-free estimate SLO admission projects from (an end-to-end
    # estimate would feed queue wait back into itself: one backlog episode
    # would poison admission long after the queue drained)
    service_p50_ms: float = 0.0
    qps: float = 0.0
    window: int = 0

    def asdict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _percentile_stats(total_s: np.ndarray, ttft_s: np.ndarray,
                      span_s: float) -> LatencyStats:
    n = len(total_s)
    return LatencyStats(
        p50_ms=float(np.percentile(total_s, 50) * 1e3),
        p99_ms=float(np.percentile(total_s, 99) * 1e3),
        ttft_p50_ms=float(np.percentile(ttft_s, 50) * 1e3),
        ttft_p99_ms=float(np.percentile(ttft_s, 99) * 1e3),
        service_p50_ms=float(np.percentile(total_s - ttft_s, 50) * 1e3),
        qps=(n / span_s if span_s > 0 else 0.0),
        window=n)


def latency_stats(completed: List) -> LatencyStats:
    """Latency percentiles over retired requests.

    Requests carry ``t_submit`` / ``t_first`` / ``t_done`` perf-counter
    stamps (every engine's request dataclass).  Returns a zeroed
    ``LatencyStats`` on an empty window.
    """
    if not completed:
        return LatencyStats()
    total = np.array([r.t_done - r.t_submit for r in completed])
    ttft = np.array([r.t_first - r.t_submit for r in completed])
    span = (max(r.t_done for r in completed)
            - min(r.t_submit for r in completed))
    return _percentile_stats(total, ttft, span)


class LatencyWindow:
    """Rolling window over the most recent retirements — the variant the
    SLO scheduler needs: admission decisions must track the CURRENT
    latency regime, not the lifetime average (a warm engine's history
    would mask a saturation onset forever)."""

    def __init__(self, maxlen: int = 256):
        self._samples: Deque[Tuple[float, float, float]] = deque(maxlen=maxlen)
        self._cache: Optional[LatencyStats] = None

    def __len__(self) -> int:
        return len(self._samples)

    def record(self, req):
        """Fold one retired request (its perf-counter stamps) in."""
        self._samples.append((req.t_done, req.t_done - req.t_submit,
                              req.t_first - req.t_submit))
        self._cache = None

    def reset(self):
        self._samples.clear()
        self._cache = None

    def stats(self) -> LatencyStats:
        # memoized until the next record(): SLO admission consults this
        # per offered request, and a percentile recompute per arrival
        # turns the scheduler itself into the bottleneck under load (the
        # stall then ages out the queue — a self-inflicted shed storm)
        if self._cache is None:
            if not self._samples:
                return LatencyStats()
            done = np.array([s[0] for s in self._samples])
            total = np.array([s[1] for s in self._samples])
            ttft = np.array([s[2] for s in self._samples])
            self._cache = _percentile_stats(total, ttft,
                                            float(done.max() - done.min()))
        return self._cache


# ---------------------------------------------------------------------------
# the unified engine contract
# ---------------------------------------------------------------------------

@runtime_checkable
class ServingEngine(Protocol):
    """What every serving surface looks like from the outside — a single
    engine, a replica, or the whole partition-routed fabric.  Callers
    (drive loops, benchmarks, launchers) program against THIS, so a
    fleet is a drop-in replacement for one engine."""
    batch: int
    pending: Deque
    running: Dict
    completed: List

    def submit(self, req) -> None: ...
    def step(self) -> int: ...
    def free_slots(self) -> List[int]: ...
    def utilization(self) -> float: ...
    def stats(self) -> LatencyStats: ...
    def run_to_completion(self, max_iters: int = 10_000) -> Dict[str, float]: ...


class EngineBase:
    """Concrete half of the ``ServingEngine`` contract.

    Engines call ``_init_serving`` and own exactly three things: their
    ``running`` store, a ``step`` body, and retirement timestamps.  Slot
    arithmetic, the bounded history, the rolling latency window, and the
    drive loop live here ONCE — the pre-seam engines each carried their
    own ``free_slots``/``utilization``/``run_to_completion`` copies,
    which is precisely how drive loops drift apart."""

    def _init_serving(self, batch: int, keep_completed: int = 4096,
                      retire_hook: Optional[Callable] = None,
                      window: int = 256):
        self.batch = batch
        self.pending: Deque = deque()
        self.completed: List = []
        self.total_completed = 0
        # retained result history is BOUNDED (an online engine must not
        # grow per-request state forever); oldest entries are dropped
        self.keep_completed = max(int(keep_completed), 1)
        self.window = LatencyWindow(window)
        self.retire_hook = retire_hook

    # -- slot accounting ------------------------------------------------
    def has_work(self) -> bool:
        """Anything queued or in flight?  The shared ``drain`` loop's
        termination test — the fabric overrides it to cover its replicas'
        queues too."""
        return bool(self.pending or self.running)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.batch) if s not in self.running]

    def utilization(self) -> float:
        return len(self.running) / max(self.batch, 1)

    # -- submission -----------------------------------------------------
    def _validate(self, req):
        """Engine-specific submit check (raise to reject)."""

    def submit(self, req):
        self._validate(req)
        req.t_submit = time.perf_counter()
        self.pending.append(req)

    # -- retirement -----------------------------------------------------
    def _retire(self, req, status: str = "done"):
        """One retirement: status, bounded history, rolling window, and
        the observer hook (the fabric's view into its replicas)."""
        req.status = status
        self.completed.append(req)
        self.total_completed += 1
        self.window.record(req)
        trim_completed(self.completed, self.keep_completed)
        if self.retire_hook is not None:
            self.retire_hook(req)

    # -- stats + drive loop ---------------------------------------------
    def stats(self) -> LatencyStats:
        """Rolling-window latency view (the SLO scheduler's input)."""
        return self.window.stats()

    def _begin_window(self) -> Dict:
        """Marks captured before a drain, for ``_window_metrics``."""
        return {}

    def _window_metrics(self, mark: Dict, emitted: int, done: int,
                        dt: float) -> Dict[str, float]:
        """Engine-specific additions to the drain summary."""
        return {}

    def run_to_completion(self, max_iters: int = 10_000) -> Dict[str, float]:
        """Drain the queues; every metric covers THIS call's window (the
        requests completed here), so repeated calls — warmup, then a
        measured wave, then a streamed re-query — each get
        self-consistent numbers.  Latency percentiles cover the window's
        tail still inside the bounded ``keep_completed`` history."""
        mark = self._begin_window()
        done0 = self.total_completed
        emitted, dt = drain(self, max_iters)
        done = self.total_completed - done0
        win = self.completed[-done:] if done else []
        out = {"completed": done, "seconds": dt}
        out.update(latency_stats(win).asdict())
        out.update(self._window_metrics(mark, emitted, done, dt))
        return out


# ---------------------------------------------------------------------------
# admission + drive-loop helpers
# ---------------------------------------------------------------------------

def admit_pending(pending: Deque, running: Dict,
                  try_allocate: Callable[[object], Optional[int]],
                  on_admit: Optional[Callable[[object, int], None]] = None
                  ) -> int:
    """Admit queued requests into free slots, in FIFO order.

    ``pending`` is a ``collections.deque`` (every engine's), so the
    head-pop per admission is O(1) instead of the O(n) list shuffle.
    ``try_allocate(req)`` returns a slot index or ``None`` (no capacity —
    or a request the pool cannot ever hold, which then blocks the head of
    the line exactly like the pre-seam engines did).  ``on_admit(req,
    slot)`` runs per admission (the LM engine prefills the KV slot there);
    afterwards ``running[slot] = req``.  Returns the number admitted.
    """
    admitted = 0
    while pending:
        req = pending[0]
        slot = try_allocate(req)
        if slot is None:
            break
        pending.popleft()
        if on_admit is not None:
            on_admit(req, slot)
        running[slot] = req
        admitted += 1
    return admitted


def trim_completed(completed: List, keep: int):
    """Bound the retained result history in place (oldest dropped) —
    an online engine must not grow per-request state forever."""
    if len(completed) > keep:
        del completed[:len(completed) - keep]


def drain(engine, max_iters: int) -> Tuple[int, float]:
    """Step ``engine`` until its queues are empty (or ``max_iters``);
    returns ``(emitted, seconds)``.  The one drive loop every
    ``ServingEngine`` shares — it lives once so the drain policy cannot
    drift between implementations."""
    t0 = time.perf_counter()
    emitted = 0
    iters = 0
    has_work = getattr(engine, "has_work",
                       lambda: bool(engine.pending or engine.running))
    while has_work() and iters < max_iters:
        emitted += engine.step()
        iters += 1
    return emitted, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# SLO-aware admission
# ---------------------------------------------------------------------------

class SLOAdmission:
    """Windowed shed-or-defer admission against a target p99 (ms).

    Two decision points, both computed from the rolling ``LatencyWindow``
    (never from lifetime averages — saturation must show up immediately):

      * ``on_offer`` at the door: with the backlog's estimated drain time
        (backlog / windowed qps) plus one windowed p50 service already
        past the target, admitting is a promise the fabric cannot keep —
        shed NOW, cheaply, instead of queueing a request that will time
        out after consuming queue space.
      * ``on_dispatch`` per queued request each scheduling tick: a
        request whose queue age plus estimated service has crossed the
        target is shed (completing it late would blow the p99 the SLO
        protects); one whose target is still reachable but whose owner
        replica has no capacity is DEFERRED — it stays queued, which is
        the graceful half of degradation.

    Both estimates are STRUCTURAL, never congestion-fed: the service
    estimate is the windowed p50 of time-IN-slot (``t_done − t_first``,
    queue wait excluded) and the drain rate is slots / service — using
    end-to-end latency or observed qps instead feeds the backlog back
    into its own admission decision, and one saturation episode poisons
    the window into shedding everything forever (the death-spiral this
    replaced).

    With ``slo_p99_ms <= 0`` admission is unconditional (defer-only) and
    the fabric behaves like the pre-SLO engines: queue wait grows
    without bound past saturation.
    """

    def __init__(self, slo_p99_ms: float, window: LatencyWindow,
                 slots: int = 1):
        self.slo_p99_ms = float(slo_p99_ms)
        self.window = window
        self.slots = max(int(slots), 1)   # fleet-wide concurrent capacity
        self.offered = 0
        self.admitted = 0
        self.shed = 0
        self.deferrals = 0

    @property
    def enabled(self) -> bool:
        return self.slo_p99_ms > 0

    def service_estimate_ms(self) -> float:
        """Windowed p50 time-in-slot (0 until history exists — a cold
        fabric admits everything and learns its regime)."""
        st = self.window.stats()
        return st.service_p50_ms if st.window else 0.0

    def wait_estimate_ms(self, backlog: int) -> float:
        """Estimated queue wait behind ``backlog`` requests: the fleet
        drains ``slots`` requests per service interval."""
        return backlog * self.service_estimate_ms() / self.slots

    def on_offer(self, backlog: int) -> str:
        """Door decision at submit time: ``admit`` (to the queue) or
        ``shed``."""
        self.offered += 1
        if (self.enabled and self.wait_estimate_ms(backlog)
                + self.service_estimate_ms() > self.slo_p99_ms):
            self.shed += 1
            return "shed"
        return "admit"

    def on_dispatch(self, age_ms: float, has_capacity: bool) -> str:
        """Scheduling decision for one queued request: ``admit`` /
        ``defer`` / ``shed``."""
        if (self.enabled
                and age_ms + self.service_estimate_ms() > self.slo_p99_ms):
            self.shed += 1
            return "shed"
        if not has_capacity:
            self.deferrals += 1
            return "defer"
        self.admitted += 1
        return "admit"

    @property
    def shed_fraction(self) -> float:
        return self.shed / self.offered if self.offered else 0.0
