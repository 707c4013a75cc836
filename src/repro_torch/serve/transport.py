"""The replica transport seam — how the fabric talks to a replica.

Cross-host serving changes none of the fabric's POLICY (routing, SLO
admission, least-loaded dispatch) but all of its FAILURE MODEL — a cheap
fleet exhibits slow hosts, dropped responses and dead replicas, and the
scheduler must survive them.  This module is the seam that separates the
two, mirroring the training side's ``HostSimMesh`` twin pattern
(``repro_torch/launch/mesh.py``): one protocol, an in-process
implementation that is bit-exact with a direct method call, and a
host-boundary twin with injectable faults so the failure model is
testable on one host.  It is numpy and the standard library only, the
same module as the JAX package's: an engine stepping on the card is as
opaque to it as one stepping on the host.

  * ``ReplicaTransport`` — the protocol: ``send`` a request toward the
    replica, ``poll`` to advance it and deliver any responses due, plus
    the local bookkeeping views dispatch needs (``in_flight_nodes`` for
    the unique-seed guard, ``busy`` for drain termination).  Responses
    come back through a callback the fabric ``bind``s — never a return
    value — because on a real wire arrival time is the transport's
    decision, not the caller's.
  * ``LoopbackTransport`` — zero-overhead in-process delivery: ``send``
    is ``engine.submit``, a retirement is delivered synchronously from
    inside ``engine.step``, and the request object crosses untouched
    (no copy), so a loopback fabric is bit-exact with the pre-seam one.
  * ``SimHostTransport`` — a modeled host boundary: requests are COPIED
    across the "wire" (the remote host owns its copy — result fields
    travel back only when a response is delivered), responses are held
    for ``added_latency_ms`` plus seeded jitter, and the ``FaultSpec``
    knobs inject the cheap-fleet failure modes — dropped responses,
    a scheduled disconnect (host crash: queued state dies with it) and
    recovery.  Every random draw comes from one seeded generator, so a
    fault schedule is exactly reproducible.
  * ``VirtualClock`` — a ``perf_counter`` stand-in the fabric ticks
    once per step.  Chaos tests run on it so timeouts, latencies and
    health transitions are deterministic functions of the schedule,
    not of host speed.
"""
from __future__ import annotations

import copy
import heapq
from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Set, runtime_checkable

import numpy as np


class VirtualClock:
    """Deterministic ``perf_counter`` stand-in (seconds).

    The fabric auto-advances it by ``tick_s`` once per ``step`` (it
    duck-types on ``tick``); tests may also ``advance`` it explicitly.
    All request timestamps, timeouts, EWMAs and fault schedules then
    move in lock-step with the step count — same seed + same schedule
    ⇒ the same trace, on any host.
    """

    def __init__(self, start: float = 0.0, tick_s: float = 1e-3):
        self.now = float(start)
        self.tick_s = float(tick_s)

    def __call__(self) -> float:
        return self.now

    def tick(self):
        self.now += self.tick_s

    def advance(self, dt_s: float):
        self.now += float(dt_s)


@runtime_checkable
class ReplicaTransport(Protocol):
    """What the fabric sees of one replica, wherever it lives.

    The fabric ``bind``s a delivery callback, ``send``s requests, and
    ``poll``s every step; everything else it knows about the replica —
    service time, health — it must infer from when (and whether)
    responses arrive.  That inference is the point of the seam: the
    dispatch/timeout/health machinery written against it works
    unchanged when the replica is a real remote host.
    """

    engine: object

    def bind(self, deliver: Callable) -> None: ...
    def send(self, req) -> None: ...
    def poll(self, now: float) -> int: ...
    def cancel(self, rid: int) -> bool: ...
    def in_flight_nodes(self) -> Set[int]: ...
    def busy(self) -> bool: ...
    def connected(self) -> bool: ...


class LoopbackTransport:
    """In-process transport — the pre-seam fabric, behind the seam.

    No copies, no queues of its own, no latency model: ``send`` feeds
    the engine directly and a retirement is delivered synchronously
    from inside ``engine.step`` (the engine's ``retire_hook``).  A
    fabric over loopback transports is bit-exact with the pre-transport
    ``ServingFabric`` — same dispatch order, same request objects, same
    timestamps — which is the regression anchor every fault-injection
    run is compared against.
    """

    def __init__(self, engine, clock=None, fault=None, seed: int = 0):
        self.engine = engine
        self._deliver: Optional[Callable] = None
        engine.retire_hook = self._on_retire

    def bind(self, deliver: Callable):
        self._deliver = deliver

    def _on_retire(self, req):
        if self._deliver is not None:
            self._deliver(req)

    def send(self, req):
        self.engine.submit(req)

    def poll(self, now: float) -> int:
        if self.engine.has_work():
            return self.engine.step()
        return 0

    def cancel(self, rid: int) -> bool:
        for i, req in enumerate(self.engine.pending):
            if req.rid == rid:
                del self.engine.pending[i]
                return True
        return False

    def in_flight_nodes(self) -> Set[int]:
        return ({r.node for r in self.engine.running.values()}
                | {r.node for r in self.engine.pending})

    def busy(self) -> bool:
        return self.engine.has_work()

    def connected(self) -> bool:
        return True


@dataclass
class FaultSpec:
    """Injectable faults for one ``SimHostTransport`` — all deterministic
    under the transport's seed.

    ``added_latency_ms`` is the fixed per-response wire+service cost a
    host boundary adds (set it 10× on one replica to model a slow
    host); ``jitter_ms`` adds a seeded uniform draw in [0, jitter_ms)
    per response; ``drop_rate`` silently drops that fraction of
    responses AFTER the remote computed them (the fabric sees only a
    timeout); ``down_at_ms``/``up_at_ms`` schedule a full disconnect
    and recovery on the transport clock (relative to construction);
    ``down_after_responses`` disconnects after the Nth delivered
    response (kill-mid-burst without knowing timestamps).
    """

    added_latency_ms: float = 0.0
    jitter_ms: float = 0.0
    drop_rate: float = 0.0
    down_at_ms: Optional[float] = None
    up_at_ms: Optional[float] = None
    down_after_responses: Optional[int] = None


class SimHostTransport:
    """A modeled host boundary around one in-process engine.

    The wrapped engine is the "remote host": ``send`` copies the
    request across the wire (the fabric's object and the host's are
    distinct — exactly the aliasing a real RPC forces), ``poll`` drives
    the host one engine step and schedules each computed response for
    delivery at ``now + added_latency + jitter``, and delivery copies
    the result fields back into the fabric's canonical request.  Faults
    (``FaultSpec``) intercept that flow: a dropped response is computed
    but never delivered; a disconnected host blackholes sends, loses
    its queued state (crash semantics) and delivers nothing until the
    scheduled recovery.  One seeded generator drives jitter, drops and
    nothing else — the whole failure schedule replays bit-identically.
    """

    def __init__(self, engine, clock=None, fault: Optional[FaultSpec] = None,
                 seed: int = 0):
        import time
        self.engine = engine
        self.clock = clock if clock is not None else time.perf_counter
        self.fault = fault if fault is not None else FaultSpec()
        self._rng = np.random.default_rng(seed)
        self._deliver: Optional[Callable] = None
        self._t0 = self.clock()
        self._connected = True
        self._auto_down_done = False
        self._auto_up_done = False
        # (due_time, seq, response copy): a heap so jittered responses
        # can overtake each other on the wire, deterministically
        self._wire: List = []
        self._seq = 0
        self._captured: List = []
        # transport-local counters (surfaced in FabricStats snapshots)
        self.sent = 0
        self.delivered = 0
        self.dropped_responses = 0
        self.blackholed_sends = 0
        self.lost_on_disconnect = 0
        engine.retire_hook = self._captured.append

    def bind(self, deliver: Callable):
        self._deliver = deliver

    # -- fault control (tests drive these directly or via the spec) ----
    def kill(self):
        """Full disconnect: the host crashes.  Everything it held —
        queued requests, computed-but-undelivered responses — dies with
        it; the fabric learns only through timeouts."""
        if not self._connected:
            return
        self._connected = False
        self.lost_on_disconnect += (len(self._wire) + len(self._captured)
                                    + len(self.engine.pending)
                                    + len(self.engine.running))
        self._wire.clear()
        self._captured.clear()
        self.engine.pending.clear()
        self.engine.running.clear()

    def revive(self):
        """Recovery: the host is back, empty-handed (restart, not
        resume) — it serves whatever the fabric sends next."""
        self._connected = True

    def connected(self) -> bool:
        return self._connected

    # ------------------------------------------------------------------
    def _apply_schedule(self, now: float):
        ms = (now - self._t0) * 1e3
        f = self.fault
        if (f.down_at_ms is not None and not self._auto_down_done
                and ms >= f.down_at_ms):
            self._auto_down_done = True
            self.kill()
        if (f.up_at_ms is not None and not self._auto_up_done
                and ms >= f.up_at_ms):
            self._auto_up_done = True
            self.revive()

    def send(self, req):
        self._apply_schedule(self.clock())
        if not self._connected:
            self.blackholed_sends += 1      # the fabric's timeout finds it
            return
        self.sent += 1
        self.engine.submit(copy.copy(req))

    def poll(self, now: float) -> int:
        self._apply_schedule(now)
        if self._connected and self.engine.has_work():
            self.engine.step()
        # computed responses board the wire with their delivery time
        for resp in self._captured:
            extra = (self._rng.uniform(0.0, self.fault.jitter_ms)
                     if self.fault.jitter_ms > 0 else 0.0)
            due = now + (self.fault.added_latency_ms + extra) * 1e-3
            heapq.heappush(self._wire, (due, self._seq, resp))
            self._seq += 1
        self._captured.clear()
        delivered = 0
        while self._wire and self._wire[0][0] <= now and self._connected:
            due, _, resp = heapq.heappop(self._wire)
            if (self.fault.drop_rate > 0
                    and self._rng.random() < self.fault.drop_rate):
                self.dropped_responses += 1
                continue
            resp.t_done = due if due > now - 1e-12 else now
            self.delivered += 1
            if self._deliver is not None:
                self._deliver(resp)
                delivered += 1
            if (self.fault.down_after_responses is not None
                    and self.delivered >= self.fault.down_after_responses):
                self.kill()
        return delivered

    def cancel(self, rid: int) -> bool:
        for i, req in enumerate(self.engine.pending):
            if req.rid == rid:
                del self.engine.pending[i]
                return True
        for i, (due, seq, resp) in enumerate(self._wire):
            if resp.rid == rid:
                del self._wire[i]
                heapq.heapify(self._wire)
                return True
        return False

    def in_flight_nodes(self) -> Set[int]:
        return ({r.node for r in self.engine.running.values()}
                | {r.node for r in self.engine.pending}
                | {resp.node for _, _, resp in self._wire}
                | {resp.node for resp in self._captured})

    def busy(self) -> bool:
        # a disconnected host's queues are DEAD state, not pending work:
        # nothing it holds will ever be delivered, so it must not keep a
        # drain loop alive (the fabric's timeout owns those requests)
        return self._connected and (bool(self._wire) or bool(self._captured)
                                    or self.engine.has_work())


def loopback_factory(engine, partition: int, replica: int, clock):
    """Default transport factory: the in-process fabric (bit-exact with
    the pre-seam one)."""
    return LoopbackTransport(engine, clock=clock)


def sim_host_factory(faults=None, base: Optional[FaultSpec] = None,
                     seed: int = 0):
    """Factory-maker for a fabric of ``SimHostTransport`` replicas.

    ``faults`` maps ``(partition, replica)`` → ``FaultSpec`` overrides;
    every other replica gets ``base`` (default: a clean ``FaultSpec()``
    — a host boundary with zero modeled cost).  Per-transport seeds are
    derived from ``seed`` and the replica coordinates, so two fabrics
    built with the same arguments replay identical fault schedules.
    """
    faults = dict(faults or {})

    def factory(engine, partition: int, replica: int, clock):
        spec = faults.get((partition, replica),
                          base if base is not None else FaultSpec())
        return SimHostTransport(engine, clock=clock, fault=spec,
                                seed=seed + 7919 * partition + 13 * replica)
    return factory
