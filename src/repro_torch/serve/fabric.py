"""ServingFabric — partition-routed, replicated, SLO-aware GNN serving.

One engine retires every admitted request on one partition; the layer
that faces MILLIONS of users is a fabric over a partition fleet (the
paper's scale-out claim, turned toward inference):

  * **partition routing** — each node query lands on the partition that
    OWNS the node (``PartitionPlan`` ownership, the same lookup the
    multi-partition trainer routes streamed updates through).  The
    owner's subgraph carries the node's out-edges plus its halo-budgeted
    boundary (feature-only leaves), so cross-cut neighborhoods are
    sampled and gathered entirely from the owner's FeaturePlane — no
    remote fetch on the query path, exactly the paper's no-remote-access
    training discipline.  Routing to a smaller, locality-grown subgraph
    is also the throughput win: the sampled frontier (and with it the
    gather) is a fraction of the full-graph one.
  * **replication behind one scheduler, across a transport seam** —
    ``replicas`` engines per partition behind a single fabric-level
    admission queue.  Every replica sits behind a
    ``serve/transport.py`` ``ReplicaTransport`` — in-process
    ``LoopbackTransport`` by default (bit-exact with calling the
    engines directly), or a host-boundary ``SimHostTransport`` with
    injectable faults — and the fabric learns service time and health
    ONLY from when responses arrive, so the same dispatch works when a
    replica group is a real remote host.  Dispatch is least-loaded-first
    weighted by a per-replica response-time EWMA: a slow host's queue
    organically drains toward its faster peers.
  * **robustness** — a per-request timeout (``timeout_ms``) bounds how
    long the fabric waits on any one replica; a timed-out request is
    retried ONCE on another replica of its partition, then retired
    explicitly (``status == "timeout"``, never silently lost).
    Consecutive timeouts drive a replica's health through
    up → suspect → down; a down replica's in-flight work is re-routed
    to survivors immediately, its dispatch share goes to zero, and the
    SLO scheduler's capacity estimate shrinks so overload is shed at
    the edge BEFORE a query crosses the wire.  A recovered replica is
    probed after a cooldown and rejoins on its first success.
  * **SLO-aware admission** — a target p99 (``GNNConfig.slo_p99_ms``)
    drives ``serve/common.py`` ``SLOAdmission``: shed-or-defer decisions
    computed from the rolling ``LatencyWindow``, so past saturation the
    fabric sheds load (cheap, explicit, ``status == "shed"``) instead of
    letting queue wait blow up — p99 of what it DOES serve stays
    bounded.

Every retry, timeout, re-route and health transition is counted in
``FabricStats`` (per-replica EWMA snapshots included) — the chaos
harness in ``tests/test_torch_transport.py`` drives seeded fault
schedules against these counters and the conservation invariant: every
admitted query ends served, shed, or timed-out, explicitly.

The fabric itself conforms to the ``ServingEngine`` protocol — to a
drive loop or the launcher, a fleet is indistinguishable from one engine.

Device: every replica's forward runs on the fabric's ``device`` (default
``cuda``), and a partition's device feature plane keeps ONE cache table
there, shared by that partition's replicas.  The parameter tree is handed
to every replica as it is: the port's optimizer returns new tensors and
never writes into the old ones, so one tree shared across replicas is as
safe as the JAX package's immutable one.  A tree on another device is
refused, never copied.  The dispatch itself is host-side bookkeeping,
identical to the JAX package's line for line: on a ``VirtualClock`` a
fabric on the card and its twin on the CPU give the same request trace.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.graph.partition import PartitionPlan
from repro_torch.graph.storage import Graph
from repro_torch.models.params import leaves
from repro_torch.serve.common import (EngineBase, SLOAdmission, drain,
                                      trim_completed)
from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest
from repro_torch.serve.transport import loopback_factory


@dataclass
class FabricStats:
    """Fleet-wide fault/robustness counters (the observability half of
    the transport seam).

    ``timeouts`` counts timer expiries (including ones recovered by a
    retry); ``retries`` re-dispatches onto another replica;
    ``reroutes`` in-flight requests pulled off a replica that went
    down; ``timed_out`` requests retired with ``status == "timeout"``
    (retry budget exhausted — the explicit terminal state, never a
    silent loss); ``late_responses`` responses that arrived after the
    fabric stopped waiting (post-timeout, or from a pre-retry attempt)
    and were discarded; ``health_transitions`` up/suspect/down edges.
    """
    timeouts: int = 0
    retries: int = 0
    reroutes: int = 0
    timed_out: int = 0
    late_responses: int = 0
    health_transitions: int = 0

    def asdict(self) -> Dict[str, int]:
        return {"timeouts": self.timeouts, "retries": self.retries,
                "reroutes": self.reroutes, "timed_out": self.timed_out,
                "late_responses": self.late_responses,
                "health_transitions": self.health_transitions}


@dataclass
class ReplicaState:
    """Per-replica health + dispatch statistics, inferred ONLY from
    response arrivals (the cross-host-honest view).

    The health machine: ``up`` → (any timeout) → ``suspect`` →
    (``down_after`` consecutive timeouts) → ``down`` → (cooldown
    ``down_retry_ms`` elapses) → probed with ONE request → ``up`` on
    success, back to ``down`` on another timeout.  Any success resets
    the machine to ``up``.
    """
    state: str = "up"                  # up | suspect | down
    consecutive_timeouts: int = 0
    down_since: float = 0.0
    ewma_ms: Optional[float] = None    # response-time EWMA (dispatch weight)
    sent: int = 0
    completed: int = 0
    timeouts: int = 0


@dataclass
class _Inflight:
    """One dispatched-but-unresolved request: the fabric's canonical
    request object, where it went, and when."""
    req: GNNRequest
    key: Tuple[int, int]               # (partition, replica)
    transport: object
    sent_at: float


class ServingFabric(EngineBase):
    """Partition-routed fleet of ``GNNInferenceEngine`` replicas behind
    one SLO-aware admission scheduler, across the replica transport seam.

    ``planes[p]`` serves every replica of partition p (the warmed cache
    and its accounting are per PARTITION, shared across replicas);
    ``params`` is shared fleet-wide and refreshed via
    ``refresh_weights``.  Requests use GLOBAL node ids throughout —
    translation to partition-local ids happens inside the replica at
    sampling time (``node_map``)."""

    # dispatch scoring: EWMA ratios inside the snap band count as equal
    # (a homogeneous in-process fleet must reduce to pure least-loaded,
    # bit for bit); past it the ratio weights the queue depth directly,
    # capped so one set-up spike cannot starve a replica forever
    EWMA_SNAP = 2.0
    EWMA_CAP = 64.0
    EWMA_ALPHA = 0.3
    SUSPECT_PENALTY = 4.0

    def __init__(self, graph: Graph, plan: PartitionPlan, cfg, params,
                 planes: Optional[List] = None,
                 weight_fns: Optional[List[Optional[Callable]]] = None,
                 batch: int = 8, replicas: int = 1,
                 slo_p99_ms: Optional[float] = None, seed: int = 0,
                 keep_completed: int = 4096,
                 weight_source=None,
                 transport_factory: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 timeout_ms: Optional[float] = None,
                 retry_limit: int = 1, down_after: int = 2,
                 down_retry_ms: float = 50.0,
                 record_trace: bool = False, device="cuda"):
        if replicas < 1:
            raise ValueError(f"replicas must be ≥ 1, got {replicas}")
        self.device = torch.device(device)
        self._check_device(params)
        self.graph = graph
        self.plan = plan
        self.cfg = cfg
        self.replicas = replicas
        self.engine_batch = batch
        self._weight_source = weight_source
        self._seed = seed
        self.clock = clock if clock is not None else time.perf_counter
        self._transport_factory = (transport_factory
                                   if transport_factory is not None
                                   else loopback_factory)
        self.timeout_ms = float(timeout_ms if timeout_ms is not None
                                else getattr(cfg, "serve_timeout_ms", 0.0))
        self.retry_limit = int(retry_limit)
        self.down_after = max(int(down_after), 1)
        self.down_retry_ms = float(down_retry_ms)
        # topology the fabric currently serves: each replica samples a
        # FROZEN subgraph copy built at plan time, so mutations to the
        # full graph are invisible until refresh_topology() adopts a new
        # plan — the version stamp makes that consistency auditable
        self.topology_version = plan.topology_version
        self._init_serving(batch * plan.parts * replicas, keep_completed,
                           window=max(256, 4 * batch * plan.parts))
        self.slo = SLOAdmission(
            cfg.slo_p99_ms if slo_p99_ms is None else slo_p99_ms,
            self.window, slots=self.batch)
        self._build_fleet(plan, params, planes, weight_fns)
        self.steps = 0
        self.shed_requests: List[GNNRequest] = []
        self.timeout_requests: List[GNNRequest] = []
        self.fstats = FabricStats()
        # terminal-by-timeout rids, bounded: a response surfacing for one
        # of these is LATE (discard + count), not an external retirement
        self._failed_rids: Set[int] = set()
        self._failed_order: List[int] = []
        self.request_trace: Optional[List[Tuple]] = ([] if record_trace
                                                     else None)

    def _check_device(self, params):
        """The tree is handed over as it is, so it must already live on
        the fabric's device."""
        want = self.device
        for t in leaves(params):
            if isinstance(t, torch.Tensor) and not (
                    t.device.type == want.type
                    and (want.index is None or t.device.index == want.index)):
                raise ValueError(f"parameters on {t.device}, fabric on "
                                 f"{want}: move the tree before serving it")

    def _build_fleet(self, plan: PartitionPlan, params,
                     planes: Optional[List],
                     weight_fns: Optional[List]):
        """Engines + transports + per-replica dispatch state for one
        plan.  Replicas share the partition plane, get distinct sampler
        seeds; each sits behind its own transport (``retire_hook`` is
        the TRANSPORT's — responses reach the fabric only through
        ``_on_response``)."""
        node_maps = plan.node_maps()
        planes = planes if planes is not None else [None] * plan.parts
        weight_fns = weight_fns if weight_fns is not None else (
            [None] * plan.parts)
        # engines[p][r]: replica r of partition p
        self.engines: List[List[GNNInferenceEngine]] = [
            [GNNInferenceEngine(plan.subgraphs[p], self.cfg, params,
                                plane=planes[p], batch=self.engine_batch,
                                weight_fn=weight_fns[p],
                                seed=self._seed + 101 * p + r,
                                node_map=node_maps[p],
                                keep_completed=max(self.engine_batch, 16),
                                device=self.device)
             for r in range(self.replicas)]
            for p in range(plan.parts)]
        self.transports: List[List] = []
        for p in range(plan.parts):
            row = []
            for r in range(self.replicas):
                t = self._transport_factory(self.engines[p][r], p, r,
                                            self.clock)
                t.bind(lambda resp, key=(p, r): self._on_response(key, resp))
                row.append(t)
            self.transports.append(row)
        self.inflight: Dict[int, _Inflight] = {}
        self.replica_state: Dict[Tuple[int, int], ReplicaState] = {
            (p, r): ReplicaState()
            for p in range(plan.parts) for r in range(self.replicas)}
        self._outstanding: Dict[Tuple[int, int], int] = {
            k: 0 for k in self.replica_state}
        self._inflight_nodes: Dict[Tuple[int, int], Set[int]] = {
            k: set() for k in self.replica_state}

    # ------------------------------------------------------------------
    @classmethod
    def from_trainer(cls, trainer, batch: int = 8,
                     replicas: Optional[int] = None,
                     slo_p99_ms: Optional[float] = None,
                     seed: int = 0, **fabric_kw) -> "ServingFabric":
        """Serve over a ``MultiPartitionTrainer``'s own machinery: each
        partition's replicas share the slot's live feature plane (warmed
        cache + accounting), the γ bias is the slot's own ``weight_fn``,
        halo rows are the ones the trainer's exchange filled, and
        ``refresh_weights()`` pulls the trainer's exported tree.  The
        fabric serves on the trainer's ``device``.  ``fabric_kw`` passes
        the transport-seam knobs through (``transport_factory``,
        ``clock``, ``timeout_ms``, ...)."""
        replicas = (replicas if replicas is not None
                    else getattr(trainer.cfg, "serve_replicas", 1))
        return cls(trainer.full_graph, trainer.plan, trainer.cfg,
                   trainer.get_weights()["params"],
                   planes=[s.pipe.plane for s in trainer.slots],
                   weight_fns=[s.weight_fn for s in trainer.slots],
                   batch=batch, replicas=replicas, slo_p99_ms=slo_p99_ms,
                   seed=seed, weight_source=trainer, device=trainer.device,
                   **fabric_kw)

    @classmethod
    def from_plan(cls, graph: Graph, plan: PartitionPlan, cfg, params,
                  batch: int = 8, replicas: int = 1,
                  slo_p99_ms: Optional[float] = None,
                  seed: int = 0, device="cuda",
                  **fabric_kw) -> "ServingFabric":
        """Standalone fabric (no trainer): per-partition caches + planes
        over the plan's subgraphs, halo feature rows filled host-locally
        from the full graph (the one-host equivalent of the training
        path's ``halo_all_to_all`` result — same rows, same planes).  A
        device plane keeps its cache table on ``device``; the halo fill
        goes through the plane, so resident halo rows reach that table."""
        from repro_torch.core.cache import FeatureCache
        from repro_torch.core.feature_plane import make_feature_plane
        from repro_torch.core.locality import bias_weight_fn
        planes, weight_fns = [], []
        for p, sub in enumerate(plan.subgraphs):
            cache = (FeatureCache(sub, cfg.cache_volume_mb, cfg.cache_policy)
                     if cfg.cache_volume_mb > 0 else None)
            weight_fns.append(bias_weight_fn(cache, cfg.bias_rate)
                              if (cache is not None and cfg.bias_rate > 1.0)
                              else None)
            plane = make_feature_plane(sub, cache, cfg.sampling_device,
                                       device)
            halo = plan.halo_sets[p] if plan.halo_sets else []
            if len(halo):
                n_owned = len(plan.node_sets[p])
                local = np.arange(n_owned, n_owned + len(halo))
                plane.fill_rows(local, graph.features[halo])
            planes.append(plane)
        return cls(graph, plan, cfg, params, planes=planes,
                   weight_fns=weight_fns, batch=batch, replicas=replicas,
                   slo_p99_ms=slo_p99_ms, seed=seed, device=device,
                   **fabric_kw)

    # ------------------------------------------------------------------
    # ServingEngine surface — aggregate views over the fleet
    # ------------------------------------------------------------------
    @property
    def all_engines(self) -> List[GNNInferenceEngine]:
        return [e for part in self.engines for e in part]

    @property
    def all_transports(self) -> List:
        return [t for part in self.transports for t in part]

    @property
    def running(self) -> Dict:
        """Fleet-wide dispatched-but-unresolved view, keyed (partition,
        replica, rid).  Built on access — ``inflight`` owns the records."""
        return {(rec.key[0], rec.key[1], rid): rec.req
                for rid, rec in self.inflight.items()}

    def free_slots(self) -> List:
        return [(p, r, s)
                for p in range(self.plan.parts)
                for r in range(self.replicas)
                for s in range(self.engine_batch
                               - self._outstanding[(p, r)])]

    def utilization(self) -> float:
        return sum(self._outstanding.values()) / max(self.batch, 1)

    def _queued(self) -> int:
        """Backlog ahead of a new arrival: the fabric queue plus work
        dispatched but not yet resolved."""
        return len(self.pending) + len(self.inflight)

    def has_work(self) -> bool:
        """Fabric work covers its own queue, everything dispatched and
        unresolved, and the transports' local queues (e.g. an engine
        driven directly for warm-up) — the shared drain must not stop
        while any of them still holds work.  A disconnected transport's
        dead state is excluded (``busy`` is False); its in-flight
        requests keep the drain alive through ``inflight`` until the
        timeout reclaims them."""
        return (bool(self.pending) or bool(self.inflight)
                or any(t.busy() for t in self.all_transports))

    # ------------------------------------------------------------------
    def _validate(self, req: GNNRequest):
        if not (0 <= req.node < self.graph.num_nodes):
            raise ValueError(f"node {req.node} outside graph "
                             f"[0, {self.graph.num_nodes})")

    def submit(self, req: GNNRequest):
        """Offered load enters HERE: route (stamp the owner partition)
        and run the door half of SLO admission — a request whose
        estimated wait already busts the target is shed at the door,
        before it consumes queue space (and before it crosses any
        wire)."""
        self._validate(req)
        req.partition = int(self.plan.owner_of([req.node])[0])
        req.topology_version = self.topology_version
        req.t_submit = self.clock()
        if self.slo.on_offer(self._queued()) == "shed":
            self._shed(req)
            return
        self.pending.append(req)

    def _trace(self, req: GNNRequest, status: str):
        if self.request_trace is not None:
            self.request_trace.append((req.rid, req.partition, req.replica,
                                       status, req.pred))

    def _shed(self, req: GNNRequest):
        req.t_first = req.t_done = self.clock()
        req.status = "shed"                     # pred stays the −1 sentinel
        self.shed_requests.append(req)
        trim_completed(self.shed_requests, self.keep_completed)
        self._trace(req, "shed")

    def _account_retirement(self, req: GNNRequest):
        """One served retirement surfacing at the fabric: the fleet-wide
        history + rolling window (the SLO scheduler's input)."""
        self.completed.append(req)
        self.total_completed += 1
        self.window.record(req)
        trim_completed(self.completed, self.keep_completed)
        if self.retire_hook is not None:
            self.retire_hook(req)

    # ------------------------------------------------------------------
    # health + EWMA bookkeeping (inferred from response arrivals only)
    # ------------------------------------------------------------------
    def _update_slo_slots(self):
        """Live fleet capacity feeds the SLO wait estimate: a down
        replica's slots stop counting, so the door sheds the load the
        survivors cannot carry — before it queues, before any wire."""
        alive = sum(1 for st in self.replica_state.values()
                    if st.state != "down")
        self.slo.slots = max(1, self.engine_batch * alive)

    def _note_success(self, key: Tuple[int, int], sample_ms: float):
        st = self.replica_state[key]
        st.consecutive_timeouts = 0
        if st.state != "up":
            st.state = "up"
            self.fstats.health_transitions += 1
            self._update_slo_slots()
        st.completed += 1
        st.ewma_ms = (sample_ms if st.ewma_ms is None else
                      self.EWMA_ALPHA * sample_ms
                      + (1.0 - self.EWMA_ALPHA) * st.ewma_ms)

    def _note_timeout(self, key: Tuple[int, int], now: float):
        st = self.replica_state[key]
        st.consecutive_timeouts += 1
        st.timeouts += 1
        if st.state == "up":
            st.state = "suspect"
            self.fstats.health_transitions += 1
        if (st.state == "suspect"
                and st.consecutive_timeouts >= self.down_after):
            st.state = "down"
            st.down_since = now
            self.fstats.health_transitions += 1
            self._update_slo_slots()
            self._reroute_replica(key, now)
        elif st.state == "down":
            st.down_since = now          # failed probe: restart cooldown

    def _note_failed_rid(self, rid: int):
        self._failed_rids.add(rid)
        self._failed_order.append(rid)
        if len(self._failed_order) > 4096:
            drop = self._failed_order[:len(self._failed_order) - 4096]
            del self._failed_order[:len(self._failed_order) - 4096]
            self._failed_rids.difference_update(drop)

    # ------------------------------------------------------------------
    # dispatch: SLO verdict, then health/EWMA-weighted least-loaded
    # ------------------------------------------------------------------
    def _candidates(self, req: GNNRequest, now: float) -> List[int]:
        """Replica indices of the owner partition eligible for this
        request: not down (unless their probe cooldown elapsed), with a
        free slot (suspect/probed replicas carry at most ONE in-flight
        request), and not already holding this node (the unique-seed
        invariant — checked against the fabric's dispatch record AND the
        transport's local view, which also covers directly-driven
        warm-up work)."""
        p = req.partition
        out = []
        for r in range(self.replicas):
            key = (p, r)
            st = self.replica_state[key]
            depth = self._outstanding[key]
            if st.state == "down":
                if now < st.down_since + self.down_retry_ms * 1e-3:
                    continue
                if depth >= 1:
                    continue             # one probe at a time
            elif st.state == "suspect" and depth >= 1:
                continue
            if depth >= self.engine_batch:
                continue
            if req.node in self._inflight_nodes[key]:
                continue
            if req.node in self.transports[p][r].in_flight_nodes():
                continue
            out.append(r)
        return out

    def _pick_replica(self, req: GNNRequest, candidates: List[int]) -> int:
        """Least-loaded weighted by the response-time EWMA.  Ratios
        inside ``EWMA_SNAP`` count as equal, so a homogeneous fleet
        reduces EXACTLY to the pre-seam queue-depth choice (first
        minimal index), the loopback bit-exactness anchor, while a
        genuinely slow host (a 10× wire delay) takes proportionally
        fewer requests and organically drains.  Suspect replicas carry
        a fixed penalty: they are probed, not trusted."""
        p = req.partition
        prev = req.replica if req.retries > 0 else -1
        pool = [r for r in candidates if r != prev] or candidates
        sampled = [self.replica_state[(p, r)].ewma_ms for r in pool
                   if self.replica_state[(p, r)].ewma_ms is not None]
        ewma_min = min(sampled) if sampled else 0.0
        best_r, best_score = pool[0], float("inf")
        for r in pool:
            st = self.replica_state[(p, r)]
            rel = 1.0
            if st.ewma_ms is not None and ewma_min > 0:
                rel = st.ewma_ms / ewma_min
                rel = 1.0 if rel < self.EWMA_SNAP else min(rel,
                                                           self.EWMA_CAP)
            pen = 1.0 if st.state == "up" else self.SUSPECT_PENALTY
            score = (self._outstanding[(p, r)] + 1) * rel * pen
            if score < best_score:
                best_r, best_score = r, score
        return best_r

    def _send(self, req: GNNRequest, r: int, now: float):
        key = (req.partition, r)
        req.replica = r
        transport = self.transports[req.partition][r]
        self.inflight[req.rid] = _Inflight(req, key, transport, now)
        self._outstanding[key] += 1
        self._inflight_nodes[key].add(req.node)
        self.replica_state[key].sent += 1
        transport.send(req)

    def _dispatch_pass(self, now: float):
        """Drain the fabric queue toward the replicas: per request, the
        SLO decision (shed the hopeless, defer the currently-unplaceable)
        then the weighted least-loaded choice among the owner's eligible
        replicas.  A deferred request keeps its place; requests for
        OTHER partitions behind it still dispatch (no cross-partition
        head-of-line blocking)."""
        keep: List[GNNRequest] = []
        while self.pending:
            req = self.pending.popleft()
            candidates = self._candidates(req, now)
            verdict = self.slo.on_dispatch((now - req.t_submit) * 1e3,
                                           bool(candidates))
            if verdict == "shed":
                self._shed(req)
            elif verdict == "defer" or not candidates:
                keep.append(req)
            else:
                self._send(req, self._pick_replica(req, candidates), now)
        self.pending.extend(keep)

    # ------------------------------------------------------------------
    # responses, timeouts, retries, re-routes
    # ------------------------------------------------------------------
    def _resolve(self, rec: _Inflight):
        self.inflight.pop(rec.req.rid, None)
        self._outstanding[rec.key] -= 1
        self._inflight_nodes[rec.key].discard(rec.req.node)

    def _on_response(self, key: Tuple[int, int], resp: GNNRequest):
        """A transport delivered a response.  Three cases: the request
        is in flight on that replica (success — retire it); the fabric
        stopped waiting, or retried elsewhere (late — discard, count);
        or the fabric never dispatched it (an engine driven directly,
        e.g. the launcher's warm-up — account it as an engine's own)."""
        now = self.clock()
        rec = self.inflight.get(resp.rid)
        if rec is None or rec.key != key:
            if rec is not None or resp.rid in self._failed_rids:
                self.fstats.late_responses += 1
                return
            self._account_retirement(resp)       # external retirement
            return
        req = rec.req
        self._resolve(rec)
        if resp is not req:
            # the response crossed a modeled wire: fold the remote copy's
            # results back into the canonical request, stamped on the
            # fabric clock (dispatch → delivery is the honest latency)
            req.pred = resp.pred
            req.logits = resp.logits
            req.status = resp.status
            req.t_first = rec.sent_at
            req.t_done = now
        self._note_success(key, (now - rec.sent_at) * 1e3)
        self._account_retirement(req)
        self._trace(req, "done")

    def _fail_attempt(self, rec: _Inflight, now: float, reroute: bool):
        """One dispatched attempt gave up (timer expiry, or its replica
        went down): reclaim it, then retry on another replica while the
        budget lasts — otherwise retire it EXPLICITLY as timed out.
        Every admitted request ends in exactly one terminal state; none
        vanish inside a dead host."""
        req = rec.req
        if req.rid not in self.inflight:
            # already reclaimed this step: a timeout that tips its replica
            # to down re-routes the SAME records the expiry snapshot holds
            return
        self._resolve(rec)
        rec.transport.cancel(req.rid)
        if reroute:
            self.fstats.reroutes += 1
        else:
            self.fstats.timeouts += 1
            self._note_timeout(rec.key, now)
        req.retries += 1
        if req.retries <= self.retry_limit:
            self.fstats.retries += 1
            self.pending.append(req)
            return
        req.status = "timeout"
        req.t_done = now
        self.timeout_requests.append(req)
        trim_completed(self.timeout_requests, self.keep_completed)
        self.fstats.timed_out += 1
        self._note_failed_rid(req.rid)
        self._trace(req, "timeout")

    def _reroute_replica(self, key: Tuple[int, int], now: float):
        """A replica went down: pull everything in flight on it back
        and re-route to survivors (or retire explicitly) NOW — waiting
        out each request's own timer would serialize the failures."""
        stuck = [rec for rec in self.inflight.values() if rec.key == key]
        for rec in stuck:
            self._fail_attempt(rec, now, reroute=True)

    def _service_timeouts(self, now: float):
        if self.timeout_ms <= 0 or not self.inflight:
            return
        expired = [rec for rec in self.inflight.values()
                   if (now - rec.sent_at) * 1e3 > self.timeout_ms]
        for rec in expired:
            self._fail_attempt(rec, now, reroute=False)

    # ------------------------------------------------------------------
    def _advance_clock(self) -> float:
        tick = getattr(self.clock, "tick", None)
        if tick is not None:
            tick()                       # VirtualClock: one tick per step
        return self.clock()

    def step(self) -> int:
        """One fabric tick: service timeouts, a dispatch pass, then one
        poll on every transport (which drives in-process engines one
        step and delivers whatever responses are due).  Returns
        fleet-wide resolutions (served + explicitly timed out)."""
        now = self._advance_clock()
        done0 = self.total_completed
        timed0 = self.fstats.timed_out
        self._service_timeouts(now)
        self._dispatch_pass(now)
        for part in self.transports:
            for t in part:
                t.poll(now)
        self.steps += 1
        return (self.total_completed - done0
                + self.fstats.timed_out - timed0)

    # ------------------------------------------------------------------
    # weight hand-off: trainer → every replica, between steps
    # ------------------------------------------------------------------
    def refresh_weights(self, weights: Optional[Dict] = None):
        """Swap every replica's params (the get/set-weights discipline).
        With no argument, pulls from the trainer this fabric was built
        from.  In-flight requests are NOT dropped: a single-shot query is
        computed wholly inside one engine step, so everything retired
        after this call used the refreshed tree, which is handed over as
        it is (on the fabric's device, or refused)."""
        if weights is None:
            if self._weight_source is None:
                raise ValueError("no weight source: pass weights= or build "
                                 "the fabric with from_trainer")
            weights = self._weight_source.get_weights()
        self._check_device(weights["params"])
        for eng in self.all_engines:
            eng.set_weights(weights)

    # ------------------------------------------------------------------
    # topology hand-off: a mutated graph reaches serving the same way
    # weights do — a whole-plan swap BETWEEN steps, never mid-flight
    # ------------------------------------------------------------------
    def refresh_topology(self, plan: Optional[PartitionPlan] = None,
                         planes: Optional[List] = None,
                         weight_fns: Optional[List] = None):
        """Adopt a new ``PartitionPlan`` (post edge stream / compaction /
        incremental re-balance).  The ``FeatureCache.version`` discipline
        generalized to topology: requests already dispatched finish
        against the subgraphs they were admitted under (each replica's
        graph is a frozen copy and a single-shot query retires inside one
        engine step), THEN the fleet is rebuilt over the new plan's
        subgraphs and every request admitted afterwards carries the new
        ``topology_version`` stamp.  Requests still queued — including
        retries reclaimed mid-rebuild, and anything a dead or
        unresponsive replica never answered — are RE-STAMPED against the
        new plan (owner may have changed under a re-balance) and
        re-dispatched onto the rebuilt fleet; none are dropped.  With
        no arguments, pulls plan/planes/weight_fns from the trainer this
        fabric was built from (``from_trainer``).  The fleet is rebuilt
        on the same ``device``."""
        if plan is None:
            if self._weight_source is None:
                raise ValueError("no topology source: pass plan= or build "
                                 "the fabric with from_trainer")
            src = self._weight_source
            plan = src.plan
            planes = [s.pipe.plane for s in src.slots]
            weight_fns = [s.weight_fn for s in src.slots]
        if plan.parts != self.plan.parts:
            raise ValueError(f"refresh_topology cannot change the partition "
                             f"count ({self.plan.parts} -> {plan.parts}); "
                             f"build a new fabric")
        # drain dispatched work against the OLD topology: poll transports
        # (responses in flight on a wire still count) and service
        # timeouts, bounded.  A timed-out request's retry lands in the
        # fabric queue — no dispatch pass runs here, so it waits for the
        # rebuilt fleet instead of a replica about to be torn down.
        iters = 0
        while ((self.inflight or any(t.busy() for t in self.all_transports))
               and iters < 10_000):
            now = self._advance_clock()
            self._service_timeouts(now)
            for t in self.all_transports:
                t.poll(now)
            iters += 1
            if (self.inflight and self.timeout_ms <= 0
                    and not any(t.busy() for t in self.all_transports)):
                break   # nothing will resolve these — pull them back below
        # anything STILL unresolved (a disconnected host, or timeouts
        # disabled) is pulled back and re-queued — the rebuild is not the
        # request's fault, so its retry budget is untouched
        if self.inflight:
            for rec in list(self.inflight.values()):
                self._resolve(rec)
                rec.transport.cancel(rec.req.rid)
                self.pending.append(rec.req)
        params = (self._weight_source.get_weights()["params"]
                  if self._weight_source is not None
                  else self.all_engines[0].params)
        self._build_fleet(plan, params, planes, weight_fns)
        self.plan = plan
        self.topology_version = plan.topology_version
        self._update_slo_slots()
        # queued-but-undispatched requests (reclaimed retries included)
        # route against the NEW owners and serve the new topology, so
        # they get the new stamp — re-stamped, never dropped
        for req in self.pending:
            req.partition = int(plan.owner_of([req.node])[0])
            req.topology_version = self.topology_version
            req.replica = -1
        self.steps += 1

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    @property
    def shed_fraction(self) -> float:
        return self.slo.shed_fraction

    def partition_completed(self) -> List[int]:
        """Fleet-wide retirements per partition (routing observability).
        Engine-side counts: what each partition's replicas COMPUTED —
        under fault injection this can exceed what the fabric received
        (a dropped response was still computed)."""
        return [sum(e.total_completed for e in part)
                for part in self.engines]

    def fabric_stats(self) -> Dict:
        """One observability snapshot: the ``FabricStats`` counters plus
        per-replica health, response-time EWMA and transport-side fault
        counters — the numbers the chaos harness checks."""
        out = self.fstats.asdict()
        out["slo_slots"] = self.slo.slots
        reps = {}
        for (p, r), st in sorted(self.replica_state.items()):
            t = self.transports[p][r]
            entry = {"health": st.state,
                     "ewma_ms": (round(st.ewma_ms, 4)
                                 if st.ewma_ms is not None else None),
                     "sent": st.sent, "completed": st.completed,
                     "timeouts": st.timeouts,
                     "outstanding": self._outstanding[(p, r)]}
            for counter in ("delivered", "dropped_responses",
                            "blackholed_sends", "lost_on_disconnect"):
                if hasattr(t, counter):
                    entry[counter] = getattr(t, counter)
            reps[f"{p}/{r}"] = entry
        out["replicas"] = reps
        return out

    def audit(self) -> Dict[str, int]:
        """Conservation ledger: every offered request is in exactly one
        bucket.  ``offered == done + shed + timed_out + pending +
        inflight`` is the chaos harness's no-silent-loss invariant
        (door-validated rejections raise before ``offered`` counts)."""
        return {"offered": self.slo.offered,
                "done": self.total_completed,
                "shed": self.slo.shed,
                "timed_out": self.fstats.timed_out,
                "pending": len(self.pending),
                "inflight": len(self.inflight)}

    def _begin_window(self) -> Dict:
        return {"steps": self.steps, "offered": self.slo.offered,
                "shed": self.slo.shed, "deferrals": self.slo.deferrals,
                "timeouts": self.fstats.timeouts,
                "retries": self.fstats.retries}

    def _window_metrics(self, mark: Dict, emitted: int, done: int,
                        dt: float) -> Dict[str, float]:
        offered = self.slo.offered - mark["offered"]
        shed = self.slo.shed - mark["shed"]
        return {"queries_per_s": done / dt if dt else 0.0,
                "fabric_steps": self.steps - mark["steps"],
                "offered": offered, "shed": shed,
                "deferrals": self.slo.deferrals - mark["deferrals"],
                "timeouts": self.fstats.timeouts - mark["timeouts"],
                "retries": self.fstats.retries - mark["retries"],
                "shed_fraction": shed / offered if offered else 0.0}

    def run_to_completion(self, max_iters: int = 10_000) -> Dict[str, float]:
        stats = super().run_to_completion(max_iters)
        caches = [e.plane.stats for e in
                  (part[0] for part in self.engines)]
        hits = sum(c.hits for c in caches if c is not None)
        total = hits + sum(c.misses for c in caches if c is not None)
        stats["cache_hit_rate"] = hits / total if total else 0.0
        return stats

    def drain(self, max_iters: int = 10_000):
        """Step until every queue (fabric + transports + replicas) is
        empty."""
        return drain(self, max_iters)
