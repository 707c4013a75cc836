"""The port's transport seam and chaos harness (``serve/transport.py``
under ``serve/fabric.py``), on the CPU.

Two halves:

  * the mirror of ``tests/test_transport_faults.py`` on the port — seeded
    fault schedules (kill a replica mid-burst, delay one host 10×, drop a
    fraction of responses, recover) driven through ``SimHostTransport``
    on a ``VirtualClock``, holding conservation, bit-exactness across
    replicas and runs, graceful degradation, recovery and determinism;
  * differential runs against the JAX package: the same smoke graph, plan
    and parameters (carried across by ``models/convert.py``), a JAX
    ``ServingFabric.from_plan`` and the port's, each over
    ``SimHostTransport`` replicas on a ``VirtualClock`` with
    ``record_trace=True``.  Every fault schedule must give the identical
    request trace (rid, partition, replica, status, pred), equal
    ``audit()`` and ``fabric_stats()`` (the response-time EWMAs within
    1e-9) and logits within atol 1e-5.  The virtual clock makes dispatch
    a function of the schedule alone, so any difference is the port's.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.core.a3gnn import A3GNNTrainer as JxTrainer
from repro.graph.partition import plan_partitions as jx_plan
from repro.serve import transport as jx_transport
from repro.serve.fabric import ServingFabric as JxFabric
from repro.serve.gnn_engine import GNNRequest as JxRequest
from repro_torch.configs.gnn import gnn_config
from repro_torch.core.a3gnn import A3GNNTrainer
from repro_torch.graph.partition import plan_partitions
from repro_torch.graph.synthetic import dataset_like
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import transport as pt_transport
from repro_torch.serve.fabric import ServingFabric
from repro_torch.serve.gnn_engine import GNNRequest
from repro_torch.serve.transport import (FaultSpec, LoopbackTransport,
                                         ReplicaTransport, SimHostTransport,
                                         VirtualClock, sim_host_factory)

FANOUT = 64


@pytest.fixture(scope="module")
def env():
    cfg = gnn_config("products", smoke=True).replace(fanout=(FANOUT, FANOUT))
    graph = dataset_like(cfg, seed=0)
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    # calm pool: seed AND every neighbor fit inside the fanout, so the
    # sampler's take-everything path runs (no rng draw) and a prediction
    # is a pure function of (node, params) — comparable across replicas,
    # retries and differently-batched runs
    indptr, indices = graph.adj()
    deg = np.diff(indptr)
    calm = np.array([deg[v] <= FANOUT and
                     (deg[indices[indptr[v]:indptr[v + 1]]].max(initial=0)
                      <= FANOUT)
                     for v in range(graph.num_nodes)])
    pool = np.where(calm)[0]
    assert len(pool) >= 400
    return SimpleNamespace(graph=graph, cfg=cfg, params=tr.params, pool=pool)


def _sim_fabric(env, faults=None, base=None, parts=2, replicas=2, batch=4,
                seed=0, tick_s=1e-3, **kw):
    clock = VirtualClock(tick_s=tick_s)
    plan = plan_partitions(env.graph, parts, "locality", seed=0,
                           halo_budget=32)
    fab = ServingFabric.from_plan(
        env.graph, plan, env.cfg, env.params, batch=batch, replicas=replicas,
        seed=0,
        transport_factory=sim_host_factory(faults=faults, base=base,
                                           seed=seed),
        clock=clock, device="cpu", **kw)
    return plan, fab, clock


def _offer(fab, nodes, per_step=0, rid0=0):
    """Submit ``nodes`` (burst, or paced ``per_step`` per fabric step)
    and drain.  Returns the submitted rids."""
    rids = list(range(rid0, rid0 + len(nodes)))
    if per_step <= 0:
        for rid, v in zip(rids, nodes):
            fab.submit(GNNRequest(rid=rid, node=int(v)))
        fab.drain()
        return rids
    i = 0
    while i < len(nodes):
        for _ in range(per_step):
            if i >= len(nodes):
                break
            fab.submit(GNNRequest(rid=rids[i], node=int(nodes[i])))
            i += 1
        fab.step()
    fab.drain()
    return rids


def _buckets(fab):
    return ({r.rid: r for r in fab.completed},
            {r.rid: r for r in fab.shed_requests},
            {r.rid: r for r in fab.timeout_requests})


def _assert_conserved(fab, rids):
    """The no-silent-loss invariant: queues empty, the audit ledger
    balances, and every submitted rid sits in exactly one terminal
    bucket with the matching explicit status."""
    done, shed, tout = _buckets(fab)
    a = fab.audit()
    assert a["pending"] == 0 and a["inflight"] == 0
    assert a["offered"] == a["done"] + a["shed"] + a["timed_out"]
    assert a["offered"] == len(rids)
    for rid in rids:
        assert (rid in done) + (rid in shed) + (rid in tout) == 1
    assert all(r.status == "done" for r in done.values())
    assert all(r.status == "shed" and r.pred == -1 for r in shed.values())
    assert all(r.status == "timeout" and r.pred == -1
               for r in tout.values())
    return done, shed, tout


def _served_p99_ms(done):
    lat = [(r.t_done - r.t_submit) * 1e3 for r in done.values()]
    return float(np.percentile(lat, 99)) if lat else 0.0


# ---------------------------------------------------------------------------
# the seam itself
# ---------------------------------------------------------------------------

def test_transports_conform_to_protocol(env):
    _, fab, _ = _sim_fabric(env, parts=2, replicas=1)
    for t in fab.all_transports:
        assert isinstance(t, ReplicaTransport)
        assert isinstance(t, SimHostTransport)
    plan = plan_partitions(env.graph, 2, "locality", seed=0, halo_budget=32)
    fab2 = ServingFabric.from_plan(env.graph, plan, env.cfg, env.params,
                                   batch=2, device="cpu")
    for t in fab2.all_transports:
        assert isinstance(t, ReplicaTransport)
        assert isinstance(t, LoopbackTransport)


def test_clean_simhost_matches_loopback_preds(env):
    """A host boundary with zero modeled cost changes nothing observable
    but timing: same preds per rid as the default in-process fabric."""
    nodes = env.pool[:24]
    plan = plan_partitions(env.graph, 2, "locality", seed=0, halo_budget=32)
    loop = ServingFabric.from_plan(env.graph, plan, env.cfg, env.params,
                                   batch=4, replicas=2, seed=0, device="cpu")
    rids = _offer(loop, nodes)
    _, sim, _ = _sim_fabric(env)
    _offer(sim, nodes)
    done_l = {r.rid: r for r in loop.completed}
    done_s, _, _ = _assert_conserved(sim, rids)
    assert set(done_l) == set(done_s)
    for rid in rids:
        assert done_l[rid].pred == done_s[rid].pred
        assert np.array_equal(done_l[rid].logits, done_s[rid].logits)


# ---------------------------------------------------------------------------
# chaos: kill, delay, drop
# ---------------------------------------------------------------------------

def test_kill_replica_mid_burst_no_silent_loss(env):
    """Replica (0,0) dies after its 3rd delivered response, mid-burst.
    Its in-flight work times out, retries land on the surviving replica,
    and every request still ends in an explicit terminal state."""
    _, fab, _ = _sim_fabric(
        env, faults={(0, 0): FaultSpec(added_latency_ms=2,
                                       down_after_responses=3)},
        base=FaultSpec(added_latency_ms=2), timeout_ms=8)
    rids = _offer(fab, env.pool[:48], per_step=4)
    done, shed, tout = _assert_conserved(fab, rids)
    assert fab.replica_state[(0, 0)].state == "down"
    assert fab.fstats.timeouts > 0 and fab.fstats.retries > 0
    assert len(done) >= 40                       # survivors carried the load
    assert all(0 <= r.pred < env.graph.num_classes for r in done.values())
    snap = fab.fabric_stats()
    assert snap["replicas"]["0/0"]["health"] == "down"
    assert snap["replicas"]["0/0"]["lost_on_disconnect"] >= 0
    assert snap["timeouts"] == fab.fstats.timeouts


def test_slow_host_organically_drains(env):
    """One host 10× slower (20 ms vs 2 ms wire+service): the EWMA-
    weighted least-loaded dispatch routes the bulk of the load to the
    fast replica without any explicit weight configuration."""
    slow = FaultSpec(added_latency_ms=20.0)
    _, fab, _ = _sim_fabric(env, faults={(0, 1): slow, (1, 1): slow},
                            base=FaultSpec(added_latency_ms=2.0))
    rids = _offer(fab, env.pool[:90], per_step=3)
    _assert_conserved(fab, rids)
    for p in range(2):
        fast, slow_st = fab.replica_state[(p, 0)], fab.replica_state[(p, 1)]
        assert fast.completed >= 3 * max(slow_st.completed, 1)
        assert slow_st.state == "up"             # slow ≠ unhealthy
        if fast.ewma_ms is not None and slow_st.ewma_ms is not None:
            assert slow_st.ewma_ms > fast.ewma_ms


def test_dropped_responses_recovered_by_retry(env):
    """An 8% response-drop rate: the remote computed the answer but the
    fabric never saw it — timeouts fire, retries recover the requests,
    nothing is silently lost."""
    _, fab, _ = _sim_fabric(
        env, base=FaultSpec(drop_rate=0.08, added_latency_ms=2),
        timeout_ms=8, seed=3)
    rids = _offer(fab, env.pool[:80], per_step=4)
    done, shed, tout = _assert_conserved(fab, rids)
    dropped = sum(t.dropped_responses for t in fab.all_transports)
    assert dropped > 0
    assert fab.fstats.timeouts >= dropped        # every drop surfaced
    assert fab.fstats.retries > 0
    assert len(done) >= len(rids) - dropped      # retries recovered them


@pytest.mark.slow
def test_kill_at_peak_load_p99_bounded_and_bitexact(env):
    """The acceptance schedule: kill one replica at peak offered load,
    with SLO admission on.  Zero silently-lost requests; predictions
    that completed in BOTH runs are bit-exact; served p99 stays within
    1.5× the fault-free twin at the same offered load (capacity loss is
    paid in shed fraction, not tail latency)."""
    nodes = env.pool[:240]

    def run(faults):
        _, fab, _ = _sim_fabric(env, faults=faults,
                                base=FaultSpec(added_latency_ms=5),
                                timeout_ms=8, slo_p99_ms=25.0, seed=7)
        rids = _offer(fab, nodes, per_step=6)
        return fab, rids

    clean, rids = run(None)
    # the override REPLACES the base spec, so it must carry the base
    # wire cost too — otherwise the doomed replica is also magically fast
    chaos, _ = run({(0, 0): FaultSpec(added_latency_ms=5, down_at_ms=30.0)})
    done_c, shed_c, _ = _assert_conserved(clean, rids)
    done_f, shed_f, _ = _assert_conserved(chaos, rids)

    both = set(done_c) & set(done_f)
    assert len(both) >= 20
    for rid in both:                             # survivors bit-exact
        assert done_c[rid].pred == done_f[rid].pred
        assert np.array_equal(done_c[rid].logits, done_f[rid].logits)

    p99_c, p99_f = _served_p99_ms(done_c), _served_p99_ms(done_f)
    assert p99_f <= 1.5 * p99_c + 1e-9           # bounded tail
    assert chaos.slo.shed_fraction >= clean.slo.shed_fraction
    assert chaos.fstats.reroutes + chaos.fstats.retries > 0


@pytest.mark.slow
def test_fault_severity_sweep_sheds_monotonically(env):
    """Same offered load, rising injected drop rate: shed fraction rises
    monotonically while served p99 stays bounded — degradation is paid
    at the door, not in the tail."""
    fractions, p99s = [], []
    for rate in (0.0, 0.2, 0.45):
        _, fab, _ = _sim_fabric(
            env, base=FaultSpec(drop_rate=rate, added_latency_ms=5),
            timeout_ms=8, slo_p99_ms=25.0, seed=11)
        rids = _offer(fab, env.pool[:180], per_step=6)
        done, _, _ = _assert_conserved(fab, rids)
        fractions.append((fab.slo.shed + fab.fstats.timed_out) / len(rids))
        p99s.append(_served_p99_ms(done))
    assert fractions == sorted(fractions)
    assert fractions[-1] > fractions[0]
    for p in p99s:
        assert p <= 1.6 * 25.0                   # SLO envelope holds


# ---------------------------------------------------------------------------
# recovery + determinism
# ---------------------------------------------------------------------------

def test_recovered_replica_rejoins_dispatch(env):
    """down_at 10 ms, up_at 30 ms: the replica is marked down, probed
    after its cooldown, and completes fresh work after recovery."""
    plan, fab, _ = _sim_fabric(
        env, faults={(0, 0): FaultSpec(added_latency_ms=2, down_at_ms=10.0,
                                       up_at_ms=30.0)},
        base=FaultSpec(added_latency_ms=2), timeout_ms=6, down_retry_ms=8.0)
    pool0 = [v for v in env.pool if int(plan.owner_of([int(v)])[0]) == 0]
    assert len(pool0) >= 240
    completed_at_down = None
    i, rid = 0, 0
    for _ in range(150):
        for _ in range(2):
            if i < 240:
                fab.submit(GNNRequest(rid=rid, node=int(pool0[i])))
                i, rid = i + 1, rid + 1
        fab.step()
        st = fab.replica_state[(0, 0)]
        if st.state == "down" and completed_at_down is None:
            completed_at_down = st.completed
    fab.drain()
    _assert_conserved(fab, list(range(rid)))
    st = fab.replica_state[(0, 0)]
    assert completed_at_down is not None         # it DID go down
    assert st.state == "up"                      # and rejoined
    assert st.completed > completed_at_down      # with fresh work served
    assert fab.fstats.health_transitions >= 3    # up→suspect→down→up


def test_same_seed_same_schedule_identical_trace(env):
    """Same seed + same fault schedule ⇒ the identical per-request
    (replica, status, pred) trace across two fabric runs — dispatch,
    EWMA tie-breaks, drops and retries are all deterministic."""
    faults = {(0, 0): FaultSpec(added_latency_ms=3, jitter_ms=2,
                                drop_rate=0.1, down_at_ms=40.0)}

    def run():
        _, fab, _ = _sim_fabric(env, faults=faults,
                                base=FaultSpec(added_latency_ms=3,
                                               jitter_ms=1),
                                timeout_ms=9, seed=5, record_trace=True)
        _offer(fab, env.pool[:60], per_step=3)
        return fab

    a, b = run(), run()
    assert a.request_trace == b.request_trace
    assert len(a.request_trace) == 60
    assert a.fstats.asdict() == b.fstats.asdict()
    assert a.fabric_stats() == b.fabric_stats()


# ---------------------------------------------------------------------------
# refresh_topology × in-flight retries (the regression the seam exposed)
# ---------------------------------------------------------------------------

def test_refresh_topology_restamps_inflight_retries(env):
    """A request in flight on a replica that dies is reclaimed during
    ``refresh_topology``'s drain, lands back in the fabric queue, and is
    RE-STAMPED against the rebuilt fleet — new owner, new topology
    version — instead of being dropped or dispatched to a torn-down
    replica."""
    plan, fab, _ = _sim_fabric(env, base=FaultSpec(added_latency_ms=4),
                               timeout_ms=6)
    for rid, v in enumerate(env.pool[:12]):
        fab.submit(GNNRequest(rid=rid, node=int(v)))
    fab.step()                                   # dispatch onto the fleet
    assert fab.inflight
    fab.transports[0][0].kill()                  # host dies mid-flight
    new_plan = plan_partitions(env.graph, 2, "locality", seed=1,
                               halo_budget=32)
    fab.refresh_topology(new_plan)
    assert fab.fstats.retries > 0                # reclaimed, not dropped
    a = fab.audit()
    assert a["inflight"] == 0
    assert a["offered"] == (a["done"] + a["shed"] + a["timed_out"]
                            + a["pending"])
    for req in fab.pending:                      # re-stamped for the new plan
        assert req.topology_version == new_plan.topology_version
        assert req.partition == int(new_plan.owner_of([req.node])[0])
    fab.drain()
    done, shed, tout = _assert_conserved(fab, list(range(12)))
    assert len(done) == 12 and not shed and not tout
    for req in done.values():
        assert req.partition == int(new_plan.owner_of([req.node])[0])


def test_refresh_topology_pullback_without_timeouts(env):
    """Timeouts disabled + a dead host holding in-flight work: the
    refresh drain cannot resolve them, so they are pulled back and
    re-queued (retry budget untouched) rather than spinning forever or
    being dropped."""
    plan, fab, _ = _sim_fabric(env, base=FaultSpec(added_latency_ms=4),
                               timeout_ms=0.0)
    for rid, v in enumerate(env.pool[:12]):
        fab.submit(GNNRequest(rid=rid, node=int(v)))
    fab.step()
    stuck = [rid for rid, rec in fab.inflight.items()
             if rec.key == (0, 0)]
    assert stuck
    fab.transports[0][0].kill()
    fab.refresh_topology(plan)                   # same plan, rebuilt fleet
    assert fab.audit()["inflight"] == 0
    retries = {r.rid: r.retries for r in fab.pending}
    for rid in stuck:
        assert retries.get(rid) == 0             # pulled back, budget intact
    fab.drain()
    done, shed, tout = _assert_conserved(fab, list(range(12)))
    assert len(done) == 12


# ---------------------------------------------------------------------------
# differential: the port's fabric against the JAX package's
# ---------------------------------------------------------------------------

# (faults on one replica, fault spec of every other replica, fabric
# knobs, transport seed, queries, queries offered per step)
SCHEDULES = {
    "clean": (None, FaultSpec(added_latency_ms=2), dict(timeout_ms=8), 0,
              48, 4),
    "kill_mid_burst": ({(0, 0): FaultSpec(added_latency_ms=2,
                                          down_after_responses=3)},
                       FaultSpec(added_latency_ms=2), dict(timeout_ms=8), 0,
                       48, 4),
    "drop_8pct": (None, FaultSpec(drop_rate=0.08, added_latency_ms=2),
                  dict(timeout_ms=8), 3, 80, 4),
    "kill_at_peak_slo": ({(0, 0): FaultSpec(added_latency_ms=5,
                                            down_at_ms=30.0)},
                         FaultSpec(added_latency_ms=5),
                         dict(timeout_ms=8, slo_p99_ms=25.0), 7, 120, 6),
}


@pytest.fixture(scope="module")
def twins(smoke_graph):
    """The JAX smoke graph and trainer parameters, the port's graph from
    the same seed and those parameters carried across.  The default smoke
    fanout (5, 5) samples, so the trace also holds every replica's sampler
    stream to its twin's."""
    from repro.configs.gnn import gnn_config as jx_gnn_config
    cfg_j = jx_gnn_config("products", smoke=True, sampling_device="device")
    cfg_t = gnn_config("products", smoke=True, sampling_device="device")
    params_j = JxTrainer(smoke_graph, cfg_j, seed=0).params
    graph_t = dataset_like(cfg_t, seed=0)
    assert np.array_equal(graph_t.features, smoke_graph.features)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), "cpu")
    return SimpleNamespace(cfg_j=cfg_j, cfg_t=cfg_t, graph_j=smoke_graph,
                           graph_t=graph_t, params_j=params_j,
                           params_t=params_t)


def _run_twin(fabric_cls, req_cls, tmod, graph, plan, cfg, params, nodes,
              schedule, **device):
    faults, base, knobs, seed, _, per_step = schedule
    fab = fabric_cls.from_plan(
        graph, plan, cfg, params, batch=4, replicas=2, seed=0,
        transport_factory=tmod.sim_host_factory(
            faults=None if faults is None else {
                k: tmod.FaultSpec(**vars(f)) for k, f in faults.items()},
            base=tmod.FaultSpec(**vars(base)), seed=seed),
        clock=tmod.VirtualClock(tick_s=1e-3), record_trace=True,
        **knobs, **device)
    i = 0
    while i < len(nodes):
        for v in nodes[i:i + per_step]:
            fab.submit(req_cls(rid=i, node=int(v)))
            i += 1
        fab.step()
    fab.drain()
    return fab


def _stats_apart_from_ewma(fab):
    snap = fab.fabric_stats()
    ewma = {k: r.pop("ewma_ms") for k, r in snap["replicas"].items()}
    return snap, ewma


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_schedule_trace_matches_jax(twins, name):
    schedule = SCHEDULES[name]
    plan_j = jx_plan(twins.graph_j, 2, "locality", seed=0, halo_budget=32)
    plan_t = plan_partitions(twins.graph_t, 2, "locality", seed=0,
                             halo_budget=32)
    assert np.array_equal(plan_t.owner, plan_j.owner)
    nodes = np.random.default_rng(1).choice(twins.graph_j.num_nodes,
                                            schedule[4], replace=False)
    fj = _run_twin(JxFabric, JxRequest, jx_transport, twins.graph_j, plan_j,
                   twins.cfg_j, twins.params_j, nodes, schedule)
    ft = _run_twin(ServingFabric, GNNRequest, pt_transport, twins.graph_t,
                   plan_t, twins.cfg_t, twins.params_t, nodes, schedule,
                   device="cpu")

    assert len(ft.request_trace) == len(nodes)
    assert ft.request_trace == fj.request_trace
    assert all(type(e[4]) is int for e in ft.request_trace)
    assert ft.audit() == fj.audit()
    a = ft.audit()
    assert a["pending"] == a["inflight"] == 0
    assert a["offered"] == a["done"] + a["shed"] + a["timed_out"]
    snap_t, ewma_t = _stats_apart_from_ewma(ft)
    snap_j, ewma_j = _stats_apart_from_ewma(fj)
    assert snap_t == snap_j
    for key, st in ft.replica_state.items():
        want = fj.replica_state[key].ewma_ms
        assert (st.ewma_ms is None) == (want is None)
        if want is not None:
            assert abs(st.ewma_ms - want) <= 1e-9
    assert ewma_t.keys() == ewma_j.keys()
    done_j = {r.rid: r for r in fj.completed}
    done_t = {r.rid: r for r in ft.completed}
    assert done_t.keys() == done_j.keys() and done_t
    for rid, r in done_t.items():
        np.testing.assert_allclose(r.logits, done_j[rid].logits, atol=1e-5,
                                   rtol=0)
    if name.startswith("kill"):
        assert ft.replica_state[(0, 0)].state == "down"
        assert ft.fstats.timeouts > 0 and ft.fstats.retries > 0
    if name == "drop_8pct":
        assert sum(t.dropped_responses for t in ft.all_transports) > 0
    if name == "kill_at_peak_slo":
        assert ft.slo.shed > 0
