"""The port's serving fabric (``serve/fabric.py``) on the CPU: the
``ServingEngine`` contract, partition routing, replica weight refresh, SLO
admission and graceful degradation (the mirror of ``tests/test_fabric.py``),
topology-consistent serving under mid-serving edge inserts (the mirror of
``tests/test_dynamic_graph.py``'s serving part), the device seam (the tree
handed over as it is, a tree on another device refused, the halo rows
filled through the plane) and the launcher against the JAX package's.

The launcher comparison runs both packages' ``run_fabric_serve`` on the
smoke config, the port's trainer starting from the JAX trainer's initial
state: the same per-partition counts, the same predictions by rid with
logits within atol 1e-5 (after 4 training steps) and the same re-query
prediction.  Nothing there may depend on the host's clock:
``--slo-p99-ms 0`` turns shedding off, and both fabrics' ``EWMA_SNAP`` is
set to infinity, so dispatch is least-loaded alone (the response-time
EWMA reads the wall clock, and past a 2× ratio between two replicas it
would send a query to the other replica, whose sampler draws another
neighbourhood)."""
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import gnn_config
from repro_torch.core.a3gnn import A3GNNTrainer
from repro_torch.graph.partition import plan_partitions
from repro_torch.graph.synthetic import dataset_like
from repro_torch.models.params import leaves, tree_map
from repro_torch.serve.common import (EngineBase, LatencyStats, LatencyWindow,
                                      ServingEngine, SLOAdmission,
                                      latency_stats)
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.fabric import ServingFabric
from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest


@pytest.fixture(scope="module")
def graph():
    return dataset_like(gnn_config("products", smoke=True), seed=0)


@pytest.fixture(scope="module")
def cfg():
    return gnn_config("products", smoke=True)


def _trainer(graph, cfg):
    return A3GNNTrainer(graph, cfg, seed=0, device="cpu")


def _fabric(graph, cfg, params, parts=2, **kw):
    plan = plan_partitions(graph, parts, "locality", seed=0, halo_budget=32)
    return plan, ServingFabric.from_plan(graph, plan, cfg, params,
                                         device="cpu", **kw)


# ---------------------------------------------------------------------------
# the unified ServingEngine contract
# ---------------------------------------------------------------------------

def test_engines_and_fabric_conform_to_protocol(graph, cfg):
    from repro_torch.configs import get_config
    tr = _trainer(graph, cfg)
    gnn = GNNInferenceEngine.from_trainer(tr, batch=2, seed=0)
    lm = Engine(get_config("llama3.2-3b", smoke=True), batch=2, max_len=32,
                seed=0, device="cpu")
    _, fab = _fabric(graph, cfg, tr.params, batch=2)
    for eng in (gnn, lm, fab):
        assert isinstance(eng, ServingEngine)
        assert isinstance(eng, EngineBase)


def test_no_engine_local_contract_copies():
    """The concrete slot/drive machinery lives ONCE in EngineBase (the
    fabric legitimately overrides the slot views — they aggregate a
    fleet)."""
    for cls in (Engine, GNNInferenceEngine):
        for name in ("free_slots", "utilization", "run_to_completion",
                     "stats", "has_work"):
            assert getattr(cls, name) is getattr(EngineBase, name), (
                f"{cls.__name__}.{name} shadows EngineBase.{name}")
        assert "drain" not in vars(cls)


def test_fabric_is_dropin_for_one_engine(graph, cfg):
    """A drive loop written against one engine runs the fleet unchanged."""
    tr = _trainer(graph, cfg)
    _, fab = _fabric(graph, cfg, tr.params, batch=2)
    rng = np.random.default_rng(0)
    for rid, v in enumerate(rng.choice(graph.num_nodes, 9, replace=False)):
        fab.submit(GNNRequest(rid=rid, node=int(v)))
    stats = fab.run_to_completion()
    assert stats["completed"] == 9
    assert fab.utilization() == 0.0
    assert len(fab.free_slots()) == fab.batch
    assert isinstance(fab.stats(), LatencyStats)
    for req in fab.completed:
        assert req.status == "done"
        assert type(req.pred) is int
        assert 0 <= req.pred < graph.num_classes


# ---------------------------------------------------------------------------
# partition routing
# ---------------------------------------------------------------------------

def test_routing_follows_ownership(graph, cfg):
    tr = _trainer(graph, cfg)
    plan, fab = _fabric(graph, cfg, tr.params, parts=3, batch=2)
    rng = np.random.default_rng(1)
    nodes = rng.choice(graph.num_nodes, 30, replace=False)
    for rid, v in enumerate(nodes):
        fab.submit(GNNRequest(rid=rid, node=int(v)))
    fab.run_to_completion()
    expect = np.bincount(plan.owner_of(nodes), minlength=3)
    assert fab.partition_completed() == list(expect)
    for req in fab.completed:
        assert req.partition == int(plan.owner_of([req.node])[0])


def test_routing_isolates_partition_caches(graph, cfg):
    """Queries for partition 0's nodes move ONLY partition 0's cache
    accounting — requests run against the owner's plane."""
    tr = _trainer(graph, cfg)
    plan, fab = _fabric(graph, cfg, tr.params, batch=2)
    owned0 = np.where(plan.owner_of(np.arange(graph.num_nodes)) == 0)[0]
    marks = []
    for part in fab.engines:
        st = part[0].plane.stats
        marks.append(st.hits + st.misses)
    for rid, v in enumerate(owned0[:8]):
        fab.submit(GNNRequest(rid=rid, node=int(v)))
    fab.run_to_completion()
    st0 = fab.engines[0][0].plane.stats
    st1 = fab.engines[1][0].plane.stats
    assert st0.hits + st0.misses > marks[0]
    assert st1.hits + st1.misses == marks[1]


# ---------------------------------------------------------------------------
# replication + weight refresh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling_device", ["cpu", "device"])
def test_replicas_share_load_and_plane(graph, cfg, sampling_device):
    """Replicas of a partition share ONE plane — on a device plane, one
    cache table per partition, not one per replica."""
    cfg = cfg.replace(sampling_device=sampling_device)
    tr = _trainer(graph, cfg)
    _, fab = _fabric(graph, cfg, tr.params, batch=2, replicas=2)
    assert len(fab.all_engines) == 4                     # 2 parts × 2 reps
    for part in fab.engines:
        assert part[0].plane is part[1].plane            # one warmed cache
        assert all(e.device == torch.device("cpu") for e in part)
    rng = np.random.default_rng(2)
    for rid, v in enumerate(rng.choice(graph.num_nodes, 16, replace=False)):
        fab.submit(GNNRequest(rid=rid, node=int(v)))
    stats = fab.run_to_completion()
    assert stats["completed"] == 16
    if sampling_device == "device":
        assert len({id(p[0].plane._dev_table) for p in fab.engines}) == 2


def test_weight_refresh_is_bitexact_and_drops_nothing(graph):
    """Mid-serving refresh: logits after refresh_weights equal a fresh
    engine's with the same tree, bit for bit, and every request admitted
    before the refresh still retires done.  Full-neighborhood fanout
    makes sampling deterministic, so logits depend only on params."""
    cfg = gnn_config("products", smoke=True).replace(fanout=(64, 64))
    tr = _trainer(graph, cfg)
    plan, fab = _fabric(graph, cfg, tr.params, batch=2, replicas=2)
    probe = int(np.where(plan.owner_of(np.arange(graph.num_nodes)) == 0)[0][0])

    fab.submit(GNNRequest(rid=0, node=probe))
    fab.run_to_completion()
    before = fab.completed[-1].logits.copy()

    rng = np.random.default_rng(3)
    for rid, v in enumerate(rng.choice(graph.num_nodes, 10, replace=False)):
        fab.submit(GNNRequest(rid=100 + rid, node=int(v)))
    fab.step()
    tr.run_epochs(1, max_steps_per_epoch=2)
    fab.refresh_weights(tr.get_weights())
    fab.run_to_completion()
    assert fab.total_completed == 1 + 10               # none dropped
    assert all(r.status == "done" for r in fab.completed)

    fab.submit(GNNRequest(rid=1, node=probe))
    fab.run_to_completion()
    after = fab.completed[-1].logits

    ref = GNNInferenceEngine(plan.subgraphs[0], cfg,
                             tr.get_weights()["params"], batch=2, seed=99,
                             node_map=plan.node_maps()[0], device="cpu")
    ref.submit(GNNRequest(rid=2, node=probe))
    ref.run_to_completion()
    assert np.array_equal(after, ref.completed[-1].logits)     # bit-exact
    assert not np.array_equal(after, before)                   # and fresh


def test_from_trainer_refresh_pulls_source(graph, cfg):
    """With no argument the fabric pulls the trainer's exported tree and
    hands it to every replica as it is — the same tensors, not copies."""
    from repro_torch.core.multipart import MultiPartitionTrainer
    mp = MultiPartitionTrainer(graph, cfg.replace(partitions=2), seed=0,
                               device="cpu")
    fab = ServingFabric.from_trainer(mp, batch=2, seed=0)
    assert fab.device == mp.device
    old = mp.get_weights()["params"]
    mp.global_step()
    want = mp.get_weights()["params"]
    assert all(eng.params is old for eng in fab.all_engines)
    fab.refresh_weights()                   # no args: pulls from the trainer
    for eng in fab.all_engines:
        assert eng.params is want
        assert all(a is b for a, b in zip(leaves(eng.params), leaves(want)))
    assert not all(torch.equal(a, b) for a, b in zip(leaves(old),
                                                      leaves(want)))


# ---------------------------------------------------------------------------
# the device seam
# ---------------------------------------------------------------------------

def test_params_on_another_device_are_refused(graph, cfg):
    tr = _trainer(graph, cfg)
    elsewhere = tree_map(lambda t: t.to("meta"), tr.params)
    with pytest.raises(ValueError, match="parameters on meta"):
        _fabric(graph, cfg, elsewhere, batch=2)
    _, fab = _fabric(graph, cfg, tr.params, batch=2)
    with pytest.raises(ValueError, match="fabric on cpu"):
        fab.refresh_weights({"params": elsewhere})
    assert all(eng.params is tr.params for eng in fab.all_engines)


@pytest.mark.parametrize("sampling_device", ["cpu", "device"])
def test_from_plan_halo_rows_reach_the_plane(graph, cfg, sampling_device):
    """``from_plan`` fills each partition's halo rows through its plane:
    every halo row a plane returns equals the owner's row, and on a device
    plane the resident ones come out of the table on the device."""
    cfg = cfg.replace(sampling_device=sampling_device, cache_volume_mb=40.0)
    tr = _trainer(graph, cfg)
    plan, fab = _fabric(graph, cfg, tr.params, batch=2, replicas=2)
    assert plan.halo_rows > 0
    owner_local = plan.local_ids()
    for p, (ns, hs) in enumerate(zip(plan.node_sets, plan.halo_sets)):
        plane = fab.engines[p][0].plane
        local = np.arange(len(ns), len(ns) + len(hs))
        want = np.stack([plan.subgraphs[q].features[owner_local[v]]
                         for q, v in zip(plan.owner[hs], hs)])
        assert np.array_equal(want, graph.features[hs])
        assert plane.cache.is_cached(local).all()        # Θ holds them all
        assert np.array_equal(plane.fetch(local), want)
        if sampling_device == "device":
            slots = torch.from_numpy(plane.cache.device_map[local]).long()
            assert torch.equal(plane._dev_table[slots],
                               torch.from_numpy(want))


# ---------------------------------------------------------------------------
# SLO admission + shedding
# ---------------------------------------------------------------------------

def _fake_req(submit, first, done):
    return GNNRequest(rid=-1, node=0, t_submit=submit, t_first=first,
                      t_done=done)


def test_slo_admission_verdicts():
    win = LatencyWindow(64)
    slo = SLOAdmission(10.0, win, slots=2)
    assert slo.on_offer(100) == "admit"                # cold window: learn
    for i in range(8):                                 # service ≈ 4 ms
        win.record(_fake_req(i * 0.01, i * 0.01 + 0.001, i * 0.01 + 0.005))
    assert slo.on_offer(0) == "admit"
    assert slo.on_offer(50) == "shed"                  # 50·4/2 ≫ 10 ms
    assert slo.on_dispatch(1.0, True) == "admit"
    assert slo.on_dispatch(1.0, False) == "defer"
    assert slo.on_dispatch(9.5, True) == "shed"        # age + service > slo
    assert slo.offered == 3 and slo.shed == 2
    assert slo.deferrals == 1
    disabled = SLOAdmission(0.0, win, slots=2)
    assert disabled.on_offer(10_000) == "admit"        # SLO off: defer-only


def test_fabric_shed_is_explicit(graph, cfg):
    """A shed request retires with status='shed' and the −1 pred
    sentinel — never a fabricated prediction."""
    tr = _trainer(graph, cfg)
    _, fab = _fabric(graph, cfg, tr.params, batch=2, slo_p99_ms=5.0)
    now = time.perf_counter()
    for i in range(16):                                # service ≈ 20 ms
        fab.window.record(_fake_req(now, now + 0.001, now + 0.021))
    rng = np.random.default_rng(4)
    for rid, v in enumerate(rng.choice(graph.num_nodes, 12, replace=False)):
        fab.submit(GNNRequest(rid=rid, node=int(v)))
    assert fab.slo.shed > 0
    for req in fab.shed_requests:
        assert req.status == "shed"
        assert req.pred == -1
        assert req.logits is None
    assert all(r.rid not in {s.rid for s in fab.shed_requests}
               for r in fab.completed)


@pytest.mark.slow
def test_saturation_degrades_gracefully(graph, cfg):
    """Past saturation: shed fraction rises monotonically with offered
    load while every ADMITTED request's queue age stays inside the SLO
    envelope."""
    slo_ms = 5.0
    tr = _trainer(graph, cfg)
    _, fab = _fabric(graph, cfg, tr.params, batch=2, slo_p99_ms=0.0)
    rng = np.random.default_rng(5)
    pool = rng.choice(graph.num_nodes, 160, replace=False)
    for w in range(3):                                 # warm: set-up + regime
        for rid, v in enumerate(pool[:16]):
            fab.submit(GNNRequest(rid=-100 * w - rid, node=int(v)))
        fab.run_to_completion()

    fab.slo.slo_p99_ms = slo_ms
    fractions = []
    for burst in (4, 32, 128):                         # rising offered load
        mark_off, mark_shed = fab.slo.offered, fab.slo.shed
        for rid, v in enumerate(pool[:burst]):
            fab.submit(GNNRequest(rid=1000 * burst + rid, node=int(v)))
        fab.run_to_completion()
        off = fab.slo.offered - mark_off
        fractions.append((fab.slo.shed - mark_shed) / off)
    assert fractions == sorted(fractions)              # monotone degradation
    assert fractions[-1] > 0.0
    done = [r for r in fab.completed if r.rid >= 0]
    assert done
    for req in done:                                   # bounded queue age
        assert (req.t_first - req.t_submit) * 1e3 <= slo_ms + 500.0


# ---------------------------------------------------------------------------
# latency accounting
# ---------------------------------------------------------------------------

def test_latency_window_rolls_and_memoizes():
    win = LatencyWindow(4)
    for i in range(6):
        win.record(_fake_req(float(i), i + 0.010, i + 0.030))
    assert len(win) == 4                               # oldest evicted
    st = win.stats()
    assert st is win.stats()                           # memoized between records
    assert st.window == 4
    assert st.ttft_p50_ms == pytest.approx(10.0, rel=1e-6)
    assert st.p50_ms == pytest.approx(30.0, rel=1e-6)
    assert st.service_p50_ms == pytest.approx(20.0, rel=1e-6)
    win.record(_fake_req(9.0, 9.1, 9.2))
    assert win.stats() is not st                       # record invalidates
    win.reset()
    assert win.stats() == LatencyStats()


def test_latency_stats_typed_and_dict_shape():
    reqs = [_fake_req(0.0, 0.010, 0.020), _fake_req(0.0, 0.020, 0.100)]
    st = latency_stats(reqs)
    assert isinstance(st, LatencyStats)
    d = st.asdict()
    assert set(d) == {"p50_ms", "p99_ms", "ttft_p50_ms", "ttft_p99_ms",
                      "service_p50_ms", "qps", "window"}
    assert d["window"] == 2
    assert latency_stats([]) == LatencyStats()

    lm_req = Request(rid=0, prompt=np.array([1, 2], np.int32),
                     max_new_tokens=1)
    lm_req.t_submit, lm_req.t_first, lm_req.t_done = 0.0, 0.005, 0.015
    assert latency_stats([lm_req]).ttft_p50_ms == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# topology-consistent serving: admitted queries are immune to mid-serving
# edge inserts; a mutation reaches serving only through refresh_topology
# ---------------------------------------------------------------------------

def _serving_pair(seed=17, parts=2):
    """Two identically-built (graph, plan, fabric) rigs — mutate one
    mid-serving, leave its twin frozen, and compare."""
    rigs = []
    cfg = gnn_config("products", smoke=True)
    params = None
    for _ in range(2):
        g = dataset_like(cfg, seed=seed)
        plan = plan_partitions(g, parts, "locality", seed=0, halo_budget=0)
        if params is None:
            params = A3GNNTrainer(g, cfg, seed=0, device="cpu").params
        fab = ServingFabric.from_plan(g, plan, cfg, params, batch=2, seed=0,
                                      device="cpu")
        rigs.append((g, plan, fab))
    return rigs


def test_midserving_inserts_do_not_change_admitted_predictions():
    (g_mut, _, fab_mut), (_, _, fab_frozen) = _serving_pair()
    nodes = [3, 41, 77, 200, 515, 999]
    v0 = fab_mut.topology_version
    for i, n in enumerate(nodes):
        fab_mut.submit(GNNRequest(rid=i, node=n))
        fab_frozen.submit(GNNRequest(rid=i, node=n))
    # mutate AFTER admission, BEFORE any serving step ran
    rng = np.random.default_rng(2)
    assert g_mut.add_edges(rng.integers(0, g_mut.num_nodes, 500),
                           rng.integers(0, g_mut.num_nodes, 500)) > 0
    assert g_mut.topology_version > v0
    fab_mut.run_to_completion()
    fab_frozen.run_to_completion()
    assert fab_mut.topology_version == v0           # not yet refreshed
    a = {r.rid: r for r in fab_mut.completed}
    b = {r.rid: r for r in fab_frozen.completed}
    assert set(a) == set(b) == set(range(len(nodes)))
    for rid in a:
        assert a[rid].topology_version == v0        # pre-bump stamp
        assert a[rid].pred == b[rid].pred
        np.testing.assert_array_equal(a[rid].logits, b[rid].logits)


def test_refresh_topology_adopts_new_plan_and_restamps():
    (g, _, fab), _ = _serving_pair()
    rng = np.random.default_rng(5)
    g.add_edges(rng.integers(0, g.num_nodes, 300),
                rng.integers(0, g.num_nodes, 300))
    new_plan = plan_partitions(g, 2, "locality", seed=0, halo_budget=0)
    assert new_plan.topology_version == g.topology_version
    fab.submit(GNNRequest(rid=0, node=7))           # queued pre-refresh
    old_v = fab.topology_version
    fab.refresh_topology(plan=new_plan)
    assert fab.topology_version == g.topology_version > old_v
    assert all(e.device == fab.device for e in fab.all_engines)
    assert fab.pending[0].topology_version == fab.topology_version
    assert fab.pending[0].partition == int(new_plan.owner_of([7])[0])
    fab.run_to_completion()
    assert fab.completed[-1].status == "done"
    fab.submit(GNNRequest(rid=1, node=11))
    assert fab.pending[0].topology_version == fab.topology_version
    fab.run_to_completion()


def test_refresh_topology_rejects_partition_count_change():
    (g, _, fab), _ = _serving_pair()
    plan3 = plan_partitions(g, 3, "locality", seed=0)
    with pytest.raises(ValueError, match="partition count"):
        fab.refresh_topology(plan=plan3)


def test_refresh_topology_pulls_the_trainer(graph, cfg):
    """With no argument the rebuilt fleet serves the trainer's current
    plan, planes and parameters, on the trainer's device."""
    from repro_torch.core.multipart import MultiPartitionTrainer
    mp = MultiPartitionTrainer(graph, cfg.replace(partitions=2), seed=0,
                               device="cpu")
    fab = ServingFabric.from_trainer(mp, batch=2, replicas=2, seed=0)
    mp.global_step()
    fab.refresh_topology()
    for p, part in enumerate(fab.engines):
        for eng in part:
            assert eng.plane is mp.slots[p].pipe.plane
            assert eng.params is mp.params
            assert eng.device == mp.device
    fab.submit(GNNRequest(rid=0, node=5))
    fab.run_to_completion()
    assert fab.completed[-1].status == "done"


# ---------------------------------------------------------------------------
# the launcher, against the JAX package's
# ---------------------------------------------------------------------------

SMOKE_ARGV = ["--gnn", "--arch", "graphsage-products", "--smoke", "--device",
              "cpu", "--sampling-device", "device", "--partitions", "2",
              "--replicas", "2", "--queries", "16", "--batch", "2"]


def test_launcher_fabric_matches_jax(monkeypatch, capsys):
    from repro.core.multipart import MultiPartitionTrainer as JxMulti
    from repro.launch import serve as jx_serve
    from repro.serve.fabric import ServingFabric as JxFabric
    from repro_torch.core.multipart import MultiPartitionTrainer
    from repro_torch.launch.serve import build_parser, run_gnn_serve
    from repro_torch.models.convert import opt_state_from_jax, params_from_jax

    args = build_parser().parse_args(SMOKE_ARGV + ["--slo-p99-ms", "0"])
    # the JAX run: capture its trainer's initial state and its fabric
    seen = {}
    jx_init, jx_from_trainer = JxMulti.__init__, JxFabric.from_trainer

    def init(self, *a, **kw):
        jx_init(self, *a, **kw)
        seen["state"] = jax.tree.map(np.asarray, {
            "params": self.params, "opt_state": self.opt_state})

    def from_trainer(*a, **kw):
        seen["fabric"] = jx_from_trainer(*a, **kw)
        return seen["fabric"]

    monkeypatch.setattr(JxMulti, "__init__", init)
    monkeypatch.setattr(JxFabric, "from_trainer", from_trainer)
    monkeypatch.setattr(JxFabric, "EWMA_SNAP", float("inf"))
    monkeypatch.setattr(ServingFabric, "EWMA_SNAP", float("inf"))
    from repro.configs import get_config as jx_get_config
    from repro.graph.synthetic import dataset_like as jx_dataset
    jcfg = jx_get_config(args.arch, smoke=True).replace(
        sampling_device="device")
    assert jx_serve.run_fabric_serve(args, jcfg,
                                     jx_dataset(jcfg, seed=0)) == 0
    jx_out = capsys.readouterr().out
    monkeypatch.setattr(JxMulti, "__init__", jx_init)

    # the port's run, its trainer starting from the JAX trainer's state
    pt_init = MultiPartitionTrainer.__init__

    def init_from_jax(self, *a, **kw):
        pt_init(self, *a, **kw)
        self.load_state_dict({
            "params": params_from_jax(seen["state"]["params"], "cpu"),
            "opt_state": opt_state_from_jax(seen["state"]["opt_state"],
                                            "cpu")})

    monkeypatch.setattr(MultiPartitionTrainer, "__init__", init_from_jax)
    rep = run_gnn_serve(args)
    pt_out = capsys.readouterr().out
    for tag in ("[data]", "[train]", "[fabric]", "[refresh]", "[slo]"):
        assert tag in pt_out

    def line(out, tag):
        return next(x for x in out.splitlines() if x.startswith(tag))

    jfab, fab = seen["fabric"], rep["fabric"]
    assert rep["per_partition"] == [int(x) for x in line(
        jx_out, "[fabric]").split("per-partition [")[1].split("]")[0]
        .split(",")]
    assert fab.slo.shed == jfab.slo.shed == 0
    assert fab.audit() == jfab.audit()
    jdone = {r.rid: r for r in jfab.completed}
    served = rep["served"]
    assert [r.rid for r in served] == list(range(16))
    for r in served:
        want = jdone[r.rid]
        assert r.partition == want.partition
        assert r.pred == want.pred
        np.testing.assert_allclose(r.logits, want.logits, atol=1e-5, rtol=0)
    assert f"pred={rep['requery'].pred} " in line(jx_out, "[refresh]")
    assert rep["held_before_refresh"][0] is rep["warm_params"]
    assert all(eng.params is rep["trainer"].params for eng in fab.all_engines)
    assert set(rep["launches"]) == {"train", "warm", "load", "refresh",
                                    "burst"}
    assert all(n == 0 for n in rep["launches"].values())   # plain on the CPU
    assert rep["dispatches"]["load"] > 0
