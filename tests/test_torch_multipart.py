"""The multi-partition slice on the CPU (``core/multipart.py``,
``distributed/collectives.py``, ``launch/mesh.py``, ``launch/train.py
--partitions``), the port against the JAX package where both run.

Tolerances follow ``tests/test_torch_train.py``: one synced step within
atol 1e-5; losses over 4 fused global steps within rel 1e-4 (Adam's
normalisation magnifies f32 rounding in the gradients); the gradient mean,
the halo rows and volume, cache and halo statistics, ``global_steps`` and
modeled memory exactly equal (numpy on both sides, or bit-identical
sampled batches).  The JAX side runs its own CPU path (the fused step
with ``use_pallas=False``) under a static cache: its device plane races
under FIFO on a CPU host.  The rest mirror ``tests/test_multipartition.py``,
``tests/test_halo.py`` and ``tests/test_streaming.py`` on the port."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.core.multipart import MultiPartitionTrainer as JxMulti
from repro.distributed.collectives import grad_allreduce as jx_allreduce
from repro.distributed.collectives import halo_all_to_all as jx_halo
from repro.graph.partition import plan_partitions as jx_plan
from repro.graph.synthetic import dataset_like as jx_dataset
from repro.launch.mesh import HostSimMesh as JxHostSimMesh
from repro_torch.configs.gnn import AutotuneConfig, gnn_config
from repro_torch.core.a3gnn import A3GNNTrainer, make_trainer
from repro_torch.core.multipart import MultiPartitionTrainer
from repro_torch.core.sampling import NeighborSampler, seed_loader
from repro_torch.distributed.collectives import (grad_allreduce,
                                                 halo_all_to_all)
from repro_torch.graph.batch import batch_device_arrays, generate_batch
from repro_torch.graph.partition import plan_partitions
from repro_torch.graph.storage import FeatureStore
from repro_torch.graph.synthetic import dataset_like
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import (GroupMesh, HostSimMesh,
                                     make_partition_mesh)
from repro_torch.launch.train import main
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.models.params import leaves, unflatten
from repro_torch.train.checkpoint import CheckpointManager

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(**kw):
    return gnn_config("products", smoke=True, **kw)


@pytest.fixture(scope="module")
def graph():
    return dataset_like(_cfg(), seed=0)


def _mutable_graph(seed=0):
    """Tests that mutate the graph never share the module fixture."""
    return dataset_like(_cfg(), seed=seed)


def _shutdown(tr):
    for s in tr.slots:
        s.pipe.shutdown()


def _from_jax(tr, jtr):
    tr.load_state_dict({"params": params_from_jax(_np(jtr.params), "cpu"),
                        "opt_state": opt_state_from_jax(_np(jtr.opt_state),
                                                        "cpu")})


# ---------------------------------------------------------------------------
# mesh + collectives
# ---------------------------------------------------------------------------

def test_partition_mesh_host_simulated_when_devices_scarce(monkeypatch,
                                                             tmp_path):
    # inside a group of P processes (here one): the group; of another
    # size: refused
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_partition_mesh(1, "cpu")
        assert isinstance(mesh, GroupMesh)
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        with pytest.raises(ValueError, match="group of 1"):
            make_partition_mesh(2, "cpu")
    finally:
        dist.destroy_process_group()
    for n in (1, 2, 4):
        mesh = make_partition_mesh(n, "cpu")
        assert isinstance(mesh, HostSimMesh)
        assert mesh.shape == {"part": n} and mesh.axis_names == ("part",)
    # a card per partition and no group: one process per card is the
    # launcher's to spawn, and the mesh is refused, not quietly simulated
    monkeypatch.setattr(mesh_mod, "device_count", lambda device: 4)
    assert isinstance(make_partition_mesh(1, "cuda"), HostSimMesh)
    with pytest.raises(RuntimeError, match="launch.train --partitions 2 "
                                           "spawns them"):
        make_partition_mesh(2, "cuda")
    assert isinstance(make_partition_mesh(8, "cuda"), HostSimMesh)
    with pytest.raises(NotImplementedError, match="GroupMesh"):
        grad_allreduce(object())


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_grad_allreduce_bit_equal_to_jax_host_mean(parts):
    rng = np.random.default_rng(parts)
    trees = [{"layers": [{"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
                          "b": rng.normal(0, 1, (3,)).astype(np.float32)}
                         for _ in range(2)]} for _ in range(parts)]
    want = jx_allreduce(JxHostSimMesh(parts))(
        [jax.tree.map(jax.numpy.asarray, t) for t in trees])
    got = grad_allreduce(HostSimMesh(parts))(
        [params_from_jax(t, "cpu") for t in trees])
    for a, b in zip(jax.tree.leaves(want), leaves(got), strict=True):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_halo_all_to_all_equals_jax(graph):
    jg = jx_dataset(jx_gnn_config("products", smoke=True), seed=0)
    plan = plan_partitions(graph, 3, "locality", seed=0, halo_budget=16)
    jplan = jx_plan(jg, 3, "locality", seed=0, halo_budget=16)
    owned = [sub.features[:len(ns)] for sub, ns in
             zip(plan.subgraphs, plan.node_sets)]
    rows, volume = halo_all_to_all(HostSimMesh(3))(plan, owned)
    jrows, jvolume = jx_halo(JxHostSimMesh(3))(
        jplan, [sub.features[:len(ns)] for sub, ns in
                zip(jplan.subgraphs, jplan.node_sets)])
    assert volume == jvolume == plan.halo_rows * graph.feat_dim * 4 > 0
    for p, (a, b) in enumerate(zip(rows, jrows, strict=True)):
        assert np.array_equal(a, b)
        np.testing.assert_array_equal(a, graph.features[plan.halo_sets[p]])


# ---------------------------------------------------------------------------
# gradient parity: the synced step
# ---------------------------------------------------------------------------

def test_two_partition_step_matches_single_and_jax(graph):
    """On the same mini-batch, the 2-partition synchronized update (grad →
    all-reduce → shared apply) matches the port's single-partition step
    and the JAX ``synced_update`` from the converted parameters."""
    cfg = _cfg()
    jcfg = jx_gnn_config("products", smoke=True, partitions=2)
    jtr = JxMulti(jx_dataset(jcfg, seed=0), jcfg, seed=0)
    single = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    multi = make_trainer(graph, cfg.replace(partitions=2), seed=0,
                         device="cpu")
    assert isinstance(multi, MultiPartitionTrainer)
    _from_jax(single, jtr)
    _from_jax(multi, jtr)
    sampler = NeighborSampler(graph, cfg.fanout, seed=7)
    arrays = [batch_device_arrays(generate_batch(sampler.sample(s), None,
                                                 graph))
              for s in list(seed_loader(graph, cfg.batch_size, 7))[:2]]
    t = torch.from_numpy
    p1, _, _, _ = single._step(single.params, single.opt_state,
                               t(arrays[0]["features"]),
                               [t(i) for i in arrays[0]["neigh_idxs"]],
                               t(arrays[0]["labels"]))
    multi.synced_update([arrays[0], arrays[0]])    # both: the same batch
    for a, b in zip(leaves(p1), leaves(multi.params), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    # different batches: the JAX trainer's synced update, then the mean
    loss = multi.synced_update(arrays)
    jtr.synced_update([arrays[0], arrays[0]])
    jloss = jtr.synced_update(arrays)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert multi.global_steps == jtr.global_steps == 2
    assert multi.opt_state["count"] == int(jtr.opt_state["count"]) == 2
    for a, b in zip(jax.tree.leaves(jtr.params), leaves(multi.params),
                    strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    g1, _, _ = multi._grad(multi.params, t(arrays[0]["features"]),
                           [t(i) for i in arrays[0]["neigh_idxs"]],
                           t(arrays[0]["labels"]))
    g2, _, _ = multi._grad(multi.params, t(arrays[1]["features"]),
                           [t(i) for i in arrays[1]["neigh_idxs"]],
                           t(arrays[1]["labels"]))
    mean = multi._allreduce([g1, g2])
    for m, a, b in zip(leaves(mean), leaves(g1), leaves(g2), strict=True):
        assert torch.equal(m, (a + b) / 2.0)


def test_grad_plus_apply_is_the_single_step_bit_for_bit(graph):
    cfg = _cfg()
    single = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    multi = MultiPartitionTrainer(graph, cfg, seed=0, device="cpu")
    sampler = NeighborSampler(graph, cfg.fanout, seed=3)
    seeds = next(seed_loader(graph, cfg.batch_size, 3))
    arrays = batch_device_arrays(generate_batch(sampler.sample(seeds), None,
                                                graph))
    t = torch.from_numpy
    inputs = (t(arrays["features"]), [t(i) for i in arrays["neigh_idxs"]],
              t(arrays["labels"]))
    p1, s1, _, _ = single._step(single.params, single.opt_state, *inputs)
    multi.synced_update([arrays])                  # one partition: no mean
    for a, b in zip(leaves(p1) + leaves(s1),
                    leaves(multi.params) + leaves(multi.opt_state),
                    strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ---------------------------------------------------------------------------
# the whole trainer against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_fused_fit_supervised_matches_jax(model, tmp_path):
    kw = dict(smoke=True, model=model, partitions=2, halo_budget=32,
              fused_gather_agg=True, sampling_device="device",
              cache_policy="static", cache_volume_mb=0.1)
    jcfg, cfg = jx_gnn_config("products", **kw), gnn_config("products", **kw)
    jtr = JxMulti(jx_dataset(jcfg, seed=0), jcfg, seed=0)
    tr = MultiPartitionTrainer(dataset_like(cfg, seed=0), cfg, seed=0,
                               device="cpu")
    try:
        _from_jax(tr, jtr)
        assert tr.halo_exchange_bytes == jtr.halo_exchange_bytes > 0
        jrep = jtr.fit_supervised(4, tmp_path / "jax", ckpt_every=2)
        rep = tr.fit_supervised(4, tmp_path / "port", ckpt_every=2)
        assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
        assert tr.global_steps == jtr.global_steps == 4
        assert tr._grad_allfused.counters["calls"] == 8
        for s, js in zip(tr.slots, jtr.slots, strict=True):
            assert s.pipe.plane.device == torch.device("cpu")
            assert len(s.pipe.stats.losses) == 4
            assert np.isfinite(s.pipe.stats.losses).all()
            np.testing.assert_allclose(s.pipe.stats.losses,
                                       js.pipe.stats.losses, rtol=1e-4,
                                       atol=0)
            assert dataclasses.asdict(s.cache.stats) == \
                dataclasses.asdict(js.cache.stats)
            assert dataclasses.asdict(s.halo_stats) == \
                dataclasses.asdict(js.halo_stats)
            assert s.pipe.stats.peak_batch_bytes == \
                js.pipe.stats.peak_batch_bytes
        assert 0 < tr.cache_hit_rate == jtr.cache_hit_rate < 1
        assert tr.halo_hit_rate == jtr.halo_hit_rate > 0
        st, jst = tr.slots[0].pipe.stats, jtr.slots[0].pipe.stats
        assert tr.modeled_memory(st) == jtr.modeled_memory(jst)
        assert tr.modeled_memory(st, "mode1", 4) == \
            jtr.modeled_memory(jst, "mode1", 4)
        assert tr.checkpoint_extra()["cache_stats"] == \
            jtr.checkpoint_extra()["cache_stats"]
        # the JAX trainer restores the port's committed checkpoint
        jtr2 = JxMulti(jtr.full_graph, jcfg, seed=1)
        from repro.train.checkpoint import CheckpointManager as JxManager
        assert jtr2.restore(JxManager(tmp_path / "port",
                                      async_save=False)) == 4
        for a, b in zip(jax.tree.leaves(jtr2.params), leaves(tr.params),
                        strict=True):
            assert np.array_equal(np.asarray(a), b.numpy())
        assert [dataclasses.asdict(s.halo_stats) for s in jtr2.slots] == \
            [dataclasses.asdict(s.halo_stats) for s in tr.slots]
        _shutdown(jtr2)
    finally:
        _shutdown(tr)
        _shutdown(jtr)


# ---------------------------------------------------------------------------
# checkpoint → rebuild → restore (mirrors tests/test_multipartition.py)
# ---------------------------------------------------------------------------

def test_checkpoint_rebuild_restore_roundtrip(graph, tmp_path):
    cfg = _cfg(partitions=2)
    tr = make_trainer(graph, cfg, seed=0, device="cpu")
    rep = tr.fit_supervised(4, tmp_path / "ckpt", ckpt_every=2)
    assert rep.steps_run == 4 and rep.checkpoints >= 1
    hit_stats = [dataclasses.asdict(s.cache.stats) for s in tr.slots]
    assert any(st["hits"] + st["misses"] > 0 for st in hit_stats)

    # rebuild from scratch (the restart path) and restore
    tr2 = make_trainer(graph, cfg, seed=1, device="cpu")  # another init
    mgr = CheckpointManager(tmp_path / "ckpt", async_save=False)
    step = tr2.restore(mgr)
    assert step == 4 and tr2.global_steps == 4
    for a, b in zip(leaves(tr.state_dict()), leaves(tr2.state_dict()),
                    strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert tr2.opt_state["count"] == 4
    # cache hit-accounting survives the rebuild
    assert [dataclasses.asdict(s.cache.stats) for s in tr2.slots] == hit_stats
    # and training resumes
    tr2.global_step()
    assert tr2.global_steps == 5
    _shutdown(tr)
    _shutdown(tr2)


def test_restore_rejects_partition_count_change(graph, tmp_path):
    tr = make_trainer(graph, _cfg(partitions=2), seed=0, device="cpu")
    mgr = CheckpointManager(tmp_path / "ckpt", async_save=False)
    tr.save(mgr, step=1)
    tr3 = make_trainer(graph, _cfg(partitions=3), seed=0, device="cpu")
    with pytest.raises(ValueError, match="partitions=2"):
        tr3.restore(mgr)
    single = A3GNNTrainer(graph, _cfg(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="partitions=2"):
        single.restore(mgr)
    # explicit migration acknowledgement goes through (the restart path)
    assert tr3.restore(mgr, expect_partitions=2) == 1
    for a, b in zip(leaves(tr.params), leaves(tr3.params), strict=True):
        assert torch.equal(a, b)


def test_supervisor_restores_multipartition_on_failure(graph, tmp_path):
    tr = make_trainer(graph, _cfg(partitions=2), seed=0, device="cpu")
    rep = tr.fit_supervised(5, tmp_path / "ckpt", ckpt_every=2,
                            fail_at_step=3)
    assert rep.failures == 1 and rep.restores == 1
    assert rep.final_step == 5                   # resumed to completion
    assert tr.opt_state["count"] == 5            # the lost step was replayed
    _shutdown(tr)


def test_multipartition_run_epochs_and_refusals(graph):
    tr = make_trainer(graph, _cfg(partitions=2), seed=0, device="cpu")
    res = tr.run_epochs(1, max_steps_per_epoch=3)
    assert res.stats.steps == 6                  # 3 global × 2 partitions
    assert np.isfinite(res.stats.losses).all()
    assert res.modeled_steps_s > 0 and res.memory_bytes > 0
    assert all(s.cache.stats.hits + s.cache.stats.misses > 0
               for s in tr.slots)
    # the autotune hooks fan out to every partition
    tr.apply_live_config({"bias_rate": 4.0, "cache_volume_mb": 0.2})
    assert tr.cfg.bias_rate == 4.0
    assert all(s.weight_fn is not None and s.cache.volume_mb == 0.2
               for s in tr.slots)
    rep = tr.fit_autotuned(AutotuneConfig(
        episodes=2, steps_per_episode=2, warmup_steps=0, presample=8,
        surrogate_trees=4, ppo_updates=1, ppo_horizon=2, seed=0))
    assert [ep.steps for ep in rep.episodes] == [4, 4]   # 2 global × 2
    assert tr.global_steps == 3 + 4 and rep.final_trainer is tr


# ---------------------------------------------------------------------------
# halo (mirrors tests/test_halo.py)
# ---------------------------------------------------------------------------

def test_budget_zero_is_the_drop_cut_edges_plan(graph):
    plan = plan_partitions(graph, 3, "locality", seed=0, halo_budget=0)
    assert plan.halo_rows == 0 and plan.recovered_edges == 0
    assert plan.kept_information(graph) == pytest.approx(
        plan.edge_locality(graph))
    for sub, ns in zip(plan.subgraphs, plan.node_sets):
        ref = graph.subgraph(ns)
        assert np.array_equal(sub.indptr, ref.indptr)
        assert np.array_equal(sub.indices, ref.indices)
        assert np.array_equal(sub.features, ref.features)
        assert np.array_equal(sub.train_mask, ref.train_mask)
    tr = make_trainer(graph, _cfg(partitions=2, halo_budget=0), seed=0,
                      device="cpu")
    assert tr.halo_exchange_bytes == 0


@pytest.mark.parametrize("sampling_device", ["cpu", "device"])
def test_trainer_fills_halo_features_through_exchange(graph, sampling_device):
    tr = make_trainer(graph, _cfg(partitions=3, halo_budget=16,
                                  sampling_device=sampling_device),
                      seed=0, device="cpu")
    assert tr.halo_exchange_bytes == tr.plan.halo_rows * \
        graph.feat_dim * 4 > 0
    for slot, ns, hs in zip(tr.slots, tr.plan.node_sets, tr.plan.halo_sets):
        assert slot.pipe.plane.backend == sampling_device
        local = np.arange(len(ns), len(ns) + len(hs))
        np.testing.assert_array_equal(slot.graph.features[local],
                                      graph.features[hs])
        np.testing.assert_array_equal(slot.pipe.plane.fetch(local),
                                      graph.features[hs])


def test_halo_hit_accounting_and_checkpoint(graph, tmp_path):
    cfg = _cfg(partitions=2, halo_budget=64)
    tr = make_trainer(graph, cfg, seed=0, device="cpu")
    for _ in range(3):
        tr.global_step()
    assert all(h.batches == 3 and h.inputs > 0 for h in tr.halo_stats)
    assert 0.0 < tr.halo_hit_rate < 1.0
    stats = [dataclasses.asdict(s.halo_stats) for s in tr.slots]
    mgr = CheckpointManager(tmp_path / "ckpt", async_save=False)
    tr.save(mgr, step=3)
    assert mgr.read_manifest(3)["extra"]["halo_stats"] == stats
    tr2 = make_trainer(graph, cfg, seed=0, device="cpu")
    tr2.restore(mgr)
    assert [dataclasses.asdict(s.halo_stats) for s in tr2.slots] == stats
    # a restore into another budget keeps its halo accounting fresh
    tr3 = make_trainer(graph, cfg.replace(halo_budget=16), seed=0,
                       device="cpu")
    tr3.restore(mgr)
    assert all(h.inputs == 0 for h in tr3.halo_stats)
    _shutdown(tr)


def test_set_halo_budget_refills_and_keeps_cache_accounting(graph):
    tr = make_trainer(graph, _cfg(partitions=2, halo_budget=8), seed=0,
                      device="cpu")
    tr.global_step()
    cache_stats = [dataclasses.asdict(s.cache.stats) for s in tr.slots]
    tr.set_halo_budget(32)
    assert tr.plan.halo_budget == 32 and tr.cfg.halo_budget == 32
    assert [dataclasses.asdict(s.cache.stats) for s in tr.slots] == \
        cache_stats
    assert all(h.inputs == 0 for h in tr.halo_stats)
    for slot, ns, hs in zip(tr.slots, tr.plan.node_sets, tr.plan.halo_sets):
        local = np.arange(len(ns), len(ns) + len(hs))
        np.testing.assert_array_equal(slot.pipe.plane.fetch(local),
                                      graph.features[hs])
    tr.global_step()
    assert tr.global_steps == 2
    _shutdown(tr)


# ---------------------------------------------------------------------------
# rebalance (mirrors tests/test_multipartition.py)
# ---------------------------------------------------------------------------

def test_trainer_rebalance_updates_plan_and_accounting():
    cfg = _cfg(partitions=2, halo_budget=16)
    g = _mutable_graph(seed=8)
    tr = MultiPartitionTrainer(g, cfg, seed=0, device="cpu")
    try:
        tr.global_step()
        assert tr.cut_drift() == 0.0                # version-matched: free
        rng = np.random.default_rng(4)
        g.add_edges(rng.integers(0, g.num_nodes, 3000),
                    rng.integers(0, g.num_nodes, 3000))
        assert tr.cut_drift() > 0.0
        res = tr.rebalance_partitions()
        assert tr.rebalances == 1 and tr.last_rebalance is res
        assert res.moved_frac < cfg.rebalance_max_move + 1e-9
        assert tr.plan.topology_version == g.topology_version
        assert tr.cut_drift() == 0.0                # re-baselined
        assert [s.graph.num_nodes for s in tr.slots] == \
            [len(ns) + len(hs) for ns, hs in
             zip(tr.plan.node_sets, tr.plan.halo_sets)]
        # halo rows refilled through the exchange, accounting reset
        assert tr.halo_exchange_bytes == tr.plan.halo_rows * g.feat_dim * 4
        for slot, ns, hs in zip(tr.slots, tr.plan.node_sets,
                                tr.plan.halo_sets):
            local = np.arange(len(ns), len(ns) + len(hs))
            np.testing.assert_array_equal(slot.pipe.plane.fetch(local),
                                          g.features[hs])
        assert all(h.inputs == 0 for h in tr.halo_stats)
        params_before = [p.clone() for p in leaves(tr.params)]
        tr.global_step()
        assert any(not torch.equal(a, b) for a, b in
                   zip(params_before, leaves(tr.params)))
        extra = tr.checkpoint_extra()
        assert extra["topology_version"] == g.topology_version
        assert extra["rebalances"] == 1
    finally:
        _shutdown(tr)


# ---------------------------------------------------------------------------
# streaming (mirrors tests/test_streaming.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling_device", ["cpu", "device"])
def test_multipart_stream_update_and_halo_refresh(sampling_device):
    cfg = _cfg(partitions=2, halo_budget=32, halo_refresh_interval=2,
               sampling_device=sampling_device)
    graph = _mutable_graph()
    tr = MultiPartitionTrainer(graph, cfg, seed=0, device="cpu")
    try:
        store = tr.attach_feature_store()
        assert isinstance(store, FeatureStore) and tr.feature_store is store
        # a halo node of partition 1 that partition 0 owns
        node = next(int(c) for c in tr.plan.halo_sets[1]
                    if tr.plan.owner[c] == 0)
        loc0 = tr._local_id(0, node)
        loc1 = tr._local_id(1, node)
        assert 0 <= loc0 < tr.slots[0].n_owned <= loc1

        rows = np.full((1, graph.feat_dim), 9.5, np.float32)
        store.update_rows(np.array([node]), rows)
        # the owner partition observes the row now, through its plane
        np.testing.assert_array_equal(
            tr.slots[0].pipe.plane.fetch(np.array([loc0])), rows)
        # partition 1's halo copy is stale until the bounded refresh
        assert not np.array_equal(tr.slots[1].graph.features[loc1], rows[0])
        assert tr._halo_dirty

        tr.global_step()                     # step 1: interval not reached
        assert tr.halo_refreshes == 0
        tr.global_step()                     # step 2: refresh fires
        assert tr.halo_refreshes == 1 and not tr._halo_dirty
        np.testing.assert_array_equal(
            tr.slots[1].pipe.plane.fetch(np.array([loc1])), rows)

        # quiescent stores don't trigger refreshes
        tr.global_step()
        tr.global_step()
        assert tr.halo_refreshes == 1
        tr.detach_feature_store()
        assert tr.feature_store is None
    finally:
        _shutdown(tr)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launch_train_partitions_runs_the_slice(capsys, tmp_path):
    assert main(["--arch", "graphsage-products", "--smoke", "--device",
                 "cpu", "--partitions", "2", "--halo-budget", "32",
                 "--sampling-device", "device", "--fused-gather-agg",
                 "--steps", "4", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for tag in ("[partition] 2 partitions", "[halo] budget=32",
                "[result] 4 global steps (8 partition mini-batches)",
                "[restore] fresh trainer restored from step 4"):
        assert tag in out
    assert CheckpointManager(tmp_path).all_steps() == [2, 4]


def test_tree_helpers_round_trip():
    tree = {"b": [torch.ones(2), torch.zeros(1)], "a": torch.arange(3)}
    assert [t.tolist() for t in leaves(unflatten(tree, leaves(tree)))] == \
        [[0, 1, 2], [1.0, 1.0], [0.0]]
