"""The online auto-tuner (``core/autotune/controller.py``) and the
trainers' live-reconfigure and restart hooks, on the CPU.

Against the JAX package: ``prewarm``'s surrogate training set from the
same ``PipelineStats`` is equal; and a scripted run — ``propose`` replaced
in both packages by one fixed list of configurations that moves γ, Θ
(through Θ = 0 and a cache built live), the batch size, the feature plane,
the halo budget and the partition count 1 → 2 → 1 — gives every episode
the same configuration, modeled memory, hit rate and step count, the
accuracy within 1e-3 and the losses within rel 1e-4 (the fused slice's
tolerance: Adam's normalisation magnifies f32 rounding), and each restart
carries the parameters and optimizer state over exactly.

The rest mirrors ``tests/test_autotune_controller.py`` and the autotune
cases of ``tests/test_feature_plane.py``, ``tests/test_halo.py``,
``tests/test_multipartition.py`` and ``tests/test_streaming.py`` on the
port alone."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs.gnn import AutotuneConfig as JxAutotuneConfig
from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.core.a3gnn import A3GNNTrainer as JxTrainer
from repro.core.autotune.controller import \
    AutotuneController as JxController
from repro.core.pipeline import PipelineStats as JxStats
from repro.graph.synthetic import dataset_like as jx_dataset
from repro_torch.configs.gnn import AutotuneConfig, gnn_config
from repro_torch.core.a3gnn import A3GNNTrainer, make_trainer
from repro_torch.core.autotune.controller import (AutotuneController,
                                                  AutotuneReport, Episode,
                                                  episode_space)
from repro_torch.core.cache import FeatureCache
from repro_torch.core.feature_plane import (DeviceFeaturePlane,
                                            HostFeaturePlane)
from repro_torch.core.multipart import MultiPartitionTrainer, MultiPipeline
from repro_torch.core.pipeline import Pipeline, PipelineStats
from repro_torch.core.sampling import seed_loader
from repro_torch.graph.synthetic import dataset_like
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import leaves


@pytest.fixture(scope="module")
def graph():
    return dataset_like(gnn_config("products", smoke=True), seed=0)


@pytest.fixture(scope="module")
def cfg():
    return gnn_config("products", smoke=True)


def _fresh_graph():
    """Streaming tests write feature rows — never the module fixture."""
    return dataset_like(gnn_config("products", smoke=True), seed=0)


def _state_equal(a, b) -> bool:
    x, y = leaves(a.state_dict()), leaves(b)
    return len(x) == len(y) and all(
        torch.equal(p, q) if isinstance(p, torch.Tensor) else p == q
        for p, q in zip(x, y))


def _snapshot(tr):
    return [x.clone() if isinstance(x, torch.Tensor) else x
            for x in leaves(tr.state_dict())]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

ACFG = dict(presample=12, surrogate_trees=4, ppo_updates=1, ppo_horizon=2,
            seed=0)


@pytest.mark.parametrize("gated", [False, True], ids=["table1", "gated"])
def test_prewarm_training_set_matches_jax(gated):
    kw = dict(max_batch_size=64, tune_sampling_device=True, max_partitions=2,
              max_halo_budget=16) if gated else {}
    base = dict(smoke=True, cache_volume_mb=0.3, bias_rate=3.0)
    cfg_j, cfg_t = jx_gnn_config("products", **base), \
        gnn_config("products", **base)
    trj = JxTrainer(jx_dataset(cfg_j, seed=0), cfg_j, seed=0)
    trt = A3GNNTrainer(dataset_like(cfg_t, seed=0), cfg_t, seed=0,
                       device="cpu")
    stats = dict(steps=5, t_sample=0.05, t_batch=0.02, t_train=0.03,
                 t_wall=0.11, peak_batch_bytes=123_456)
    ctrls = []
    for tr, Ctrl, Acfg, Stats in ((trj, JxController, JxAutotuneConfig,
                                   JxStats),
                                  (trt, AutotuneController, AutotuneConfig,
                                   PipelineStats)):
        pipe = tr.make_pipeline()
        ctrl = Ctrl(tr, pipe, Acfg(**ACFG, **kw))
        ctrl.prewarm(Stats(**stats), 0.42)
        pipe.shutdown()
        ctrls.append(ctrl)
    cj, ct = ctrls
    assert ct._current_config() == cj._current_config()
    assert np.array_equal(np.stack(ct._X), np.stack(cj._X))
    assert ct._Y == cj._Y
    x = np.stack(ct._X[:5])
    for m, v in ct.surrogate.predict(x).items():
        assert np.array_equal(v, cj.surrogate.predict(x)[m])


# episodes 1.. of the scripted run; episode 0 measures the seed config
# (p = 1, γ = 2, Θ = 0.3 MB, batch 64, device plane, halo 0)
SCRIPT = [
    dict(bias_rate=4.0, cache_volume_mb=0.0, batch_size=48,
         sampling_device="cpu", partitions=1, halo_budget=0),
    dict(bias_rate=1.5, cache_volume_mb=0.5, batch_size=64,
         sampling_device="device", partitions=1, halo_budget=0),
    dict(bias_rate=8.0, cache_volume_mb=0.2, batch_size=32,
         sampling_device="cpu", partitions=2, halo_budget=16),
    dict(bias_rate=2.0, cache_volume_mb=0.3, batch_size=64,
         sampling_device="device", partitions=2, halo_budget=0),
    dict(bias_rate=3.0, cache_volume_mb=0.4, batch_size=40,
         sampling_device="device", partitions=1, halo_budget=0),
]
SCRIPT = [dict(c, parallel_mode="seq", workers=1) for c in SCRIPT]


def _scripted_run(Ctrl, tr, acfg, monkeypatch, snapshot, equal):
    """``ctrl.run()`` with ``propose`` returning SCRIPT in order; returns
    the report, each episode's losses, and per restart (partitions, state
    carried over exactly)."""
    script = iter(SCRIPT)
    losses, restarts = [], []
    measure, restart = Ctrl.measure, Ctrl._restart

    def propose(self):
        return dict(next(script)), None

    def measured(self, index, cfg, predicted=None):
        ep = measure(self, index, cfg, predicted)
        losses.append(list(self.pipe.stats.losses))
        return ep

    def restarted(self, new_partitions, halo_budget=None):
        before = snapshot(self.tr)
        restart(self, new_partitions, halo_budget)
        restarts.append((new_partitions, equal(self.tr, before)))

    monkeypatch.setattr(Ctrl, "propose", propose)
    monkeypatch.setattr(Ctrl, "measure", measured)
    monkeypatch.setattr(Ctrl, "_restart", restarted)
    ctrl = Ctrl(tr, tr.make_pipeline(), acfg)
    try:
        rep = ctrl.run()
    finally:
        ctrl.pipe.shutdown()
    return rep, losses, restarts, ctrl


def _jx_snapshot(tr):
    return [np.asarray(x).copy() for x in jax.tree.leaves(tr.state_dict())]


def _jx_equal(tr, before):
    now = [np.asarray(x) for x in jax.tree.leaves(tr.state_dict())]
    return len(now) == len(before) and all(
        np.array_equal(a, b) for a, b in zip(now, before))


def test_scripted_episodes_match_jax(monkeypatch, tmp_path):
    base = dict(smoke=True, fused_gather_agg=True, sampling_device="device",
                cache_policy="static", cache_volume_mb=0.3)
    acfg = dict(episodes=len(SCRIPT) + 1, steps_per_episode=3,
                warmup_steps=1, presample=8, surrogate_trees=4,
                ppo_updates=1, ppo_horizon=2, max_batch_size=64,
                tune_sampling_device=True, max_partitions=2,
                max_halo_budget=16, w_throughput=0.0, w_memory=1.0,
                w_accuracy=0.0, throughput_source="modeled", seed=0)
    cfg_j, cfg_t = jx_gnn_config("products", **base), \
        gnn_config("products", **base)
    trj = JxTrainer(jx_dataset(cfg_j, seed=0), cfg_j, seed=0)
    trt = A3GNNTrainer(dataset_like(cfg_t, seed=0), cfg_t, seed=0,
                       device="cpu")
    trt.params = params_from_jax(jax.tree.map(np.asarray, trj.params), "cpu")
    rj, lj, sj, _ = _scripted_run(
        JxController, trj,
        JxAutotuneConfig(**acfg, restart_dir=str(tmp_path / "jax")),
        monkeypatch, _jx_snapshot, _jx_equal)
    rt, lt, st_, ctrl = _scripted_run(
        AutotuneController, trt,
        AutotuneConfig(**acfg, restart_dir=str(tmp_path / "port")),
        monkeypatch, _snapshot, _state_equal)
    assert sj == st_ == [(2, True), (1, True)]
    assert len(rt.episodes) == len(rj.episodes) == len(SCRIPT) + 1
    for et, ej, a, b in zip(rt.episodes, rj.episodes, lt, lj, strict=True):
        assert et.config == ej.config
        assert et.metrics["memory"] == ej.metrics["memory"]
        assert et.cache_hit_rate == ej.cache_hit_rate
        assert et.steps == ej.steps == 3 * et.config.get("partitions", 1)
        assert et.metrics["accuracy"] == pytest.approx(
            ej.metrics["accuracy"], abs=1e-3)
        assert len(a) == len(b) == et.steps and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=0)
    # the knobs the script moves all moved
    assert set(rt.changed_knobs()) == {
        "bias_rate", "cache_volume_mb", "batch_size", "sampling_device",
        "partitions", "halo_budget", "workers"}
    assert 0 < rt.episodes[0].cache_hit_rate < 1
    assert rt.best.index == rj.best.index and rt.best_feasible
    final = rt.final_trainer
    assert final is ctrl.tr and final.device.type == "cpu"
    assert final.cfg.cache_volume_mb == rt.best.config["cache_volume_mb"]
    assert ctrl.pipe.sampling_device == rt.best.config["sampling_device"]


# ---------------------------------------------------------------------------
# episode-boundary reconfiguration (tests/test_autotune_controller.py)
# ---------------------------------------------------------------------------

def test_cache_resize_preserves_hit_accounting(graph):
    c = FeatureCache(graph, volume_mb=0.05, policy="static")
    ids = np.random.default_rng(0).integers(0, graph.num_nodes, 400)
    c.fetch(ids)
    before = dataclasses.astuple(c.stats)
    assert c.stats.hits + c.stats.misses == 400
    stats_obj, cap_before = c.stats, c.capacity
    c.resize(0.1)                                 # grow
    assert c.capacity > cap_before
    assert c.stats is stats_obj and dataclasses.astuple(c.stats) == before
    np.testing.assert_allclose(c.fetch(ids[:50]), graph.features[ids[:50]])
    assert c.stats.hits + c.stats.misses == 450
    c.resize(0.02)                                # shrink below the original
    assert 0 < c.capacity < cap_before
    cached = np.where(c.device_map >= 0)[0]
    assert len(cached) == c.capacity
    assert (c.slot_owner[c.device_map[cached]] == cached).all()


def test_fifo_resize_keeps_newest_residents(graph):
    c = FeatureCache(graph, volume_mb=0.05, policy="fifo")
    c.fetch(np.arange(c.capacity * 2))            # fill + wrap
    newest = c.slot_owner[c.slot_owner >= 0]
    c.resize(0.02)
    survivors = c.slot_owner[c.slot_owner >= 0]
    assert len(survivors) == c.capacity
    assert set(survivors) <= set(newest)          # no resurrected evictees
    np.testing.assert_allclose(c.fetch(survivors), graph.features[survivors])


def test_gamma_swap_changes_reservoir_weights(graph, cfg):
    tr = A3GNNTrainer(graph, cfg.replace(bias_rate=2.0), seed=0,
                      device="cpu")
    cached = np.where(tr.cache.device_map >= 0)[0][:16]
    uncached = np.where(tr.cache.device_map < 0)[0][:16]
    assert len(uncached) == 0 or np.allclose(tr.weight_fn(uncached), 1.0)
    np.testing.assert_allclose(tr.weight_fn(cached), 2.0)
    tr.apply_live_config({"bias_rate": 8.0, "cache_volume_mb": 0.2})
    cached = np.where(tr.cache.device_map >= 0)[0][:16]
    uncached = np.where(tr.cache.device_map < 0)[0][:16]
    assert tr.cfg.bias_rate == 8.0 and len(uncached) > 0
    np.testing.assert_allclose(tr.weight_fn(cached), 8.0)
    np.testing.assert_allclose(tr.weight_fn(uncached), 1.0)
    tr.apply_live_config({"bias_rate": 1.0})      # γ=1 → uniform sampling
    assert tr.weight_fn is None


def test_mode_switch_drains_queue_without_dropping(graph, cfg):
    c = cfg.replace(parallel_mode="mode1", workers=2)
    tr = A3GNNTrainer(graph, c, seed=0, device="cpu")
    pipe = Pipeline(graph, c, tr._train_fn, cache=tr.cache,
                    weight_fn=tr.weight_fn, seed=0, device="cpu")
    try:
        batches = list(seed_loader(graph, c.batch_size, 0))[:8]
        pipe.begin_stats()
        pipe.submit(batches)
        for _ in range(3):
            assert pipe.step()
        assert pipe.inflight == 5
        pipe.reconfigure(mode="mode2")            # drain → swap → resume
        assert pipe.inflight == 0 and pipe.stats.steps == 8
        assert pipe.mode == "mode2"
        pipe.submit(batches[:2])
        pipe.drain()
        assert pipe.stats.steps == 10
    finally:
        pipe.shutdown()


@pytest.mark.parametrize("fused", [False, True])
def test_reconfigure_swaps_gamma_and_cache_live(graph, cfg, fused):
    tr = A3GNNTrainer(graph, cfg.replace(fused_gather_agg=fused), seed=0,
                      device="cpu")
    pipe = tr.make_pipeline()
    try:
        old_cache = tr.cache
        tr.apply_live_config({"bias_rate": 8.0, "cache_volume_mb": 0.5,
                              "parallel_mode": "mode2", "workers": 3}, pipe)
        assert tr.cache is old_cache               # resized, not rebuilt
        assert pipe.cache is tr.cache and pipe.weight_fn is tr.weight_fn
        assert pipe.mode == "mode2" and pipe.workers_n == 3
        assert pipe.run(max_steps=3).steps == 3
    finally:
        pipe.shutdown()


@given(n=st.integers(3, 30), seed=st.integers(0, 999))
@settings(max_examples=25, deadline=None)
def test_pareto_frontier_points_dominate_no_other(n, seed):
    rng = np.random.default_rng(seed)
    report = AutotuneReport()
    for i in range(n):
        thr, mem, acc = rng.random(3)
        report.episodes.append(Episode(
            index=i, config={"bias_rate": 1.0 + i},
            metrics={"throughput": thr, "memory": mem, "accuracy": acc},
            reward=thr, cache_hit_rate=0.0, steps=1))
    front = report.pareto_points()
    assert front
    pts = np.array([[e.metrics["throughput"], -e.metrics["memory"],
                     e.metrics["accuracy"]] for e in report.episodes])
    for ep in front:
        p = np.array([ep.metrics["throughput"], -ep.metrics["memory"],
                      ep.metrics["accuracy"]])
        assert not (np.all(pts >= p, axis=1) & np.any(pts > p, axis=1)).any()


def test_episode_space_decodes_live_knobs():
    acfg = AutotuneConfig()
    names = {k.name for k in episode_space(acfg).knobs}
    assert not names & {"batch_size", "sampling_device", "partitions",
                        "halo_budget"}
    sp = episode_space(acfg)
    for u in sp.sample(np.random.default_rng(0), 32):
        c = sp.decode(u)
        assert 1.0 <= c["bias_rate"] <= acfg.max_bias_rate
        assert 0.0 < c["cache_volume_mb"] <= acfg.max_cache_mb
        assert c["parallel_mode"] in ("seq", "mode1", "mode2")
        assert 1 <= c["workers"] <= acfg.max_workers


@pytest.mark.parametrize("knob,kw,lo,hi", [
    ("batch_size", dict(max_batch_size=256), 16, 256),
    ("partitions", dict(max_partitions=4), 1, 4),
    ("halo_budget", dict(max_halo_budget=64), 0, 64),
])
def test_episode_space_gates_knobs(knob, kw, lo, hi):
    sp = episode_space(AutotuneConfig(**kw))
    got = [sp.decode(u)[knob] for u in sp.sample(np.random.default_rng(0),
                                                 64)]
    assert min(got) >= lo and max(got) <= hi and len(set(got)) > 1


def test_episode_space_gates_sampling_device():
    sp = episode_space(AutotuneConfig(tune_sampling_device=True))
    seen = {sp.decode(u)["sampling_device"]
            for u in sp.sample(np.random.default_rng(0), 64)}
    assert seen == {"cpu", "device"}              # both backends reachable


def test_batch_size_applies_live(graph, cfg):
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    pipe = tr.make_pipeline()
    try:
        pipe.run(max_steps=2)
        tr.apply_live_config({"batch_size": 32}, pipe)
        assert tr.cfg.batch_size == 32 and pipe.batch_size == 32
        assert pipe.run(max_steps=2).steps == 2
    finally:
        pipe.shutdown()


def test_throughput_source_auto_switch(monkeypatch):
    from repro_torch.core.autotune import controller as C
    acfg = AutotuneConfig()
    monkeypatch.setattr(C, "available_cpus", lambda: 1)
    assert C.resolve_throughput_source(acfg) == "modeled"
    monkeypatch.setattr(C, "available_cpus", lambda: 4)
    assert C.resolve_throughput_source(acfg) == "wallclock"
    monkeypatch.undo()
    if hasattr(C.os, "sched_getaffinity"):
        monkeypatch.setattr(C.os, "sched_getaffinity", lambda pid: {0})
        assert C.available_cpus() == 1
        assert C.resolve_throughput_source(acfg) == "modeled"
    assert C.resolve_throughput_source(
        acfg.replace(throughput_source="wallclock")) == "wallclock"
    with pytest.raises(ValueError):
        C.resolve_throughput_source(acfg.replace(throughput_source="x"))


@pytest.mark.parametrize("source", ["modeled", "wallclock"])
def test_measure_respects_throughput_source(graph, cfg, source, monkeypatch):
    from repro_torch.core.perf_model import bottleneck_step_time
    monkeypatch.setenv("LD_PRELOAD", "")
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    pipe = tr.make_pipeline()
    ctrl = AutotuneController(tr, pipe, AutotuneConfig(
        steps_per_episode=3, warmup_steps=0, throughput_source=source,
        seed=0))
    try:
        ep = ctrl.measure(0, ctrl._current_config())
    finally:
        pipe.shutdown()
    if source == "modeled":
        want = 1.0 / max(bottleneck_step_time(
            pipe.mode, pipe.stats.stage_times(), pipe.workers_n), 1e-9)
        assert ep.tuned_runtime is None
    else:
        want = pipe.stats.throughput_steps_per_s()
        assert ep.tuned_runtime == {"tcmalloc": False,
                                    "xla_host_flags": False, "tuned": False}
    assert ep.metrics["throughput"] == pytest.approx(want)


# ---------------------------------------------------------------------------
# closed loop: fit_autotuned
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def autotune_report(graph, cfg):
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    acfg = AutotuneConfig(episodes=4, steps_per_episode=5, warmup_steps=2,
                          presample=48, surrogate_trees=16, ppo_updates=2,
                          ppo_horizon=6, max_workers=3,
                          w_throughput=1.0, w_memory=0.0, w_accuracy=0.0,
                          seed=0)
    return tr.fit_autotuned(acfg), tr


def test_fit_autotuned_completes_episodes(autotune_report):
    rep, _ = autotune_report
    assert len(rep.episodes) == 4
    assert all(ep.steps == 5 for ep in rep.episodes)
    for ep in rep.episodes:
        assert np.isfinite(list(ep.metrics.values())).all()
        assert (ep.predicted is None) == (ep.index == 0)


def test_fit_autotuned_changes_a_knob(autotune_report):
    rep, _ = autotune_report
    assert {"bias_rate", "cache_volume_mb", "parallel_mode"} & \
        set(rep.changed_knobs())


def test_fit_autotuned_beats_fixed_baseline(autotune_report):
    """The recommendation's throughput is at least the seed config's, by
    construction (episode 0 is measured and competes), and the trainer is
    left running it."""
    rep, tr = autotune_report
    assert rep.baseline.index == 0
    assert (rep.final_metrics["throughput"]
            >= rep.baseline_metrics["throughput"])
    best = rep.best.config
    assert tr.cfg.parallel_mode == best["parallel_mode"]
    assert np.isclose(tr.cfg.bias_rate, best["bias_rate"])
    assert rep.final_trainer is tr


def test_fit_autotuned_from_cacheless_config(graph, cfg):
    tr = A3GNNTrainer(graph, cfg.replace(cache_volume_mb=0.0, bias_rate=1.0),
                      seed=0, device="cpu")
    assert tr.cache is None
    acfg = AutotuneConfig(episodes=3, steps_per_episode=4, warmup_steps=0,
                          presample=24, surrogate_trees=8, ppo_updates=1,
                          ppo_horizon=4, seed=0)
    rep = tr.fit_autotuned(acfg)
    assert rep.baseline.config["cache_volume_mb"] == 0.0
    assert rep.baseline.cache_hit_rate == 0.0
    assert any(ep.config["cache_volume_mb"] > 0 for ep in rep.episodes[1:])
    assert (tr.cache is None) == (rep.best.config["cache_volume_mb"] <= 0)


def test_fit_autotuned_all_infeasible_flags_report(graph, cfg):
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    acfg = AutotuneConfig(episodes=2, steps_per_episode=3, warmup_steps=0,
                          presample=24, surrogate_trees=8, ppo_updates=1,
                          ppo_horizon=4, memory_limit_bytes=1.0, seed=0)
    rep = tr.fit_autotuned(acfg)
    assert rep.best_feasible is False
    assert rep.best.metrics["memory"] == min(
        ep.metrics["memory"] for ep in rep.episodes)


def test_shutdown_discards_backlog_without_training(graph, cfg):
    calls = {"n": 0}

    def counting_train_fn(mb):
        calls["n"] += 1
        return 0.0, 0.0

    pipe = Pipeline(graph, cfg, counting_train_fn, seed=0, device="cpu")
    pipe.submit(list(seed_loader(graph, cfg.batch_size, 0))[:6])
    pipe.step()
    assert calls["n"] == 1 and pipe.inflight == 5
    pipe.shutdown()
    assert calls["n"] == 1 and pipe.inflight == 0


def test_fit_autotuned_feedback_reaches_surrogate(graph, cfg):
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    pipe = tr.make_pipeline()
    acfg = AutotuneConfig(episodes=2, steps_per_episode=3, warmup_steps=0,
                          presample=24, surrogate_trees=8, ppo_updates=1,
                          ppo_horizon=4, seed=0)
    ctrl = AutotuneController(tr, pipe, acfg)
    try:
        rep = ctrl.run()
    finally:
        pipe.shutdown()
    assert len(ctrl._X) == acfg.presample + len(rep.episodes)
    assert len(ctrl._measured_keys) == len(
        {tuple(sorted(e.config.items())) for e in rep.episodes})
    assert all(p.device.type == "cpu" for p in ctrl.agent.parameters())


# ---------------------------------------------------------------------------
# feature plane, halo, partitions and streaming under the controller
# ---------------------------------------------------------------------------

def test_gamma_swap_under_device_plane(graph, cfg):
    """(tests/test_feature_plane.py:152-170) the bias weights see the same
    cache the device plane gathers, and the plane survives the boundary."""
    tr = A3GNNTrainer(graph, cfg.replace(sampling_device="device",
                                         bias_rate=2.0), seed=0, device="cpu")
    pipe = tr.make_pipeline()
    try:
        assert isinstance(pipe.plane, DeviceFeaturePlane)
        assert pipe.run(max_steps=2).steps == 2 and tr.cache.stats.hits > 0
        plane_before = pipe.plane
        tr.apply_live_config({"bias_rate": 8.0, "cache_volume_mb": 0.5}, pipe)
        assert pipe.plane is plane_before and pipe.plane.cache is tr.cache
        cached = np.where(tr.cache.device_map >= 0)[0][:8]
        np.testing.assert_allclose(tr.weight_fn(cached), 8.0)
        assert pipe.run(max_steps=2).steps == 2
    finally:
        pipe.shutdown()


def test_sampling_device_swap_gives_the_same_fused_step(graph, cfg):
    """A live cpu ↔ device plane swap under one cache: the fused step's
    loss from the same state and batch is bit-equal on both planes (the
    table path against the all-sideband path), and the plane keeps the
    cache's accounting."""
    tr = A3GNNTrainer(graph, cfg.replace(sampling_device="device",
                                         fused_gather_agg=True,
                                         cache_volume_mb=0.3), seed=0,
                      device="cpu")
    pipe = tr.make_pipeline()
    ctrl = AutotuneController(tr, pipe, AutotuneConfig(
        tune_sampling_device=True, seed=0))
    from repro_torch.core.sampling import NeighborSampler
    from repro_torch.graph.batch import generate_batch
    seeds = next(iter(seed_loader(tr.graph, cfg.batch_size, 0)))
    mb = generate_batch(NeighborSampler(tr.graph, cfg.fanout,
                                        weight_fn=tr.weight_fn,
                                        seed=0).sample(seeds),
                        pipe.plane, tr.graph, fused=True)
    assert mb.features is None                    # resolved at step time
    state = _snapshot(tr)
    try:
        out = {}
        for dev, kind in (("device", DeviceFeaturePlane),
                          ("cpu", HostFeaturePlane),
                          ("device", DeviceFeaturePlane)):
            ctrl._apply_config({"sampling_device": dev})
            assert isinstance(ctrl.pipe.plane, kind)
            assert ctrl.pipe.plane.cache is tr.cache
            tr.load_state_dict(_restore(tr, state))
            out.setdefault(dev, []).append(tr._train_fn(mb, ctrl.pipe.plane))
        assert out["device"][0] == out["cpu"][0] == out["device"][1]
        assert ctrl.tr is tr and tr._step_allfused.counters["calls"] == 3
    finally:
        ctrl.pipe.shutdown()


def _restore(tr, flat):
    """``flat`` (a ``_snapshot``) back into ``tr``'s state-dict tree."""
    from repro_torch.models.params import unflatten
    return unflatten(tr.state_dict(), [x.clone() if isinstance(
        x, torch.Tensor) else x for x in flat])


def test_autotune_live_swaps_sampling_device(graph, cfg):
    """(tests/test_feature_plane.py:248-270) episodes run on both backends
    and the trainer ends on the recommendation without dropping a batch."""
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    ctrl = AutotuneController(tr, tr.make_pipeline(), AutotuneConfig(
        episodes=3, steps_per_episode=3, warmup_steps=0, presample=24,
        surrogate_trees=8, ppo_updates=1, ppo_horizon=4,
        tune_sampling_device=True, seed=0))
    try:
        rep = ctrl.run()
    finally:
        ctrl.pipe.shutdown()
    assert all(ep.config["sampling_device"] in ("cpu", "device")
               for ep in rep.episodes)
    assert all(ep.steps == 3 for ep in rep.episodes)
    assert tr.cfg.sampling_device == rep.best.config["sampling_device"]
    assert ctrl.pipe.sampling_device == rep.best.config["sampling_device"]


def test_live_halo_budget_swap_preserves_state(graph, cfg):
    """(tests/test_halo.py:280-311) slots rebuild in place; params and
    cache accounting carry over, halo accounting restarts."""
    tr = make_trainer(graph, cfg.replace(partitions=2, halo_budget=0),
                      seed=0, device="cpu")
    pipe = tr.make_pipeline()
    try:
        assert pipe.run(max_steps=2).steps == 4
        state = _snapshot(tr)
        hits = [s.cache.stats.hits for s in tr.slots]
        base_nodes = [s.graph.num_nodes for s in tr.slots]
        tr.apply_live_config({"halo_budget": 32}, pipe)
        assert tr.cfg.halo_budget == 32 and tr.plan.halo_budget == 32
        for s, n, h in zip(tr.slots, base_nodes, hits):
            assert s.graph.num_nodes == n + 32
            assert s.cache.stats.hits >= h and s.halo_stats.inputs == 0
        assert _state_equal(tr, state)
        assert pipe.run(max_steps=2).steps == 4
        tr.apply_live_config({"halo_budget": 0}, pipe)
        assert [s.graph.num_nodes for s in tr.slots] == base_nodes
    finally:
        pipe.shutdown()


def test_controller_reports_and_swaps_halo_budget(graph, cfg):
    """(tests/test_halo.py:328-345) a proposed budget swaps live: the same
    trainer object, no restart."""
    tr = make_trainer(graph, cfg.replace(partitions=2, halo_budget=8),
                      seed=0, device="cpu")
    ctrl = AutotuneController(tr, tr.make_pipeline(), AutotuneConfig(
        episodes=1, steps_per_episode=1, warmup_steps=0, presample=8,
        surrogate_trees=4, ppo_updates=1, ppo_horizon=2, max_halo_budget=32,
        seed=0))
    try:
        assert ctrl._current_config()["halo_budget"] == 8
        ctrl._apply_config({"halo_budget": 24})
        assert ctrl.tr is tr and tr.plan.halo_budget == 24
        assert ctrl.restarts == 0
    finally:
        ctrl.pipe.shutdown()


@pytest.mark.slow
def test_fit_autotuned_with_halo_knob(graph, cfg):
    """(tests/test_halo.py:348-361)"""
    tr = make_trainer(graph, cfg.replace(partitions=2, halo_budget=16),
                      seed=0, device="cpu")
    assert isinstance(tr, MultiPartitionTrainer)
    rep = tr.fit_autotuned(AutotuneConfig(
        episodes=3, steps_per_episode=2, warmup_steps=0, presample=16,
        surrogate_trees=8, ppo_updates=1, ppo_horizon=4, max_workers=2,
        max_halo_budget=32, seed=0))
    assert len(rep.episodes) == 3
    assert all("halo_budget" in ep.config for ep in rep.episodes)
    for ep in rep.episodes:
        assert np.isfinite(list(ep.metrics.values())).all()


def test_controller_restart_path_preserves_training_state(graph, cfg,
                                                          tmp_path):
    """(tests/test_multipartition.py:282-307) checkpoint → rebuild (new
    partition count, the trainer's device) → restore, and back."""
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    ctrl = AutotuneController(tr, tr.make_pipeline(), AutotuneConfig(
        episodes=2, steps_per_episode=2, warmup_steps=0, presample=16,
        surrogate_trees=8, ppo_updates=1, ppo_horizon=4, max_partitions=3,
        restart_dir=str(tmp_path / "restart"), seed=0))
    try:
        ctrl.pipe.run(max_steps=2)
        state = _snapshot(tr)
        ctrl._restart(2)
        assert isinstance(ctrl.tr, MultiPartitionTrainer)
        assert isinstance(ctrl.pipe, MultiPipeline)
        assert ctrl.tr.cfg.partitions == 2 and ctrl.restarts == 1
        assert ctrl.tr.device.type == "cpu" and _state_equal(ctrl.tr, state)
        ctrl._restart(1)
        assert isinstance(ctrl.tr, A3GNNTrainer) and ctrl.restarts == 2
        assert ctrl.tr.device.type == "cpu" and _state_equal(ctrl.tr, state)
    finally:
        ctrl.pipe.shutdown()


@pytest.mark.slow
def test_fit_autotuned_with_partitions_knob(graph, cfg):
    """(tests/test_multipartition.py:311-328) every episode measures
    whatever partition count the proposal picks."""
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    acfg = AutotuneConfig(episodes=3, steps_per_episode=3, warmup_steps=0,
                          presample=24, surrogate_trees=8, ppo_updates=1,
                          ppo_horizon=4, max_workers=2, max_partitions=2,
                          seed=0)
    rep = tr.fit_autotuned(acfg)
    assert len(rep.episodes) == 3
    for ep in rep.episodes:
        assert np.isfinite(list(ep.metrics.values())).all()
        assert ep.steps == acfg.steps_per_episode * int(
            ep.config["partitions"])


def test_partitions_restart_migrates_feature_store():
    """(tests/test_streaming.py:224-248) the dead trainer detaches, the
    rebuilt trainer observes subsequent updates."""
    g = _fresh_graph()
    c = gnn_config("products", smoke=True, partitions=2, halo_budget=8)
    tr = MultiPartitionTrainer(g, c, seed=0, device="cpu")
    ctrl = AutotuneController(tr, tr.make_pipeline(),
                              AutotuneConfig(max_partitions=2, seed=0))
    store = tr.attach_feature_store()
    try:
        ctrl._restart(1)
        new_tr = ctrl.tr
        assert new_tr is not tr and isinstance(new_tr, A3GNNTrainer)
        assert tr.feature_store is None
        assert new_tr.feature_store is store
        node = int(np.where(new_tr.cache.device_map >= 0)[0][0])
        rows = np.full((1, g.feat_dim), 6.5, np.float32)
        store.update_rows(np.array([node]), rows)
        np.testing.assert_array_equal(new_tr.cache.fetch(np.array([node])),
                                      rows)
    finally:
        ctrl.pipe.shutdown()

