"""Checkpointing and fault tolerance of the port (``train/checkpoint.py``,
``train/fault_tolerance.py``) and the single-partition trainer's
checkpoint and streaming hooks, on the CPU.

The on-disk format is the JAX package's: a checkpoint that either package
wrote restores in the other, with params and ``opt_state`` bit-equal
(``count`` included), and the next step on each side agrees within
atol = rtol = 1e-5 (f32; the CPU matmuls of the two frameworks sum in
different orders).  The rest mirror ``tests/test_train_substrate.py``'s
checkpoint and supervisor tests and ``tests/test_streaming.py``'s
single-partition attach, on the port's tensors."""
import json
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.core.a3gnn import A3GNNTrainer as JxTrainer
from repro.graph.synthetic import dataset_like as jx_dataset
from repro.train.checkpoint import CheckpointManager as JxManager
from repro_torch.configs.gnn import AutotuneConfig, gnn_config
from repro_torch.core.a3gnn import A3GNNTrainer
from repro_torch.core.sampling import NeighborSampler, seed_loader
from repro_torch.graph.batch import batch_device_arrays, generate_batch
from repro_torch.graph.synthetic import dataset_like
from repro_torch.models.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy)
from repro_torch.models.params import leaves
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               StragglerMitigator,
                                               TrainSupervisor)

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def batches():
    """Three unfused batches of the smoke graph, as numpy arrays."""
    cfg = gnn_config("products", smoke=True)
    g = dataset_like(cfg, seed=0)
    sampler = NeighborSampler(g, cfg.fanout, seed=7)
    out = []
    for seeds in list(seed_loader(g, cfg.batch_size, 7))[:3]:
        mb = generate_batch(sampler.sample(seeds), None, g)
        out.append(batch_device_arrays(mb))
    return out


def _jx_step(tr, b):
    tr.params, tr.opt_state, loss, _ = tr._step(
        tr.params, tr.opt_state, b["features"], b["neigh_idxs"], b["labels"])
    return float(loss)


def _step(tr, b):
    t = torch.from_numpy
    tr.params, tr.opt_state, loss, _ = tr._step(
        tr.params, tr.opt_state, t(b["features"]),
        [t(i) for i in b["neigh_idxs"]], t(b["labels"]))
    return float(loss)


def _assert_state_equal(jx_tr, tr):
    for a, b in zip(jax.tree.leaves(jx_tr.params), leaves(tr.params),
                    strict=True):
        assert np.array_equal(np.asarray(a), b.numpy())
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jx_tr.opt_state[key]),
                        leaves(tr.opt_state[key]), strict=True):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert isinstance(tr.opt_state["count"], int)
    assert np.asarray(jx_tr.opt_state["count"]).dtype == np.int32
    assert int(jx_tr.opt_state["count"]) == tr.opt_state["count"]


def _pair():
    cfg_j = jx_gnn_config("products", smoke=True)
    cfg_t = gnn_config("products", smoke=True)
    jx_tr = JxTrainer(jx_dataset(cfg_j, seed=0), cfg_j, seed=0)
    tr = A3GNNTrainer(dataset_like(cfg_t, seed=0), cfg_t, seed=1,
                      device="cpu")
    return jx_tr, tr


def test_jax_checkpoint_restores_in_the_port(tmp_path, batches):
    jx_tr, tr = _pair()
    for b in batches[:2]:
        _jx_step(jx_tr, b)
    jx_tr.save(JxManager(tmp_path, async_save=False), step=2)
    assert tr.restore(CheckpointManager(tmp_path, async_save=False)) == 2
    _assert_state_equal(jx_tr, tr)
    assert tr.opt_state["count"] == 2
    # the checkpoint route and the direct converter agree
    direct = opt_state_from_jax(_np(jx_tr.opt_state), "cpu")
    assert direct["count"] == tr.opt_state["count"]
    for a, b in zip(leaves(direct), leaves(tr.opt_state), strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(_step(tr, batches[2]),
                               _jx_step(jx_tr, batches[2]), **TOL)
    for a, b in zip(jax.tree.leaves(jx_tr.params), leaves(tr.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_port_checkpoint_restores_in_jax(tmp_path, batches):
    jx_tr, tr = _pair()
    for b in batches[:2]:
        _step(tr, b)
    tr.save(CheckpointManager(tmp_path, async_save=False), step=2)
    assert jx_tr.restore(JxManager(tmp_path, async_save=False)) == 2
    _assert_state_equal(jx_tr, tr)
    np.testing.assert_allclose(_step(tr, batches[2]),
                               _jx_step(jx_tr, batches[2]), **TOL)
    for a, b in zip(jax.tree.leaves(jx_tr.params), leaves(tr.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_manifest_and_keys_match_jax(tmp_path):
    jx_tr, tr = _pair()
    tr.load_state_dict({"params": params_from_jax(_np(jx_tr.params), "cpu"),
                        "opt_state": opt_state_from_jax(
                            _np(jx_tr.opt_state), "cpu")})
    jx_tr.save(JxManager(tmp_path / "jax", async_save=False), step=3)
    tr.save(CheckpointManager(tmp_path / "port", async_save=False), step=3)
    man = [json.loads((tmp_path / d / "step_000000003" /
                       "MANIFEST.json").read_text()) for d in ("jax", "port")]
    assert man[0]["leaves"] == man[1]["leaves"]
    assert man[0]["extra"] == man[1]["extra"]
    assert man[1]["leaves"]["opt_state/count"] == {"shape": [],
                                                   "dtype": "int32"}
    z = [np.load(tmp_path / d / "step_000000003" / "shard_0.npz")
         for d in ("jax", "port")]
    assert sorted(z[0].files) == sorted(z[1].files)
    assert "params__layers__1__w_neigh" in z[1].files
    for k in z[0].files:
        assert z[0][k].dtype == z[1][k].dtype
        assert np.array_equal(z[0][k], z[1][k]), k


# ---------------------------------------------------------------------------
# checkpoint manager (mirrors tests/test_train_substrate.py)
# ---------------------------------------------------------------------------

def _tiny_state():
    return {"params": {"w": torch.from_numpy(
                           RNG.normal(0, 1, (4, 4)).astype(np.float32)),
                       "b": torch.arange(3, dtype=torch.float32)},
            "opt_state": {"count": 7}}


def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2, async_save=False)
    state = _tiny_state()
    cm.save(10, state)
    restored, step = cm.restore(state)
    assert step == 10
    for k in ("w", "b"):
        assert torch.equal(restored["params"][k], state["params"][k])
    assert restored["opt_state"]["count"] == 7


def test_checkpoint_keep_k_and_latest(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2, async_save=False)
    state = _tiny_state()
    for s in (1, 2, 3, 4):
        cm.save(s, state)
    assert cm.all_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_checkpoint_async_snapshots_before_writing(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3, async_save=True)
    state = _tiny_state()
    want = state["params"]["w"].clone()
    cm.save(5, state)
    state["params"]["w"].add_(1.0)       # a later in-place step
    cm.wait()
    assert cm.latest_step() == 5
    restored, _ = cm.restore(state)
    assert torch.equal(restored["params"]["w"], want)


def test_checkpoint_ignores_uncommitted(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3, async_save=False)
    cm.save(1, _tiny_state())
    # fake a torn write
    bad = tmp_path / "step_000000099"
    bad.mkdir()
    (bad / "shard_0.npz").write_bytes(b"garbage")
    assert cm.latest_step() == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3, async_save=False)
    cm.save(1, _tiny_state())
    bad = {"params": {"w": torch.zeros(5, 5), "b": torch.zeros(3)},
           "opt_state": {"count": 0}}
    with pytest.raises(ValueError, match="shape mismatch"):
        cm.restore(bad)


def test_checkpoint_write_error_surfaces_on_wait(tmp_path):
    cm = CheckpointManager(tmp_path / "ckpt", keep=3, async_save=True)
    (tmp_path / "ckpt").rmdir()
    (tmp_path / "ckpt").write_text("a file where the directory was")
    cm.save(1, _tiny_state())                 # the writer thread fails
    with pytest.raises(FileExistsError):
        cm.wait()
    cm.wait()                                 # the error is raised once


# ---------------------------------------------------------------------------
# fault tolerance (mirrors tests/test_train_substrate.py)
# ---------------------------------------------------------------------------

def test_supervisor_restarts_from_checkpoint(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3, async_save=False)
    fail_at = {12}

    def step_fn(state, step):
        if step in fail_at:
            fail_at.clear()                 # fail exactly once
            raise RuntimeError("simulated node failure")
        return {"params": {"w": state["params"]["w"] + 1.0}}

    state = {"params": {"w": torch.zeros(())}}
    sup = TrainSupervisor(cm, ckpt_every=5, max_restarts=2)
    final, rep = sup.run(state, step_fn, 20)
    assert rep.failures == 1 and rep.restores == 1
    assert rep.final_step == 20
    # w counts *effective* (non-lost) steps: restart replays 10..20
    assert float(final["params"]["w"]) == 20.0


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3, async_save=False)

    def step_fn(state, step):
        raise RuntimeError("always fails")

    sup = TrainSupervisor(cm, ckpt_every=5, max_restarts=2)
    with pytest.raises(RuntimeError, match="always fails"):
        sup.run({"params": {"w": torch.zeros(())}}, step_fn, 4)


def test_heartbeat_detects_dead():
    hb = HeartbeatMonitor(3, timeout=0.2)
    hb.beat(0)
    hb.beat(1)
    hb.mark_dead(2)
    assert 2 in hb.dead_workers()
    assert hb.alive() == [0, 1]
    time.sleep(0.3)
    assert set(hb.dead_workers()) == {0, 1, 2}


def test_straggler_speculative_execution():
    sm = StragglerMitigator(factor=3.0, min_history=3)
    for _ in range(5):
        sm.record(0.01)
    calls = {"n": 0}

    def sometimes_slow():
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.5)                 # straggling primary
        return 42

    v, winner = sm.run_speculative(sometimes_slow)
    assert v == 42
    assert winner == "backup"               # duplicate won


# ---------------------------------------------------------------------------
# the single-partition trainer's checkpoint and streaming hooks
# ---------------------------------------------------------------------------

def test_trainer_checkpoint_extra_and_restore(tmp_path):
    cfg = gnn_config("products", smoke=True)
    tr = A3GNNTrainer(dataset_like(cfg, seed=0), cfg, seed=0, device="cpu")
    tr.run_epochs(1, max_steps_per_epoch=2)
    extra = tr.checkpoint_extra()
    assert extra["partitions"] == 1 and extra["global_steps"] == 0
    assert extra["cache_stats"][0]["hits"] == tr.cache.stats.hits
    mgr = CheckpointManager(tmp_path, async_save=False)
    tr.save(mgr, step=2)
    tr2 = A3GNNTrainer(tr.full_graph, cfg, seed=5, device="cpu")
    assert tr2.restore(mgr) == 2
    for a, b in zip(leaves(tr.state_dict()), leaves(tr2.state_dict()),
                    strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert tr2.opt_state["count"] == 2
    # the autotune hooks act on the restored trainer: a live γ swap, then
    # tuning episodes that resume from the restored optimizer state
    tr2.apply_live_config({"bias_rate": 4.0})
    assert tr2.cfg.bias_rate == 4.0 and tr2.weight_fn is not None
    rep = tr2.fit_autotuned(AutotuneConfig(
        episodes=2, steps_per_episode=2, warmup_steps=0, presample=8,
        surrogate_trees=4, ppo_updates=1, ppo_horizon=2, seed=0))
    assert [ep.steps for ep in rep.episodes] == [2, 2]
    assert tr2.opt_state["count"] == 6 and rep.final_trainer is tr2


def test_single_partition_attach_refreshes_cache_and_detach_stops():
    cfg = gnn_config("products", smoke=True)
    graph = dataset_like(cfg, seed=0)
    tr = A3GNNTrainer(graph, cfg, seed=0, device="cpu")
    store = tr.attach_feature_store()
    node = int(np.where(tr.cache.device_map >= 0)[0][0])
    rows = np.full((1, graph.feat_dim), 5.5, np.float32)
    v = tr.cache.version
    store.update_rows(np.array([node]), rows)
    assert tr.cache.version > v                  # resident copy refreshed
    np.testing.assert_array_equal(tr.cache.fetch(np.array([node])), rows)
    tr.detach_feature_store()
    assert tr.feature_store is None
    store.update_rows(np.array([node]),
                      np.full((1, graph.feat_dim), -1.0, np.float32))
    # detached: the resident copy intentionally no longer tracks the store
    np.testing.assert_array_equal(tr.cache.fetch(np.array([node])), rows)
    # a worker-partition trainer has no global view to subscribe
    tr2 = A3GNNTrainer(graph, cfg.replace(partitions=2), seed=0,
                       device="cpu")
    with pytest.raises(ValueError):
        tr2.attach_feature_store()


def test_params_to_numpy_round_trip():
    cfg = gnn_config("products", smoke=True)
    tr = A3GNNTrainer(dataset_like(cfg, seed=0), cfg, seed=0, device="cpu")
    back = params_from_jax(params_to_numpy(tr.params), "cpu")
    for a, b in zip(leaves(tr.params), leaves(back), strict=True):
        assert torch.equal(a, b)
