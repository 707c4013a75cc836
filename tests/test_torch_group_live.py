"""The partition fleet's live reconfiguration over a ``torch.distributed``
group, on the CPU: 2 gloo ranks spawned by ``launch/group.spawn_partitions``
(one module-scoped spawn, join timeout 120 s), each running the launcher's
rank code ``launch.train.autotune_rank``, held against the same sequence
on the host-simulated mesh in this process, which
``tests/test_torch_multipart.py`` and
``tests/test_torch_autotune_controller.py`` hold against JAX:

  (a) one 2-partition trainer, 2 global steps after each of: the halo
      budget swapped 32 -> 0 -> 32, seeded edges added on every rank and
      ``rebalance_partitions``, a streamed ``update_rows`` of owned rows
      that the other partition holds as halo (refreshed at
      ``halo_refresh_interval`` 2); then (c) an unscripted auto-tuner run of
      3 episodes on the same trainer (wall-clock throughput): only
      agreement is held, every rank's report identical;
  (b) a scripted auto-tuner run on a fresh trainer, partitions 2 -> 1 ->
      2, the halo budget, γ and Θ moved, ``w_throughput=0``: every
      episode's configuration, memory, accuracy and hit rate, each
      episode's losses, each restart's manifest and the final state
      bit-equal to the host-simulated run, and the episodes equal to JAX's
      controller on the same script from the same parameters (losses
      within rel 1e-4, as ``test_scripted_episodes_match_jax`` holds them;
      JAX in a subprocess, so this module imports neither JAX nor the JAX
      package).

Each rank also answers ``_current_config`` holding no partition, refuses
a mesh of more partitions than processes, and raises on topology edits
that diverged between the ranks.  A static cache keeps the JAX side's
device plane deterministic (queue 3 of ROADMAP.md).  The ranks and the
host-simulated runs use one torch thread each: MKL splits a product's
inner dimension over its threads, so a process whose MKL runs another
thread count rounds the weight gradients differently (a rank's losses
moved by 1e-6 once in eight loaded runs of this sequence).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import gnn_config
from repro_torch.core.autotune.controller import AutotuneController
from repro_torch.core.multipart import (IdleRank, MultiPartitionTrainer,
                                        make_rank_trainer)
from repro_torch.graph.synthetic import dataset_like
from repro_torch.launch.group import spawn_partitions
from repro_torch.launch.mesh import make_partition_mesh
from repro_torch.launch.train import autotune_rank, build_parser
from repro_torch.models.convert import params_to_numpy
from repro_torch.models.gnn import decls_gnn
from repro_torch.models.params import init_params

SRC = str(Path(__file__).resolve().parents[1] / "src")
JOIN_S = 120
CFG = dict(smoke=True, partitions=2, halo_budget=32, fused_gather_agg=True,
           sampling_device="device", cache_policy="static",
           cache_volume_mb=0.1, halo_refresh_interval=2)
LIVE = [("steps", 2), ("halo", 0), ("steps", 2), ("halo", 32), ("steps", 2),
        ("edges", (3, 400)), ("rebalance", None), ("steps", 2),
        ("update", (5, 4)), ("steps", 2), ("snapshot", None)]
UNSCRIPTED = dict(episodes=3, presample=8, surrogate_trees=4, ppo_updates=1,
                  ppo_horizon=2, warmup_steps=0, throughput_source="wallclock")
# episodes 1..; episode 0 measures the seed configuration (p = 2, halo 32)
SCRIPT = [dict(bias_rate=4.0, cache_volume_mb=0.05, partitions=1,
               halo_budget=0),
          dict(bias_rate=1.5, cache_volume_mb=0.1, partitions=2,
               halo_budget=16),
          dict(bias_rate=2.0, cache_volume_mb=0.08, partitions=2,
               halo_budget=32)]
SCRIPT = [dict(c, parallel_mode="seq", workers=1) for c in SCRIPT]
SCRIPTED = dict(episodes=len(SCRIPT) + 1, steps_per_episode=3,
                warmup_steps=1, presample=8, surrogate_trees=4,
                ppo_updates=1, ppo_horizon=2, max_partitions=2,
                max_halo_budget=32, w_throughput=0.0, w_memory=1.0,
                w_accuracy=0.0, throughput_source="modeled", seed=0)
# three processes, a fleet of 2 on a process group of ranks 0-1 and rank 2
# idle, grown to 3 by a restart and shrunk back to the cached group
SCRIPT3 = [dict(bias_rate=3.0, cache_volume_mb=0.05, partitions=3,
                halo_budget=16),
           dict(bias_rate=2.0, cache_volume_mb=0.1, partitions=2,
                halo_budget=32)]
SCRIPT3 = [dict(c, parallel_mode="seq", workers=1) for c in SCRIPT3]
LIVE3 = [("steps", 2), ("halo", 16), ("steps", 2),
         ("autotune", dict(SCRIPTED, episodes=len(SCRIPT3) + 1,
                           max_partitions=3, script=SCRIPT3)),
         ("snapshot", None)]
# what an episode must carry over exactly (the throughput is a clock's)
EPISODE_KEYS = ("index", "config", "reward", "cache_hit_rate", "steps")


def _cfg():
    return gnn_config("products", **CFG)


def _args():
    return build_parser().parse_args(
        ["--arch", "graphsage-products", "--smoke", "--device", "cpu",
         "--steps", "3", "--episodes-autotune", "3"])


def _sequences(rank, device):
    args, cfg = _args(), _cfg()
    return {"live": autotune_rank(rank, device, args, cfg,
                                  ops=LIVE + [("autotune", UNSCRIPTED)]),
            "scripted": autotune_rank(rank, device, args, cfg, script=SCRIPT,
                                      ops=[("autotune", SCRIPTED)])}


def _idle_config(device):
    """A one-partition fleet in a group of 2: rank 0 trains, rank 1 holds
    no partition; both answer the configuration of record."""
    cfg = _cfg().replace(partitions=1)
    tr = make_rank_trainer(dataset_like(cfg, seed=0), cfg, seed=0,
                           device=device)
    pipe = tr.make_pipeline()
    try:
        ctrl = AutotuneController(tr, pipe, cfg.autotune.replace(
            max_partitions=2, max_halo_budget=32))
        return type(tr).__name__, ctrl._current_config()
    finally:
        if pipe is not None:
            pipe.shutdown()


def _diverged(rank, device):
    """Rank r adds edges of its own seed: the rebalance's guard raises."""
    cfg = _cfg()
    g = dataset_like(cfg, seed=0)
    tr = MultiPartitionTrainer(g, cfg, seed=0, device=device)
    rng = np.random.default_rng(10 + rank)
    g.add_edges(rng.integers(0, g.num_nodes, 200),
                rng.integers(0, g.num_nodes, 200))
    try:
        tr.rebalance_partitions()
        return None
    except RuntimeError as e:
        return str(e)
    finally:
        for s in tr.slots:
            s.pipe.shutdown()


def _three_rank(rank, device):
    torch.set_num_threads(1)
    return autotune_rank(rank, device, _args(), _cfg(), ops=LIVE3)


def _live_rank(rank, device):
    torch.set_num_threads(1)
    out = _sequences(rank, device)
    out["idle_config"] = _idle_config(device)
    try:
        make_partition_mesh(3, device)
        out["too_many"] = None
    except ValueError as e:
        out["too_many"] = str(e)
    out["diverged"] = _diverged(rank, device)
    return out


JAX_SIDE = """
import pickle
import sys
import jax
import jax.numpy as jnp
from repro.configs.gnn import AutotuneConfig, gnn_config
from repro.core.a3gnn import make_trainer
from repro.core.autotune.controller import AutotuneController as C
from repro.graph.synthetic import dataset_like
spec = pickle.loads(open(sys.argv[1], "rb").read())
cfg = gnn_config("products", **spec["cfg"])
tr = make_trainer(dataset_like(cfg, seed=0), cfg, seed=0)
tr.params = jax.tree.map(jnp.asarray, spec["params"])
proposals, losses, measure = iter(spec["script"]), [], C.measure
def measured(self, index, cfg, predicted=None):
    ep = measure(self, index, cfg, predicted)
    losses.append(list(self.pipe.stats.losses))
    return ep
C.propose = lambda self: (dict(next(proposals)), None)
C.measure = measured
rep = tr.fit_autotuned(AutotuneConfig(**spec["acfg"],
                                      restart_dir=sys.argv[3]))
out = {"episodes": [dict(config=e.config, memory=e.metrics["memory"],
                         accuracy=e.metrics["accuracy"],
                         hit=e.cache_hit_rate, steps=e.steps)
                    for e in rep.episodes],
       "losses": losses, "best": rep.best.index}
open(sys.argv[2], "wb").write(pickle.dumps(out))
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the 2- and 3-rank spawns and the
    host-simulated runs, the subprocess overlapping the rest."""
    d = tmp_path_factory.mktemp("group_live")
    cfg = _cfg()
    params = init_params(decls_gnn(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    (d / "spec.pkl").write_bytes(pickle.dumps(
        {"cfg": CFG, "params": params_to_numpy(params), "script": SCRIPT,
         "acfg": SCRIPTED}))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(d / "spec.pkl"),
         str(d / "jax.pkl"), str(d / "jax_restart")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ranks = spawn_partitions(
            _live_rank, 2, "gloo", ["cpu", "cpu"],
            init_method=f"file://{d}/store", timeout=JOIN_S)
        three = spawn_partitions(
            _three_rank, 3, "gloo", ["cpu"] * 3,
            init_method=f"file://{d}/store3", timeout=JOIN_S)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            host = _sequences(0, "cpu")
            host3 = autotune_rank(0, "cpu", _args(), _cfg(), ops=LIVE3)
        finally:
            torch.set_num_threads(threads)
        out, err = jax_proc.communicate(timeout=300)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0 and "JAX_SIDE_OK" in out, \
        f"STDOUT:\n{out}\nSTDERR:\n{err[-3000:]}"
    return {"ranks": ranks, "host": host, "three": three, "host3": host3,
            "jax": pickle.loads((d / "jax.pkl").read_bytes())}


def _bit_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _hold_steps(r, g, w):
    """A ``steps`` record of rank r against the host-simulated one."""
    for key, value in w.items():
        if key.endswith("seconds"):
            continue
        if key == "losses":
            assert g[key].keys() == {r}
            assert _bit_equal(g[key][r], value[r]), (w["op"], r)
        else:
            assert g[key] == value, (w["op"], key)


def _hold_autotune(r, g, w):
    """A scripted auto-tuner record of rank r against the host-simulated
    one: every episode (but its clock's throughput), each episode's losses
    where rank r held a partition (None where it held none), the
    restarts' manifests."""
    for eg, ew in zip(g["episodes"], w["episodes"], strict=True):
        for key in EPISODE_KEYS:
            assert eg[key] == ew[key], (r, ew["index"], key)
        for key in ("memory", "accuracy"):
            assert eg["metrics"][key] == ew["metrics"][key], key
    assert g["best"] == w["best"]
    assert len(g["losses"]) == len(w["losses"]) == len(g["t_walls"])
    for i, (lg, lw) in enumerate(zip(g["losses"], w["losses"])):
        if w["episodes"][i]["config"]["partitions"] > r:
            assert _bit_equal(lg, lw), (r, i)
            assert g["t_walls"][i] > 0
        else:
            assert lg is None and g["t_walls"][i] is None
    assert g["manifests"] == w["manifests"]


def _hold_final(r, got, want):
    """The state, hit rates, manifest and halo rows a rank holds at the
    end, against the host-simulated run's."""
    assert got["partitions"] == want["partitions"]
    assert got["held"] == (r < want["partitions"])
    if not got["held"]:
        return
    assert got["state"].keys() == want["state"].keys()
    for k, v in want["state"].items():
        assert _bit_equal(got["state"][k], v), k
    for key in ("cache_hit_rate", "halo_hit_rate", "manifest"):
        assert got[key] == want[key], key
    if "halo_rows" in want:
        assert got["halo_rows"].keys() == {r}
        assert _bit_equal(got["halo_rows"][r], want["halo_rows"][r])


# ---------------------------------------------------------------------------
# (a) the live operations
# ---------------------------------------------------------------------------

def test_live_operations_bit_equal_to_host_sim(runs):
    want = runs["host"]["live"]["ops"][:len(LIVE) - 1]
    assert [w["op"] for w in want] == [name for name, _ in LIVE[:-1]]
    assert want[-1]["halo_refreshes"] == 1           # the update refreshed
    assert len(want[-1]["refresh_seconds"]) == 1
    assert want[6]["moved_nodes"] > 0                # the rebalance moved
    for r, got in enumerate(runs["ranks"]):
        for g, w in zip(got["live"]["ops"], want):
            _hold_steps(r, g, w)


def test_live_fleet_bit_equal_to_host_sim_after_the_operations(runs):
    """State, hit rates, manifest and halo rows after (a): the streamed
    rows reached the other partition's halo through the refresh."""
    want = runs["host"]["live"]["ops"][len(LIVE) - 1]
    assert want["op"] == "snapshot" and want["held"]
    assert want["manifest"]["rebalances"] == 1
    for r, got in enumerate(runs["ranks"]):
        _hold_final(r, got["live"]["ops"][len(LIVE) - 1], want)
        assert got["live"]["launches"] == dict.fromkeys(
            got["live"]["launches"], 0)                        # the CPU
        assert not {"jax", "repro"} & set(got["live"]["modules"])


# ---------------------------------------------------------------------------
# (b) the scripted auto-tuner, with its partitions restarts
# ---------------------------------------------------------------------------

def test_scripted_autotune_bit_equal_to_host_sim(runs):
    want = runs["host"]["scripted"]
    w = want["ops"][0]
    assert [e["config"]["partitions"] for e in w["episodes"]] == [2, 1, 2, 2]
    assert [m["partitions"] for m in w["manifests"]][:2] == [2, 1]
    for r, got in enumerate(runs["ranks"]):
        _hold_autotune(r, got["scripted"]["ops"][0], w)
        _hold_final(r, got["scripted"], want)


def test_scripted_autotune_matches_jax(runs):
    want = runs["jax"]
    got = runs["host"]["scripted"]["ops"][0]
    assert got["best"] == want["best"]
    for et, ej in zip(got["episodes"], want["episodes"], strict=True):
        assert et["config"] == ej["config"]
        assert et["metrics"]["memory"] == ej["memory"]
        assert et["cache_hit_rate"] == ej["hit"]
        assert et["steps"] == ej["steps"] == 3 * et["config"]["partitions"]
        assert et["metrics"]["accuracy"] == pytest.approx(ej["accuracy"],
                                                          abs=1e-3)
    for a, b in zip(got["losses"], want["losses"], strict=True):
        assert len(a) == len(b) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=0)


def test_fleet_on_the_first_ranks_of_a_larger_group(runs):
    """3 processes, a 2-partition fleet on the process group of ranks 0-1
    (rank 2 idle): steps and a halo swap, then restarts to 3 partitions
    (the world) and back to 2 (the cached group), bit-equal to the
    host-simulated run."""
    want = runs["host3"]
    w = want["ops"][3]
    assert [e["config"]["partitions"] for e in w["episodes"]] == [2, 3, 2]
    assert [m["partitions"] for m in w["manifests"]][:2] == [2, 3]
    for r, got in enumerate(runs["three"]):
        for g, wo in zip(got["ops"][:3], want["ops"][:3]):
            if r < 2:
                _hold_steps(r, g, wo)
            else:                             # idle: records, runs nothing
                assert set(g) == {"op", "seconds"}
        _hold_autotune(r, got["ops"][3], w)
        _hold_final(r, got["ops"][4], want["ops"][4])
        _hold_final(r, got, want)
        assert not {"jax", "repro"} & set(got["modules"])


# ---------------------------------------------------------------------------
# (c) the unscripted auto-tuner: every rank agrees
# ---------------------------------------------------------------------------

def test_unscripted_autotune_every_rank_agrees(runs):
    reports = [got["live"]["ops"][-1] for got in runs["ranks"]]
    assert len(reports[0]["episodes"]) == UNSCRIPTED["episodes"]
    for rep in reports[1:]:
        assert rep["episodes"] == reports[0]["episodes"]     # rank 0's
        assert rep["best"] == reports[0]["best"]
    for rep in reports:                       # each rank's own wall clock
        assert all(t > 0 for t in rep["t_walls"])
    finals = [got["live"] for got in runs["ranks"]]
    assert all(f["held"] for f in finals)
    for k, v in finals[0]["state"].items():   # the same mean, the same step
        assert _bit_equal(finals[1]["state"][k], v), k


# ---------------------------------------------------------------------------
# what a group refuses or guards
# ---------------------------------------------------------------------------

def test_idle_rank_answers_the_configuration_of_record(runs):
    kinds = [got["idle_config"][0] for got in runs["ranks"]]
    assert kinds == ["A3GNNTrainer", IdleRank.__name__]
    configs = [got["idle_config"][1] for got in runs["ranks"]]
    assert configs[0] == configs[1]
    assert configs[0]["partitions"] == 1 and \
        configs[0]["cache_volume_mb"] == CFG["cache_volume_mb"]


def test_more_partitions_than_processes_refuse(runs):
    for got in runs["ranks"]:
        assert "3 partitions" in got["too_many"]
        assert "group of 2" in got["too_many"]


def test_diverged_topology_edits_raise_on_the_guard(runs):
    for got in runs["ranks"]:
        assert got["diverged"] and "disagree" in got["diverged"]
