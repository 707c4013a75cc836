"""The partition mesh as a ``torch.distributed`` group, on the CPU: gloo
ranks spawned by ``launch/group.spawn_partitions``, one module-scoped
spawn for each world size (2, 3, 4), every rank running all of its checks
at once and the tests asserting on what the ranks returned.

  * 2 ranks: the multi-partition launcher's rank code (``gnn_rank``:
    fused training at smoke size, ``fit_supervised`` 4 steps with a
    checkpoint every 2, then a fresh trainer that restores it) bit-equal
    to the same ``run_gnn_multipartition`` on the host-simulated mesh,
    which ``tests/test_torch_multipart.py`` holds against JAX: every
    partition's loss at each step, params and ``opt_state``, accuracy,
    statistics, the checkpoints' arrays and manifests; an injected failure
    restored on every rank; the gradient mean bit-equal to the
    host-simulated mean and equal in value to JAX's psum over a real
    2-device mesh (JAX's psum keeps a -0.0 that the mean from Python's 0
    makes +0.0); ``compressed_psum_int8`` and ``flash_decode_attention``
    bit-equal to their host-simulated forms;
  * 3 ranks: ``halo_all_to_all`` bit-equal to JAX's exchange over a real
    3-device mesh; the gradient mean;
  * 4 ranks: ``compressed_psum_int8``, the cross-pod transform and
    ``flash_decode_attention``.

A static cache keeps the JAX side's device plane deterministic (queue 3 of
ROADMAP.md).  JAX runs in a subprocess with forced host devices, as
``tests/test_halo.py`` runs its real mesh; this module imports neither JAX
nor the JAX package, so the ranks import the port only.  Each spawn has a
join timeout of 120 s.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import gnn_config
from repro_torch.core.autotune.controller import AutotuneController
from repro_torch.core.multipart import MultiPartitionTrainer
from repro_torch.distributed.collectives import (flash_decode_attention,
                                                 grad_allreduce)
from repro_torch.graph.partition import plan_partitions
from repro_torch.graph.synthetic import dataset_like
from repro_torch.launch import train as train_mod
from repro_torch.launch.group import collectives_rank, spawn_partitions
from repro_torch.launch.mesh import (GroupMesh, HostSimMesh,
                                     make_partition_mesh)
from repro_torch.launch.train import (build_parser, gnn_rank, load_graph,
                                      multipartition_summary,
                                      run_gnn_multipartition)
from repro_torch.train.compression import (compressed_psum_int8,
                                           make_crosspod_grad_transform)

SRC = str(Path(__file__).resolve().parents[1] / "src")
JOIN_S = 120
CFG = dict(smoke=True, partitions=2, halo_budget=32, fused_gather_agg=True,
           sampling_device="device", cache_policy="static",
           cache_volume_mb=0.1)


def _cfg():
    return gnn_config("products", **CFG)


def _args(ckpt_dir):
    return build_parser().parse_args(
        ["--arch", "graphsage-products", "--smoke", "--device", "cpu",
         "--steps", "4", "--ckpt-dir", str(ckpt_dir)])


def _grad_trees(n, seed):
    """One gradient tree a member, with a leaf of -0.0 everywhere."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
             "b": rng.normal(0, 1, (3,)).astype(np.float32),
             "z": np.full((4,), -0.0, np.float32)} for _ in range(n)]


def _shim_inputs(n, seed):
    rng = np.random.default_rng(seed)
    B, T, H, Dh = 3, 8 * n, 4, 16
    return {"compress": [rng.normal(0, 1, (8, 32)).astype(np.float32)
                         for _ in range(n)],
            "crosspod": [{"w": rng.normal(0, 1, (6, 4)).astype(np.float32)}
                         for _ in range(n)],
            "decode": [rng.normal(0, 1, (B, H, Dh)).astype(np.float32),
                       rng.normal(0, 1, (B, T, H, Dh)).astype(np.float32),
                       rng.normal(0, 1, (B, T, H, Dh)).astype(np.float32),
                       np.array([0, 8 * n - 5, T - 1], np.int32)]}


def _halo_inputs():
    g = dataset_like(gnn_config("products", smoke=True), seed=0)
    plan = plan_partitions(g, 3, "locality", seed=0, halo_budget=12)
    return plan, [g.features[ns] for ns in plan.node_sets]


def _named(state):
    return train_mod._named_numpy(state)


def _shutdown(*trainers):
    for t in trainers:
        for s in t.slots:
            s.pipe.shutdown()


def _two_rank_checks(rank, device, args, cfg, fail_dir, inputs):
    """Rank code of the 2-rank spawn: the mesh, the launcher's rank, an
    injected failure, the collectives."""
    mesh = make_partition_mesh(2, device)
    try:
        make_partition_mesh(3, device)
        wrong = None
    except ValueError as e:
        wrong = str(e)
    train = gnn_rank(rank, device, args, cfg, capture=True)
    tr = MultiPartitionTrainer(dataset_like(cfg, seed=0), cfg, seed=0,
                               device=device)
    try:
        rep = tr.fit_supervised(5, fail_dir, ckpt_every=2, fail_at_step=3)
        fail = {"report": dataclasses.asdict(rep),
                "state": _named(tr.state_dict()),
                "losses": {s.index: s.pipe.stats.losses for s in tr.slots}}
        refused = {}
        pipe = tr.make_pipeline()
        ctrl = AutotuneController(tr, pipe, cfg.autotune.replace(
            max_partitions=3))
        try:
            ctrl._restart(3)
            refused["restart_beyond_the_world"] = None
        except ValueError as e:
            refused["restart_beyond_the_world"] = str(e)
        refused["kept"] = (tr.cfg.partitions, ctrl.restarts,
                           ctrl._restart_mgr)
    finally:
        _shutdown(tr)
    return {"mesh": mesh, "wrong_size": wrong, "train": train, "fail": fail,
            "refused": refused,
            "coll": collectives_rank(rank, device, inputs)}


def _raises_on_rank_1(rank, device):
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()                    # rank 0 waits for a peer that is gone


JAX_SIDE = """
import sys
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs.gnn import gnn_config
from repro.distributed.collectives import grad_allreduce, halo_all_to_all
from repro.graph.partition import plan_partitions
from repro.graph.synthetic import dataset_like
from repro.launch.mesh import make_partition_mesh
inp, out = dict(np.load(sys.argv[1])), {}
g = dataset_like(gnn_config("products", smoke=True), seed=0)
plan = plan_partitions(g, 3, "locality", seed=0, halo_budget=12)
mesh = make_partition_mesh(3)
assert isinstance(mesh, Mesh), mesh
rows, volume = halo_all_to_all(mesh)(plan, [g.features[ns]
                                            for ns in plan.node_sets])
out.update({f"halo_{p}": r for p, r in enumerate(rows)})
out["halo_volume"] = np.asarray(volume)
mesh = make_partition_mesh(2)
assert isinstance(mesh, Mesh), mesh
mean = grad_allreduce(mesh)([{k: jnp.asarray(inp[f"{m}_{k}"])
                              for k in ("w", "b", "z")} for m in range(2)])
out.update({f"psum_{k}": np.asarray(v) for k, v in mean.items()})
np.savez(sys.argv[2], **out)
print("JAX_SIDE_OK")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_group")
    np.savez(d / "in.npz", **{f"{m}_{k}": v for m, t in
                              enumerate(_grad_trees(2, 2))
                              for k, v in t.items()})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=3",
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "JAX_SIDE_OK" in r.stdout, \
        f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    return dict(np.load(d / "out.npz"))


def _store(tmp_path_factory, name):
    return f"file://{tmp_path_factory.mktemp(name)}/store"


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = tmp_path_factory.mktemp("group2")
    inputs = {"grad_trees": _grad_trees(2, 2), **_shim_inputs(2, 5),
              "objects": "member"}
    ranks = spawn_partitions(
        _two_rank_checks, 2, "gloo", ["cpu", "cpu"],
        init_method=_store(tmp_path_factory, "store2"),
        args=(_args(d / "group"), _cfg(), d / "group_fail", inputs),
        timeout=JOIN_S)
    return {"ranks": ranks, "dir": d, "inputs": inputs}


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    inputs = {"grad_trees": _grad_trees(3, 3), "halo": _halo_inputs()}
    ranks = spawn_partitions(collectives_rank, 3, "gloo", ["cpu"] * 3,
                             init_method=_store(tmp_path_factory, "store3"),
                             args=(inputs,), timeout=JOIN_S)
    return {"ranks": ranks, "inputs": inputs}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    inputs = _shim_inputs(4, 7)
    ranks = spawn_partitions(collectives_rank, 4, "gloo", ["cpu"] * 4,
                             init_method=_store(tmp_path_factory, "store4"),
                             args=(inputs,), timeout=JOIN_S)
    return {"ranks": ranks, "inputs": inputs}


@pytest.fixture(scope="module")
def host(two):
    """The same runs in this process, on the host-simulated mesh."""
    d = two["dir"]
    cfg, args = _cfg(), _args(d / "host")
    rep = run_gnn_multipartition(args, cfg, load_graph(args, cfg))
    try:
        assert isinstance(rep["trainer"].mesh, HostSimMesh)
        summary = multipartition_summary(rep)
        summary["halo_rows"] = train_mod.halo_rows(rep["trainer"])
    finally:
        _shutdown(rep["trainer"], rep["restored"])
    tr = MultiPartitionTrainer(dataset_like(cfg, seed=0), cfg, seed=0,
                               device="cpu")
    try:
        rep = tr.fit_supervised(5, d / "host_fail", ckpt_every=2,
                                fail_at_step=3)
        fail = {"report": dataclasses.asdict(rep),
                "state": _named(tr.state_dict()),
                "losses": {s.index: s.pipe.stats.losses for s in tr.slots}}
    finally:
        _shutdown(tr)
    return {"train": summary, "fail": fail}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _bit_equal(a, b) -> bool:
    return np.asarray(a).dtype == np.asarray(b).dtype and \
        np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# the mesh and the spawn
# ---------------------------------------------------------------------------

def test_partition_mesh_inside_a_group(two):
    for r, got in enumerate(two["ranks"]):
        assert got["mesh"] == GroupMesh(2, r, "part", "gloo",
                                        torch.device("cpu"))
        assert got["mesh"].shape == {"part": 2}
        assert "group of 2" in got["wrong_size"]


def test_group_refuses_what_is_not_ported_over_it(two):
    """What refuses over a group: a ``partitions`` restart past the
    world's processes (before it checkpoints anything), and a pipeline over
    a ``GroupMesh`` whose axis is not its stage axis."""
    for got in two["ranks"]:
        refused = got["refused"]
        assert refused.pop("kept") == (2, 0, None)
        msg = refused.pop("restart_beyond_the_world")
        assert msg and "restart to 3" in msg and "group of 2" in msg
        assert refused == {}
    from repro_torch.distributed.pp import make_pipeline_fn
    with pytest.raises(ValueError, match="no 'stage' axis of 2 stages"):
        make_pipeline_fn(lambda w, x: x, 2, 4,
                         GroupMesh(2, 0, "part", "gloo", torch.device("cpu")))


def test_group_all_gathers_objects_in_rank_order(two):
    for got in two["ranks"]:
        assert got["coll"]["objects"] == [(0, "member"), (1, "member")]


def test_a_failing_rank_fails_the_spawn(tmp_path):
    # rank 0's barrier may fail first, when gloo sees its peer gone
    with pytest.raises(RuntimeError, match=r"rank [01] of 2 \(gloo\)"):
        spawn_partitions(_raises_on_rank_1, 2, "gloo", ["cpu", "cpu"],
                         init_method=f"file://{tmp_path}/store",
                         timeout=JOIN_S)


def test_spawn_refuses_nccl_without_a_card_each():
    for devices in (["cuda:0", "cuda:0"], ["cpu", "cpu"], ["cuda", "cuda"]):
        with pytest.raises(ValueError, match="one card per rank"):
            spawn_partitions(_raises_on_rank_1, 2, "nccl", devices)


def test_launcher_spawns_only_with_a_card_each(monkeypatch):
    cfg = _cfg()
    assert not train_mod._spawns_ranks(cfg, "cpu")
    assert not train_mod._spawns_ranks(cfg, "cuda") or \
        torch.cuda.device_count() >= 2
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(mesh_mod, "device_count", lambda device: 2)
    assert train_mod._spawns_ranks(cfg, "cuda")
    assert not train_mod._spawns_ranks(cfg.replace(partitions=3), "cuda")
    assert not train_mod._spawns_ranks(cfg.replace(partitions=1), "cuda")


# ---------------------------------------------------------------------------
# fused multi-partition training: 2 gloo ranks = the host-simulated mesh
# ---------------------------------------------------------------------------

def test_group_training_bit_equal_to_host_sim(two, host):
    want = host["train"]
    assert want["report"]["steps_run"] == 4 and want["global_steps"] == 4
    for r, got in enumerate(two["ranks"]):
        got = got["train"]
        assert got["rank"] == r and got["losses"].keys() == {r}
        assert _bit_equal(got["losses"][r], want["losses"][r])
        assert got["state"].keys() == want["state"].keys()
        for k, v in want["state"].items():
            assert _bit_equal(got["state"][k], v), k
        for key in ("report", "global_steps", "acc", "restored_acc",
                    "restored_step", "restored_global_steps",
                    "cache_hit_rate", "halo_hit_rate", "halo_exchange_bytes",
                    "fused_grad_calls"):
            assert got[key] == want[key], key
        assert got["fused_grad_calls"] == 8          # 2 partitions × 4
        for k, v in want["state"].items():
            assert _bit_equal(got["restored_state"][k], v), k
        assert _bit_equal(got["halo_rows"][r], want["halo_rows"][r])
        assert got["launches"] == dict.fromkeys(got["launches"], 0)  # CPU
        assert not {"jax", "repro"} & set(got["modules"])
    # rank 0 prints what the command prints; its numbers are the host's
    text = two["ranks"][0]["train"]["stdout"]
    assert "[result] 4 global steps (8 partition mini-batches)" in text
    assert f"acc={want['acc']:.4f}" in text
    assert "[restore] fresh trainer restored from step 4" in text
    assert two["ranks"][1]["train"]["stdout"] == ""


def test_group_checkpoints_bit_equal_to_host_sim(two, host):
    d = two["dir"]
    for step in (2, 4):
        got_dir, want_dir = (d / run / f"step_{step:09d}"
                             for run in ("group", "host"))
        with np.load(got_dir / "shard_0.npz") as a, \
                np.load(want_dir / "shard_0.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert _bit_equal(a[k], b[k]), k
        got, want = (json.loads((p / "MANIFEST.json").read_text())
                     for p in (got_dir, want_dir))
        got.pop("time"), want.pop("time")
        assert got == want
        assert len(got["extra"]["cache_stats"]) == 2
        assert list(got_dir.parent.glob("step_*/shard_1.npz")) == []


def test_group_failure_is_restored_on_every_rank(two, host):
    want = host["fail"]
    assert want["report"] == {"steps_run": 6, "failures": 1, "restores": 1,
                              "checkpoints": 3, "final_step": 5}
    for r, got in enumerate(two["ranks"]):
        got = got["fail"]
        assert got["report"] == want["report"]
        assert _bit_equal(got["losses"][r], want["losses"][r])
        for k, v in want["state"].items():
            assert _bit_equal(got["state"][k], v), k


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3])
def test_grad_allreduce_group_bit_equal_to_host_sim(two, three, world):
    run = {2: two, 3: three}[world]
    trees = run["inputs"]["grad_trees"]
    want = grad_allreduce(HostSimMesh(world))(
        [{k: _t(v) for k, v in t.items()} for t in trees])
    assert np.signbit(want["z"].numpy()).sum() == 0       # 0 + -0.0 = +0.0
    for got in run["ranks"]:
        got = got["coll"]["grad_trees"] if world == 2 else got["grad_trees"]
        for k, v in want.items():
            assert _bit_equal(got[k], v.numpy()), k


def test_grad_allreduce_group_equals_jax_real_psum(two, jax_out):
    for got in two["ranks"]:
        for k in ("w", "b", "z"):
            np.testing.assert_array_equal(got["coll"]["grad_trees"][k],
                                          jax_out[f"psum_{k}"])


def test_halo_all_to_all_group_bit_equal_to_jax_real_mesh(three, jax_out):
    plan, _ = three["inputs"]["halo"]
    assert plan.halo_rows > 0
    for r, got in enumerate(three["ranks"]):
        rows, volume = got["halo"]
        assert volume == int(jax_out["halo_volume"]) == \
            plan.halo_rows * rows.shape[1] * 4
        assert _bit_equal(rows, jax_out[f"halo_{r}"])


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_int8_group_bit_equal_to_host_sim(two, four, world):
    run = {2: two, 4: four}[world]
    xs = [_t(x) for x in run["inputs"]["compress"]]
    want = compressed_psum_int8(xs, HostSimMesh(world, "pod")).numpy()
    for got in run["ranks"]:
        got = got["coll"] if world == 2 else got
        assert _bit_equal(got["compress"], want)


@pytest.mark.parametrize("world", [2, 4])
def test_flash_decode_group_bit_equal_to_host_sim(two, four, world):
    run = {2: two, 4: four}[world]
    want = flash_decode_attention(HostSimMesh(world, "model"), "model")(
        *map(_t, run["inputs"]["decode"])).numpy()
    for got in run["ranks"]:
        got = got["coll"] if world == 2 else got
        assert _bit_equal(got["decode"], want)


def test_crosspod_transform_over_a_group_is_the_members_mean(four):
    trees = four["inputs"]["crosspod"]
    want = compressed_psum_int8([_t(t["w"]) for t in trees],
                                HostSimMesh(4, "pod")).numpy()
    for got in four["ranks"]:
        assert _bit_equal(got["crosspod"]["w"], want)
    mesh = GroupMesh(4, 0, "part", "gloo", torch.device("cpu"))
    assert make_crosspod_grad_transform(mesh) is None
