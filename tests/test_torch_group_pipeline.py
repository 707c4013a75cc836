"""The GPipe pipeline over a ``torch.distributed`` stage group, on the CPU:
``gloo`` ranks spawned by ``launch/group.spawn_partitions`` (module-scoped
spawns, one torch thread a process), each running stage ``rank`` of
``distributed/pp.make_pipeline_fn`` over a ``GroupMesh`` through the rank
code ``launch.group.pipeline_rank``, forward and the hand-written
backward, held against

  * the port's host-simulated pipeline in this process (one torch
    thread), bit for bit: outputs, every stage's parameter gradients and
    the gradient of ``xs``;
  * JAX's ``shard_map`` pipeline and ``jax.grad`` through it, on forced
    host devices in a subprocess (so this module imports neither JAX nor
    the JAX package): the toy stack of
    ``tests/test_distributed.py::test_pipeline_parallel_matches_sequential``
    (S 4 and S 2, M 8, mb 4, D 16, seed 0, ``tanh(x @ w)``), outputs within
    1e-6 and the gradients of ``sum(out ** 2)`` within 1e-5; a smoke-size
    llama3.2-3b in f32 (4 layers, 2 stages of 2), a stage the port's
    ``transformer.layer_fwd`` against JAX's ``_layer_fwd``, with JAX's
    ``init_params`` carried across and with weights scaled by their
    fan-in: outputs and each gradient leaf of ``mean(out ** 2)`` within the
    tolerances measured and stated at ``LM_CASES``;
  * the sequential stack (the toy's gradients within 1e-5): the replicated
    output's cotangent counts once, not once a stage.

The schedule's edges (M < S, M = 1, a 2-stage mesh over the first 2 ranks
of 3 whose rank 2 idles) and the refusals (a wrong axis, a wrong size, a
``layer_fn`` that changes the shape, raised on every rank with no hang)
run in the same spawns.
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

from repro_torch.distributed.pp import make_pipeline_fn
from repro_torch.launch.group import pipeline_rank, spawn_partitions
from repro_torch.launch.mesh import GroupMesh, HostSimMesh, make_partition_mesh

SRC = str(Path(__file__).resolve().parents[1] / "src")
JOIN_S = 120
MB, D = 4, 16                        # the toy's rows a microbatch, width
TOYS = {"s4m8": (4, 8), "s2m8": (2, 8), "s4m2": (4, 2), "s2m1": (2, 1)}
LM = dict(arch="llama3.2-3b", smoke=True, num_layers=4, dtype="float32")
LM_MICRO, LM_MB, LM_TOKENS = 4, 2, 16
# (weights, the output's max |port - JAX| over its largest JAX entry, each
# gradient leaf's max |port - JAX| over that leaf's largest JAX entry).
# JAX's ``init_params`` gives ``wv (D, Hkv, Dh)`` a fan-in of Hkv, and the
# seeded stack is chaotic in f32: 1e-7 relative noise on ``xs`` moves
# JAX's own output 3.4e-5 of its largest (94.5), and JAX's jitted and
# eager stacks differ by 1.5e-5 of it; the port read 2.8e-5 (output) and
# 1.2e-4 to 2.8e-4 (the leaves and ``xs``).  Weights drawn N(0, 1 / their
# whole fan-in) (``scaled``, as ``tests/test_torch_lm_train_archs.py``
# draws them) keep the stack tame: the port read 4.2e-7 of the largest
# output (11.2; 4.8e-6 absolute, within 1e-5) and at most 1.1e-6 a leaf.
LM_CASES = {"lm": ("jax", 1e-4, 1e-3), "lm_scaled": ("scaled", 1e-6, 1e-5)}
FAN_IN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
               "w_down": 1}


def toy_inputs(S: int, M: int) -> dict:
    """``test_pipeline_parallel_matches_sequential``'s draw for S stages
    and M microbatches."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (M * MB, D)).astype(np.float32)
    return {"stages": S, "micro": M, "loss": "sum",
            "toy": {"w": w, "xs": x.reshape(M, MB, D)}}


JAX_SIDE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed.pp import make_pipeline_fn
from repro.models.api import build
from repro.models.params import init_params
from repro.models.transformer import _layer_fwd
spec = pickle.loads(open(sys.argv[1], "rb").read())
out = {}

def run(layer_fn, S, M, w, xs, loss):
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))
    pipe = make_pipeline_fn(layer_fn, S, M, mesh)
    f = lambda w, x: loss(pipe(w, x))
    y = jax.jit(pipe)(w, xs)
    gw, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(w, xs)
    return np.asarray(y), jax.tree.map(np.asarray, gw), np.asarray(gx)

for name, (S, M, w, xs) in spec["toys"].items():
    out[name] = run(lambda w, x: jnp.tanh(x @ w), S, M, jnp.asarray(w),
                    jnp.asarray(xs), lambda y: jnp.sum(y ** 2))
lm = spec["lm"]
cfg = get_config(lm["arch"], smoke=True).replace(
    num_layers=lm["num_layers"], compute_dtype="float32")
S, per = 2, lm["num_layers"] // 2
xs = jnp.asarray(lm["xs"])
M, B, T, D = xs.shape

def stage(p, x):
    # JAX's pipeline places a microbatch by (M, 1, 1) masks: 3-D here
    h = x.reshape(B, T, D)
    pos = jnp.arange(T, dtype=jnp.int32)[None, :].repeat(B, 0)
    for i in range(per):
        h = _layer_fwd(jax.tree.map(lambda a: a[i], p), h, cfg, pos)[0]
    return h.reshape(x.shape)

for name, layers in spec["lms"].items():
    if layers is None:
        layers = init_params(build(cfg).decls, jax.random.PRNGKey(0))["layers"]
    layers = jax.tree.map(jnp.asarray, layers)
    staged = jax.tree.map(lambda a: a.reshape(S, per, *a.shape[1:]), layers)
    y, gw, gx = run(stage, S, M, staged, xs.reshape(M, B, T * D),
                    lambda y: jnp.mean(y.astype(jnp.float32) ** 2))
    out[name] = (y.reshape(M, B, T, D), gw, gx.reshape(M, B, T, D),
                 jax.tree.map(np.asarray, layers))
open(sys.argv[2], "wb").write(pickle.dumps(out))
print("JAX_SIDE_OK")
"""


def _refusals(rank, device) -> dict:
    """Each refusal's message on this rank (None: it did not raise)."""
    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None
    stage = make_partition_mesh(2, device, axis="stage")
    part = make_partition_mesh(2, device, axis="part")
    xs = torch.ones(4, 3, 5)
    w = {"w": torch.ones(1, 5, 5)}

    def shrink_on(s):
        def layer(p, x):
            y = torch.tanh(x @ p["w"])
            return y[..., :-1] if rank == s else y
        return make_pipeline_fn(layer, 2, 4, stage)(w, xs)
    return {"axis": message(lambda: make_pipeline_fn(_tanh, 2, 4, part)),
            "size": message(lambda: make_pipeline_fn(_tanh, 3, 4, stage)),
            "shape_stage0": message(lambda: shrink_on(0)),
            "shape_stage1": message(lambda: shrink_on(1)),
            "after": pipeline_rank(rank, device, toy_inputs(2, 8))}


def _tanh(p, x):
    return torch.tanh(x @ p["w"])


def _signed_zero_stage(p, x):
    return x * p["w"]


def signed_zero_inputs():
    """A stage ``x * w`` whose gradients hold exact zeros of both signs:
    column 0 of ``xs`` is -0.0, column 1 +0.0, under a cotangent of mixed
    sign."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, 1, (2, 4)).astype(np.float32)
    xs = rng.normal(0, 1, (3, 2, 4)).astype(np.float32)
    xs[..., 0], xs[..., 1] = -0.0, 0.0
    return w, xs


def _signed_zeros(rank, device, mesh=None):
    """The ``x * w`` pipeline's gradients of ``sum(out * sign)``: this
    stage's over a group, every stage's over ``mesh``."""
    w, xs = signed_zero_inputs()
    mesh = mesh or make_partition_mesh(2, device, axis="stage")
    if isinstance(mesh, GroupMesh):
        w = w[rank:rank + 1]
    w = torch.from_numpy(w).requires_grad_()
    xs = torch.from_numpy(xs).requires_grad_()
    out = make_pipeline_fn(_signed_zero_stage, 2, 3, mesh)({"w": w}, xs)
    sign = torch.tensor([1.0, -1.0, 1.0, 1.0])
    gw, gx = torch.autograd.grad((out * sign).sum(), (w, xs))
    return {"w": gw, "xs": gx}


def _two_rank(rank, device, lms):
    torch.set_num_threads(1)
    out = {name: pipeline_rank(rank, device, toy_inputs(*TOYS[name]))
           for name in ("s2m8", "s2m1")}
    out.update({name: pipeline_rank(rank, device, inputs)
                for name, inputs in lms.items()})
    out["refused"] = _refusals(rank, device)
    out["signed_zeros"] = _signed_zeros(rank, device)
    return out


def _four_rank(rank, device):
    torch.set_num_threads(1)
    return {name: pipeline_rank(rank, device, toy_inputs(*TOYS[name]))
            for name in ("s4m8", "s4m2")}


def _three_rank(rank, device):
    """A 2-stage pipeline over ranks 0 and 1 of 3; rank 2 idles, and the
    pipeline refuses it."""
    torch.set_num_threads(1)
    out = {"s2m8": pipeline_rank(rank, device, toy_inputs(2, 8))}
    mesh = make_partition_mesh(2, device, axis="stage")
    out["mesh"] = mesh
    if not mesh.holds_partition:
        try:
            make_pipeline_fn(_tanh, 2, 8, mesh)(
                {"w": torch.ones(1, D, D)}, torch.ones(8, MB, D))
            out["idle_call"] = None
        except RuntimeError as e:
            out["idle_call"] = str(e)
    return out


def scaled_layers(seed=0) -> dict:
    """The smoke stack's layer tree drawn in numpy: each weight N(0, 1 /
    its whole fan-in), each norm scale U(0.5, 1.5)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import stack_decls
    from repro_torch.models.transformer import decls_layer
    rng = np.random.default_rng(seed)
    cfg = get_config(LM["arch"], smoke=True)

    def draw(tree, key=None):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        if tree.init == "ones":
            x = rng.uniform(0.5, 1.5, tree.shape)
        else:
            core = tree.shape[1:]
            x = rng.standard_normal(tree.shape) / np.sqrt(
                np.prod(core[:FAN_IN_AXES[key]]))
        return x.astype(np.float32)
    return draw(stack_decls(decls_layer(cfg), LM["num_layers"]))


def lm_inputs(layers=None) -> dict:
    rng = np.random.default_rng(7)
    xs = rng.normal(0, 1, (LM_MICRO, LM_MB, LM_TOKENS, 64)).astype(np.float32)
    return {"stages": 2, "micro": LM_MICRO, "loss": "mean",
            "lm": {**LM, "layers": layers, "xs": xs}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the 4- and 3-rank spawns beside it, then the
    2-rank spawn (its LM stack is JAX's) and the host-simulated runs."""
    d = tmp_path_factory.mktemp("group_pipeline")
    toys = {k: (S, M, toy_inputs(S, M)["toy"]["w"],
                toy_inputs(S, M)["toy"]["xs"]) for k, (S, M) in TOYS.items()}
    scaled = scaled_layers()
    (d / "spec.pkl").write_bytes(pickle.dumps(
        {"toys": toys, "lm": {**LM, "xs": lm_inputs()["lm"]["xs"]},
         "lms": {"lm": None, "lm_scaled": scaled}}))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(d / "spec.pkl"),
         str(d / "jax.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        four = spawn_partitions(_four_rank, 4, "gloo", ["cpu"] * 4,
                                init_method=f"file://{d}/store4",
                                timeout=JOIN_S)
        three = spawn_partitions(_three_rank, 3, "gloo", ["cpu"] * 3,
                                 init_method=f"file://{d}/store3",
                                 timeout=JOIN_S)
        out, err = jax_proc.communicate(timeout=300)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0 and "JAX_SIDE_OK" in out, \
        f"STDOUT:\n{out}\nSTDERR:\n{err[-3000:]}"
    jx = pickle.loads((d / "jax.pkl").read_bytes())
    lms = {name: lm_inputs(jx[name][3]) for name in LM_CASES}
    two = spawn_partitions(_two_rank, 2, "gloo", ["cpu"] * 2,
                           init_method=f"file://{d}/store2", args=(lms,),
                           timeout=JOIN_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        host = {k: pipeline_rank(0, "cpu", toy_inputs(S, M))
                for k, (S, M) in TOYS.items()}
        host.update({name: pipeline_rank(0, "cpu", inputs)
                     for name, inputs in lms.items()})
        host["signed_zeros"] = _signed_zeros(0, "cpu", HostSimMesh(2, "stage"))
    finally:
        torch.set_num_threads(threads)
    return {"two": two, "three": three, "four": four, "host": host,
            "jax": jx}


def _bit_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.view(-1).view(torch.uint8).equal(b.view(-1).view(torch.uint8))


def _rank_results(runs, case: str) -> list:
    world = {"s4m8": "four", "s4m2": "four"}.get(case, "two")
    return [r[case] for r in runs[world]]


def _hold_to_host(got: list, want: dict, S: int):
    """Every stage's values bit-equal to the host-simulated run's."""
    seen = set()
    for s, res in enumerate(got[:S]):
        assert res["stage"] == s
        for k, v in res["values"].items():
            assert _bit_equal(v, want["values"][k]), (s, k)
            seen.add(k)
    assert seen == set(want["values"])


@pytest.mark.parametrize("case", list(TOYS))
def test_toy_pipeline_bit_equal_to_host_sim(runs, case):
    S, M = TOYS[case]
    _hold_to_host(_rank_results(runs, case), runs["host"][case], S)


def _grads(values, S: int):
    w = torch.cat([values[f"grad/{s}/w"] for s in range(S)])
    return w.numpy(), values["dxs"].numpy()


@pytest.mark.parametrize("case", list(TOYS))
def test_toy_pipeline_matches_jax(runs, case):
    S, M = TOYS[case]
    y, gw, gx = runs["jax"][case]
    host = runs["host"][case]["values"]
    np.testing.assert_allclose(host["out"].numpy(), y, rtol=0, atol=1e-6)
    w, x = _grads(host, S)
    np.testing.assert_allclose(w, gw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(x, gx, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", list(TOYS))
def test_toy_gradient_is_the_sequential_stacks_once(runs, case):
    """The replicated output's cotangent counts once: the gradients equal
    the sequential stack's, not S times them."""
    S, M = TOYS[case]
    inp = toy_inputs(S, M)["toy"]
    w = torch.from_numpy(inp["w"]).requires_grad_()
    xs = torch.from_numpy(inp["xs"]).requires_grad_()
    h = xs
    for s in range(S):
        h = torch.tanh(h @ w[s])
    gw, gx = torch.autograd.grad((h ** 2).sum(), (w, xs))
    got_w, got_x = _grads(_stage_values(runs, case), S)
    assert float(gw.abs().max()) > 0
    np.testing.assert_allclose(got_w, gw.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_x, gx.numpy(), rtol=0, atol=1e-5)


def _stage_values(runs, case) -> dict:
    """The group run's values: every stage's gradients, each from the rank
    that holds it."""
    return {k: v for r in _rank_results(runs, case)
            for k, v in r.get("values", {}).items()}


def test_every_rank_holds_the_outputs_and_the_gradient_of_xs(runs):
    for case in TOYS:
        got = _rank_results(runs, case)
        for r in got:
            for k in ("out", "dxs"):
                assert _bit_equal(r["values"][k], got[0]["values"][k])


def test_schedule_traffic_per_boundary(runs):
    """Stage s sends each microbatch's activation once forward (s < S-1)
    and its input's gradient once backward (s > 0), nothing over the ring
    edge from the last stage to the first; bubbles move nothing."""
    for case, (S, M) in TOYS.items():
        act = MB * D * 4
        for s, r in enumerate(_rank_results(runs, case)[:S]):
            fwd = [t for t in r["traffic"] if t[0] == "forward"]
            bwd = [t for t in r["traffic"] if t[0] == "backward"]
            assert sum(t[2] for t in fwd) == (M * act if s < S - 1 else 0)
            assert sum(t[3] for t in fwd) == (M * act if s > 0 else 0)
            assert sum(t[2] for t in bwd) == (M * act if s > 0 else 0)
            assert sum(t[3] for t in bwd) == (M * act if s < S - 1 else 0)
            assert all(1 <= t[1] <= S + M - 2 for t in fwd)


def test_pipeline_over_the_first_ranks_of_a_larger_world(runs):
    """Ranks 0-1 of a 3-rank world give the 2-rank world's results; rank 2
    holds no stage, and calling the pipeline there raises."""
    three = runs["three"]
    assert [r["mesh"] for r in three] == [
        GroupMesh(2, r, "stage", "gloo", torch.device("cpu"), 3)
        for r in range(3)]
    assert [r["mesh"].holds_partition for r in three] == [True, True, False]
    assert three[2]["s2m8"]["stage"] is None
    assert "holds no stage" in three[2]["idle_call"]
    for s in range(2):
        want = runs["two"][s]["s2m8"]["values"]
        got = three[s]["s2m8"]["values"]
        assert got.keys() == want.keys()
        for k in want:
            assert _bit_equal(got[k], want[k]), k


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_stack_bit_equal_to_host_sim(runs, case):
    _hold_to_host([r[case] for r in runs["two"]], runs["host"][case], 2)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_stack_matches_jax(runs, case):
    _, out_tol, leaf_rel = LM_CASES[case]
    y, gw, gx, _ = runs["jax"][case]
    host = runs["host"][case]["values"]
    np.testing.assert_allclose(host["out"].numpy(), y, rtol=0,
                               atol=out_tol * np.abs(y).max())
    np.testing.assert_allclose(host["dxs"].numpy(), gx, rtol=0,
                               atol=leaf_rel * np.abs(gx).max())
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v
    walk(gw)
    assert len(flat) == len([k for k in host if k.startswith("grad/0/")])
    for name, want in flat.items():
        got = np.concatenate([host[f"grad/{s}/{name}"].numpy()
                              for s in range(2)])
        assert got.shape == want.shape, name
        scale = float(np.abs(want).max())
        assert scale > 0, name
        err = float(np.abs(got - want).max())
        assert err <= leaf_rel * scale, (name, err / scale)


def test_refusals_raise_on_every_rank(runs):
    for r in runs["two"]:
        refused = r["refused"]
        assert "'stage' axis of 2 stages" in refused["axis"]
        assert "'stage' axis of 3 stages" in refused["size"]
        for s in (0, 1):
            msg = refused[f"shape_stage{s}"]
            assert msg and f"stage {s}'s layer_fn turned" in msg, msg
        # the group is still in step after the refusals
        for k, v in refused["after"]["values"].items():
            assert _bit_equal(v, r["s2m8"]["values"][k]), k


def test_signed_zero_gradients_as_the_host_simulated_form(runs):
    """A stacked leaf's host-simulated gradient sums each stage's slice
    with the others' zeros (-0.0 becomes +0.0); the group form's matches
    it sign for sign."""
    want = runs["host"]["signed_zeros"]
    assert bool((want["w"] == 0).any())
    for s, r in enumerate(runs["two"]):
        got = r["signed_zeros"]
        assert _bit_equal(got["w"], want["w"][s:s + 1])
        assert _bit_equal(got["xs"], want["xs"])
