"""The sharded train step's two memory faults, repaired: the loss's gold
logit read per rank, and Adafactor's update on each rank's shards.

  * The loss at a vocabulary that does not divide the model axis
    (``vocab_size`` 255): whisper-medium and mamba2-1.3b at smoke size over
    4 ``gloo`` CPU ranks as (2, 2), held to the unsharded step (loss and
    gradients within 1e-5 abs, parameters after 2 AdamW steps within 1e-4
    of each leaf's largest magnitude), each rank's bytes by op equal to the
    ``meta`` trace; and the ``meta`` trace of the same step on a fake
    (4, 2) group peaks at least (1 - 1/4) x B x S x V x 4 B below the
    figure the same trace gave before the repair, when the gather's
    backward made zeros of the global (B, S, V) logits on every rank.
  * Adafactor on kimi-k2-1t-a32b at smoke size, 3 layers (uneven over the
    2 data ranks) at (2, 2): the parameters after 2 sharded steps within
    1e-4 of each leaf's largest magnitude of the unsharded ones (the
    weights JAX's re-scaled to the fan-in, as whisper's), and each
    rank's bytes equal to the trace; the unsharded update of the step's
    gradients held to JAX's ``update``; and the ``meta`` trace of a
    17-layer step on a fake (16, 16) group issues no all-gather from the
    optimizer (before the repair it issued 34, the largest a (272, 4, 1,
    64) f32 view of a stacked expert weight, where DTensor placed the
    update's layer axis over the data ranks).
  * Adafactor's state placed by its declarations lies as the sharded
    update needs it (``optimizer._check_placed``): the parameter's
    placements less the factored dim, for every leaf of every LM arch on
    (16, 16) and (2, 16, 16), so it is never redistributed.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.models.api import build as jx_build
from repro.models.params import init_params as jx_init
from repro.train import optimizer as jx_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.group import (sharded_lm_rank, sharded_runs_rank,
                                      spawn_partitions)
from repro_torch.launch.mesh import (AbstractMesh, fake_device_mesh,
                                     release_fake_group)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import leaves
from repro_torch.train import optimizer as pt_opt

ATOL = 1e-5                # loss and gradients, f32
PARAM_REL = 1e-4           # parameters after 2 steps, of a leaf's max
B, S = 8, 64
VOCAB = 255                # divides no model axis above 1
LOSS_ARCHS = ["whisper-medium", "mamba2-1.3b"]
# (arch, layers, overrides) of each run
RUNS = [(a, 2, {"vocab_size": VOCAB}) for a in LOSS_ARCHS] + [
    ("kimi-k2-1t-a32b", 3, {"optimizer": "adafactor"})]
# the (4, 2) meta trace's peak of each loss arch before the repair, read
# at commit c09211c
PARENT_PEAK = {"whisper-medium": 3_632_128, "mamba2-1.3b": 3_296_256}
DEEP = 17                  # layers: uneven over 16 data ranks
DEEP_SHAPE = ShapeConfig("x", "train", 16, 16)
# JAX's init makes the smoke whisper stack chaotic
# (tests/test_torch_sharded_families.py), and the 3-layer kimi's: 1e-7
# relative noise on its weights moves the unsharded step's own
# ``embed/tok`` gradient by 2.5e-4 (its largest 0.28), by 1.1e-7 with the
# fan-in weights
TAME = {"whisper-medium": {"init": "fan_in"},
        "kimi-k2-1t-a32b": {"init": "fan_in"}}


def _cfg(arch, layers, overrides):
    return get_config(arch, smoke=True).replace(
        num_layers=layers, param_dtype="float32", compute_dtype="float32",
        **overrides)


def _spec(arch, layers, overrides, seed=0):
    jcfg = jx_get_config(arch, smoke=True).replace(
        num_layers=layers, param_dtype="float32", compute_dtype="float32",
        **overrides)
    decls = jx_build(jcfg).decls
    jp = jax.jit(lambda k: jx_init(decls, k))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    V = jcfg.vocab_size
    spec = {"arch": arch, "smoke": True, "num_layers": layers,
            "mesh": (2, 2), "steps": 2, "seed": seed,
            "overrides": overrides,
            "params": jax.tree.map(np.asarray, jp),
            "tokens": rng.integers(0, V, (B, S), dtype=np.int32),
            "targets": rng.integers(0, V, (B, S), dtype=np.int32),
            **TAME.get(arch, {})}
    if jcfg.family == "encdec":
        spec["audio_embeds"] = rng.normal(
            0, 1, (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    return spec


@pytest.fixture(scope="module")
def runs():
    """Per run of ``RUNS``: its spec, the unsharded reference, the 4
    ranks' results at (2, 2) (one spawn, the runs in turn) and the trace
    at (2, 2); the loss archs' traces at (4, 2) and kimi's at ``DEEP``
    layers on (16, 16), traced in turn on one child while the ranks
    run."""
    torch.set_num_threads(1)
    shape = ShapeConfig("x", "train", S, B)
    with dryrun.CollectiveTracer() as tracer:
        jobs = []
        for arch, layers, over in RUNS:
            cfg = _cfg(arch, layers, over)
            jobs.append((cfg, shape, AbstractMesh((2, 2), ("data", "model")),
                         False))
            if arch in LOSS_ARCHS:
                jobs.append((cfg, shape, AbstractMesh((4, 2), (
                    "data", "model")), False))
            else:
                jobs.append((_cfg(arch, DEEP, over), DEEP_SHAPE,
                             AbstractMesh((16, 16), ("data", "model")),
                             True))
        slot = tracer.submit(jobs)
        specs = [_spec(*r) for r in RUNS]
        outs = spawn_partitions(sharded_runs_rank, 4, "gloo", ["cpu"] * 4,
                                args=(specs,), timeout=600)
        refs = [sharded_lm_rank(0, "cpu", s) for s in specs]
        traces = tracer.result(slot)
    return {r[0]: {"spec": spec, "ref": ref, "ranks": [o[i] for o in outs],
                   "trace": traces[2 * i], "other": traces[2 * i + 1]}
            for i, (r, spec, ref) in enumerate(zip(RUNS, specs, refs))}


def _hold_to_unsharded(run):
    ref = run["ref"]
    for r, out in enumerate(run["ranks"]):
        assert abs(out["loss"] - ref["loss"]) <= ATOL, r
        for k, g in ref["grads"].items():
            err = float((out["grads"][k] - g).abs().max())
            assert err <= ATOL, (r, k, err)
        for k, p in ref["params"].items():
            err = float((out["params"][k] - p).abs().max())
            assert err <= PARAM_REL * float(p.abs().max()), (r, k, err)
        assert out["traffic"]["per_op"] == run["trace"]["per_op"], (
            r, out["traffic"], run["trace"]["per_op"])
        assert out["traffic"]["total"] > 0
        assert not {"jax", "repro"} & set(out["modules"])
    assert ref["traffic"]["total"] == 0


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_gathers_gold_per_rank(runs, arch):
    run = runs[arch]
    _hold_to_unsharded(run)
    # the data ranks' zeros of the logits' gradient are each one's rows
    saved = (1 - 1 / 4) * B * S * VOCAB * 4
    assert run["other"]["peak_bytes"] <= PARENT_PEAK[arch] - saved, (
        run["other"]["peak_bytes"], PARENT_PEAK[arch])


def _nest(named: dict) -> dict:
    tree: dict = {}
    for k, v in named.items():
        *path, last = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def test_adafactor_updates_each_shard(runs):
    run = runs["kimi-k2-1t-a32b"]
    _hold_to_unsharded(run)
    # the unsharded update of the step's gradients is JAX's
    cfg = _cfg(*RUNS[-1])
    jp = run["spec"]["params"]
    grads = {k: g.numpy() for k, g in run["ref"]["grads"].items()}
    jo, to = jx_opt.make_adafactor(), pt_opt.make_adafactor()
    jstate = jo.init(jax.tree.map(jnp.asarray, jp))
    upd, _ = jax.jit(jo.update)(jax.tree.map(jnp.asarray, _nest(grads)),
                                jstate, jax.tree.map(jnp.asarray, jp),
                                cfg.learning_rate)
    tp = params_from_jax(jp, "cpu")
    to.update_([torch.from_numpy(g) for g in grads.values()],
               to.init(tp), tp, cfg.learning_rate)
    want = jax.tree.map(lambda p, u: np.asarray(p + u), jp, upd)
    names = list(grads)                          # in ``leaves`` order
    assert len(names) == len(leaves(tp)) > 10
    for name, a, b in zip(names, leaves(tp), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    # no placement in the update is left to DTensor at an uneven depth
    deep = run["other"]
    gathers = [s for s in deep["sites"] if s["op"] == "all-gather"
               and any("train/optimizer.py" in a for a in s["at"])]
    assert not gathers, gathers[:3]
    assert any("train/optimizer.py" in a for s in deep["sites"]
               for a in s["at"])                 # its reductions are seen


@pytest.fixture
def fake_group():
    yield fake_device_mesh
    release_fake_group()


@pytest.mark.parametrize("sizes", [(16, 16), (2, 16, 16)])
def test_adafactor_state_lies_as_its_parameter(sizes, fake_group):
    axes = ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")
    mesh = AbstractMesh(sizes, axes)
    dm = fake_group(mesh)
    opt = pt_opt.make_adafactor()
    n = swapped = 0
    for arch in dryrun.lm_archs():
        cfg = get_config(arch)
        decls = dryrun.build(cfg).decls
        params = dryrun._meta_tree(decls, cfg, mesh, dm)
        state = pt_opt._per_leaf(params, dryrun._meta_tree(
            opt.state_decls(decls)["fac"], cfg, mesh, dm))
        for p, s in zip(leaves(params), state):
            pt_opt._check_placed(s, p)            # raises where they differ
            n += 1
            if "vr" in s and s["vr"].placements != s["vc"].placements:
                with pytest.raises(ValueError):
                    pt_opt._check_placed({"vr": s["vc"]}, p)
                swapped += 1
    assert n > 100 and swapped > 10
