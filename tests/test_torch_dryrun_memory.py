"""The dry-run's peak and temp bytes and its transcendentals
(``repro_torch.launch.dryrun``, ``repro_torch.launch.footprint``).

  * ``allocator_block`` rounds as the caching allocator does, and
    ``LiveBytes`` is exact on a hand-counted toy: a 2-layer MLP step whose
    arguments, saved activations, gradients and update temporary are
    summed by hand in allocator blocks; autograd's in-place sum of two
    gradients counts no block, as on the card; ``unflatten`` keeps no
    leaf alive past its tree;
  * ``meta`` changes no lifetime: the memory trace of a step on ``meta``
    equals the same tracker over the same step on real CPU tensors (the
    attention's ``footprint()`` in both), for train, prefill and decode of
    the six families' smoke configs;
  * a trace's ``entry_bytes`` are ``memory()``'s ``argument_blocks``:
    unsharded, and over fake (2, 2) and (16, 16) meshes;
  * the peak is the sharded step traced at full depth, from the
    arguments' blocks, for every family and kind; at full width the
    traced llama3.2-3b step peaks read on an H100 are matched to the byte,
    and the line through two depth probes misses the 28-layer one;
  * the attention's footprint on ``meta`` is its kernels' (``o``, ``lse``;
    ``dq``, ``dk``, ``dv``, ``d_rows``), not the plain version's scores;
  * transcendentals against XLA's ``cost_analysis()`` of the JAX step
    lowered at smoke size, within [0.95, 1.05] for prefill; the train
    steps are the known misses, each held to its ratio as read
    (``TRANSCENDENTAL_MISSES``);
  * the JAX witness: XLA's ``memory_analysis()`` of the pure data-parallel
    llama3.2-3b smoke step on (8, 1) host devices (``jax.make_mesh`` with
    Auto axes, in a subprocess), its argument bytes equal to the port's,
    its temp and peak printed beside the port's with no bound.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jx_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.models.api import build as jx_build
from repro.models.params import abstract_params as jx_abstract
from repro.models.unroll import force_unroll
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import dryrun
from repro_torch.launch.footprint import (LiveBytes, allocator_block,
                                          allocator_slack)
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ["llama3.2-3b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-7b",
         "whisper-medium", "qwen2-vl-2b"]
KINDS = ["train", "prefill", "decode"]
SMOKE = (2, 64)                    # batch, sequence
MiB = 2**20
# PyTorch's backward formulas recompute what JAX's autodiff keeps: the
# SiLU backward's sigmoid (an exp an element of the MLP), the log-softmax
# backward's exp over the logits; and the port forms the rope angles'
# sin and cos in every layer, JAX once.  Each train step's ratio to XLA's
# count as read (llama3.2-3b: 205,600 against 135,952; PERF.md)
TRANSCENDENTAL_MISSES = {
    ("llama3.2-3b", "train"): 1.5123, ("qwen2-moe-a2.7b", "train"): 1.6833,
    ("mamba2-1.3b", "train"): 1.5816, ("zamba2-7b", "train"): 1.4849,
    ("whisper-medium", "train"): 1.4194, ("qwen2-vl-2b", "train"): 1.5123}


@pytest.fixture(scope="module")
def tracer():
    with dryrun.CollectiveTracer() as t:
        yield t


def _shape(kind):
    return ShapeConfig("x", kind, SMOKE[1], SMOKE[0])


@functools.lru_cache(maxsize=None)
def _unsharded(arch, kind, device="meta"):
    return dryrun.trace_unsharded(get_config(arch, smoke=True),
                                  _shape(kind), device)


@pytest.mark.parametrize("nbytes,block", [
    (0, 0), (1, 512), (512, 512), (513, 1024), (MiB, MiB),
    (MiB + 1, MiB + 512),                  # a 20-MiB segment, split
    (19 * MiB + 512, 20 * MiB),            # its remainder under 1 MiB
    (11 * MiB, 12 * MiB),                  # rounded to 2 MiB, 1 MiB left
    (13 * MiB - 512, 13 * MiB - 512)])     # 14 MiB, over 1 MiB left
def test_allocator_block_rule(nbytes, block):
    assert allocator_block(nbytes) == block
    assert 0 <= allocator_block(nbytes) - nbytes <= allocator_slack(nbytes)


def test_tracker_exact_on_a_hand_counted_toy():
    """y = relu(x @ w1) @ w2, loss = y.sum(), then w -= 0.1 g: the peak is
    the arguments, the activations the step keeps (relu's output, y, the
    loss), both gradients and one update temporary of w1's size."""
    B, D, H, O = 4, 32, 64, 30
    x = torch.randn(B, D)
    w1 = torch.randn(D, H, requires_grad=True)
    w2 = torch.randn(H, O, requires_grad=True)
    with LiveBytes() as live:
        live.hold(x, w1, w2)
        live.mark_entry()
        a = torch.relu(x @ w1)
        y = a @ w2
        loss = y.sum()
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        with torch.no_grad():
            w1.sub_(0.1 * g1)
            w2.sub_(0.1 * g2)
    f32 = 4
    args = (allocator_block(B * D * f32) + allocator_block(D * H * f32)
            + allocator_block(H * O * f32))
    kept = (allocator_block(B * H * f32) + allocator_block(B * O * f32)
            + allocator_block(f32))
    grads = allocator_block(D * H * f32) + allocator_block(H * O * f32)
    update = allocator_block(D * H * f32)
    assert (live.entry, live.peak) == (args, args + kept + grads + update)
    assert live.live == args + kept + grads
    del a, y, loss, g1, g2
    assert live.live == args


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_engine_sums_gradients_in_place(device):
    """a = w * 2 read twice: autograd's engine adds a's second gradient
    into the first in place (no dispatch mode runs on the card), so the
    trace counts no block for the sum; a plain add under no_grad still
    allocates."""
    n = 1024 * 4                                  # bytes of a (1024,) f32
    w = torch.ones(1024, device=device, requires_grad=True)
    with LiveBytes() as live:
        live.hold(w)
        live.mark_entry()
        a = w * 2
        out = (a * 3).sum() + (a * 4).sum()
        (g,) = torch.autograd.grad(out, w)
        # w, a, out, the backward's ones, a's two gradients: no third
        assert live.peak - live.entry == n + 512 + 512 + 2 * n
        with torch.no_grad():
            live.mark_entry()
            g + g
        assert live.peak - live.entry == n


def test_unflatten_frees_its_leaves_without_the_collector():
    """A train step with a ``grad_transform`` rebuilds the gradients' tree;
    that tree must not keep them allocated until the garbage collector
    runs (it did: a phase-14 step's 12.85 GB of gradients outlived it)."""
    import gc
    import weakref

    from repro_torch.models.params import unflatten
    flat = [torch.ones(3), torch.ones(2)]
    gone = [weakref.ref(t) for t in flat]
    was = gc.isenabled()
    gc.disable()
    try:
        tree = unflatten({"a": [0, 0]}, flat)
        del tree, flat
        assert all(r() is None for r in gone)
    finally:
        if was:
            gc.enable()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trace_equals_the_same_step_on_cpu(arch, kind):
    meta = _unsharded(arch, kind)
    assert meta["peak_bytes"] > meta["entry_bytes"] > 0
    assert _unsharded(arch, kind, "cpu") == meta


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_entry_bytes_are_the_argument_blocks(arch, kind):
    want = dryrun.memory(get_config(arch, smoke=True), _shape(kind),
                         make_host_mesh())["argument_blocks"]
    assert _unsharded(arch, kind)["entry_bytes"] == want


SHARDED_ENTRY = ([((2, 2), "llama3.2-3b", k) for k in KINDS]
                 + [((16, 16), "llama3.2-3b", k) for k in ("train", "decode")]
                 + [((2, 2), a, "train") for a in ("qwen2-moe-a2.7b",
                                                   "zamba2-7b",
                                                   "whisper-medium")])


@pytest.mark.parametrize("mesh,arch,kind", SHARDED_ENTRY,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_entry_bytes_are_the_argument_blocks_sharded(tracer, mesh, arch,
                                                      kind):
    cfg = get_config(arch, smoke=True)
    mesh = AbstractMesh(mesh, ("data", "model"))
    shape = ShapeConfig("x", kind, SMOKE[1], 16)   # 16 rows over the data
    got = dryrun.count_collectives(cfg, shape, mesh, tracer)
    assert got["entry_bytes"] == \
        dryrun.memory(cfg, shape, mesh)["argument_blocks"]
    assert got["peak_bytes"] > got["entry_bytes"]


def _deeper(cfg):
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        return cfg.replace(num_layers=3 * every + cfg.num_layers % every)
    if cfg.family == "encdec":
        return cfg.replace(num_layers=6, encoder_layers=6)
    return cfg.replace(num_layers=6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_peak_memory_is_the_full_depth_sharded_trace(tracer, arch, kind):
    """The cell's peak is its sharded step traced at its own depth (6
    layers; the hybrid 3 groups) on a fake (2, 2) mesh, from the
    arguments' blocks: no depth probe enters it."""
    cfg = _deeper(get_config(arch, smoke=True))
    shape = ShapeConfig("x", kind, SMOKE[1], 16)   # 16 rows over the data
    mesh = AbstractMesh((2, 2), ("data", "model"))
    got = dryrun.peak_memory(cfg, shape, mesh, tracer)
    assert got["entry_bytes"] == \
        dryrun.memory(cfg, shape, mesh)["argument_blocks"]
    assert got["peak_bytes"] > got["entry_bytes"]


def test_full_width_trace_reads_the_cards_bytes():
    """llama3.2-3b's f32 train step at 8 x 128 traced on meta gives the
    step peaks an H100 read (700 W; chip_smoke.py phases 14 (d) and 15
    (a)) to the byte at 2, 4 and 28 layers.  The line through the 2- and
    4-layer peaks falls 459,276,288 B (0.85%) short of the 28-layer one:
    up to 8 layers the step peaks where the tied embedding's gradient is
    cast to f32, at 28 where the stacked layers' gradients are stacked.
    So the dry-run traces a cell's peak at full depth."""
    cfg = get_config("llama3.2-3b")
    shape = ShapeConfig("x", "train", 128, 8)
    peaks = [dryrun.trace_unsharded(cfg.replace(num_layers=n), shape)
             ["peak_bytes"] for n in (2, 4, 28)]
    assert peaks == [11_895_302_144, 15_116_724_224, 54_233_065_472]
    line = dryrun._extrapolate(peaks[0], peaks[1], 2, 4, 28)
    assert peaks[2] - line == 459_276_288


def test_attention_footprint_is_the_kernels():
    B, S, H, Hkv, Dh = 2, 40, 4, 2, 16
    f32 = 4
    q = torch.empty(B, S, H, Dh, device="meta", requires_grad=True)
    k = torch.empty(B, S, Hkv, Dh, device="meta", requires_grad=True)
    v = torch.empty(B, S, Hkv, Dh, device="meta", requires_grad=True)
    qb, kb = (allocator_block(t.numel() * f32) for t in (q, k))
    lse = allocator_block(B * H * S * f32)
    with LiveBytes() as live, fa.footprint():
        out = fa.flash_attention(q, k, v)
        assert "Footprint" in type(out.grad_fn).__name__
        assert live.live == qb + lse               # o and lse, saved
        do = torch.empty(B, S, H, Dh, device="meta")
        live.mark_entry()
        grads = torch.autograd.grad(out, (q, k, v), do)
    # dq, dk, dv, then d_rows beside them, freed on return
    assert live.peak - live.entry == qb + 2 * kb + lse
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    # the plain version keeps the (B, H, S, S) probabilities
    with LiveBytes() as plain:
        out = fa.flash_attention(q, k, v)
    assert plain.live >= qb + allocator_block(B * H * S * S * f32)
    # and without grad the kernel allocates o alone
    with LiveBytes() as live, fa.footprint(), torch.no_grad():
        out = fa.flash_attention(q, k, v)
        assert live.peak == live.live == qb


def _xla_transcendentals(arch, kind):
    cfg = jx_get_config(arch, smoke=True).replace(compute_dtype="float32")
    model = jx_build(cfg)
    spec = model.input_specs(JShape("x", kind, SMOKE[1], SMOKE[0]))
    params = jx_abstract(model.decls, dtype_override=jnp.dtype(
        cfg.param_dtype))
    with force_unroll(True):
        fn = (jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))
              if kind == "train" else jax.jit(model.prefill))
        lc = fn.lower(params, spec["batch"]).cost_analysis()
    lc = lc[0] if isinstance(lc, (list, tuple)) else lc
    return float(lc["transcendentals"])


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_transcendentals_match_xla(arch, kind):
    want = _xla_transcendentals(arch, kind)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    got = dryrun.count_flops(cfg, _shape(kind), make_host_mesh())
    ratio = got["transcendentals"] / want
    print(f"[transcendentals] {arch} {kind}: port {got['transcendentals']}"
          f" xla {want} ({ratio:.4f})")
    if (arch, kind) in TRANSCENDENTAL_MISSES:   # see above
        assert ratio == pytest.approx(TRANSCENDENTAL_MISSES[arch, kind],
                                      abs=1e-4)
    else:
        assert 0.95 <= ratio <= 1.05


_WITNESS = """
    import json
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.distributed.sharding import shard_ctx
    from repro.launch.dryrun import _lower_cell
    m = jax.make_mesh((8, 1), ("data", "model"),
                      axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        fsdp_params=False, param_dtype="float32", compute_dtype="float32")
    with shard_ctx(cfg, m):
        lowered, _ = _lower_cell(cfg, ShapeConfig("x", "train", S, B), m)
        ma = lowered.compile().memory_analysis()
    print("WITNESS" + json.dumps({
        "argument": ma.argument_size_in_bytes,
        "output": ma.output_size_in_bytes, "temp": ma.temp_size_in_bytes,
        "alias": ma.alias_size_in_bytes}))
"""


def test_jax_memory_witness(tracer):
    """XLA's argument bytes are the port's: the f32 parameters, AdamW's m
    and v, its int32 count (4 B) and one device's rows of the int32
    tokens and targets, leaf for leaf.  Temp and peak differ by design:
    XLA's temp is its buffer assignment's, outputs excluded; the port's
    peak is the caching allocator's high-water mark over PyTorch's eager
    lifetimes, outputs included (PERF.md)."""
    B, S = 64, 256
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = f"S, B = {S}, {B}\n" + textwrap.dedent(_WITNESS)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("WITNESS"))
    xla = json.loads(line[len("WITNESS"):])
    cfg = get_config("llama3.2-3b", smoke=True).replace(
        fsdp_params=False, param_dtype="float32", compute_dtype="float32")
    shape, mesh = ShapeConfig("x", "train", S, B), AbstractMesh(
        (8, 1), ("data", "model"))
    mem = dryrun.memory(cfg, shape, mesh)
    port = dryrun.count_collectives(cfg, shape, mesh, tracer)
    print(f"[witness] llama3.2-3b smoke (8, 1): argument xla "
          f"{xla['argument']} port {mem['argument_bytes']}; temp xla "
          f"{xla['temp']} port {port['peak_bytes'] - mem['argument_bytes']};"
          f" peak (argument + temp) xla {xla['argument'] + xla['temp']} "
          f"port {port['peak_bytes']}; output xla {xla['output']} port "
          f"{mem['output_bytes']}; alias xla {xla['alias']} port "
          f"{mem['alias_bytes']}")
    assert xla["argument"] == mem["argument_bytes"]
    assert port["peak_bytes"] > port["entry_bytes"] > 0
