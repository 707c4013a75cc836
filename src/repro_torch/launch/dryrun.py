"""Dry-run accounting on the ``meta`` device.

For every (architecture × input shape × mesh) cell, without allocating a
tensor or touching a device:

1. PARAMETERS: ``params_total`` is ``param_count`` of the declarations
   (the JAX package's count exactly), ``params_active`` the config's
   active count.
2. MEMORY: ``argument_bytes`` is one device's bytes of the step's inputs:
   the parameters (in ``cfg.param_dtype``), the optimizer state (train),
   the caches (decode) and the batch.  Each leaf is its shape divided by
   the mesh axes of its physical spec (``distributed/sharding.py``), times
   its dtype's size.  ``output_bytes`` counts the step's outputs the same
   way (train: parameters, state and three f32 metrics; prefill and
   decode: the (B, V) f32 logits and the caches), ``alias_bytes`` the
   inputs the step donates to its outputs (train: parameters and state;
   decode: the caches).  ``peak_device_bytes`` is the high-water mark of
   what one device's caching allocator holds over one step, its arguments
   included: the sharded step traced below (4.) under
   ``launch/footprint.LiveBytes``, each storage counted as the
   allocator's block for its size, the attention allocating what its
   kernels allocate (``flash_attention``'s ``footprint()``), so
   ``torch.cuda.max_memory_allocated`` over the same step can be held to
   it (``chip_smoke.py`` phases 14, 15 and 19,
   ``scripts/dryrun_memory.py``).  The step is traced at full depth
   (``peak_memory``): the peak is not linear in depth.  It is what the
   allocator holds and nothing else: a fit on a card must also leave room
   for the CUDA context, the libraries' workspaces (cuBLAS's, NCCL's
   buffers) and the blocks the allocator reserves but does not hand out.
   ``temp_bytes`` is ``peak_device_bytes - argument_bytes``, JAX's
   identity.  Unlike XLA's temp, which excludes the output buffers and
   comes from its buffer assignment, the port's peak includes the
   outputs the allocator holds, over PyTorch's eager lifetimes.
3. FLOPs: the step traced on ``meta`` tensors under the sharding context
   (the MoE groups its tokens by the mesh's data shards), at the two
   reduced depths of ``depth_probe_cfgs``, extrapolated linearly to full
   depth (``_extrapolate``).  The step is the kind's: the loss and its
   backward under ``cfg.remat`` (train), ``prefill`` or ``decode``.  On
   ``meta`` the model's ``flash_attention`` is the plain version, so the
   count is that of the JAX model's jnp attention and its autodiff.  Two
   counters run over the trace: ``torch.utils.flop_counter.FlopCounterMode``
   counts the matrix products (2·M·N·K each), and ``ElementwiseCounter``
   the rest of the arithmetic by XLA's cost-analysis conventions, so the
   sum is comparable with the JAX package's ``cost_analysis()["flops"]``:
   one FLOP per output element of an arithmetic, compare, select or
   converting op, a reduction's input elements less its output's, the
   added elements of an accumulating scatter, and nothing for a data
   movement; composite ops (softmax, SiLU, GELU, log-sum-exp and their
   backwards, ...) are counted through their ``torch._decomp``
   decompositions.  Transcendentals (exp, log, log1p, expm1, tanh,
   logistic, rsqrt, sqrt, a non-whole power, sin, cos, erf) are counted
   apart, one an output element, as ``cost.transcendentals``: XLA's count
   for a prefill or decode step (0.999 of it at smoke size), but not for
   a train step, whose count is the port's own program's, PyTorch's
   backward formulas recomputing what JAX's autodiff keeps (SiLU's
   sigmoid, log-softmax's exp) and the rope angles formed in every layer
   (1.42-1.68 times XLA's at smoke size,
   ``tests/test_torch_dryrun_memory.py``).
   ``flops_per_device`` is that total over ``n_devices``: it counts no
   replicated work (XLA counts what each device runs, replicas included).

4. COLLECTIVES: ``collective_bytes_per_device`` and ``per_op`` are the
   traffic of the port's own sharded step, not XLA's: the kind's step
   (train: the loss, its backward, each gradient redistributed to its
   parameter's placements, the clipped AdamW update and the replicated
   metrics, ``train/trainer.make_train_step``; prefill; decode, its
   outputs placed as JAX's ``out_shardings`` place them) run on ``meta``
   DTensors placed by ``physical_specs`` over ``fake_production_mesh``
   (a ``fake`` group of 256 or 512 ranks, in a child process of its own:
   ``CollectiveTracer``), and every functional collective DTensor issues
   counted by ``distributed/collectives.CollectiveTraffic`` with the JAX
   package's volume model: the result's bytes for ``all-gather`` and
   ``all-to-all``, twice them for ``all-reduce`` and ``reduce-scatter``,
   nothing over a one-wide axis.  The two depth probes are extrapolated
   as the FLOPs are.  ``per_op`` has the JAX package's op names; DTensor
   issues no ``collective-permute``.  Under ``remat`` the recompute
   re-issues the forward's gathers, and they are counted.  Every family
   is counted: the SSM blocks' conv and chunk scan and the encoder-decoder's
   cross attention run per shard under ``local_map``, as the attention
   does.

The JSON has the keys of the JAX package's ``run_cell``.  The fields that
depend on XLA's compile are ``null``: ``t_compile_s``,
``cost.bytes_per_device`` (its fusion's memory traffic) and
``cost.raw_full_flops_scanned`` (the count of the scanned full-depth
program).  ``t_lower_s`` is the host seconds of building the inputs and
resolving every spec, ``t_probe_s`` those of the two traced FLOP probes,
``t_collectives_s`` those of the traces of the sharded step (the two
depth probes for the collectives, the full-depth step for memory).  ``run_cell(..., traced=False)`` skips those traces: the
collective and memory fields are then ``null``.

Results are written as JSON under ``build/dryrun/<mesh>/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
from torch._decomp import decomposition_table
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (SHAPES_BY_NAME, applicable_shapes,
                                 get_config, list_archs)
from repro_torch.distributed.collectives import CollectiveTraffic
from repro_torch.distributed.sharding import (P, enforce_divisible,
                                              make_rules, physical_specs,
                                              placements, resolve_spec,
                                              shard_bytes, shard_ctx)
from repro_torch.launch.footprint import LiveBytes, allocator_block
from repro_torch.launch.mesh import (axis_sizes, fake_device_mesh,
                                     make_production_mesh,
                                     release_fake_group)
from repro_torch.models.api import build
from repro_torch.models.params import (abstract_params, leaves,
                                       param_count, unflatten)
from repro_torch.train.optimizer import get_optimizer

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
METRICS = 3                 # loss, grad_norm, aux: f32 scalars
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


# ---------------------------------------------------------------------------
# Depth scaling (the JAX package's)
# ---------------------------------------------------------------------------

def depth_probe_cfgs(cfg):
    """(cfg1, u1), (cfg2, u2), u_full — linear depth units per family."""
    if cfg.family == "hybrid":
        every, rem = cfg.shared_attn_every, cfg.num_layers % cfg.shared_attn_every
        l1, l2 = every + rem, 2 * every + rem
        return ((cfg.replace(num_layers=l1), 1),
                (cfg.replace(num_layers=l2), 2),
                cfg.num_layers // every)
    if cfg.family == "encdec":
        return ((cfg.replace(num_layers=2, encoder_layers=2), 2),
                (cfg.replace(num_layers=4, encoder_layers=4), 4),
                cfg.num_layers)
    return ((cfg.replace(num_layers=2), 2),
            (cfg.replace(num_layers=4), 4),
            cfg.num_layers)


def _extrapolate(c1, c2, u1, u2, uf):
    b = (c2 - c1) / max(u2 - u1, 1)
    return max(c1 + b * (uf - u1), 0.0)


# ---------------------------------------------------------------------------
# Memory: one device's share of each tensor
# ---------------------------------------------------------------------------

def _decl_sizes(decls, cfg, mesh, dtype=None) -> list:
    """One device's bytes of each declared leaf, by its physical spec
    (``dtype`` for every leaf if given, else its own)."""
    specs = leaves(physical_specs(decls, cfg, mesh))
    return [shard_bytes(d.shape, (dtype or d.dtype).itemsize, s, mesh)
            for d, s in zip(leaves(decls), specs, strict=True)]


def _batch_sizes(batch, specs, rules, mesh) -> list:
    return [shard_bytes(t.shape, t.dtype.itemsize, enforce_divisible(
                resolve_spec(specs[name], rules), t.shape, mesh), mesh)
            for name, t in batch.items()]


def memory(cfg, shape, mesh) -> dict:
    """Per-device argument, output and alias bytes of the cell's step, the
    parts of the argument bytes, and ``argument_blocks``: the arguments as
    the caching allocator holds them (``allocator_block`` a leaf; the
    optimizer's step count is a Python int in the port, not JAX's int32
    scalar, so it has none)."""
    model = build(cfg)
    rules = make_rules(cfg, mesh)
    spec = model.input_specs(shape)
    pdt = getattr(torch, cfg.param_dtype)
    sizes = {"params": _decl_sizes(model.decls, cfg, mesh, pdt),
             "batch": _batch_sizes(spec["batch"], spec["batch_specs"], rules,
                                   mesh)}
    blocks = [n for v in sizes.values() for n in v]
    B = shape.global_batch
    logits = shard_bytes((B, cfg.vocab_size), 4, enforce_divisible(
        resolve_spec(P("dp", None), rules), (B, cfg.vocab_size), mesh), mesh)
    if spec["kind"] == "train":
        odecls = get_optimizer(cfg).state_decls(model.decls)
        sizes["opt_state"] = _decl_sizes(odecls, cfg, mesh)
        blocks += _decl_sizes({k: v for k, v in odecls.items()
                               if k != "count"}, cfg, mesh)
    elif spec["kind"] == "decode":
        sizes["caches"] = _decl_sizes(spec["cache_decls"], cfg, mesh)
        blocks += sizes["caches"]
    parts = {k: sum(v) for k, v in sizes.items()}
    if spec["kind"] == "train":
        alias = parts["params"] + parts["opt_state"]
        output = alias + METRICS * 4
    elif spec["kind"] == "prefill":
        alias = 0
        output = logits + sum(_decl_sizes(
            model.cache_decls(B, shape.seq_len), cfg, mesh))
    else:
        alias = parts["caches"]
        output = logits + alias
    return {"argument_bytes": sum(parts.values()), "output_bytes": output,
            "alias_bytes": alias, "parts": parts,
            "argument_blocks": sum(allocator_block(n) for n in blocks)}


# ---------------------------------------------------------------------------
# FLOPs: the step traced on meta tensors
# ---------------------------------------------------------------------------

_A = torch.ops.aten
# composite ops counted through their decompositions into primitives
_DECOMPOSE = frozenset(op for op in (
    _A._softmax.default, _A._softmax_backward_data.default,
    _A._log_softmax.default, _A._log_softmax_backward_data.default,
    _A.logsumexp.default, _A.silu.default, _A.silu_backward.default,
    _A.sigmoid.default, _A.sigmoid_backward.default, _A.gelu.default,
    _A.gelu_backward.default, _A.logaddexp.default, _A.mean.dim,
    _A.mean.default, _A.softplus.default, _A.softplus_backward.default,
    _A.tanh_backward.default, _A.threshold_backward.default,
    _A.var_mean.correction, _A.native_layer_norm.default,
    _A.native_layer_norm_backward.default, _A.clamp_min.default,
    _A.clamp_max.default, _A.relu.default, _A.rsqrt.default)
    if op in decomposition_table)
# one FLOP per output element
_ONE = frozenset((
    _A.add, _A.sub, _A.rsub, _A.mul, _A.div, _A.neg, _A.abs, _A.sign,
    _A.reciprocal, _A.square, _A.maximum, _A.minimum, _A.clamp, _A.where,
    _A.masked_fill, _A.eq, _A.ne, _A.lt, _A.le, _A.gt, _A.ge,
    _A.logical_not, _A.logical_and, _A.logical_or, _A.bitwise_and,
    _A.bitwise_or, _A.bitwise_not, _A.fmod, _A.remainder, _A.floor_divide,
    _A.cumsum, _A.tril, _A.triu))
# a reduction: its input's elements less its output's
_REDUCE = frozenset((_A.sum, _A.amax, _A.amin, _A.prod, _A.any, _A.all,
                     _A.argmax, _A.argmin, _A.max, _A.min))
# one transcendental per output element (XLA's ``HloCostAnalysis`` set:
# exp, log, log1p, expm1, tanh, logistic, rsqrt, sqrt, power, sin, cos,
# erf), counted apart from the FLOPs, as the aten op or as the primitive
# a decomposition reaches; ``pow`` to a whole exponent is products
# instead (``_elementwise_flops``)
_TRANSCENDENTAL_NAMES = ("exp", "log", "log1p", "expm1", "tanh", "rsqrt",
                         "sqrt", "sin", "cos", "erf")
_TRANSCENDENTAL = frozenset(
    [getattr(_A, n) for n in _TRANSCENDENTAL_NAMES + ("sigmoid",)]
    + [getattr(torch.ops.prims, n) for n in _TRANSCENDENTAL_NAMES])
_POW = (_A.pow, torch.ops.prims.pow)


class ElementwiseCounter(TorchDispatchMode):
    """Counts the arithmetic that is not a matrix product, as XLA's cost
    analysis does (see the module docstring); ``flops`` is the total,
    ``transcendentals`` the transcendental output elements, which XLA
    counts apart."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _DECOMPOSE:
            with self:
                return decomposition_table[func](*args, **kwargs)
        out = func(*args, **kwargs)
        op = func.overloadpacket
        self.flops += _elementwise_flops(op, args, kwargs, out)
        self.transcendentals += _transcendentals(op, args, out)
        return out


def _whole_power(e) -> bool:
    return isinstance(e, (int, float)) and float(e).is_integer() and e >= 1


def _transcendentals(op, args, out) -> int:
    if op in _TRANSCENDENTAL or (op in _POW and not _whole_power(args[1])):
        return out.numel()
    return 0


def _elementwise_flops(op, args, kwargs, out) -> int:
    o = out[0] if isinstance(out, (tuple, list)) else out
    n = o.numel() if isinstance(o, torch.Tensor) else 0
    if op in _ONE:
        return n
    if op in _REDUCE:
        return args[0].numel() - n
    if op is _A.pow:                 # x ** e, e a whole number: e - 1 products
        return n * (int(args[1]) - 1) if _whole_power(args[1]) else 0
    if op is _A.scatter_add:
        return args[3].numel()
    if op is _A.index_add:
        return args[3].numel()
    if op is _A.index_put:
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate")
        return args[2].numel() if accumulate else 0
    if op is _A._to_copy:
        return n if args[0].dtype != o.dtype else 0
    if op is _A.copy_:
        return n if args[1].dtype != o.dtype else 0
    if op in (_A.addmm, _A.baddbmm):  # the added term (the product is counted)
        return n
    return 0


def count_flops(cfg, shape, mesh) -> dict:
    """FLOPs of the cell's step at ``cfg``'s depth (all devices together),
    over a trace on ``meta`` tensors: ``products`` (``FlopCounterMode``),
    ``elementwise`` and ``transcendentals`` (``ElementwiseCounter``)."""
    model = build(cfg)
    with shard_ctx(cfg, mesh), FlopCounterMode(display=False) as counter, \
            ElementwiseCounter() as elementwise:
        spec = model.input_specs(shape)
        params = abstract_params(model.decls,
                                 dtype_override=getattr(torch, cfg.param_dtype))
        if spec["kind"] == "train":
            p_l = [p.requires_grad_(True) for p in leaves(params)]
            loss, _ = model.loss_fn(unflatten(params, p_l), spec["batch"])
            torch.autograd.grad(loss, p_l, allow_unused=True)
        else:
            with torch.no_grad():
                if spec["kind"] == "prefill":
                    model.prefill(params, spec["batch"])
                else:
                    model.decode(params, spec["caches"], spec["batch"])
    return {"products": float(counter.get_total_flops()),
            "elementwise": float(elementwise.flops),
            "transcendentals": float(elementwise.transcendentals)}


# ---------------------------------------------------------------------------
# Collectives: the sharded step traced on meta DTensors over a fake group
# ---------------------------------------------------------------------------

def meta_dtensor(shape, dtype, spec: P, device_mesh, device="meta"):
    """A DTensor of the global ``shape`` laid out by the physical ``spec``
    (which divides it) over ``device_mesh``: its local tensor empty on
    ``meta``, zeros on another ``device``."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, device_mesh)
    local = list(shape)
    for j, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= device_mesh.size(j)
    full = torch.empty(shape, dtype=dtype, device="meta")
    make = torch.empty if torch.device(device).type == "meta" else torch.zeros
    return DTensor.from_local(make(local, dtype=dtype, device=device),
                              device_mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def _meta_tree(decls, cfg, mesh, device_mesh, dtype=None, device="meta"):
    specs = leaves(physical_specs(decls, cfg, mesh))
    return unflatten(decls, [meta_dtensor(d.shape, dtype or d.dtype, s,
                                          device_mesh, device)
                             for d, s in zip(leaves(decls), specs)])


def _place(t, spec: P, mesh, device_mesh):
    """A DTensor ``t`` redistributed to ``spec`` (made divisible)."""
    spec = enforce_divisible(spec, t.shape, mesh)
    return t.redistribute(device_mesh, placements(spec, device_mesh))


def run_step(model, cfg, spec, args, place=None):
    """The kind's step on ``args`` (``params``, ``batch``; ``state`` for
    train, ``caches`` for decode): train ``make_train_step``'s step (the
    loss, its backward, the gradients placed like their parameters, the
    clipped AdamW update in place), else ``prefill`` or ``decode`` under
    no_grad, their logits and caches passed through ``place(logits,
    caches, cache_decls)`` where given (the sharded step's
    ``out_shardings``).  Returns the step's outputs."""
    from repro_torch.train.trainer import make_train_step
    params, batch = args["params"], args["batch"]
    if spec["kind"] == "train":
        step, _ = make_train_step(model, cfg, get_optimizer(cfg),
                                  grad_accum=getattr(cfg, "grad_accum", 1))
        return step(params, args["state"], batch)
    with torch.no_grad():
        if spec["kind"] == "prefill":
            cdecls = model.cache_decls(*batch["tokens"].shape)
            out = model.prefill(params, batch)
        else:
            cdecls = spec["cache_decls"]
            out = model.decode(params, args["caches"], batch)
        return place(*out, cdecls) if place is not None else out


def out_placer(cfg, mesh, device_mesh):
    """``place(logits, caches, cache_decls)`` for ``run_step``: a prefill's
    or decode's logits and caches redistributed where JAX's
    ``out_shardings`` put them (the caches by their declarations)."""
    rules = make_rules(cfg, mesh)

    def place(logits, caches, cdecls):
        logits = _place(logits, resolve_spec(P("dp", None), rules), mesh,
                        device_mesh)
        return logits, unflatten(caches, [
            _place(c, s, mesh, device_mesh) for c, s in zip(
                leaves(caches), leaves(physical_specs(cdecls, cfg, mesh)))])
    return place


def sharded_args(cfg, shape, mesh, device_mesh, device="meta"):
    """One rank's arguments of the cell's sharded step and how to run it:
    ``(model, spec, args, place)`` for ``run_step``.  ``args`` holds the
    parameters (in ``cfg.param_dtype``), the batch, and the optimizer
    state (train) or the caches (decode) as DTensors placed by
    ``physical_specs`` over ``device_mesh``, empty on ``meta``, zeros on
    another ``device`` (a production rank run for real,
    ``scripts/dryrun_memory.py``); ``place`` puts prefill's and decode's
    logits and caches where JAX's ``out_shardings`` put them."""
    model = build(cfg)
    rules = make_rules(cfg, mesh)
    spec = model.input_specs(shape)
    pdt = getattr(torch, cfg.param_dtype)
    place = out_placer(cfg, mesh, device_mesh)
    args = {"params": _meta_tree(model.decls, cfg, mesh, device_mesh, pdt,
                                 device),
            "batch": {k: meta_dtensor(t.shape, t.dtype, enforce_divisible(
                resolve_spec(spec["batch_specs"][k], rules), t.shape, mesh),
                device_mesh, device) for k, t in spec["batch"].items()}}
    if spec["kind"] == "train":
        sdecls = get_optimizer(cfg).state_decls(model.decls)
        args["state"] = {**_meta_tree({k: v for k, v in sdecls.items()
                                       if k != "count"}, cfg, mesh,
                                      device_mesh, device=device),
                         "count": 0}
    elif spec["kind"] == "decode":
        args["caches"] = _meta_tree(spec["cache_decls"], cfg, mesh,
                                    device_mesh, device=device)
    # the global meta inputs of ``input_specs`` are not a rank's
    spec = {k: v for k, v in spec.items() if k in ("kind", "cache_decls")}
    return model, spec, args, place


def trace_step(cfg, shape, mesh, device_mesh, sites: bool = False) -> dict:
    """The collectives and the memory of the cell's sharded step at
    ``cfg``'s depth, one device's, traced on ``meta`` DTensors over
    ``device_mesh`` (a ``DeviceMesh`` of ``mesh``'s axes):
    ``CollectiveTraffic.summary()`` (with each collective's call site
    where ``sites``) and ``LiveBytes.summary()`` (``entry_bytes``, the
    arguments' allocator blocks, and ``peak_bytes``), the attention
    allocating what its kernels do (``flash_attention``'s
    ``footprint()``: it runs per shard and moves nothing, so the
    collectives are those of the plain attention)."""
    from repro_torch.kernels.flash_attention.ops import footprint
    with shard_ctx(cfg, mesh, device_mesh), \
            CollectiveTraffic(sites) as traffic, LiveBytes() as live, \
            footprint():
        model, spec, args, place = sharded_args(cfg, shape, mesh,
                                                device_mesh)
        live.hold(args)
        live.mark_entry()
        out = run_step(model, cfg, spec, args, place)
        del out
    return {**traffic.summary(), **live.summary()}


def trace_unsharded(cfg, shape, device="meta") -> dict:
    """The memory of the cell's step on one device, unsharded (a
    ``make_host_mesh()`` mesh, plain tensors: what ``run_lm`` runs on one
    card), traced by ``LiveBytes`` with the attention's ``footprint()``:
    ``{"entry_bytes", "peak_bytes"}``.  On ``meta`` the arguments are
    empty; on another device (the check that ``meta`` changes no
    lifetime) the parameters are ``init_params`` from a generator seeded
    0, the batch ``launch.group.lm_batch``'s and the caches zeros, and the
    step really runs."""
    from repro_torch.kernels.flash_attention.ops import footprint
    from repro_torch.launch.mesh import make_host_mesh
    model = build(cfg)
    spec = model.input_specs(shape)
    pdt = getattr(torch, cfg.param_dtype)
    if torch.device(device).type == "meta":
        args = {"params": abstract_params(model.decls, dtype_override=pdt),
                "batch": spec["batch"]}
        caches = spec.get("caches")
    else:
        from repro_torch.launch.group import lm_batch
        from repro_torch.models.params import init_params
        args = {"params": init_params(
                    model.decls, torch.Generator().manual_seed(0), device,
                    dtype_override=pdt),
                "batch": lm_batch({"batch": shape.global_batch,
                                   "seq": shape.seq_len},
                                  model, spec["kind"], device)}
        caches = spec.get("cache_decls") and unflatten(
            spec["cache_decls"], [torch.zeros(d.shape, dtype=d.dtype,
                                              device=device)
                                  for d in leaves(spec["cache_decls"])])
    if spec["kind"] == "train":
        args["state"] = get_optimizer(cfg).init(args["params"])
    elif spec["kind"] == "decode":
        args["caches"] = caches
    with shard_ctx(cfg, make_host_mesh()), LiveBytes() as live, \
            footprint():
        live.hold(args)
        live.mark_entry()
        out = run_step(model, cfg, spec, args)
        del out
    return live.summary()


def _tracer_main(conn):
    """The child of ``CollectiveTracer``: traces each list of (cfg, shape,
    mesh, sites) it is sent, in order, on a fake group of each mesh's
    size."""
    try:
        while True:
            jobs = conn.recv()
            if jobs is None:
                break
            try:
                out = []
                for cfg, shape, mesh, sites in jobs:
                    t0 = time.perf_counter()
                    res = trace_step(cfg, shape, mesh,
                                     fake_device_mesh(mesh), sites)
                    res["seconds"] = time.perf_counter() - t0
                    out.append(res)
                conn.send(("ok", out))
            except Exception as e:  # noqa: BLE001 — the parent raises it
                conn.send(("error", f"{type(e).__name__}: {e}\n"
                                    f"{traceback.format_exc()[-3000:]}"))
    finally:
        release_fake_group()
        conn.close()


class CollectiveTracer:
    """Child processes (``spawn``) that each own a fake group and trace
    cells' steps on it: ``count(cfg, shape, mesh)``, ``map(jobs)`` (a list
    of steps, in order, on one child), or ``submit(jobs)`` and later
    ``result(child)``, so that up to ``workers`` lists trace at once (the
    sweep's cells; a list's own steps trace in order, the later ones
    reusing the layouts the first derived).  The group is global state, so it never lives in the
    caller's process; the children serve a whole sweep (each one's first
    ops pay DTensor's one-time set-up)."""

    timeout = 900.0                 # seconds a trace may take
    workers = 3                     # children, started as lists arrive

    def __init__(self):
        self._children = {}         # slot: (process, pipe), started as needed
        self._busy = {}             # slot: its list of steps

    def _start(self, slot):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        conn, child = ctx.Pipe()
        proc = ctx.Process(target=_tracer_main, args=(child,),
                           name="collective tracer", daemon=True)
        proc.start()
        child.close()
        self._children[slot] = (proc, conn)

    def submit(self, jobs) -> int:
        """Sends ``jobs``, each ``(cfg, shape, mesh, sites)``, to an idle
        child; returns its slot, for ``result``."""
        slot = next(i for i in range(self.workers) if i not in self._busy)
        if slot not in self._children:
            self._start(slot)
        self._children[slot][1].send(jobs)
        self._busy[slot] = jobs
        return slot

    def result(self, slot) -> list:
        """The traces of the list sent to ``slot``, in order."""
        proc, conn = self._children[slot]
        jobs = self._busy.pop(slot)
        if not conn.poll(self.timeout * len(jobs)):
            self._stop(slot, kill=True)
            cfg, _, mesh, _ = jobs[0]
            raise TimeoutError(f"no collective trace of {cfg.name} on "
                               f"{axis_sizes(mesh)} after "
                               f"{self.timeout} s a step")
        status, res = conn.recv()
        if status != "ok":
            raise RuntimeError(f"collective trace failed: {res}")
        return res

    def map(self, jobs) -> list:
        return self.result(self.submit(jobs))

    def count(self, cfg, shape, mesh, sites: bool = False) -> dict:
        return self.map([(cfg, shape, mesh, sites)])[0]

    def _stop(self, slot, kill: bool = False):
        proc, conn = self._children.pop(slot)
        if not kill:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
            proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
        conn.close()

    def close(self):
        for slot in list(self._children):
            self._stop(slot, kill=slot in self._busy)
        self._busy = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def count_collectives(cfg, shape, mesh, tracer=None,
                      sites: bool = False) -> dict:
    """One device's collective traffic of the cell's sharded step at
    ``cfg``'s depth (``trace_step``), traced in a child process
    (``tracer``'s, else a new one's): ``{"per_op": {op: bytes}, "counts":
    {op: calls}, "total": bytes, "seconds": host seconds of the trace}``,
    and where ``sites`` each collective's call site (``sites``)."""
    return _traces([(cfg, shape, mesh, sites)], tracer)[0]


def _traces(jobs, tracer=None) -> list:
    """``CollectiveTracer.map`` of ``jobs`` on ``tracer``, else on a new
    one (in order, on one child)."""
    if tracer is not None:
        return tracer.map(jobs)
    with CollectiveTracer() as t:
        return t.map(jobs)


def collectives(cfg, shape, mesh, tracer=None) -> dict:
    """The cell's collective traffic at full depth: the two depth probes
    traced and extrapolated, per op (``_extrapolate``)."""
    (cfg1, _), (cfg2, _), _ = depth_probe_cfgs(cfg)
    return _probes_extrapolated(cfg, *_traces(
        [(cfg1, shape, mesh, False), (cfg2, shape, mesh, False)], tracer))


def _probes_extrapolated(cfg, c1, c2) -> dict:
    (_, u1), (_, u2), uf = depth_probe_cfgs(cfg)
    ops = sorted(set(c1["per_op"]) | set(c2["per_op"]))
    per_op = {op: _extrapolate(c1["per_op"].get(op, 0),
                               c2["per_op"].get(op, 0), u1, u2, uf)
              for op in ops}
    return {"per_op": per_op, "total": sum(per_op.values()),
            "probes": [c1, c2], "seconds": c1["seconds"] + c2["seconds"]}


def peak_memory(cfg, shape, mesh, tracer=None) -> dict:
    """One device's ``peak_bytes`` over the cell's sharded step and the
    ``entry_bytes`` it starts from (its arguments in allocator blocks,
    ``memory()``'s ``argument_blocks``), from the step traced at full depth
    (``count_collectives``, by ``tracer``).  Not extrapolated from the
    depth probes: the peak is the most live over the step's program points,
    and the point that holds it moves as layers are added (llama3.2-3b's
    unsharded 8 x 128 step peaks at the tied embedding's f32 gradient at 2
    to 8 layers and at the stacked layers' gradients at 28, where the
    probes' line falls 0.85% short)."""
    full = count_collectives(cfg, shape, mesh, tracer)
    return {k: full[k] for k in ("entry_bytes", "peak_bytes", "seconds")}


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def account(cfg, shape, mesh) -> dict:
    """The accounting of one (config, shape, mesh) cell: parameters,
    per-device memory and FLOPs extrapolated from the two depth probes."""
    t0 = time.perf_counter()
    mem = memory(cfg, shape, mesh)
    t_lower = time.perf_counter() - t0
    (cfg1, u1), (cfg2, u2), uf = depth_probe_cfgs(cfg)
    t0 = time.perf_counter()
    f1 = count_flops(cfg1, shape, mesh)
    f2 = count_flops(cfg2, shape, mesh)
    t_probe = time.perf_counter() - t0
    flops = {k: _extrapolate(f1[k], f2[k], u1, u2, uf) for k in f1}
    return {"mem": mem, "flops": flops["products"] + flops["elementwise"],
            "product_flops": flops["products"],
            "transcendentals": flops["transcendentals"],
            "probe_flops": [f1, f2], "probe_depths": [u1, u2],
            "full_depth_units": uf, "t_lower_s": t_lower,
            "t_probe_s": t_probe}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, tag: str = "", tracer=None,
             traced: bool = True):
    """The cell's JSON; where ``traced``, its collective traffic and peak
    memory come from traces of its sharded step by ``tracer`` (a
    ``CollectiveTracer``; a new one for this cell if None), else they are
    ``null``."""
    res, jobs = cell_parts(arch, shape_name, mesh_kind, overrides, tag)
    if not (traced and jobs):
        return res
    if tracer is None:
        with CollectiveTracer() as own:
            return fill_traced(res, jobs, own.map(jobs))
    return fill_traced(res, jobs, tracer.map(jobs))


def cell_parts(arch: str, shape_name: str, mesh_kind: str,
               overrides: dict | None = None, tag: str = ""):
    """(the cell's JSON with its traced fields ``null``, the steps to trace
    for them: the two depth probes and the full-depth step, none where the
    cell is skipped)."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES_BY_NAME[shape_name]
    if shape not in applicable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "tag": tag, "skipped": True,
                "reason": "long_500k needs sub-quadratic attention"}, []

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = mesh.size
    model = build(cfg)
    acc = account(cfg, shape, mesh)
    mem = acc["mem"]
    kind = model.input_specs(shape)["kind"]
    res = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "kind": kind, "skipped": False,
        "n_devices": n_dev,
        "t_lower_s": round(acc["t_lower_s"], 2), "t_compile_s": None,
        "t_probe_s": round(acc["t_probe_s"], 2),
        "t_collectives_s": None,
        "params_total": param_count(model.decls),
        "params_active": cfg.active_param_count(),
        "param_bytes_dtype": getattr(torch, cfg.param_dtype).itemsize,
        "tokens_per_step": shape.global_batch * (
            shape.seq_len if kind in ("train", "prefill") else 1),
        "memory": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": None,
            "alias_bytes": mem["alias_bytes"],
            "peak_device_bytes": None,
            "argument_parts": mem["parts"],
        },
        "cost": {
            "flops_per_device": acc["flops"] / n_dev,
            "product_flops_per_device": acc["product_flops"] / n_dev,
            "bytes_per_device": None,
            "transcendentals": acc["transcendentals"] / n_dev,
            "collective_bytes_per_device": None,
            "per_op": None,
            "raw_full_flops_scanned": None,
            "probe_depths": acc["probe_depths"],
            "full_depth_units": acc["full_depth_units"],
        },
        "config": {
            "remat": cfg.remat, "attn_chunk": cfg.attn_chunk,
            "loss_chunk": cfg.loss_chunk, "param_dtype": cfg.param_dtype,
            "optimizer": cfg.optimizer, "kv_shard": cfg.kv_shard,
            **(overrides or {}),
        },
    }
    (cfg1, _), (cfg2, _), _ = depth_probe_cfgs(cfg)
    return res, [(c, shape, mesh, False) for c in (cfg1, cfg2, cfg)]


def fill_traced(res: dict, jobs, traces) -> dict:
    """``res`` (``cell_parts``'s) with its collective traffic, extrapolated
    from the two depth probes, and its peak memory, the full-depth step's:
    ``traces`` of ``jobs``."""
    c1, c2, full = traces
    coll = _probes_extrapolated(jobs[2][0], c1, c2)
    res["t_collectives_s"] = round(sum(t["seconds"] for t in traces), 2)
    res["memory"]["peak_device_bytes"] = full["peak_bytes"]
    res["memory"]["temp_bytes"] = (full["peak_bytes"]
                                   - res["memory"]["argument_bytes"])
    res["cost"]["collective_bytes_per_device"] = coll["total"]
    res["cost"]["per_op"] = coll["per_op"]
    return res


def cell_path(arch, shape, mesh_kind, tag=""):
    sfx = f"__{tag}" if tag else ""
    return ART_DIR / mesh_kind / f"{arch}__{shape}{sfx}.json"


def parse_overrides(pairs):
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            overrides[k] = v == "True"
            continue
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    return overrides


def lm_archs():
    return [a for a in list_archs() if not a.startswith("graphsage")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="config override k=v (int/float/str/bool)")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    archs = args.arch or (lm_archs() if args.all else [])
    shapes = args.shape or list(SHAPES_BY_NAME)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not archs:
        ap.error("pass --arch or --all")

    with CollectiveTracer() as tracer:
        done, failed = _sweep(args, archs, shapes, meshes, overrides, tracer)
    print(f"done={done} failed={failed}")
    return 0 if failed == 0 else 1


def _sweep(args, archs, shapes, meshes, overrides, tracer):
    """Each cell's host accounting here, in turn, and its traces on a free
    child of ``tracer`` while the next cells are accounted."""
    tally = {"done": 0, "failed": 0}
    pending = []                    # (name, path, JSON, steps, child)
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                name = f"{mesh_kind}/{arch}/{shape}"
                out = cell_path(arch, shape, mesh_kind, args.tag)
                if out.exists() and not args.force:
                    print(f"[skip-cached] {name}")
                    continue
                print(f"[run] {name} ...", flush=True)
                try:
                    res, jobs = cell_parts(arch, shape, mesh_kind,
                                           overrides or None, args.tag)
                except Exception as e:  # noqa: BLE001 — sweep must continue
                    _write(name, out, _failed(arch, shape, mesh_kind,
                                              args.tag, e), tally)
                    continue
                if not jobs:
                    _write(name, out, res, tally)
                    continue
                if len(pending) == tracer.workers:
                    _finish(*pending.pop(0), tracer, tally)
                pending.append((name, out, res, jobs, tracer.submit(jobs)))
    for p in pending:
        _finish(*p, tracer, tally)
    return tally["done"], tally["failed"]


def _failed(arch, shape, mesh_kind, tag, e) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:]}


def _finish(name, out, res, jobs, slot, tracer, tally):
    try:
        res = fill_traced(res, jobs, tracer.result(slot))
    except Exception as e:  # noqa: BLE001 — sweep must continue
        res = _failed(res["arch"], res["shape"], res["mesh"], res["tag"], e)
    _write(name, out, res, tally)


def _write(name, out, res, tally):
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    if "error" in res:
        tally["failed"] += 1
        print(f"  FAILED {name}: {res['error']}", flush=True)
    elif res.get("skipped"):
        tally["done"] += 1
        print(f"  skipped {name}:", res["reason"], flush=True)
    else:
        tally["done"] += 1
        c, m = res["cost"], res["memory"]
        print(f"  ok {name}: params={res['params_total']} "
              f"probe={res['t_probe_s']}s "
              f"flops/dev={c['flops_per_device']:.3e} "
              f"args={m['argument_bytes'] / 2**30:.2f}GiB "
              f"peak={m['peak_device_bytes'] / 2**30:.2f}GiB "
              f"coll={c['collective_bytes_per_device'] / 2**20:.1f}MiB",
              flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
