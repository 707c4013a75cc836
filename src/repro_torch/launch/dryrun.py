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
   decode: the caches).
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
   added elements of an accumulating scatter, and nothing for a
   transcendental (XLA counts those apart) or a data movement; composite
   ops (softmax, SiLU, GELU, log-sum-exp and their backwards, ...) are
   counted through their ``torch._decomp`` decompositions.
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
only XLA's compile gives are ``null``: ``t_compile_s``,
``memory.temp_bytes`` and ``memory.peak_device_bytes`` (the compiler's
buffer assignment), ``cost.bytes_per_device`` and ``cost.transcendentals``
(its cost analysis) and ``cost.raw_full_flops_scanned`` (the count of the
scanned full-depth program).  ``t_lower_s`` is the host seconds of
building the inputs and resolving every spec, ``t_probe_s`` those of the
two traced FLOP probes, ``t_collectives_s`` those of the two collective
traces.

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

def _decl_bytes(decls, cfg, mesh, dtype=None) -> int:
    """One device's bytes of every declared leaf, each by its physical spec
    (``dtype`` for every leaf if given, else its own)."""
    specs = leaves(physical_specs(decls, cfg, mesh))
    return sum(shard_bytes(d.shape, (dtype or d.dtype).itemsize, s, mesh)
               for d, s in zip(leaves(decls), specs, strict=True))


def _batch_bytes(batch, specs, rules, mesh) -> int:
    total = 0
    for name, t in batch.items():
        spec = enforce_divisible(resolve_spec(specs[name], rules), t.shape,
                                 mesh)
        total += shard_bytes(t.shape, t.dtype.itemsize, spec, mesh)
    return total


def memory(cfg, shape, mesh) -> dict:
    """Per-device argument, output and alias bytes of the cell's step, and
    the parts of the argument bytes."""
    model = build(cfg)
    rules = make_rules(cfg, mesh)
    spec = model.input_specs(shape)
    pdt = getattr(torch, cfg.param_dtype)
    parts = {"params": _decl_bytes(model.decls, cfg, mesh, pdt),
             "batch": _batch_bytes(spec["batch"], spec["batch_specs"], rules,
                                   mesh)}
    B = shape.global_batch
    logits = shard_bytes((B, cfg.vocab_size), 4, enforce_divisible(
        resolve_spec(P("dp", None), rules), (B, cfg.vocab_size), mesh), mesh)
    if spec["kind"] == "train":
        odecls = get_optimizer(cfg).state_decls(model.decls)
        parts["opt_state"] = _decl_bytes(odecls, cfg, mesh)
        alias = parts["params"] + parts["opt_state"]
        output = alias + METRICS * 4
    elif spec["kind"] == "prefill":
        alias = 0
        output = logits + _decl_bytes(
            model.cache_decls(B, shape.seq_len), cfg, mesh)
    else:
        parts["caches"] = _decl_bytes(spec["cache_decls"], cfg, mesh)
        alias = parts["caches"]
        output = logits + alias
    return {"argument_bytes": sum(parts.values()), "output_bytes": output,
            "alias_bytes": alias, "parts": parts}


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


class ElementwiseCounter(TorchDispatchMode):
    """Counts the arithmetic that is not a matrix product, as XLA's cost
    analysis does (see the module docstring); ``flops`` is the total."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _DECOMPOSE:
            with self:
                return decomposition_table[func](*args, **kwargs)
        out = func(*args, **kwargs)
        self.flops += _elementwise_flops(func.overloadpacket, args, kwargs,
                                         out)
        return out


def _elementwise_flops(op, args, kwargs, out) -> int:
    o = out[0] if isinstance(out, (tuple, list)) else out
    n = o.numel() if isinstance(o, torch.Tensor) else 0
    if op in _ONE:
        return n
    if op in _REDUCE:
        return args[0].numel() - n
    if op is _A.pow:                 # x ** e, e a whole number: e - 1 products
        e = args[1]
        if isinstance(e, (int, float)) and float(e).is_integer() and e >= 1:
            return n * (int(e) - 1)
        return 0
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
    over a trace on ``meta`` tensors: ``products`` (``FlopCounterMode``)
    and ``elementwise`` (``ElementwiseCounter``)."""
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
            "elementwise": float(elementwise.flops)}


# ---------------------------------------------------------------------------
# Collectives: the sharded step traced on meta DTensors over a fake group
# ---------------------------------------------------------------------------

def meta_dtensor(shape, dtype, spec: P, device_mesh):
    """A ``meta`` DTensor of the global ``shape`` laid out by the physical
    ``spec`` (which divides it) over ``device_mesh``."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, device_mesh)
    local = list(shape)
    for j, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= device_mesh.size(j)
    full = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              device_mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())


def _meta_tree(decls, cfg, mesh, device_mesh, dtype=None):
    specs = leaves(physical_specs(decls, cfg, mesh))
    return unflatten(decls, [meta_dtensor(d.shape, dtype or d.dtype, s,
                                          device_mesh)
                             for d, s in zip(leaves(decls), specs)])


def _place(t, spec: P, mesh, device_mesh):
    """A DTensor ``t`` redistributed to ``spec`` (made divisible)."""
    spec = enforce_divisible(spec, t.shape, mesh)
    return t.redistribute(device_mesh, placements(spec, device_mesh))


def trace_step(cfg, shape, mesh, device_mesh, sites: bool = False) -> dict:
    """The collectives of the cell's sharded step at ``cfg``'s depth, one
    device's, traced on ``meta`` DTensors over ``device_mesh`` (a
    ``DeviceMesh`` of ``mesh``'s axes): ``CollectiveTraffic.summary()``
    (with each collective's call site where ``sites``)."""
    from repro_torch.train.trainer import make_train_step
    model = build(cfg)
    rules = make_rules(cfg, mesh)
    spec = model.input_specs(shape)
    pdt = getattr(torch, cfg.param_dtype)
    with shard_ctx(cfg, mesh, device_mesh), \
            CollectiveTraffic(sites) as traffic:
        params = _meta_tree(model.decls, cfg, mesh, device_mesh, pdt)
        batch = {k: meta_dtensor(t.shape, t.dtype, enforce_divisible(
                     resolve_spec(spec["batch_specs"][k], rules), t.shape,
                     mesh), device_mesh)
                 for k, t in spec["batch"].items()}
        if spec["kind"] == "train":
            opt = get_optimizer(cfg)
            state = _meta_tree(opt.state_decls(model.decls), cfg, mesh,
                               device_mesh)
            state["count"] = 0
            step, _ = make_train_step(model, cfg, opt,
                                      grad_accum=getattr(cfg, "grad_accum",
                                                         1))
            step(params, state, batch)
        else:
            logit_spec = resolve_spec(P("dp", None), rules)
            with torch.no_grad():
                if spec["kind"] == "prefill":
                    cdecls = model.cache_decls(shape.global_batch,
                                               shape.seq_len)
                    logits, caches = model.prefill(params, batch)
                else:
                    cdecls = spec["cache_decls"]
                    caches = _meta_tree(cdecls, cfg, mesh, device_mesh)
                    logits, caches = model.decode(params, caches, batch)
                _place(logits, logit_spec, mesh, device_mesh)
                for c, s in zip(leaves(caches),
                                leaves(physical_specs(cdecls, cfg, mesh))):
                    _place(c, s, mesh, device_mesh)
    return traffic.summary()


def _tracer_main(conn):
    """The child of ``CollectiveTracer``: traces each (cfg, shape, mesh)
    it is sent on a fake group of the mesh's size."""
    try:
        while True:
            job = conn.recv()
            if job is None:
                break
            cfg, shape, mesh, sites = job
            try:
                t0 = time.perf_counter()
                res = trace_step(cfg, shape, mesh, fake_device_mesh(mesh),
                                 sites)
                res["seconds"] = time.perf_counter() - t0
                conn.send(("ok", res))
            except Exception as e:  # noqa: BLE001 — the parent raises it
                conn.send(("error", f"{type(e).__name__}: {e}\n"
                                    f"{traceback.format_exc()[-3000:]}"))
    finally:
        release_fake_group()
        conn.close()


class CollectiveTracer:
    """A child process (``spawn``) that owns the dry-run's fake group and
    traces cells' steps on it: ``count(cfg, shape, mesh)``.  The group is
    global state, so it never lives in the caller's process; one child
    serves a whole sweep (each trace's first ops pay DTensor's one-time
    set-up)."""

    timeout = 900.0                 # seconds a trace may take

    def __init__(self):
        self._proc = None           # started by the first ``count``

    def _start(self):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_tracer_main, args=(child,),
                                 name="collective tracer", daemon=True)
        self._proc.start()
        child.close()

    def count(self, cfg, shape, mesh, sites: bool = False) -> dict:
        if self._proc is None:
            self._start()
        self._conn.send((cfg, shape, mesh, sites))
        if not self._conn.poll(self.timeout):
            self._proc.kill()
            self.close()
            raise TimeoutError(f"no collective trace of {cfg.name} on "
                               f"{axis_sizes(mesh)} after {self.timeout} s")
        status, res = self._conn.recv()
        if status != "ok":
            raise RuntimeError(f"collective trace failed: {res}")
        return res

    def close(self):
        if self._proc is None:
            return
        try:
            self._conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()
        self._conn.close()
        self._proc = None

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
    if tracer is not None:
        return tracer.count(cfg, shape, mesh, sites)
    with CollectiveTracer() as t:
        return t.count(cfg, shape, mesh, sites)


def collectives(cfg, shape, mesh, tracer=None) -> dict:
    """The cell's collective traffic at full depth: the two depth probes
    traced and extrapolated, per op (``_extrapolate``)."""
    (cfg1, u1), (cfg2, u2), uf = depth_probe_cfgs(cfg)
    c1 = count_collectives(cfg1, shape, mesh, tracer)
    c2 = count_collectives(cfg2, shape, mesh, tracer)
    ops = sorted(set(c1["per_op"]) | set(c2["per_op"]))
    per_op = {op: _extrapolate(c1["per_op"].get(op, 0),
                               c2["per_op"].get(op, 0), u1, u2, uf)
              for op in ops}
    return {"per_op": per_op, "total": sum(per_op.values()),
            "probes": [c1, c2], "seconds": c1["seconds"] + c2["seconds"]}


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
            "probe_flops": [f1, f2], "probe_depths": [u1, u2],
            "full_depth_units": uf, "t_lower_s": t_lower,
            "t_probe_s": t_probe}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, tag: str = "", tracer=None,
             collectives_too: bool = True):
    """The cell's JSON; its collective traffic is traced by ``tracer``
    (a ``CollectiveTracer``; a new one for this cell if None) where
    ``collectives_too``."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES_BY_NAME[shape_name]
    if shape not in applicable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "tag": tag, "skipped": True,
                "reason": "long_500k needs sub-quadratic attention"}

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = mesh.size
    model = build(cfg)
    acc = account(cfg, shape, mesh)
    mem = acc["mem"]
    kind = model.input_specs(shape)["kind"]
    coll = collectives(cfg, shape, mesh, tracer) if collectives_too else None
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "kind": kind, "skipped": False,
        "n_devices": n_dev,
        "t_lower_s": round(acc["t_lower_s"], 2), "t_compile_s": None,
        "t_probe_s": round(acc["t_probe_s"], 2),
        "t_collectives_s": None if coll is None else round(coll["seconds"],
                                                           2),
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
            "transcendentals": None,
            "collective_bytes_per_device": (None if coll is None
                                            else coll["total"]),
            "per_op": None if coll is None else coll["per_op"],
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
    done, failed = 0, 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                out = cell_path(arch, shape, mesh_kind, args.tag)
                if out.exists() and not args.force:
                    print(f"[skip-cached] {mesh_kind}/{arch}/{shape}")
                    continue
                print(f"[run] {mesh_kind}/{arch}/{shape} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind,
                                   overrides or None, args.tag, tracer)
                except Exception as e:  # noqa: BLE001 — sweep must continue
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "tag": args.tag,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failed += 1
                    print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(json.dumps(res, indent=1))
                if "error" not in res:
                    done += 1
                    if res.get("skipped"):
                        print("  skipped:", res["reason"], flush=True)
                    else:
                        c, m = res["cost"], res["memory"]
                        coll = c["collective_bytes_per_device"]
                        coll = ("null" if coll is None
                                else f"{coll / 2**20:.1f}MiB")
                        print(f"  ok: params={res['params_total']} "
                              f"probe={res['t_probe_s']}s "
                              f"flops/dev={c['flops_per_device']:.3e} "
                              f"args={m['argument_bytes'] / 2**30:.2f}GiB "
                              f"coll={coll}", flush=True)
    return done, failed


if __name__ == "__main__":
    raise SystemExit(main())
