"""One process per partition: the ranks of a ``torch.distributed`` group.

``spawn_partitions(fn, parts, backend, devices)`` starts ``parts``
processes with the ``spawn`` start method (the parent may hold a CUDA
context, which a forked child cannot use).  Rank r sets its card first
where ``devices[r]`` is one, joins the default group (``backend``,
``init_method``, rank r of ``parts``), runs ``fn(r, device, *args)``,
hands its result to the parent and leaves the group.  Inside the group,
``launch/mesh.make_partition_mesh`` returns a ``GroupMesh``, so the
multi-partition trainer and the collectives run one partition a process.

``nccl`` takes one card per rank (it refuses two ranks on one card);
``gloo`` runs on the CPU, and its ranks may share one card for their
tensors while their collectives' buffers pass through the host.  Where
the collectives are issued on card tensors (DTensor's, the sharded LM
step), ``gloo-host`` carries them: a ``gloo`` group whose functional
collectives on card tensors run gloo's collective on a host copy of the
buffer (``stage_collectives_through_host``; this PyTorch's gloo faults
on card tensors).  Such a run checks what a step computes; its walls time
the host copies, not the step.  The caller names the backend: nothing
here falls back from one to the other.

A rank that raises exits non-zero with its traceback on stderr; the
parent then stops every other rank and raises, so the run fails.

Rank code: ``collectives_rank`` (every group collective),
``pipeline_rank`` (the GPipe pipeline), ``sharded_lm_rank`` (the LM
train step sharded as DTensors on a (data, model) mesh of the group;
``sharded_runs_rank`` several in turn) and ``sharded_serve_rank`` (its
block prefill and decode step); each is, outside a group, the reference
it is held to.
"""
from __future__ import annotations

import math
import pickle
import queue
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence


HOST_STAGED = "gloo-host"
# the functional collectives DTensor issues
_STAGED_OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single")
_STAGED_LIBS: list = []


def stage_collectives_through_host():
    """Give DTensor's functional collectives (``torch.ops._c10d_functional``
    ``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``) a kernel for card tensors that runs the
    collective on a host copy of the input, over this process's ``gloo``
    group, and copies the result back to the input's card: the transport
    of the ``gloo-host`` backend.  Only the collective's buffer passes
    through the host (gloo itself faults on card tensors in this
    PyTorch); every other op stays on the card.  Once a process."""
    if _STAGED_LIBS:
        return
    import torch
    ops = torch.ops._c10d_functional
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def staged(op):
        def kernel(t, *args):
            out = ops.wait_tensor(op(t.detach().to("cpu"), *args))
            return out.to(t.device)
        return kernel
    for name in _STAGED_OPS:
        lib.impl(name, staged(getattr(ops, name).default), "CUDA")
    _STAGED_LIBS.append(lib)


def _rank_main(rank: int, fn: Callable, args: tuple, backend: str,
               init_method: str, devices: Sequence[str], results):
    import torch
    import torch.distributed as dist
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == HOST_STAGED:
        stage_collectives_through_host()
    dist.init_process_group("gloo" if backend == HOST_STAGED else backend,
                            init_method=init_method, rank=rank,
                            world_size=len(devices))
    out = fn(rank, device, *args)
    results.put((rank, pickle.dumps(out)))
    dist.destroy_process_group()


def spawn_partitions(fn: Callable, parts: int, backend: str,
                     devices: Sequence, init_method: Optional[str] = None,
                     args: tuple = (), timeout: Optional[float] = None
                     ) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``parts`` spawned processes
    joined in a ``torch.distributed`` group; returns their results in rank
    order.

    ``fn`` is a module-level function (the child imports it by name) and
    its result must pickle.  ``devices[r]`` is rank r's device; under
    ``nccl`` each is a card of its own (``cuda:r``).  ``init_method``
    defaults to a ``file://`` store in a fresh temporary directory, removed
    afterwards.  Raises ``RuntimeError`` when a rank exits non-zero and
    ``TimeoutError`` after ``timeout`` seconds; either way every rank still
    running is stopped first."""
    import torch
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != parts:
        raise ValueError(f"{len(devices)} devices for {parts} ranks")
    if backend == "nccl" and (
            any(not d.startswith("cuda:") for d in devices)
            or len(set(devices)) != parts):
        raise ValueError(f"nccl takes one card per rank (cuda:r), not "
                         f"{devices}")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
        init_method = f"file://{tmp}/store"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank {r}",
                         args=(r, fn, tuple(args), backend, init_method,
                               devices, results))
             for r in range(parts)]
    deadline = None if timeout is None else time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        # drain the queue while the ranks run: a child that put a large
        # result cannot exit before the parent reads it
        while len(out) < parts:
            try:
                rank, blob = results.get(timeout=0.5)
                out[rank] = pickle.loads(blob)
                continue
            except queue.Empty:
                pass
            for p in procs:
                if p.exitcode not in (None, 0):
                    raise RuntimeError(f"{p.name} of {parts} ({backend}) "
                                       f"exited with code {p.exitcode}")
            if all(p.exitcode == 0 for p in procs) and results.empty():
                missing = sorted(set(range(parts)) - set(out))
                raise RuntimeError(f"ranks {missing} exited without a "
                                   f"result")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{parts} ranks ({backend}) still running "
                                   f"after {timeout} s")
        for p in procs:
            p.join(None if deadline is None
                   else max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"{p.name} of {parts} ({backend}) ended "
                                   f"with {p.exitcode} after its result")
    finally:
        procs = [p for p in procs if p.pid is not None]     # started
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(parts)]


def decode_inputs(shape, seed: int, device):
    """Seeded f32 ``(q, k, v, pos)`` of a decode step, drawn on ``device``
    (the same values wherever the same device draws them): q scaled by
    Dh^-0.5, as a caller folds the attention's scale into it, and each
    row's last valid position spread over the cache."""
    import torch
    B, T, H, Dh = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, H, Dh, generator=g, device=device) * Dh ** -0.5
    k = torch.randn(B, T, H, Dh, generator=g, device=device)
    v = torch.randn(B, T, H, Dh, generator=g, device=device)
    pos = torch.linspace(0, T - 1, B, device=device).to(torch.int32)
    return q, k, v, pos


def collectives_rank(rank: int, device, inputs: dict) -> dict:
    """Each group collective on this rank's share of ``inputs`` (numpy,
    put on ``device``), for the checks that hold the group forms to the
    host-simulated ones: every key present runs, and its output comes back
    as numpy.

      ``grad_trees``  one gradient tree (dict of arrays) per member →
                      ``grad_allreduce`` over a ``part`` axis
      ``compress``    one array per member → ``compressed_psum_int8``
                      over a ``pod`` axis
      ``crosspod``    one tree per member → ``make_crosspod_grad_transform``
      ``decode``      ``(q, k, v, pos)``, the whole cache, or
                      ``{"shape": (B, T, H, Dh), "seed": s}`` to draw it
                      on ``device`` (``decode_inputs``) →
                      ``flash_decode_attention`` over a ``model`` axis
      ``halo``        ``(plan, part_feats)`` → ``halo_all_to_all``: this
                      rank's halo rows and the volume
      ``objects``     any value → ``all_gather_objects`` of (rank, value)

    ``modules`` lists the top-level modules the process has imported."""
    import numpy as np
    import torch

    from repro_torch.distributed.collectives import (all_gather_objects,
                                                     flash_decode_attention,
                                                     grad_allreduce,
                                                     halo_all_to_all)
    from repro_torch.launch.mesh import group_mesh
    from repro_torch.models.params import tree_map
    from repro_torch.train.compression import (compressed_psum_int8,
                                               make_crosspod_grad_transform)

    def dev(tree):
        return tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(device),
                        tree)

    def host(tree):
        return tree_map(lambda t: t.cpu().numpy(), tree)

    out = {}
    if "grad_trees" in inputs:
        fn = grad_allreduce(group_mesh("part"))
        out["grad_trees"] = host(fn([dev(inputs["grad_trees"][rank])]))
    if "compress" in inputs:
        out["compress"] = host(compressed_psum_int8(
            [dev(inputs["compress"][rank])], group_mesh("pod")))
    if "crosspod" in inputs:
        fn = make_crosspod_grad_transform(group_mesh("pod"))
        out["crosspod"] = host(fn(dev(inputs["crosspod"][rank])))
    if "decode" in inputs:
        fn = flash_decode_attention(group_mesh("model"), "model")
        spec = inputs["decode"]
        args = (decode_inputs(spec["shape"], spec["seed"], device)
                if isinstance(spec, dict) else dev(list(spec)))
        out["decode"] = host(fn(*args))
    if "halo" in inputs:
        plan, feats = inputs["halo"]
        rows, volume = halo_all_to_all(group_mesh("part"))(plan, feats)
        out["halo"] = (rows[rank], volume)
    if "objects" in inputs:
        out["objects"] = all_gather_objects(group_mesh("part"),
                                            (rank, inputs["objects"]))
    out["modules"] = imported_modules()
    return out


def imported_modules() -> list:
    """The top-level names of every module this process has imported."""
    import sys
    return sorted({name.split(".")[0] for name in sys.modules})


def _toy_stage(p, x):
    """``tests/test_distributed.py``'s pipeline stage: tanh(x @ w)."""
    import torch
    return torch.tanh(x @ p["w"])


def pipeline_model(spec: dict, stages: int, device):
    """``(params, xs, layer_fn)`` of a pipeline run on ``device``: the
    whole stack's parameters, each leaf with a leading dim of ``stages``,
    the microbatches ``xs`` (M, mb, ...) and the stage function.  ``spec``
    holds one of

      ``toy``  ``{"w": (S, D, D), "xs": (M, mb, D)}`` (numpy): a stage is
               ``tanh(x @ w)``;
      ``lm``   ``{"arch", "num_layers", "dtype", "smoke"}`` and either
               ``"layers"`` (the stacked layer tree as numpy, e.g. JAX's
               converted) and ``"xs"`` (M, mb, T, D), or ``"seed"``,
               ``"x_seed"``, ``"micro"``, ``"mb"`` and ``"tokens"`` to draw
               them on ``device`` (``init_params`` of the stacked layers
               in ``dtype``, then ``randn`` hidden states): a stage is
               ``transformer.pipeline_stage``, ``num_layers / stages``
               layers."""
    import numpy as np
    import torch

    from repro_torch.models.params import tree_map
    device = torch.device(device)
    if "toy" in spec:
        toy = spec["toy"]
        return ({"w": torch.from_numpy(np.asarray(toy["w"])).to(device)},
                torch.from_numpy(np.asarray(toy["xs"])).to(device),
                _toy_stage)
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.params import init_params, stack_decls
    from repro_torch.models.transformer import decls_layer, pipeline_stage
    lm = spec["lm"]
    dtype = getattr(torch, lm["dtype"])
    n = lm["num_layers"]
    cfg = get_config(lm["arch"], smoke=lm.get("smoke", False)).replace(
        num_layers=n, compute_dtype=lm["dtype"])
    if "layers" in lm:
        stack = tree_map(lambda a: a.to(dtype),
                         params_from_jax(lm["layers"], device))
        xs = torch.from_numpy(np.asarray(lm["xs"])).to(device, dtype)
    else:
        stack = init_params(stack_decls(decls_layer(cfg), n),
                            torch.Generator(device).manual_seed(lm["seed"]),
                            device, dtype_override=dtype)
        g = torch.Generator(device).manual_seed(lm["x_seed"])
        xs = torch.randn(lm["micro"], lm["mb"], lm["tokens"], cfg.d_model,
                         generator=g, device=device).to(dtype)
    staged = tree_map(lambda a: a.view(stages, n // stages, *a.shape[1:]),
                      stack)
    return staged, xs, pipeline_stage(cfg)


def named_leaves(tree, prefix: str = "") -> dict:
    """``{"a/b": leaf}`` of a nested dict, in ``leaves`` order."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in named_leaves(tree[key], f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def tensor_digest(t) -> tuple:
    """(SHA-256 of the bytes, shape, dtype) of a tensor."""
    import hashlib
    import torch
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return (hashlib.sha256(flat.numpy()).hexdigest(), tuple(t.shape),
            str(t.dtype))


def pipeline_rank(rank: int, device, inputs: dict) -> dict:
    """The GPipe pipeline's forward and backward (``distributed/pp.py``)
    on ``device``, for the checks that hold its group form to the
    host-simulated one.

    Inside a group, this process is stage ``rank`` of
    ``make_partition_mesh(inputs["stages"], axis="stage")`` (a rank past
    it returns ``{"stage": None}`` and calls nothing); outside one, every
    stage runs here on a ``HostSimMesh``, the reference.  ``inputs``:
    ``stages``, ``micro``, the model (``pipeline_model``'s ``toy`` or
    ``lm``), ``loss`` ("sum" or "mean" of ``out.float() ** 2``), ``runs``
    (forward + backward runs, default 1: each is timed; the last one's
    launches and traffic are reported), ``digest`` (each value as
    ``tensor_digest`` instead of a CPU tensor: a full-width stack's
    gradients do not cross the result queue) and ``want`` (digests by
    key: ``differs`` is then the first key, in name order, whose digest
    differs, with this process's tensor of it).

    ``values``: ``out``, ``dxs`` (the gradient of ``xs``) and
    ``grad/<stage>/<leaf>`` (leaves (1, ...)): this stage's, or every
    stage's."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.pp import make_pipeline_fn
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.launch.mesh import HostSimMesh, make_partition_mesh
    from repro_torch.models.params import leaves, tree_map, unflatten

    def counts():
        return {**launch_counts(),
                "flash_attention_bwd": flash_attention_bwd.launches}

    S, M = inputs["stages"], inputs["micro"]
    in_group = dist.is_available() and dist.is_initialized()
    mesh = (make_partition_mesh(S, device, axis="stage") if in_group
            else HostSimMesh(S, "stage"))
    if in_group and not mesh.holds_partition:
        return {"stage": None, "modules": imported_modules()}
    params, xs, layer_fn = pipeline_model(inputs, S, device)
    stages = [rank] if in_group else list(range(S))
    if in_group:                    # this stage's block, the rest freed
        params = tree_map(lambda a: a[rank:rank + 1].clone(), params)
    pipe = make_pipeline_fn(layer_fn, S, M, mesh)
    flat = [a.requires_grad_() for a in leaves(params)]
    xs.requires_grad_()
    cuda = torch.device(device).type == "cuda"
    seconds = []
    for _ in range(inputs.get("runs", 1)):
        before = counts()
        t0 = time.perf_counter()
        out = pipe(unflatten(params, flat), xs)
        sq = out.float() ** 2
        loss = sq.sum() if inputs["loss"] == "sum" else sq.mean()
        *dp, dxs = torch.autograd.grad(loss, flat + [xs])
        if cuda:
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        launches = {k: n - before[k] for k, n in counts().items()}
    values = {"out": out.detach(), "dxs": dxs}
    grads = named_leaves(unflatten(params, dp))
    for s in stages:
        for name, g in grads.items():
            values[f"grad/{s}/{name}"] = g if in_group else g[s:s + 1]
    del params, flat, dp, grads, out, dxs
    res = {"stage": rank if in_group else None, "seconds": seconds,
           "launches": launches,
           "traffic": list(getattr(pipe, "traffic", [])),
           "modules": imported_modules()}
    if not inputs.get("digest"):
        res["values"] = {k: v.cpu() for k, v in values.items()}
        return res
    res["values"] = {k: tensor_digest(v) for k, v in values.items()}
    want = inputs.get("want") or {}
    bad = sorted(k for k, d in res["values"].items()
                 if k in want and want[k] != d)
    res["differs"] = (bad[0], values[bad[0]].cpu()) if bad else None
    return res


def lm_config(spec: dict):
    """The config of a sharded-step run: ``arch`` (``smoke``) at
    ``num_layers``, ``dtype`` its parameter and compute dtype, and any
    further ``overrides``."""
    from repro_torch.configs import get_config
    dtype = spec.get("dtype", "float32")
    return get_config(spec["arch"], smoke=spec.get("smoke", False)).replace(
        num_layers=spec["num_layers"], param_dtype=dtype, compute_dtype=dtype,
        **spec.get("overrides", {}))


def _fan_in(name: str, shape) -> int:
    """The whole fan-in of a (layer-stacked) weight: the dims its input
    contracts (q/k/v: d_model; wo: heads x head_dim; the tied embedding as
    the unembedding: d_model; every other: the dim before the last)."""
    dims = {"wq": (-3,), "wk": (-3,), "wv": (-3,), "wo": (-3, -2),
            "tok": (-1,)}.get(name.rsplit("/", 1)[-1], (-2,))
    return math.prod(shape[d] for d in dims)


def lm_setup(spec: dict, device):
    """``(cfg, model, params, batch)`` of a sharded-step run on
    ``device``: the config (``arch``, ``smoke``, ``num_layers`` and
    ``dtype``, the parameter and compute dtype), the full parameters
    (``params``, a numpy tree such as JAX's converted, else ``init_params``
    drawn from a CPU generator seeded ``seed``) and the train step's batch
    (``lm_batch``: ``tokens``, ``targets`` and the family's frontends).
    ``init: "fan_in"`` redraws the weights tame: each projection N(0, 1 /
    its whole fan-in), the (tied) embedding N(0, 1 / d_model), where
    ``init_params``, as JAX's, reads a fan-in from the dim before the
    last only (the attention's heads) and draws the embedding
    N(0, 1), which makes a seeded stack chaotic."""
    import torch

    from repro_torch.models.api import build
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.params import init_params, leaves, tree_map
    dtype = spec.get("dtype", "float32")
    cfg = lm_config(spec)
    model = build(cfg)
    if "params" in spec:
        params = tree_map(lambda t: t.to(getattr(torch, dtype)),
                          params_from_jax(spec["params"], device))
    else:
        params = init_params(model.decls,
                             torch.Generator().manual_seed(spec["seed"]),
                             device, dtype_override=getattr(torch, dtype))
    if spec.get("init") == "fan_in":
        for (name, t), d in zip(named_leaves(params).items(),
                                leaves(model.decls)):
            if d.init in ("scaled", "normal") and t.dim() >= 2:
                now = d.scale / (math.sqrt(d.shape[-2])
                                 if d.init == "scaled" else 1.0)
                t.mul_(1.0 / (now * math.sqrt(_fan_in(name, t.shape))))
    return cfg, model, params, lm_batch(spec, model, "train", device)


def lm_batch(spec: dict, model, kind: str, device):
    """The inputs of a ``kind`` step, by ``model.input_specs``: each key
    ``spec`` holds (numpy, e.g. from the JAX side) as it is, the rest
    drawn from a CPU generator seeded ``seed`` + 1: ``tokens``,
    ``targets`` and a decode ``token`` uniform over the vocabulary, the
    frontends' embeddings (whisper's ``audio_embeds``, the VLM's
    ``vision_embeds``) N(0, 1) in the compute dtype, M-RoPE ``positions``
    the text positions on all three streams, a decode ``pos`` at S/2 +
    b mod S.  Train and prefill take ``batch`` x ``seq`` tokens (or the
    shape of ``spec["tokens"]``); decode a cache of ``seq``."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    if "tokens" in spec:
        B, S = np.shape(spec["tokens"])
    else:
        B, S = spec["batch"], spec["seq"]
    specs = model.input_specs(ShapeConfig("run", kind, S, B))["batch"]
    g = torch.Generator().manual_seed(spec.get("seed", 0) + 1)
    V = model.cfg.vocab_size
    batch = {}
    for k, t in specs.items():
        if k in spec and not (kind == "decode" and k == "positions"):
            v = torch.from_numpy(np.asarray(spec[k]))
        elif k in ("tokens", "targets", "token"):
            v = torch.randint(0, V, t.shape, generator=g, dtype=torch.int32)
        elif k == "pos":
            v = ((S // 2 + torch.arange(B)) % S).to(torch.int32)
        elif k == "positions":
            n = t.shape[-1]
            v = (torch.arange(n, dtype=torch.int32) if kind != "decode"
                 else batch["pos"][:, None]).expand(t.shape).contiguous()
        else:
            v = torch.randn(t.shape, generator=g).to(t.dtype)
        batch[k] = v.to(device)
    return batch


def _place_batch(batch: dict, model, kind: str, mesh, device_mesh) -> dict:
    """Each key of a ``kind`` step's batch as a DTensor laid out by its
    own spec of ``model.input_specs`` (resolved, and made divisible)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import (enforce_divisible,
                                                  make_rules, placements,
                                                  resolve_spec)
    from repro_torch.models.convert import local_shard
    # the specs do not depend on the shape
    specs = model.input_specs(ShapeConfig("run", kind, 4, 1))["batch_specs"]
    rules = make_rules(model.cfg, mesh)
    out = {}
    for k, t in batch.items():
        pl = placements(enforce_divisible(resolve_spec(specs[k], rules),
                                          t.shape, mesh), device_mesh)
        out[k] = DTensor.from_local(local_shard(t, pl, device_mesh),
                                    device_mesh, pl,
                                    run_check=False, shape=t.shape,
                                    stride=t.stride())
    return out


def sharded_lm_rank(rank: int, device, spec: dict) -> dict:
    """The LM train step sharded over a ``(data, model)`` mesh (``spec
    ["mesh"]``: its sizes), for the checks that hold it to the unsharded
    step.

    Inside a group of the mesh's size: a ``DeviceMesh`` over it
    (``launch/mesh.device_mesh``), the full weights and batch of
    ``lm_setup`` and the optimizer's initial state placed as DTensors
    (``models/convert.distribute_params``, by ``model.decls`` and
    ``opt.state_decls``; each batch key by its own spec of
    ``model.input_specs``), then ``steps`` (default 2) steps of the
    config's optimizer of ``train/trainer.make_train_step`` inside
    ``shard_ctx`` with the
    ``DeviceMesh``.  Outside a group: the same steps unsharded on plain
    tensors, under ``shard_ctx`` of an ``AbstractMesh`` of the same shape
    (so the MoE groups its tokens alike): the reference.

    Returns ``loss`` (the first step's, a float), ``grads`` (the first
    step's gradients, full tensors by leaf name), ``params`` (after the
    steps), ``traffic`` (the bytes this rank's collectives moved in the
    first step, by op: ``CollectiveTraffic.summary()``; empty outside a
    group), ``launches`` (the ``flash_attention`` forward and backward
    launches of the first step), ``seconds`` (each step's wall),
    ``peak_bytes`` (the card's peak allocation over the run, 0 on the
    CPU), ``step_peak_bytes`` (the last step's own peak on the card as
    the dry-run's memory trace counts it, ``launch/footprint.step_peak``:
    what else the run holds through that step drops out; 0 on the CPU)
    and ``modules``; outside a group also ``moves`` (each leaf's ||params -
    the parameters before the steps||).  With ``spec["ref"]`` (a file of a
    reference's ``grads``, ``params`` and ``moves`` saved by
    ``torch.save``), ``grads`` and ``params`` are replaced by each leaf's
    relative error against it (``when_written``: the caller may write it
    while the ranks run), so a full-width tree never crosses the result
    queue: ``grad_err`` ||g - g_ref|| / ||g_ref||, ``param_err``
    ||p - p_ref|| over the reference's move (an elementwise optimizer moves
    every element about lr a step, so a max-abs bound on the parameters
    would only bound a sign flip)."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import CollectiveTraffic
    from repro_torch.distributed.sharding import is_dtensor, shard_ctx
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.launch.footprint import step_peak, window_start
    from repro_torch.launch.mesh import AbstractMesh, device_mesh
    from repro_torch.models.convert import distribute_params
    from repro_torch.models.params import leaves, unflatten
    from repro_torch.train.trainer import make_train_step, placed_like

    device = torch.device(device)
    mesh = AbstractMesh(tuple(spec["mesh"]), ("data", "model"))
    cfg, model, params, batch = lm_setup(spec, device)
    in_group = dist.is_available() and dist.is_initialized()
    dm = device_mesh(mesh, device) if in_group else None
    step, opt = make_train_step(model, cfg)
    state = opt.init(params)
    start = None if in_group else {k: t.clone() for k, t in
                                   named_leaves(params).items()}
    if in_group:
        params = distribute_params(params, model, cfg, dm)
        sdecls = opt.state_decls(model.decls)
        state = {k: v if k == "count" else
                 distribute_params(v, model, cfg, dm, sdecls[k])
                 for k, v in state.items()}
        batch = _place_batch(batch, model, "train", mesh, dm)
    cuda = device.type == "cuda"

    def full(t):
        return (t.full_tensor() if is_dtensor(t) else t).detach()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with shard_ctx(cfg, mesh, dm):
        p_l = [p.requires_grad_(True) for p in leaves(params)]
        loss, _ = model.loss_fn(unflatten(params, p_l), batch)
        grads = torch.autograd.grad(loss, p_l, allow_unused=True)
        for p in p_l:
            p.requires_grad_(False)
        grads = placed_like([torch.zeros_like(p) if g is None else g
                             for g, p in zip(grads, p_l)], p_l)
        grads = {k: full(g) for k, g in
                 named_leaves(unflatten(params, grads)).items()}
        loss = float(full(loss))
        seconds, traffic = [], {}
        steps, step_peak_bytes, run_peak = spec.get("steps", 2), 0, 0
        for i in range(steps):
            f0, b0 = flash_attention.launches, flash_attention_bwd.launches
            sync()
            if cuda and i == steps - 1:
                # the last step's own window (the run's peak kept apart)
                run_peak = torch.cuda.max_memory_allocated(device)
                base = window_start(device)
            t0 = time.perf_counter()
            if i == 0:
                with CollectiveTraffic() as tr:
                    step(params, state, batch)
                traffic = tr.summary()
            else:
                step(params, state, batch)
            sync()
            seconds.append(time.perf_counter() - t0)
            if cuda and i == steps - 1:
                step_peak_bytes = step_peak(base, params, state, batch,
                                            device=device)
            if i == 0:
                launches = {"flash_attention": flash_attention.launches - f0,
                            "flash_attention_bwd":
                                flash_attention_bwd.launches - b0}
    after = {k: full(t) for k, t in named_leaves(params).items()}
    res = {"loss": loss, "traffic": traffic, "launches": launches,
           "seconds": seconds, "modules": imported_modules(),
           "peak_bytes": (max(run_peak, torch.cuda.max_memory_allocated(
               device)) if cuda else 0),
           "step_peak_bytes": step_peak_bytes}
    if start is not None:
        res["moves"] = {k: float((t.float() - start[k].float()).norm())
                        for k, t in after.items()}
    if "ref" not in spec:
        res["grads"] = {k: g.cpu() for k, g in grads.items()}
        res["params"] = {k: t.cpu() for k, t in after.items()}
        return res
    ref = torch.load(when_written(spec["ref"]), map_location=device)
    res["grad_err"] = {k: _relative(g, ref["grads"][k],
                                    ref["grads"][k].float().norm())
                       for k, g in grads.items()}
    res["param_err"] = {k: _relative(t, ref["params"][k], ref["moves"][k])
                        for k, t in after.items()}
    return res


def when_written(path, timeout: float = 600.0):
    """``path`` once it exists, for a file a caller writes beside the
    ranks (renamed into place whole).  Raises ``RuntimeError`` where the
    caller left ``<path>.failed`` instead, ``TimeoutError`` after
    ``timeout`` seconds."""
    from pathlib import Path
    path = Path(path)
    failed = path.with_name(path.name + ".failed")
    deadline = time.monotonic() + timeout
    while not path.exists():
        if failed.exists():
            raise RuntimeError(f"{path} was not written: "
                               f"{failed.read_text()}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written after {timeout} s")
        time.sleep(0.1)
    return path


def sharded_runs_rank(rank: int, device, specs: list, fn=None) -> list:
    """``sharded_lm_rank`` (or ``fn``, the same signature) of each spec in
    turn, in one process: one spawn for several runs."""
    import torch
    out = []
    for spec in specs:
        out.append((fn or sharded_lm_rank)(rank, device, spec))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def sharded_serve_rank(rank: int, device, spec: dict) -> dict:
    """One block prefill and one decode step sharded over a ``(data,
    model)`` mesh (``spec["mesh"]``), as ``sharded_lm_rank`` shards the
    train step; outside a group the same two steps on plain tensors, the
    reference.  The prefill reads the prompt of ``lm_batch`` (its
    ``targets`` unused); the decode step a cache of ``seq`` positions
    drawn N(0, 1/4) from a generator seeded ``seed`` + 2 (placed by
    ``model.cache_decls``' specs in the group), the tokens and positions
    of ``lm_batch``'s decode batch.  The prefill runs as the dry-run
    traces it (``launch.dryrun.run_step``: its logits and caches then
    placed where JAX's ``out_shardings`` put them).  Returns
    ``prefill_logits``, ``prefill_caches``, ``decode_logits`` and
    ``decode_caches`` (full tensors on the CPU, by name),
    ``prefill_placements`` (each prefill cache's DTensor placements as
    strings; empty outside a group), ``prefill_traffic`` (the prefill's
    collectives on this rank, ``CollectiveTraffic.summary()``) and
    ``modules``."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import CollectiveTraffic
    from repro_torch.distributed.sharding import is_dtensor, shard_ctx
    from repro_torch.launch.dryrun import out_placer, run_step
    from repro_torch.launch.mesh import AbstractMesh, device_mesh
    from repro_torch.models.convert import distribute_params
    from repro_torch.models.params import leaves, unflatten

    device = torch.device(device)
    mesh = AbstractMesh(tuple(spec["mesh"]), ("data", "model"))
    cfg, model, params, batch = lm_setup(spec, device)
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    step = lm_batch({k: v for k, v in spec.items() if k != "tokens"}
                    | {"batch": batch["tokens"].shape[0],
                       "seq": batch["tokens"].shape[1]},
                    model, "decode", device)
    cdecls = model.cache_decls(*batch["tokens"].shape)
    g = torch.Generator().manual_seed(spec.get("seed", 0) + 2)
    caches = unflatten(cdecls, [(0.5 * torch.randn(d.shape, generator=g))
                                .to(device, d.dtype)
                                for d in leaves(cdecls)])
    in_group = dist.is_available() and dist.is_initialized()
    dm = device_mesh(mesh, device) if in_group else None
    place = None
    if in_group:
        params = distribute_params(params, model, cfg, dm)
        caches = distribute_params(caches, model, cfg, dm, cdecls)
        prompt = _place_batch(prompt, model, "prefill", mesh, dm)
        step = _place_batch(step, model, "decode", mesh, dm)
        place = out_placer(cfg, mesh, dm)

    def full(tree):
        return {k: (t.full_tensor() if is_dtensor(t) else t).cpu()
                for k, t in tree.items()}
    with shard_ctx(cfg, mesh, dm), torch.no_grad():
        with CollectiveTraffic() as traffic:
            logits, pcaches = run_step(model, cfg, {"kind": "prefill"},
                                       {"params": params, "batch": prompt},
                                       place)
        res = {"prefill_logits": full({"": logits})[""],
               "prefill_caches": full(pcaches),
               "prefill_placements": {
                   k: [str(p) for p in c.placements]
                   for k, c in pcaches.items() if is_dtensor(c)},
               "prefill_traffic": traffic.summary()}
        logits, dcaches = model.decode(params, caches, step)
        res.update(decode_logits=full({"": logits})[""],
                   decode_caches=full(dcaches), modules=imported_modules())
    return res


def _relative(got, want, over) -> float:
    """||got - want|| (f32) / ``over``; 0 where they agree."""
    diff = float((got.float() - want.float()).norm())
    if not diff:
        return 0.0
    return diff / float(over) if float(over) else math.inf
