"""GPipe-style pipeline parallelism over a stage mesh.

A port of ``src/repro/distributed/pp.py``: the layer stack is split into
S stages over a ``stage`` mesh axis, and microbatches flow through the
GPipe schedule of S + M − 1 ticks.  At tick t stage 0 takes in microbatch
t, stage s works on microbatch t − s, and the last stage emits microbatch
t − (S − 1).  A slot of the schedule with no microbatch (the pipeline's
fill and drain bubbles) computes nothing: JAX's stages run their layers on
zeros there, whose results never reach an output.  So each stage runs
``layer_fn`` once per microbatch, in the schedule's order.

Two meshes, one result:

* on a ``HostSimMesh`` every stage runs in this process, on one device:
  between ticks the activations rotate to the next stage as tensors, and
  autograd differentiates the whole schedule, as ``jax.grad`` does JAX's;
* on a ``GroupMesh`` each process is one stage and holds that stage's
  parameters only.  Between ticks each stage sends its activation to the
  next by a send/recv pair (JAX's ``ppermute``, less the ring edge from
  the last stage to the first, which no stage reads), and the last
  stage's outputs are broadcast.  Autograd does not cross processes, so
  the backward is written by hand (``_StageFunction``): the GPipe drain,
  tick by tick in reverse, each stage differentiating the graph it kept of
  each microbatch and sending the gradient of that microbatch's input to
  the stage before.  The parameter gradients sum their microbatches in
  the order autograd sums the host-simulated form's (the last microbatch
  first), so outputs and gradients are bit-equal to it on one device.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.collectives import all_gather_objects
from repro_torch.launch.mesh import GroupMesh, HostSimMesh, axis_sizes
from repro_torch.models.params import leaves, tree_map, unflatten


def make_pipeline_fn(layer_fn: Callable, n_stages: int, n_micro: int,
                     mesh, stage_axis: str = "stage"):
    """Builds ``pipelined(params, xs)``.

    ``layer_fn(params_stage, x) -> x`` is one stage's computation; it keeps
    ``x``'s shape and dtype.  ``xs`` (n_micro, mb, ...) is replicated.
    Returns the last stage's outputs (n_micro, mb, ...), on every process
    of a group (JAX's replicated ``out_specs``).

    On a ``HostSimMesh`` ``params`` is a tree whose leaves have a leading
    dim of ``n_stages``.  On a ``GroupMesh`` whose axis is ``stage_axis``,
    process s is stage s and passes its own stage's tree, leaves with a
    leading dim of 1 (the block JAX's ``in_specs`` give a device).  Every
    process of the group calls the pipeline, and the backward of its
    result, the same number of times in the same order, each with the same
    ``xs`` shape and the same ``requires_grad`` on ``xs`` and on its
    parameters: a forward and a backward are each a schedule of send/recv
    pairs and collectives over the group.  A rank past the mesh (``not
    mesh.holds_partition``) holds no stage and calls neither."""
    if not isinstance(mesh, (HostSimMesh, GroupMesh)):
        raise NotImplementedError(f"a pipeline over {mesh!r}: its stages run "
                                  f"on a HostSimMesh or a GroupMesh")
    if axis_sizes(mesh).get(stage_axis) != n_stages:
        raise ValueError(f"mesh {mesh!r} has no {stage_axis!r} axis of "
                         f"{n_stages} stages")
    if isinstance(mesh, GroupMesh):
        return _StageSchedule(layer_fn, n_stages, n_micro, mesh)

    def pipelined(params, xs):
        if xs.shape[0] != n_micro:
            raise ValueError(f"{xs.shape[0]} microbatches, not {n_micro}")
        stage_params = [tree_map(lambda a, s=s: a[s], params)
                        for s in range(n_stages)]
        state = [None] * n_stages            # each stage's input this tick
        outs = [None] * n_micro
        for t in range(n_stages + n_micro - 1):
            if t < n_micro:
                state[0] = xs[t]
            ys = [layer_fn(stage_params[s], state[s])
                  if state[s] is not None else None
                  for s in range(n_stages)]
            if ys[-1] is not None:
                outs[t - (n_stages - 1)] = ys[-1]
            # rotate the activations to the next stage
            state = [None] + ys[:-1]
        return torch.stack(outs)
    return pipelined


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor (gloo takes no bf16)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.view(like.dtype).reshape(like.shape).to(like.device)


def _plus_zero(t: torch.Tensor) -> torch.Tensor:
    """``t + 0``, in place: the host-simulated form's gradient of a stacked
    leaf sums each slice's gradient with the other slices' zeros, which
    turns a -0.0 into +0.0 and leaves every other value as it is."""
    return t.add_(0.0)


class _StageSchedule:
    """The pipeline as run by stage ``mesh.rank`` of a ``GroupMesh``.

    ``traffic`` lists, for the last call's forward and backward, each
    boundary between ticks at which this stage sent or received:
    ``(pass, tick, bytes sent, bytes received)``, the activation (or its
    gradient) crossing before ``tick``'s work (after it, in the backward's
    reverse order)."""

    def __init__(self, layer_fn, n_stages, n_micro, mesh):
        self.layer_fn, self.n_stages, self.n_micro = layer_fn, n_stages, n_micro
        self.mesh = mesh
        self.traffic = []

    def __call__(self, params, xs):
        mesh = self.mesh
        if not mesh.holds_partition:
            raise RuntimeError(f"rank {mesh.rank} holds no stage of the "
                               f"{self.n_stages}-stage mesh")
        if xs.shape[0] != self.n_micro:
            raise ValueError(f"{xs.shape[0]} microbatches, not {self.n_micro}")
        flat = leaves(params)
        if any(a.shape[:1] != (1,) for a in flat):
            raise ValueError("over a GroupMesh each process passes its own "
                             "stage's parameters: leaves with a leading dim "
                             "of 1")
        self.traffic = []
        return _StageFunction.apply(self, tree_map(lambda a: None, params),
                                    xs, *flat)

    def _micro(self, t: int):
        """The microbatch this stage works on at tick ``t``; None in a
        bubble."""
        m = t - self.mesh.rank
        return m if 0 <= m < self.n_micro else None

    def _shift(self, pass_: str, t: int, send, to: int, recv: bool,
               frm: int, like: torch.Tensor):
        """One boundary between ticks: ``send`` to stage ``to`` and, where
        ``recv``, a tensor like ``like`` from stage ``frm``, as one batch of
        point-to-point ops on ``mesh.comm_device``.  Sender and receiver
        derive both from the schedule, so each send meets its recv."""
        import torch.distributed as dist
        mesh = self.mesh
        ops, box = [], None
        if send is not None:
            out = _bytes(send).to(mesh.comm_device)
            ops.append(dist.P2POp(dist.isend, out, to, mesh.group))
        if recv:
            box = torch.empty(like.numel() * like.element_size(),
                              dtype=torch.uint8, device=mesh.comm_device)
            ops.append(dist.P2POp(dist.irecv, box, frm, mesh.group))
        if not ops:
            return None
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self.traffic.append((pass_, t, 0 if send is None else out.numel(),
                             0 if box is None else box.numel()))
        return None if box is None else _from_bytes(box, like)

    def _broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Stage ``src``'s ``t`` on every stage (each passes a tensor of
        its shape and dtype)."""
        import torch.distributed as dist
        buf = _bytes(t).to(self.mesh.comm_device)
        dist.broadcast(buf, src=src, group=self.mesh.group)
        return t if self.mesh.rank == src else _from_bytes(buf, t)

    def forward(self, tree, xs, flat, need_dx: bool, need_dp):
        S, M, s = self.n_stages, self.n_micro, self.mesh.rank
        grad = need_dx or any(need_dp)
        calls = all_gather_objects(self.mesh, (tuple(xs.shape), str(xs.dtype),
                                               need_dx, grad))
        if any(c != calls[0] for c in calls):
            raise ValueError(f"the stages' calls differ (xs shape and dtype, "
                             f"whether xs and the parameters take "
                             f"gradients): {calls}")
        like = xs[0]
        p = [a.detach().requires_grad_(n) for a, n in zip(flat, need_dp)]
        kept, outs, fault, y_prev = {}, [], None, None
        with torch.set_grad_enabled(grad):
            local = unflatten(tree, [a[0] for a in p])
            for t in range(S + M - 1):
                m = self._micro(t)
                x = self._shift("forward", t, y_prev, s + 1,
                                s > 0 and m is not None, s - 1, like)
                y_prev = None
                if m is None:
                    continue
                if s == 0:
                    x = xs[m].detach()
                x.requires_grad_(grad and (s > 0 or need_dx))
                if fault is None:
                    y = self.layer_fn(local, x)
                    if y.shape != like.shape or y.dtype != like.dtype:
                        fault = (f"stage {s}'s layer_fn turned "
                                 f"{tuple(like.shape)} {like.dtype} into "
                                 f"{tuple(y.shape)} {y.dtype}: a stage keeps "
                                 f"its input's shape and dtype")
                if fault is not None:          # zeros keep the schedule
                    y = torch.zeros_like(like)
                if grad:
                    kept[m] = (x, y)
                if s == S - 1:
                    outs.append(y.detach())
                else:
                    y_prev = y.detach()
        faults = [f for f in all_gather_objects(self.mesh, fault) if f]
        if faults:
            raise ValueError(faults[0])
        out = torch.stack(outs) if s == S - 1 else torch.empty_like(xs)
        return self._broadcast(out, S - 1), (p, kept)

    def backward(self, state, grad_out, need_dx: bool, need_dp):
        S, M, s = self.n_stages, self.n_micro, self.mesh.rank
        p, kept = state
        like = grad_out[0]
        dp = [None] * len(p)
        dxs = [None] * M
        dx_prev = None
        for t in reversed(range(S + M - 1)):
            m = self._micro(t)
            g = self._shift("backward", t, dx_prev, s - 1,
                            s < S - 1 and m is not None, s + 1, like)
            dx_prev = None
            if m is None:
                continue
            x, y = kept.pop(m)
            if s == S - 1:
                g = grad_out[m]        # this process's own copy, used once
            wrt = [x] if x.requires_grad else []
            wrt += [a for a, n in zip(p, need_dp) if n]
            got = list(torch.autograd.grad(y, wrt, g, allow_unused=True))
            if x.requires_grad:
                dx = got.pop(0)
                dx = torch.zeros_like(x) if dx is None else dx
                if s > 0:
                    dx_prev = dx
                else:
                    dxs[m] = dx
            # microbatch M-1 first: the order autograd sums the
            # host-simulated form's uses of a stage's parameters in
            for i in (i for i, n in enumerate(need_dp) if n):
                gi = got.pop(0)
                if gi is not None:
                    dp[i] = gi if dp[i] is None else dp[i].add_(gi)
        if S > 1:
            dp = [g if g is None else _plus_zero(g) for g in dp]
        dx_all = None
        if need_dx:
            dx_all = (torch.stack(dxs) if s == 0
                      else torch.empty_like(grad_out))
            if s == 0 and M > 1:
                _plus_zero(dx_all)
            dx_all = self._broadcast(dx_all, 0)
        return dx_all, dp


class _StageFunction(torch.autograd.Function):
    """One stage's pipeline forward and its hand-written GPipe backward."""

    @staticmethod
    def forward(ctx, schedule, tree, xs, *flat):
        ctx.schedule = schedule
        ctx.need_dx = ctx.needs_input_grad[2]
        ctx.need_dp = ctx.needs_input_grad[3:]
        out, ctx.state = schedule.forward(tree, xs, flat, ctx.need_dx,
                                          ctx.need_dp)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        state, ctx.state = ctx.state, None
        dxs, dp = ctx.schedule.backward(state, grad_out, ctx.need_dx,
                                        ctx.need_dp)
        return (None, None, dxs, *dp)


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    B = x.shape[0]
    assert B % n_micro == 0, (B, n_micro)
    return x.reshape(n_micro, B // n_micro, *x.shape[1:])
