"""GPipe-style pipeline parallelism over the host-simulated mesh.

A port of ``src/repro/distributed/pp.py``: the layer stack is split into
S stages over a ``stage`` mesh axis, and microbatches flow through the
GPipe schedule of S + M − 1 ticks.  At tick t stage 0 takes in microbatch
t, stage s works on microbatch t − s, and the last stage emits microbatch
t − (S − 1).  Between ticks the activations rotate to the next stage on
the host (every stage on one device), where JAX's stages pass them with
``ppermute``.  A slot of the schedule with no microbatch (the pipeline's
fill and drain bubbles) computes nothing: JAX's stages run their layers on
zeros there, whose results never reach an output.  So each stage runs
``layer_fn`` once per microbatch, in the schedule's order.  The result is
differentiable through autograd, as JAX's is through ``jax.grad``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch.mesh import GROUP_TODO, HostSimMesh, axis_sizes
from repro_torch.models.params import tree_map


def make_pipeline_fn(layer_fn: Callable, n_stages: int, n_micro: int,
                     mesh, stage_axis: str = "stage"):
    """Builds ``pipelined(stacked_params, xs)``.

    ``layer_fn(params_stage, x) -> x`` is one stage's computation;
    ``stacked_params`` is a tree whose leaves have a leading dim of
    ``n_stages``; ``xs`` (n_micro, mb, ...).  Returns the last stage's
    outputs (n_micro, mb, ...)."""
    if not isinstance(mesh, HostSimMesh):
        raise NotImplementedError(f"a pipeline over {mesh!r}: stages in "
                                  f"processes are {GROUP_TODO}")
    if axis_sizes(mesh).get(stage_axis) != n_stages:
        raise ValueError(f"mesh {mesh!r} has no {stage_axis!r} axis of "
                         f"{n_stages} stages")

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


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    B = x.shape[0]
    assert B % n_micro == 0, (B, n_micro)
    return x.reshape(n_micro, B // n_micro, *x.shape[1:])
