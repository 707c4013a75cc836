"""Carry parameters and optimizer state between the JAX package and the
port.

Both packages keep the same trees with the same layouts: the GNN's
``{"layers": [{name: array}]}`` with ``(din, dout)`` weights, and the LM's
nested dicts (``embed.tok``, ``layers.{ln1,ln2}.scale``,
``layers.attn.{wq,wk,wv,wo,q_norm.scale,k_norm.scale}``,
``layers.mlp.{w_gate,w_up,w_down}``, ``ln_f.scale``; MoE layers'
``layers.moe.{router,w_gate,w_up,w_down,shared.{w_gate,w_up,w_down}}``;
the SSM LM's ``layers.{ln,block.*}`` with ``block.{in_proj,conv_w,conv_b,
A_log,D,dt_bias,norm.scale,out_proj}``; the hybrid's ``mamba.{ln,block.*}``
and its one ``shared.{ln1,attn.*,ln2,mlp.*}``; the encoder-decoder's
``pos_enc``, ``pos_dec``, ``encoder.{ln1,attn.*,ln2,mlp.*}``,
``decoder.{ln1,attn.*,ln_x,xattn.*,ln2,mlp.*}``, ``ln_enc`` and ``ln_f``,
each LayerNorm a ``{scale,bias}``, its MLPs ``{w_up,w_down}`` (GELU); a
no-RoPE LM's ``pos_emb``) stacked on a leading layer axis.  So the
mapping is by name and nothing is transposed.  The
PPO agent's nets (``core/autotune/ppo.py``) keep JAX's lists of
``{"w": (in, out), "b": (out,)}`` layers as ``MLP`` modules of the same
layout.  The JAX side is handed over as numpy arrays (``np.asarray`` of
each leaf); this module never imports JAX.

``distribute_params`` places such a tree of full tensors as DTensors for
the sharded LM step, so that the sharded and the unsharded step start
from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.autotune.ppo import MLP
from repro_torch.models.params import leaves, tree_map, unflatten


def params_from_jax(tree, device="cuda"):
    """A tree of dicts and lists of array-likes → the same tree of the
    port's tensors on ``device``, in each array's own dtype."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def params_to_numpy(params):
    """The port's parameters → the same tree of ``np.ndarray``, the form
    the JAX package's functions accept."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def opt_state_from_jax(state, device="cuda"):
    """A JAX AdamW state ``{"m", "v", "count"}`` (array-likes) → the port's:
    ``m`` and ``v`` as tensors on ``device``, ``count`` (an int32 0-d array
    there) as the Python ``int`` the port's optimizer keeps."""
    return {"m": params_from_jax(state["m"], device),
            "v": params_from_jax(state["v"], device),
            "count": int(np.asarray(state["count"]))}


def ppo_params_from_jax(pi, log_std, vf, device="cuda"):
    """A JAX ``PPOAgent``'s ``pi`` and ``vf`` (lists of ``{"w", "b"}``) and
    ``log_std``, as array-likes → the port's policy ``MLP``, ``log_std``
    parameter and value ``MLP`` on ``device``."""
    def mlp(layers):
        return MLP([(torch.from_numpy(np.array(p["w"])),
                     torch.from_numpy(np.array(p["b"]))) for p in layers]
                   ).to(device)
    return (mlp(pi), nn.Parameter(torch.from_numpy(np.array(log_std))
                                  .to(device)), mlp(vf))


def local_shard(t, placements, device_mesh):
    """This rank's shard of the full tensor ``t`` laid out by
    ``placements``: ``t`` cut along each sharded dim, mesh dim by mesh dim
    in order (so ``("pod", "data")`` on one dim cuts by pod, then by data
    within it), each rank taking its coordinate's piece, contiguous and in
    a storage of its own (a piece that viewed ``t`` would keep the whole
    of ``t`` allocated)."""
    coord = device_mesh.get_coordinate()
    for j, pl in enumerate(placements):
        if pl.is_shard():
            t = t.chunk(device_mesh.size(j), dim=pl.dim)[coord[j]]
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        return t.clone(memory_format=torch.contiguous_format)
    return t.contiguous()


def distribute_params(params, model, cfg, device_mesh, decls=None):
    """A tree of full tensors (every rank holding the same values, e.g.
    converted JAX parameters) → the same tree of DTensors over
    ``device_mesh``, each leaf placed by ``physical_specs`` of its
    declaration (``decls``, ``model.decls`` by default: pass
    ``opt.state_decls(model.decls)``'s subtree for optimizer state).  Each
    rank keeps its own shard, cut locally: nothing is sent."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import physical_specs, placements
    specs = leaves(physical_specs(model.decls if decls is None else decls,
                                  cfg, device_mesh))
    flat = leaves(params)
    if len(specs) != len(flat):
        raise ValueError(f"{len(flat)} leaves for {len(specs)} declarations")
    out = []
    for t, spec in zip(flat, specs):
        pl = placements(spec, device_mesh)
        out.append(DTensor.from_local(
            local_shard(t, pl, device_mesh), device_mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride()))
    return unflatten(params, out)
