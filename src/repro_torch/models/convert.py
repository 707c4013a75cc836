"""Carry parameters and optimizer state between the JAX package and the
port.

Both packages keep the same trees with the same layouts: the GNN's
``{"layers": [{name: array}]}`` with ``(din, dout)`` weights, and the LM's
nested dicts (``embed.tok``, ``layers.{ln1,ln2}.scale``,
``layers.attn.{wq,wk,wv,wo,q_norm.scale,k_norm.scale}``,
``layers.mlp.{w_gate,w_up,w_down}``, ``ln_f.scale``) stacked on a leading
layer axis.  So the mapping is by name and nothing is transposed.  The
PPO agent's nets (``core/autotune/ppo.py``) keep JAX's lists of
``{"w": (in, out), "b": (out,)}`` layers as ``MLP`` modules of the same
layout.  The JAX side is handed over as numpy arrays (``np.asarray`` of
each leaf); this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.autotune.ppo import MLP
from repro_torch.models.params import tree_map


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
