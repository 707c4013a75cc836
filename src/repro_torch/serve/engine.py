"""Batched decode engine (continuous batching) for every LM family: dense,
MoE, VLM, SSM, hybrid and encoder-decoder.

A port of ``src/repro/serve/engine.py``: per-request prefill into a free
cache slot, then one decode step per iteration for the whole batch;
finished requests free their slot and waiting prompts join.  The cache
tree is the model's (``Model.cache_decls``): KV caches, for the SSM
and hybrid families the f32 ``ssm`` states and the ``conv`` buffers, and
for the encoder-decoder the cross-attention ``xk`` / ``xv``, carried as
they are.  As in JAX, the engine never runs the encoder: a served
encoder-decoder request attends to the zero cross caches
``cache_decls`` makes.  An M-RoPE model's decode step gets each slot's
position on all three streams, ``positions (3, B, 1)``.  As in JAX, a
released slot's ``ssm`` / ``conv`` state is not reset when a new request
takes the slot, and while the slot is free every decode step still
advances it (a step runs the whole batch).  Greedy or temperature
sampling; temperature draws come from numpy's
``default_rng(seed)`` on the host, the stream the JAX engine draws from.

Prefill is sequential, as in JAX: the prompt is fed through the decode step
one token at a time.  The block prefill (``Model.prefill``, whose attention
runs the ``flash_attention`` kernel) is the engine's oracle: the first
greedy token equals the argmax of its logits (for MoE only where the block
prefill drops no token past an expert's capacity; not for the
encoder-decoder, whose block prefill encodes audio the engine never sees).

Parameters are f32 masters; the engine makes one compute-dtype copy at
construction (``models.api.compute_params``): the values JAX's
``.astype(x.dtype)`` gives at each use, without casting every weight on
every step.  Both engines are ``serve/common.py`` ``ServingEngine``s.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.models.api import build, compute_params
from repro_torch.models.params import init_params
from repro_torch.serve.common import EngineBase, admit_pending
from repro_torch.serve.kv_cache import KVCacheManager


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stop early
    out_tokens: List[int] = field(default_factory=list)
    status: str = "pending"            # pending | done | shed
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine(EngineBase):
    """``params``: the f32 master tree, or None to draw one from
    ``torch.Generator(device).manual_seed(seed)`` on ``device``."""

    def __init__(self, cfg, params=None, batch: int = 8, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0,
                 keep_completed: int = 4096, device="cuda"):
        self.cfg = cfg
        self.model = build(cfg)
        self.max_len = max_len
        self.temperature = temperature
        self.device = torch.device(device)
        self.params = params if params is not None else init_params(
            self.model.decls,
            torch.Generator(device=self.device).manual_seed(seed),
            self.device)
        self._cparams = compute_params(self.params, cfg)
        caches = init_params(self.model.cache_decls(batch, max_len),
                             torch.Generator(), self.device)
        self.kv = KVCacheManager(caches, batch, max_len)
        self._rng = np.random.default_rng(seed)
        self._init_serving(batch, keep_completed)
        self.running: Dict[int, Request] = {}   # slot -> request
        self._tokens = np.zeros(batch, np.int32)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _decode(self, batch):
        return self.model.decode(self._cparams, self.kv.caches, batch)

    def _prefill_into_slot(self, req: Request, slot: int):
        """Sequential decode-based prefill: feeds prompt tokens one at a time
        through the decode path."""
        for i, tok in enumerate(req.prompt[:-1]):
            batch = self._make_batch(slot_tokens={slot: int(tok)},
                                     slot_pos={slot: i})
            _, self.kv.caches = self._decode(batch)
        self._tokens[slot] = int(req.prompt[-1])
        self.kv.slots[slot].length = len(req.prompt) - 1

    def _make_batch(self, slot_tokens: Dict[int, int],
                    slot_pos: Dict[int, int]):
        toks = self._tokens.copy()
        pos = self.kv.positions()
        for s, t in slot_tokens.items():
            toks[s] = t
        for s, p in slot_pos.items():
            pos[s] = p
        batch = {"token": torch.from_numpy(toks).to(self.device),
                 "pos": torch.from_numpy(pos).to(self.device)}
        if self.cfg.mrope_sections:
            batch["positions"] = batch["pos"][None, :, None].expand(
                3, self.batch, 1)
        return batch

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: admit, decode, sample, retire."""
        admit_pending(self.pending, self.running,
                      lambda r: self.kv.allocate(r.rid, len(r.prompt)),
                      self._prefill_into_slot)
        if not self.running:
            return 0

        logits, self.kv.caches = self._decode(self._make_batch({}, {}))
        logits = logits.cpu().numpy()
        n_emitted = 0
        for slot in list(self.running):
            req = self.running[slot]
            lg = logits[slot]
            if self.temperature > 0:
                p = np.exp((lg - lg.max()) / self.temperature)
                p /= p.sum()
                tok = int(self._rng.choice(len(p), p=p))
            else:
                tok = int(np.argmax(lg))
            if not req.out_tokens:
                req.t_first = time.perf_counter()
            req.out_tokens.append(tok)
            self._tokens[slot] = tok
            self.kv.advance(slot)
            n_emitted += 1
            done = (len(req.out_tokens) >= req.max_new_tokens
                    or tok == req.eos_id
                    or self.kv.slots[slot].length >= self.max_len - 1)
            if done:
                req.t_done = time.perf_counter()
                self.kv.release(slot)
                del self.running[slot]
                self._retire(req)
        return n_emitted

    # ------------------------------------------------------------------
    def _window_metrics(self, mark: Dict, emitted: int, done: int,
                        dt: float) -> Dict[str, float]:
        return {"tokens": emitted,
                "tokens_per_s": emitted / dt if dt else 0.0}
