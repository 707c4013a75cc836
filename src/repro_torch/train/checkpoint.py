"""Atomic, async checkpointing of parameter trees, in the JAX package's
on-disk format.

Layout per step::

    <dir>/step_000123/
        MANIFEST.json     step, extra, and the shape and dtype of each leaf
        shard_<host>.npz  the leaves, keyed ``group__path__to__leaf``
        _COMMITTED        written last — restore ignores uncommitted dirs

The keys and the manifest are those of ``repro.train.checkpoint``: a leaf's
name joins its dict keys (sorted, as the trees are flattened) and list
indices with ``/``, and ``/`` becomes ``__`` in the npz.  So a checkpoint
either package wrote restores in the other.  A Python ``int`` leaf (the
AdamW step ``count``) is written as a 0-d ``int32`` array, as the JAX
package keeps it, and a template's ``int`` leaf is given back as an
``int``.

  * atomic commit (tmp dir + rename + commit marker) — a preempted writer
    never corrupts the latest checkpoint
  * keep-k garbage collection
  * async save (background thread; tensors are copied to host numpy
    before the thread starts, so a later step cannot race the writer)

The JAX package's elastic ``shardings`` argument (re-placing leaves onto a
different device mesh) has no meaning on one card and is not taken:
``restore`` puts each leaf on its template leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten_with_names(tree, prefix: str = ""):
    """``[(name, leaf)]`` in ``jax.tree`` order: dict keys sorted, lists in
    order, ``None`` an empty subtree; names join the path with ``/``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_names(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(tree, flat):
    """Rebuild ``tree``'s structure from ``flat`` (``_flatten_with_names``
    order); tuples become lists, as ``models.params.tree_map`` makes them."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` as numpy, independent of the live state."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = True, host_id: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.host_id = host_id
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None):
        """state: {"params": ..., "opt_state": ...} (trees of tensors)."""
        # snapshot to host (so a later in-place update cannot race the writer)
        host_state = {group: [(name, _to_host(leaf)) for name, leaf in
                              _flatten_with_names(tree)]
                      for group, tree in state.items()}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state, extra), daemon=True)
            self._thread.start()
        else:
            # synchronous save: surface writer errors immediately instead of
            # parking them for a wait() that may never come
            self._write(step, host_state, extra)
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def _write(self, step: int, host_state, extra):
        try:
            final = self.dir / f"step_{step:09d}"
            tmp = self.dir / f".tmp_step_{step:09d}"
            # the target dir may not exist yet on first save (or may have
            # been removed between construction and save)
            self.dir.mkdir(parents=True, exist_ok=True)
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "extra": extra or {}, "leaves": {},
                        "time": time.time()}
            arrays = {}
            for group, named in host_state.items():
                for name, leaf in named:
                    key = f"{group}/{name}"
                    arrays[key.replace('/', '__')] = leaf
                    manifest["leaves"][key] = {"shape": list(leaf.shape),
                                               "dtype": str(leaf.dtype)}
            np.savez(tmp / f"shard_{self.host_id}.npz", **arrays)
            (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
            (tmp / "_COMMITTED").write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "_COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Manifest of a committed step (tree metadata + the ``extra`` dict
        the writer attached — e.g. partition topology and cache accounting
        for the multi-partition GNN restore path)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        return json.loads(
            (self.dir / f"step_{step:09d}" / "MANIFEST.json").read_text())

    # ------------------------------------------------------------------
    def restore(self, template: Dict[str, Any], step: Optional[int] = None
                ) -> Tuple[Dict[str, Any], int]:
        """Restore into the structure of ``template``: each tensor leaf comes
        back in the checkpoint's dtype on the template leaf's device, each
        ``int`` leaf as an ``int``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        data = {}
        for shard in sorted(d.glob("shard_*.npz")):
            with np.load(shard) as z:
                for k in z.files:
                    data[k] = z[k]

        out = {}
        for group, tree in template.items():
            leaves = []
            for name, leaf in _flatten_with_names(tree):
                key = f"{group}/{name}".replace("/", "__")
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {group}/{name}")
                arr = data[key]
                want_shape = tuple(np.shape(leaf))
                if tuple(arr.shape) != want_shape:
                    raise ValueError(f"shape mismatch for {group}/{name}: "
                                     f"ckpt {arr.shape} vs target {want_shape}")
                if isinstance(leaf, torch.Tensor):
                    leaves.append(torch.from_numpy(arr).to(leaf.device))
                elif isinstance(leaf, int):
                    leaves.append(int(arr))
                else:
                    leaves.append(arr)
            out[group] = _unflatten(tree, leaves)
        return out, step


class GroupCheckpointManager(CheckpointManager):
    """One checkpoint directory shared by the processes of a ``GroupMesh``
    (launch/mesh.py): rank 0 writes each step, synchronously, and every
    rank of the mesh then waits at a barrier over the mesh's group, so
    each step is committed before any rank goes on and every rank reads
    the same steps.  ``save`` is a collective of the mesh: every rank
    calls it (only rank 0's ``state`` is read).  The auto-tuner's
    ``partitions`` restart gives it the world (``GroupMesh.world``), so
    ranks that hold no partition wait for the commit too."""

    def __init__(self, directory: str | Path, mesh, keep: int = 3):
        super().__init__(directory, keep=keep, async_save=False)
        self.mesh = mesh

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict] = None):
        from repro_torch.distributed.collectives import barrier
        if self.mesh.rank == 0:
            super().save(step, state, extra)
        barrier(self.mesh)


class TrainerCheckpointMixin:
    """Shared checkpoint/restore contract for the GNN trainers (single- and
    multi-partition, core/a3gnn.py and core/multipart.py).

    Expects ``self.params``, ``self.opt_state`` and ``self.cfg.partitions``;
    subclasses extend ``checkpoint_extra`` (manifest payload) and
    ``_after_restore`` (e.g. cache hit-accounting).  A checkpoint written
    under a different partition count is REJECTED unless the caller
    explicitly acknowledges the migration (``expect_partitions`` = the
    saved count — the autotune restart path does exactly that after
    rebuilding the trainer)."""

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params, "opt_state": self.opt_state}

    def load_state_dict(self, state: Dict[str, Any]):
        self.params = state["params"]
        self.opt_state = state["opt_state"]

    def checkpoint_extra(self) -> Dict[str, Any]:
        return {"partitions": int(self.cfg.partitions),
                "global_steps": int(getattr(self, "global_steps", 0))}

    def save(self, ckpt: "CheckpointManager", step: Optional[int] = None):
        ckpt.save(step if step is not None
                  else int(getattr(self, "global_steps", 0)),
                  self.state_dict(), extra=self.checkpoint_extra())

    def restore(self, ckpt: "CheckpointManager", step: Optional[int] = None,
                expect_partitions: Optional[int] = None) -> int:
        step = step if step is not None else ckpt.latest_step()
        extra = ckpt.read_manifest(step).get("extra") or {}
        saved_parts = extra.get("partitions")
        want = (expect_partitions if expect_partitions is not None
                else int(self.cfg.partitions))
        if saved_parts is not None and int(saved_parts) != int(want):
            raise ValueError(
                f"checkpoint step {step} was written with "
                f"partitions={saved_parts}, but this trainer runs "
                f"partitions={self.cfg.partitions}; rebuild the trainer "
                f"with partitions={saved_parts}, or pass "
                f"expect_partitions={saved_parts} to migrate through the "
                f"restart path (checkpoint → rebuild → restore)")
        state, step = ckpt.restore(self.state_dict(), step)
        self.load_state_dict(state)
        self._after_restore(extra, step)
        return step

    def _after_restore(self, extra: Dict[str, Any], step: int):
        pass
