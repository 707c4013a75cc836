"""Graph storage: CSR adjacency + node feature store (host DRAM).

The host-resident graph mirrors the paper's CPU-side data: adjacency in CSR,
features in a dense row store, labels + split masks for node classification.
Degree ("hotness") statistics drive the static cache policy (PaGraph-style).
``FeatureStore`` is the streaming write path over that row store: versioned
row updates fanned out to every derived copy (caches, device mirrors, halo
rows) so trainers and the serving engine observe feature drift coherently.

DYNAMIC TOPOLOGY (delta-CSR overlay): production graphs gain and lose
edges continuously, and the paper's CPU-side preprocessing is exactly the
path that must NOT be re-run per edge (HitGNN's scalability bottleneck).
``Graph.add_edges`` / ``Graph.remove_edges`` record mutations in a
``DeltaOverlay`` next to the frozen base CSR; every adjacency consumer
(``neighbors``, ``degrees``, ``subgraph``, the ``core/sampling.py``
samplers, the partitioner's cut scan) reads through ``Graph.adj()`` — the
merged base+overlay view, memoized per ``topology_version`` so the merge
costs one O(E) pass per mutation batch, not one per sample.  A periodic
``compact()`` folds the overlay into the base CSR WITHOUT changing
``topology_version`` — compaction is a layout change, not a topology
change, which is what makes "sampling over base+overlay is bit-exact with
sampling over the compacted CSR at the same seed and version" a testable
invariant (tests/test_dynamic_graph.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


class DeltaOverlay:
    """Pending edge mutations over a frozen base CSR (delta-CSR).

    Semantics are SET-like per directed edge ``(src, dst)``: inserting an
    edge that is already live (in the kept base or the overlay) is a no-op
    (duplicate-edge insert), and removing one deletes every live copy —
    so a double-delete is idempotent.  Base-edge removals are a boolean
    ``kept`` mask over the base ``indices`` array; insertions append to a
    per-source list in arrival order.  The merged per-row neighbor order
    is therefore *kept base order, then insertion order* — the one
    ordering contract ``Graph.adj()``, ``Graph.compact()`` and the
    differential reference model in tests/test_dynamic_graph.py all
    share (neighbor order feeds the sampler's rng stream, so the order IS
    the bit-exactness contract)."""

    def __init__(self, num_base_edges: int):
        self.kept: Optional[np.ndarray] = None   # lazy (E_base,) bool
        self.added: dict = {}                    # src -> [dst, ...] arrival order
        self.added_set: set = set()              # {(src, dst)} live overlay edges
        self.n_removed_base = 0                  # base copies masked out
        self._num_base_edges = num_base_edges

    @property
    def n_added(self) -> int:
        return len(self.added_set)

    @property
    def empty(self) -> bool:
        return not self.added_set and self.n_removed_base == 0

    def ensure_kept(self) -> np.ndarray:
        if self.kept is None:
            self.kept = np.ones(self._num_base_edges, bool)
        return self.kept


@dataclass
class Graph:
    indptr: np.ndarray          # (N+1,) int64 — BASE CSR (frozen between compactions)
    indices: np.ndarray         # (E,) int32 — neighbor lists, CSR
    features: np.ndarray        # (N, F) float32
    labels: np.ndarray          # (N,) int32
    train_mask: np.ndarray      # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    name: str = "graph"
    # dynamic topology: monotone version (bumps once per mutating
    # add_edges/remove_edges call that changed the edge set; compact()
    # preserves it) + the pending delta overlay and the memoized merged view
    topology_version: int = 0
    _overlay: Optional[DeltaOverlay] = field(default=None, repr=False,
                                             compare=False)
    _adj_cache: Optional[Tuple[np.ndarray, np.ndarray]] = field(
        default=None, repr=False, compare=False)
    _adj_cache_version: int = field(default=-1, repr=False, compare=False)

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        ov = self._overlay
        if ov is None or ov.empty:
            return len(self.indices)
        return len(self.indices) - ov.n_removed_base + ov.n_added

    @property
    def feat_dim(self) -> int:
        return self.features.shape[1]

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1

    def density(self) -> float:
        n = self.num_nodes
        return self.num_edges / max(n * (n - 1), 1)

    def avg_degree(self) -> float:
        return self.num_edges / max(self.num_nodes, 1)

    def degrees(self) -> np.ndarray:
        return np.diff(self.adj()[0]).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        indptr, indices = self.adj()
        return indices[indptr[v]:indptr[v + 1]]

    # ------------------------------------------------------------------
    # dynamic topology: delta-CSR overlay (add/remove/compact + merged view)
    # ------------------------------------------------------------------
    @property
    def has_overlay(self) -> bool:
        """True when uncompacted mutations are pending."""
        return self._overlay is not None and not self._overlay.empty

    def adj(self) -> Tuple[np.ndarray, np.ndarray]:
        """The CURRENT adjacency as ``(indptr, indices)`` — the base CSR
        when no mutations are pending, otherwise the merged base+overlay
        view.  This is THE read every adjacency consumer goes through
        (samplers, partitioner, ``subgraph``), so a mutation is visible to
        the very next sample.  The merge is memoized per
        ``topology_version``: one O(E) pass per mutation batch, amortized
        across every sample drawn at that version.  Callers must treat
        the returned arrays as read-only."""
        ov = self._overlay
        if ov is None or ov.empty:
            return self.indptr, self.indices
        if (self._adj_cache is not None
                and self._adj_cache_version == self.topology_version):
            return self._adj_cache
        self._adj_cache = self._merge_overlay(ov)
        self._adj_cache_version = self.topology_version
        return self._adj_cache

    def _merge_overlay(self, ov: DeltaOverlay):
        """Materialize the merged view: per row, kept base neighbors (in
        base order) followed by overlay insertions (in arrival order)."""
        n = self.num_nodes
        if ov.kept is not None and ov.n_removed_base:
            keep = ov.kept
            cum = np.zeros(len(self.indices) + 1, np.int64)
            np.cumsum(keep, out=cum[1:])
            kept_counts = cum[self.indptr[1:]] - cum[self.indptr[:-1]]
            kept_indices = self.indices[keep]
        else:
            kept_counts = np.diff(self.indptr)
            kept_indices = self.indices
        add_counts = np.zeros(n, np.int64)
        for u, lst in ov.added.items():
            add_counts[u] = len(lst)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(kept_counts + add_counts, out=indptr[1:])
        indices = np.empty(int(indptr[-1]), np.int32)
        if len(kept_indices):
            # kept base edges land at the head of their merged row: global
            # row-major order is preserved, so destinations are one
            # vectorized scatter
            starts = np.cumsum(kept_counts) - kept_counts
            dest = (np.repeat(indptr[:-1] - starts, kept_counts)
                    + np.arange(len(kept_indices)))
            indices[dest] = kept_indices
        for u, lst in ov.added.items():
            at = indptr[u] + kept_counts[u]
            indices[at:at + len(lst)] = lst
        return indptr, indices

    def _check_endpoints(self, src: np.ndarray, dst: np.ndarray):
        if len(src) != len(dst):
            raise ValueError(f"src/dst length mismatch: {len(src)} vs "
                             f"{len(dst)}")
        for arr in (src, dst):
            if len(arr) and (arr.min() < 0 or arr.max() >= self.num_nodes):
                raise ValueError(f"edge endpoint outside [0, "
                                 f"{self.num_nodes})")

    def _base_live_positions(self, u: int, v: int) -> np.ndarray:
        """Base ``indices`` positions of live (kept) copies of u→v."""
        s, e = int(self.indptr[u]), int(self.indptr[u + 1])
        pos = s + np.where(self.indices[s:e] == v)[0]
        ov = self._overlay
        if ov is not None and ov.kept is not None and len(pos):
            pos = pos[ov.kept[pos]]
        return pos

    def add_edges(self, src, dst) -> int:
        """Insert directed edges ``src[i] → dst[i]`` into the overlay.
        Pairs already live (kept base copy or earlier insertion) are
        no-ops — duplicate-edge insert never creates a parallel edge.
        Returns the number actually added; bumps ``topology_version``
        once iff that number is > 0."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        self._check_endpoints(src, dst)
        if self._overlay is None:
            self._overlay = DeltaOverlay(len(self.indices))
        ov = self._overlay
        added = 0
        for u, v in zip(src.tolist(), dst.tolist()):
            if (u, v) in ov.added_set or len(self._base_live_positions(u, v)):
                continue
            ov.added.setdefault(u, []).append(v)
            ov.added_set.add((u, v))
            added += 1
        if added:
            self.topology_version += 1
        return added

    def remove_edges(self, src, dst) -> int:
        """Delete directed edges ``src[i] → dst[i]`` — every live copy
        (base AND overlay).  Absent pairs are no-ops, so a double-delete
        is idempotent.  Returns the number of pairs that had a live copy;
        bumps ``topology_version`` once iff that number is > 0."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        self._check_endpoints(src, dst)
        if self._overlay is None:
            self._overlay = DeltaOverlay(len(self.indices))
        ov = self._overlay
        removed = 0
        for u, v in zip(src.tolist(), dst.tolist()):
            hit = False
            if (u, v) in ov.added_set:
                ov.added_set.remove((u, v))
                ov.added[u].remove(v)
                if not ov.added[u]:
                    del ov.added[u]
                hit = True
            pos = self._base_live_positions(u, v)
            if len(pos):
                ov.ensure_kept()[pos] = False
                ov.n_removed_base += len(pos)
                hit = True
            removed += int(hit)
        if removed:
            self.topology_version += 1
        return removed

    def compact(self) -> int:
        """Fold the overlay into the base CSR.  The merged view BECOMES
        the base (same per-row neighbor order, so sampling at the same
        seed is bit-exact across the fold — the tested invariant), the
        overlay resets, and ``topology_version`` is UNCHANGED: compaction
        re-lays-out the same topology.  Returns the number of folded
        mutations (0 when nothing was pending)."""
        ov = self._overlay
        if ov is None or ov.empty:
            self._overlay = None
            return 0
        folded = ov.n_added + ov.n_removed_base
        indptr, indices = self.adj()
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self._overlay = None
        self._adj_cache = None
        self._adj_cache_version = -1
        return folded

    def hotness_order(self) -> np.ndarray:
        """Node ids sorted by descending out-degree (PaGraph hotness)."""
        return np.argsort(-self.degrees(), kind="stable").astype(np.int32)

    def subgraph(self, nodes: np.ndarray,
                 feature_leaves: np.ndarray = None) -> "Graph":
        """Induced subgraph with LOCAL ids 0..len(nodes)-1 (partitioning).

        ``feature_leaves``: optional extra nodes appended AFTER ``nodes``
        as feature-only leaves — reachable through ``nodes``' out-edges
        but with empty local adjacency, zeroed feature rows (their
        features are owned elsewhere; graph/partition.py fills them
        through the halo exchange) and all-False split masks.  With no
        leaves the result is bit-identical to the plain induced subgraph."""
        nodes = np.asarray(nodes, dtype=np.int32)
        leaves = (np.asarray(feature_leaves, dtype=np.int32)
                  if feature_leaves is not None else np.zeros(0, np.int32))
        aug = np.concatenate([nodes, leaves]) if len(leaves) else nodes
        remap = -np.ones(self.num_nodes, dtype=np.int32)
        remap[aug] = np.arange(len(aug), dtype=np.int32)
        if len(leaves) and (remap[nodes] != np.arange(len(nodes))).any():
            # a leaf id that is also owned would hijack the owned node's
            # local id, silently rerouting its edges to an empty leaf row
            raise ValueError("feature_leaves must be disjoint from nodes")
        indptr = [0]
        idx_out = []
        for v in nodes:
            nb = remap[self.neighbors(v)]
            nb = nb[nb >= 0]
            idx_out.append(nb)
            indptr.append(indptr[-1] + len(nb))
        if len(leaves):
            indptr.extend([indptr[-1]] * len(leaves))
            features = np.zeros((len(aug), self.feat_dim), np.float32)
            features[:len(nodes)] = self.features[nodes]
            off = np.zeros(len(leaves), bool)
            masks = [np.concatenate([m[nodes], off]) for m in
                     (self.train_mask, self.val_mask, self.test_mask)]
            name = f"{self.name}-sub{len(nodes)}+h{len(leaves)}"
        else:
            features = self.features[nodes]
            masks = [self.train_mask[nodes], self.val_mask[nodes],
                     self.test_mask[nodes]]
            name = f"{self.name}-sub{len(nodes)}"
        return Graph(
            indptr=np.asarray(indptr, np.int64),
            indices=(np.concatenate(idx_out) if idx_out else
                     np.zeros(0, np.int32)).astype(np.int32),
            features=features,
            labels=self.labels[aug],
            train_mask=masks[0],
            val_mask=masks[1],
            test_mask=masks[2],
            name=name,
        )

    def memory_bytes(self) -> int:
        return (self.indptr.nbytes + self.indices.nbytes
                + self.features.nbytes + self.labels.nbytes)


class FeatureStore:
    """Streaming mutation path for the host feature row store.

    ``Graph.features`` is the single source of truth for node features;
    every derived copy — cache-resident rows (``core/cache.py``), device
    mirrors (``core/feature_plane.py``), halo rows on other partitions
    (``core/multipart.py``) — must observe a row update or training and
    serving silently drift apart.  ``FeatureStore`` wraps one graph's
    store with a monotonic ``version`` and a subscriber fan-out so a
    single ``update_rows`` call reaches every consumer:

      * a ``FeaturePlane`` subscribes its ``fill_rows`` (via
        ``FeaturePlane.subscribe_to``) — cache-resident copies update and
        the device mirror invalidates through ``FeatureCache.version``;
      * ``MultiPartitionTrainer.attach_feature_store`` subscribes a
        global→local remap that routes owned rows into the owning
        partition's plane and marks stale halo copies for the bounded
        periodic re-fill.

    Subscribers receive ``(ids, rows)`` with GLOBAL node ids; the store
    writes ``graph.features`` first, so a subscriber may re-read the
    store instead of using ``rows``.
    """

    def __init__(self, graph: Graph):
        self.graph = graph
        self.version = 0                 # bumps once per update_rows call
        self.rows_updated = 0            # cumulative streamed row count
        self._subscribers = []

    def subscribe(self, fn):
        """Register ``fn(ids, rows)`` to run after every ``update_rows``."""
        self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn):
        """Drop a subscriber (no-op if absent) — consumers being replaced
        (a trainer rebuilt by the autotune ``partitions`` restart, a plane
        swapped by ``Pipeline.reconfigure``) MUST detach, or updates keep
        routing into the dead object while its replacement drifts."""
        if fn in self._subscribers:
            self._subscribers.remove(fn)

    def update_rows(self, ids: np.ndarray, rows: np.ndarray) -> int:
        """Overwrite feature rows ``ids`` (global) with ``rows`` and fan
        the update out to every subscriber.  Returns the new version."""
        ids = np.asarray(ids, dtype=np.int64)
        rows = np.asarray(rows, dtype=np.float32)
        if rows.shape != (len(ids), self.graph.feat_dim):
            raise ValueError(f"update_rows: rows shape {rows.shape} != "
                             f"({len(ids)}, {self.graph.feat_dim})")
        self.graph.features[ids] = rows
        self.version += 1
        self.rows_updated += len(ids)
        for fn in list(self._subscribers):
            # a subscriber may detach another (or itself) mid-fanout — e.g.
            # a plane being torn down by the trainer callback running just
            # before it; delivering to the detached one would write into a
            # dead object (tests/test_streaming.py covers this)
            if fn in self._subscribers:
                fn(ids, rows)
        return self.version


class FeatureStreamConsumer:
    """Attach/detach scaffolding for trainers subscribing a
    ``_on_feature_update(ids, rows)`` callback to a ``FeatureStore``.

    Both trainer kinds (core/a3gnn.py, core/multipart.py) mix this in;
    the autotune ``partitions`` restart path migrates the subscription
    between them and relies on the two staying behaviorally identical,
    so the skeleton lives ONCE, here.  Subclasses implement
    ``_on_feature_update`` and may override ``_check_feature_store_target``
    to reject unroutable topologies."""

    feature_store: "FeatureStore" = None

    def _check_feature_store_target(self):
        pass

    def attach_feature_store(self, store: "FeatureStore" = None
                             ) -> "FeatureStore":
        """Subscribe this consumer to ``store`` (default: a fresh store
        over the trainer's full graph).  Any previous subscription is
        detached first — a consumer tracks at most one store, so a
        re-attach can never leak an unreachable subscription on the old
        one.  Returns the store."""
        self._check_feature_store_target()
        self.detach_feature_store()
        if store is None:
            store = FeatureStore(self.full_graph)
        store.subscribe(self._on_feature_update)
        self.feature_store = store
        return store

    def detach_feature_store(self):
        """Unsubscribe (a replaced trainer — e.g. the autotune
        ``partitions`` restart — must detach, or updates keep routing
        into the dead object); the store itself lives on."""
        if self.feature_store is not None:
            self.feature_store.unsubscribe(self._on_feature_update)
            self.feature_store = None


def from_edges(num_nodes: int, src: np.ndarray, dst: np.ndarray,
               features: np.ndarray, labels: np.ndarray,
               train_frac=0.66, val_frac=0.1, seed=0,
               name="graph") -> Graph:
    """Build CSR (out-edges src→dst) + random split masks."""
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    rng = np.random.default_rng(seed)
    r = rng.random(num_nodes)
    train = r < train_frac
    val = (r >= train_frac) & (r < train_frac + val_frac)
    test = ~train & ~val
    return Graph(indptr, dst.astype(np.int32), features.astype(np.float32),
                 labels.astype(np.int32), train, val, test, name=name)
