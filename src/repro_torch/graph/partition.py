"""Graph partitioning (Algo. 1 line 2) — hash, BFS-grown and locality-aware.

Each GPU/TPU worker trains on its own partition (the paper's no-NVLink
setting: no remote feature access, accepted accuracy cost modeled by the
η term of Eq. (1)).  The scale-out path (core/multipart.py) consumes a
``PartitionPlan`` — the assignment plus the cut/halo statistics that the
locality objective minimizes: a *halo node* of partition p is a node
owned elsewhere but adjacent to p, i.e. exactly the features p would
have to fetch remotely (HitGNN's inter-device traffic term).

BOUNDED HALO EXCHANGE: with ``halo_budget > 0`` each partition keeps the
top-k halo candidates by *affinity* — the number of owned→candidate cut
edges, i.e. exactly the edges the out-edge-following sampler can
traverse (remote→owned edges are invisible to it on these directed
graphs, so they earn no rank), ties broken by node id so larger budgets
are strict prefix-supersets of smaller ones.  The budgeted halo nodes
are appended to the partition's subgraph as feature-only leaves — owned
nodes keep their out-edges into them, so a sampled batch reaches ONE
hop across the cut — and their feature rows are moved through
``distributed/collectives.halo_all_to_all`` (never read locally).  With
``halo_budget=0`` the plan is bit-identical to the drop-cut-edges
setting (the regression anchor)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.locality import edge_locality_score
from repro_torch.graph.storage import Graph


def hash_partition(g: Graph, parts: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, parts, size=g.num_nodes)
    return [np.where(assign == p)[0].astype(np.int32) for p in range(parts)]


def bfs_partition(g: Graph, parts: int, seed: int = 0) -> List[np.ndarray]:
    """Grow partitions from random seeds by BFS — better edge locality than
    hashing (fewer cut edges → higher η overlap per partition)."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    owner = -np.ones(n, np.int32)
    target = n // parts + 1
    sizes = np.zeros(parts, np.int64)
    frontiers = [list(rng.choice(n, size=1)) for _ in range(parts)]
    for p in range(parts):
        owner[frontiers[p][0]] = p
        sizes[p] = 1
    active = True
    while active:
        active = False
        for p in range(parts):
            if sizes[p] >= target or not frontiers[p]:
                continue
            nxt = []
            for v in frontiers[p]:
                for u in g.neighbors(v):
                    if owner[u] < 0 and sizes[p] < target:
                        owner[u] = p
                        sizes[p] += 1
                        nxt.append(int(u))
            frontiers[p] = nxt
            active = active or bool(nxt)
    # orphans (disconnected) → smallest partition
    for v in np.where(owner < 0)[0]:
        p = int(np.argmin(sizes))
        owner[v] = p
        sizes[p] += 1
    return [np.where(owner == p)[0].astype(np.int32) for p in range(parts)]


def locality_partition(g: Graph, parts: int, seed: int = 0) -> List[np.ndarray]:
    """Affinity-ordered growth: admit the frontier node with the most
    neighbors already inside the partition (maximum internal affinity ⇒
    minimum new halo).  Seeds are the hottest nodes (degree order), so each
    partition starts from a hub of its own community — the same hotness
    signal the static cache policy uses (core/cache.py).

    Per-partition frontiers are max-heaps with lazy invalidation (stale
    entries are skipped when popped), so the whole growth is
    O(E log E) rather than a per-admission scan over all nodes."""
    import heapq
    n = g.num_nodes
    if parts <= 1:
        return [np.arange(n, dtype=np.int32)]
    owner = -np.ones(n, np.int32)
    target = n // parts + 1
    sizes = np.zeros(parts, np.int64)
    # affinity[p][v] = #neighbors of v already owned by p (current score);
    # heaps hold (-affinity_at_push, v) — stale when affinity moved on
    affinity = np.zeros((parts, n), np.int32)
    heaps: List[list] = [[] for _ in range(parts)]

    def absorb(p: int, v: int):
        owner[v] = p
        sizes[p] += 1
        for u in g.neighbors(v):
            if owner[u] < 0:
                affinity[p, u] += 1
                heapq.heappush(heaps[p], (-int(affinity[p, u]), int(u)))

    hot = g.hotness_order()
    rng = np.random.default_rng(seed)
    for p, v in enumerate(hot[:parts]):
        absorb(p, int(v))
    stalled = np.zeros(parts, bool)
    while not stalled.all():
        for p in range(parts):
            if stalled[p]:
                continue
            if sizes[p] >= target:
                stalled[p] = True
                continue
            v = -1
            while heaps[p]:
                neg_a, cand = heapq.heappop(heaps[p])
                if owner[cand] < 0 and -neg_a == affinity[p, cand]:
                    v = cand
                    break
            if v < 0:
                stalled[p] = True
                continue
            absorb(p, v)
    # leftovers (disconnected or capped out): hash onto the smallest parts
    for v in np.where(owner < 0)[0]:
        p = int(np.argmin(sizes + rng.random(parts)))   # random tie-break
        owner[v] = p
        sizes[p] += 1
    return [np.where(owner == p)[0].astype(np.int32) for p in range(parts)]


_METHODS = {"hash": hash_partition, "bfs": bfs_partition,
            "locality": locality_partition}


@dataclass
class PartitionPlan:
    """A partition assignment plus the statistics the scale-out path and
    the Eq. (1) accuracy model consume.

    ``halo_sets[p]`` holds the budgeted halo nodes of partition p as
    GLOBAL ids in affinity-rank order; the subgraph of partition p appends
    them after the owned nodes, so local ids ``>= len(node_sets[p])`` are
    halo rows (feature-only leaves whose rows arrive through
    ``halo_all_to_all``)."""
    node_sets: List[np.ndarray]
    owner: np.ndarray               # (N,) int32 node → partition
    method: str
    subgraphs: List[Graph] = field(default_factory=list)
    cut_edges: int = 0              # edges crossing a partition boundary
    halo_counts: List[int] = field(default_factory=list)   # candidate pool
    halo_budget: int = 0            # per-partition cap on kept halo nodes
    halo_sets: List[np.ndarray] = field(default_factory=list)
    recovered_edges: int = 0        # cut edges reachable again via the halo
    # full affinity ranking (ids + per-id recovered-edge counts), kept so
    # a live re-budget slices prefixes instead of rescanning the edges
    halo_ranked: List[np.ndarray] = field(default_factory=list, repr=False)
    halo_ranked_aff: List[np.ndarray] = field(default_factory=list,
                                              repr=False)
    # graph topology version the plan was built against (dynamic graphs:
    # drift tracking compares the live graph's version to this one)
    topology_version: int = 0
    # lazy (N,) owned-local index (ownership lookup API) — one shared map
    # next to ``owner``, not a per-partition N-map, so routing costs O(N)
    # memory once, not P×N
    _local_ids: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def parts(self) -> int:
        return len(self.node_sets)

    # ------------------------------------------------------------------
    # ownership lookup — the routing API the serving fabric and the
    # multi-partition streaming path share: global node → (owner, local)
    # ------------------------------------------------------------------
    def owner_of(self, nodes) -> np.ndarray:
        """Owning partition of each global node id (vectorized)."""
        return self.owner[np.asarray(nodes, dtype=np.int64)]

    def local_ids(self) -> np.ndarray:
        """(N,) local id of each node WITHIN its owning partition's
        subgraph (owned prefix — halo tails are borrowed features, not
        membership).  Computed once and cached on the plan."""
        if self._local_ids is None:
            m = np.zeros(len(self.owner), dtype=np.int32)
            for ns in self.node_sets:
                m[ns] = np.arange(len(ns), dtype=np.int32)
            self._local_ids = m
        return self._local_ids

    def node_maps(self) -> List[np.ndarray]:
        """Per-partition (N,) global → local translation: the owned
        prefix id for partition p's nodes, −1 everywhere else.  Halo ids
        are deliberately −1 — a query for a halo-resident node routes to
        its OWNER (where its out-edges live); the halo tail only serves
        borrowed feature rows to cross-cut neighborhoods."""
        local = self.local_ids()
        maps = []
        for p in range(self.parts):
            m = np.full(len(self.owner), -1, dtype=np.int32)
            mine = self.owner == p
            m[mine] = local[mine]
            maps.append(m)
        return maps

    @property
    def halo_rows(self) -> int:
        """Total budgeted halo feature rows across the fleet — the row
        count ``halo_all_to_all`` moves (all of them cross a boundary)."""
        return int(sum(len(hs) for hs in self.halo_sets))

    def etas(self, full: Graph) -> List[float]:
        """Per-partition η = |Vs_i| / |V| of Eq. (1)."""
        return [len(ns) / max(full.num_nodes, 1) for ns in self.node_sets]

    def edge_locality(self, full: Graph) -> float:
        """Fraction of edges kept inside a partition (1 − cut ratio)."""
        return 1.0 - self.cut_edges / max(full.num_edges, 1)

    def kept_information(self, full: Graph) -> float:
        """Fraction of full-graph edges some partition's sampler can still
        follow: internal edges plus the cut edges recovered through the
        budgeted halo.  Equals ``edge_locality`` at ``halo_budget=0`` and
        strictly exceeds it whenever the budget recovers a cut edge."""
        kept = full.num_edges - self.cut_edges + self.recovered_edges
        return kept / max(full.num_edges, 1)

    def exchange_volume_bytes(self, full: Graph) -> int:
        """Analytic boundary-feature traffic of one full halo refresh."""
        return self.halo_rows * full.feat_dim * 4

    def with_halo_budget(self, full: Graph, budget: int) -> "PartitionPlan":
        """Re-budget the SAME assignment (owner/node_sets untouched) —
        the live ``halo_budget`` swap path: the stored affinity ranking is
        sliced to the new prefix (no edge rescan, no re-partition); only
        the subgraphs are rebuilt for the new halo tails."""
        return _finalize_plan(full, self.node_sets, self.owner, self.method,
                              budget, ranking=(self.halo_ranked,
                                               self.halo_ranked_aff,
                                               self.halo_counts,
                                               self.cut_edges))


def _halo_candidates(g: Graph, owner: np.ndarray, parts: int):
    """Per-partition halo candidates ranked by affinity = the number of
    owned→candidate cut edges (the only direction the out-edge-following
    sampler can traverse — a remote→owned edge recovers nothing, so it
    earns no rank); ties broken by ascending node id so a larger budget
    keeps a strict prefix-superset of a smaller one.  ``halo_counts``
    stays the full either-direction candidate pool (the remote-fetch
    statistic the plan reports)."""
    indptr, indices = g.adj()
    src = np.repeat(np.arange(g.num_nodes), np.diff(indptr))
    cross = owner[src] != owner[indices]
    ranked, affs, counts = [], [], []
    for p in range(parts):
        out_nb = indices[cross & (owner[src] == p)]       # owned → remote
        in_src = src[cross & (owner[indices] == p)]       # remote → owned
        ids, aff = np.unique(out_nb, return_counts=True)
        order = np.lexsort((ids, -aff))
        ranked.append(ids[order].astype(np.int64))
        affs.append(aff[order].astype(np.int64))
        counts.append(int(len(np.unique(np.concatenate([out_nb, in_src])))))
    return ranked, affs, counts, int(cross.sum())


def _finalize_plan(g: Graph, node_sets: List[np.ndarray], owner: np.ndarray,
                   method: str, halo_budget: int,
                   ranking=None) -> PartitionPlan:
    parts = len(node_sets)
    budget = max(int(halo_budget), 0)
    if ranking is None:
        ranked, affs, counts, cut = _halo_candidates(g, owner, parts)
    else:                              # live re-budget: reuse the ranking
        ranked, affs, counts, cut = ranking
    halo_sets = [r[:budget] for r in ranked]
    # affinity IS the owned→halo cut-edge count, so the recovered total is
    # just the kept prefix sum — no edge rescan needed
    recovered = int(sum(int(a[:budget].sum()) for a in affs))
    return PartitionPlan(
        node_sets=node_sets, owner=owner, method=method,
        subgraphs=[g.subgraph(ns, feature_leaves=hs)
                   for ns, hs in zip(node_sets, halo_sets)],
        cut_edges=cut, halo_counts=counts, halo_budget=budget,
        halo_sets=halo_sets, recovered_edges=recovered,
        halo_ranked=ranked, halo_ranked_aff=affs,
        topology_version=g.topology_version)


def plan_partitions(g: Graph, parts: int, method: str = "locality",
                    seed: int = 0, halo_budget: int = 0) -> PartitionPlan:
    """Build the full plan: assignment, induced subgraphs (halo-augmented
    when ``halo_budget > 0``), cut/halo stats."""
    if method not in _METHODS:
        raise ValueError(f"unknown partition method {method!r}; "
                         f"expected one of {sorted(_METHODS)}")
    node_sets = _METHODS[method](g, max(parts, 1), seed)
    owner = -np.ones(g.num_nodes, np.int32)
    for p, ns in enumerate(node_sets):
        owner[ns] = p
    return _finalize_plan(g, node_sets, owner, method, halo_budget)


def assignment_cut_fraction(g: Graph, owner: np.ndarray) -> float:
    """Fraction of CURRENT edges crossing a partition boundary under an
    ownership vector — the drift statistic: computed against ``g.adj()``
    so streamed edge inserts/deletes move it even while ``plan.cut_edges``
    (frozen at plan-build) does not."""
    indptr, indices = g.adj()
    src = np.repeat(np.arange(g.num_nodes), np.diff(indptr))
    return float((owner[src] != owner[indices]).sum() / max(len(indices), 1))


@dataclass
class RebalanceResult:
    """Outcome of one ``incremental_rebalance`` call."""
    plan: PartitionPlan
    moved_nodes: int                # boundary nodes migrated
    moved_frac: float               # moved_nodes / N
    cut_before: float               # cut fraction entering the rebalance
    cut_after: float                # cut fraction of the new assignment
    sweeps: int                     # refinement sweeps executed


def incremental_rebalance(g: Graph, plan: PartitionPlan,
                          halo_budget: Optional[int] = None,
                          max_move_frac: float = 0.25,
                          balance_slack: float = 0.10,
                          max_sweeps: int = 8) -> RebalanceResult:
    """Restore partition quality after topology drift by migrating ONLY
    boundary nodes — never a full repartition (HitGNN's CPU-side
    preprocessing is the scalability bottleneck; re-running it per drift
    event is exactly what this avoids).

    Greedy gain refinement over the CURRENT adjacency (``g.adj()``, so
    pending overlay edges count): per node, ``aff[v, p]`` = incident
    edges (either direction — cut edges hurt both endpoints' partitions)
    landing in partition p; a boundary node moves to its best partition
    when the gain ``aff[v, best] - aff[v, own]`` is positive and the
    size-balance slack allows it, and its neighbors' affinities update
    incrementally.  Total moves are capped at ``max_move_frac·N`` — the
    incremental-vs-full contract benchmarked in fig_dynamic.  The
    returned plan is rebuilt through ``_finalize_plan`` on the new node
    sets, so subgraphs, halo sets and ``kept_information`` are recomputed
    against the mutated graph, never carried stale."""
    n = g.num_nodes
    parts = plan.parts
    owner = plan.owner.copy()
    indptr, indices = g.adj()
    cut_before = assignment_cut_fraction(g, owner)
    budget = plan.halo_budget if halo_budget is None else int(halo_budget)

    src = np.repeat(np.arange(n), np.diff(indptr)).astype(np.int64)
    aff = np.zeros((n, parts), np.int64)
    np.add.at(aff, (src, owner[indices]), 1)          # out-edges of src
    np.add.at(aff, (indices, owner[src]), 1)          # in-edges of dst
    # reverse CSR: in-neighbors of v, for incremental aff updates on move
    rev_order = np.argsort(indices, kind="stable")
    rev_src = src[rev_order]
    rev_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(indices, minlength=n), out=rev_indptr[1:])

    sizes = np.bincount(owner, minlength=parts).astype(np.int64)
    target = n / parts
    lo = int(np.floor(target * (1.0 - balance_slack)))
    hi = int(np.ceil(target * (1.0 + balance_slack)))
    move_budget = int(max_move_frac * n)
    moved_total = 0
    sweeps = 0
    while sweeps < max_sweeps and moved_total < move_budget:
        sweeps += 1
        best = np.argmax(aff, axis=1)
        own_aff = aff[np.arange(n), owner]
        gain = aff[np.arange(n), best] - own_aff
        cand = np.where((gain > 0) & (best != owner))[0]
        if not len(cand):
            break
        moved_this_sweep = 0
        # biggest gains first: the move budget goes to the worst offenders
        for v in cand[np.argsort(-gain[cand], kind="stable")]:
            if moved_total >= move_budget:
                break
            p_from, p_to = int(owner[v]), int(np.argmax(aff[v]))
            if p_to == p_from or aff[v, p_to] <= aff[v, p_from]:
                continue                      # stale after earlier moves
            if sizes[p_from] - 1 < lo or sizes[p_to] + 1 > hi:
                continue
            owner[v] = p_to
            sizes[p_from] -= 1
            sizes[p_to] += 1
            moved_total += 1
            moved_this_sweep += 1
            out_nb = indices[indptr[v]:indptr[v + 1]]
            in_nb = rev_src[rev_indptr[v]:rev_indptr[v + 1]]
            for nb in (out_nb, in_nb):
                if len(nb):
                    np.add.at(aff, (nb, p_from), -1)
                    np.add.at(aff, (nb, p_to), 1)
        if not moved_this_sweep:
            break
    node_sets = [np.where(owner == p)[0].astype(np.int32)
                 for p in range(parts)]
    new_plan = _finalize_plan(g, node_sets, owner, plan.method, budget)
    return RebalanceResult(plan=new_plan, moved_nodes=moved_total,
                           moved_frac=moved_total / max(n, 1),
                           cut_before=cut_before,
                           cut_after=assignment_cut_fraction(g, owner),
                           sweeps=sweeps)


def partition(g: Graph, parts: int, method: str = "bfs",
              seed: int = 0) -> List[Graph]:
    if parts <= 1:
        return [g]
    node_sets = _METHODS[method](g, parts, seed)
    return [g.subgraph(ns) for ns in node_sets]


def overlap_ratio(part: Graph, full: Graph) -> float:
    """η = |Vs_i| / |V| of Eq. (1)."""
    return part.num_nodes / max(full.num_nodes, 1)


__all__ = ["hash_partition", "bfs_partition", "locality_partition",
           "PartitionPlan", "plan_partitions", "partition", "overlap_ratio",
           "edge_locality_score", "assignment_cut_fraction",
           "incremental_rebalance", "RebalanceResult"]
