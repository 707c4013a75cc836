"""Device-side feature cache (paper's feature-cache module).

Maintains a *device map* (node id → cache slot, -1 = miss) enabling both
O(1) lookup during batch generation and the locality-aware sampler's bias
(cached ids get weight γ).  Policies:

  * ``static``  — preload hottest nodes (out-degree order, PaGraph-style)
  * ``fifo``    — dynamic ring-buffer replacement (BGL/GNNavigator-style)

On the TPU adaptation the cache rows live in device HBM and misses are
host→device DMA; here storage is a pinned numpy array and we count
hit/miss traffic exactly (benchmarks derive PCIe-volume savings from it).
The Pallas gather kernel (kernels/gather) implements the device-side
cached-row gather for the real-TPU path.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.storage import Graph


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_from_cache: int = 0
    bytes_from_host: int = 0

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def reset(self):
        self.hits = self.misses = self.evictions = 0
        self.bytes_from_cache = self.bytes_from_host = 0


class FeatureCache:
    def __init__(self, graph: Graph, volume_mb: float, policy: str = "static"):
        self.g = graph
        self.policy = policy
        self.stats = CacheStats()
        self._alloc(volume_mb)

    def _alloc(self, volume_mb: float):
        """(Re)allocate storage for ``volume_mb`` and warm it per policy.
        ``self.stats`` is untouched — hit/miss accounting survives resizes.
        ``version`` advances on every (re)allocation so device-resident
        mirrors (core/feature_plane.py DeviceFeaturePlane) know to re-sync;
        ``epoch`` advances too, marking a full invalidation — the buffers
        themselves were reallocated, so row-wise deltas from before this
        point are meaningless to a mirror."""
        graph = self.g
        self.version = getattr(self, "version", -1) + 1
        self.epoch = getattr(self, "epoch", -1) + 1
        self._delta_log = []            # [(version, dirty_slots, dirty_ids)]
        self._delta_floor = self.version  # oldest version deltas can bridge
        self._delta_rows = 0            # total rows across the log (bound)
        self.volume_mb = float(volume_mb)
        row_bytes = graph.feat_dim * 4
        self.capacity = max(int(volume_mb * 2**20 / row_bytes), 0)
        self.capacity = min(self.capacity, graph.num_nodes)
        self.device_map = -np.ones(graph.num_nodes, dtype=np.int32)
        self.storage = np.zeros((self.capacity, graph.feat_dim), np.float32)
        self.slot_owner = -np.ones(self.capacity, dtype=np.int64)
        self._fifo_head = 0
        if self.policy == "static" and self.capacity:
            hot = graph.hotness_order()[:self.capacity]
            self.storage[:len(hot)] = graph.features[hot]
            self.device_map[hot] = np.arange(len(hot), dtype=np.int32)
            self.slot_owner[:len(hot)] = hot

    def resize(self, volume_mb: float, keep_residents: bool = True):
        """Episode-boundary reconfiguration (autotune controller).

        Static policy re-warms from the hotness order at the new capacity.
        FIFO keeps the most-recently-inserted residents that still fit
        (``keep_residents``), so a shrink behaves like ``new_cap``
        evictions, not a cold restart.  Cumulative ``stats`` are preserved
        either way — the controller's measured hit rate spans episodes via
        ``stats.reset()`` at the boundary it chooses, not here.
        """
        if self.policy != "fifo" or not keep_residents:
            self._alloc(volume_mb)
            return
        # FIFO: snapshot residents in insertion order (oldest → newest)
        old_cap, head = self.capacity, self._fifo_head
        order = (np.arange(old_cap) + head) % old_cap if old_cap else \
            np.arange(0)
        residents = self.slot_owner[order]
        residents = residents[residents >= 0]
        self._alloc(volume_mb)
        if self.capacity and len(residents):
            keep = residents[-self.capacity:]
            n = len(keep)
            self.slot_owner[:n] = keep
            self.device_map[keep] = np.arange(n, dtype=np.int32)
            self.storage[:n] = self.g.features[keep]
            self._fifo_head = n % self.capacity

    # -- dirty-row delta log -------------------------------------------------
    def _record_delta(self, dirty_slots: np.ndarray, dirty_ids: np.ndarray):
        """Advance ``version`` by exactly one and remember WHICH rows moved.

        ``dirty_slots`` are storage rows whose contents changed;
        ``dirty_ids`` are node ids whose ``device_map`` entry changed.
        Device mirrors (core/feature_plane.py) consume the log through
        ``deltas_since`` to scatter only dirty rows instead of re-uploading
        the whole table.  The log is bounded: once it accumulates more
        dirty rows than the table holds, an incremental replay costs more
        than a full upload, so we drop it and raise ``_delta_floor`` —
        stale mirrors then fall back to a full re-upload."""
        self.version += 1
        self._delta_log.append((self.version,
                                np.asarray(dirty_slots, np.int32).copy(),
                                np.asarray(dirty_ids, np.int64).copy()))
        self._delta_rows += len(dirty_slots) + len(dirty_ids)
        if self._delta_rows > 2 * max(self.capacity, 1):
            self._delta_log = []
            self._delta_rows = 0
            self._delta_floor = self.version

    def deltas_since(self, version: int, epoch: int):
        """Cumulative dirty set between a mirror's ``(version, epoch)`` and
        now, or ``None`` if only a full re-upload can bridge the gap
        (reallocation, or the bounded log was dropped).  Returns
        ``(dirty_slots, dirty_ids)`` — unique, final-state row indices: the
        caller reads current ``storage``/``device_map`` contents, so replay
        order is irrelevant."""
        if epoch != self.epoch or version < self._delta_floor:
            return None
        slots = [s for v, s, _ in self._delta_log if v > version]
        ids = [i for v, _, i in self._delta_log if v > version]
        return (np.unique(np.concatenate(slots)) if slots
                else np.empty(0, np.int32),
                np.unique(np.concatenate(ids)) if ids
                else np.empty(0, np.int64))

    # -- streaming updates ---------------------------------------------------
    def patch_resident(self, ids: np.ndarray, rows: np.ndarray) -> int:
        """Overwrite the cache-resident copies among ``ids`` with the
        matching ``rows``, bumping ``version`` when anything changed so
        device mirrors (core/feature_plane.py) re-sync.  THE one place
        the resident-write → version invariant lives: both the push path
        (``FeaturePlane.fill_rows``) and the pull path (``refresh_rows``)
        delegate here.  Returns the number of resident rows patched."""
        if not self.capacity:
            return 0
        ids = np.asarray(ids, dtype=np.int64)
        # ids outside this cache's node universe (a full-graph stream
        # hitting a subgraph cache) have no slot here — not-resident, not
        # an indexing error
        in_universe = ids < len(self.device_map)
        if not in_universe.all():
            ids = ids[in_universe]
            rows = np.asarray(rows)[in_universe]
        slots = self.device_map[ids]
        hit = slots >= 0
        if hit.any():
            self.storage[slots[hit]] = rows[hit]
            # device mirrors must re-sync, but only the patched rows —
            # the slot map is untouched
            self._record_delta(slots[hit], np.empty(0, np.int64))
        return int(hit.sum())

    def refresh_rows(self, ids: np.ndarray) -> int:
        """Re-copy ``ids``'s rows from the host store into their resident
        cache slots after a streaming update (``graph/storage.py``
        ``FeatureStore.update_rows``) — the pull side for consumers that
        only learn WHICH rows moved."""
        ids = np.asarray(ids, dtype=np.int64)
        if not self.capacity:
            return 0
        return self.patch_resident(ids, self.g.features[ids])

    # -- lookups ------------------------------------------------------------
    def is_cached(self, ids: np.ndarray) -> np.ndarray:
        return self.device_map[ids] >= 0

    def volume_bytes(self) -> int:
        return self.storage.nbytes

    # -- fetch --------------------------------------------------------------
    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """Gather features for ``ids`` through the cache, updating stats
        (and, for FIFO, inserting missed rows)."""
        ids = np.asarray(ids, dtype=np.int64)
        slots = self.device_map[ids]
        hit = slots >= 0
        out = np.empty((len(ids), self.g.feat_dim), np.float32)
        if hit.any():
            out[hit] = self.storage[slots[hit]]
        miss_ids = ids[~hit]
        if len(miss_ids):
            out[~hit] = self.g.features[miss_ids]
        self.account_fetch(hit, miss_ids)
        return out

    def account_fetch(self, hit: np.ndarray, miss_ids: np.ndarray):
        """Hit/miss/byte accounting + FIFO insertion for one fetch of
        ``len(hit)`` ids.  Shared by ``fetch`` and the device feature plane
        (core/feature_plane.py), which must stay stats-exact with it —
        keep every accounting change in THIS one place."""
        row_bytes = self.g.feat_dim * 4
        n_hit = int(hit.sum())
        self.stats.hits += n_hit
        self.stats.misses += int(len(hit) - n_hit)
        self.stats.bytes_from_cache += n_hit * row_bytes
        self.stats.bytes_from_host += int(len(miss_ids)) * row_bytes
        if self.policy == "fifo" and self.capacity and len(miss_ids):
            self._fifo_insert(np.unique(miss_ids))

    def _fifo_insert(self, ids: np.ndarray):
        dirty_slots = []
        dirty_ids = []                  # evicted owners AND inserted ids
        for v in ids:
            slot = self._fifo_head
            old = self.slot_owner[slot]
            if old >= 0:
                self.device_map[old] = -1
                self.stats.evictions += 1
                dirty_ids.append(old)
            self.slot_owner[slot] = v
            self.device_map[v] = slot
            self.storage[slot] = self.g.features[v]
            dirty_slots.append(slot)
            dirty_ids.append(v)
            self._fifo_head = (self._fifo_head + 1) % self.capacity
        # one version bump per insert batch → mirrors re-sync once
        self._record_delta(np.asarray(dirty_slots, np.int32),
                           np.asarray(dirty_ids, np.int64))
