"""FeaturePlane — the pluggable feature-fetch seam of the batch-generation
hot path (paper §III-A/B; the "gather" stage of sample → gather → transfer).
Training (core/pipeline.py) and online inference serving
(serve/gnn_engine.py) fetch through the SAME plane object, so the γ/Θ
cache and its hit/miss accounting carry across the train → serve boundary.

  * ``HostFeaturePlane``   — the numpy path: ``FeatureCache.fetch`` when a
    cache is configured, a direct host-store gather otherwise.
  * ``DeviceFeaturePlane`` — the cache table and the slot map live as torch
    tensors on ``device``; a batch fetch gathers resident rows with the
    CUDA ``cache_gather`` kernel (kernels/gather) and fills misses from the
    host feature store.  Accounting, FIFO insertion and resize semantics
    are delegated to the SAME ``FeatureCache`` bookkeeping, so the two
    planes are bit-exact and stats-exact on the same request stream.

``make_feature_plane`` picks the backend from ``GNNConfig.sampling_device``
(``cpu | device | auto``).  ``auto`` never probes: it follows the caller's
``device`` — the device plane for ``cuda``, the host plane for ``cpu``.
A device plane on a CPU ``device`` runs the gather's plain version (the
CPU tests' configuration); on ``cuda`` it launches the kernel or raises.

Known cost: ``fetch`` returns numpy rows, as the JAX package's does, so
resident rows travel device → host here and host → device again before the
forward (graph/batch.py builds the padded batch in numpy).  The fused reads
avoid it: ``fused_inputs`` (the all-hop fused train step's layer-0 input)
hands the step the live device table itself, with resident rows encoded
as slots and only the misses written into a persistent device sideband;
``gather_aggregate`` resolves and aggregates layer 0 in one kernel.

Reconfiguration: ``resize``/γ-swap mutates the ``FeatureCache`` in place;
the device plane sees the new ``FeatureCache.version`` and re-syncs —
row scatters from the cache's delta log, or a full re-upload after a
reallocation, dropping the stale buffers first.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cache import FeatureCache
from repro_torch.graph.storage import Graph
from repro_torch.kernels.pad_plan import bucket_plan

# the device-plane gather is issued in bounded row chunks; the chunking and
# the pow2 padding of mirror scatters (bucket_plan) follow the JAX package,
# so every sync_*/gather_* counter equals its twin's on one request stream
GATHER_CHUNK_ROWS = 4096


class FeaturePlane:
    """Backend-pluggable feature-fetch interface (host implementation).

    ``fetch`` is the hot-path read (through the cache, with accounting);
    ``fill_rows`` is the write side — it updates the host store AND any
    cache-resident copy of the written rows, so a fill is visible no
    matter which backend serves the next fetch.
    """

    backend = "cpu"

    def __init__(self, graph: Graph, cache: Optional[FeatureCache] = None):
        self.graph = graph
        self.cache = cache
        self.store = None               # attached FeatureStore (subscribe_to)
        # ``gather_dispatches`` counts gather invocations (device plane:
        # one per kernel chunk; host plane: one per call); ``gather_rows``
        # the rows those dispatches resolved
        self.gather_dispatches = 0
        self.gather_rows = 0
        self._fused_table = None        # host fused_inputs' 1-row dummy

    # -- reads ---------------------------------------------------------------
    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """Gather features for ``ids`` (n,) → (n, F) float32."""
        self.gather_dispatches += 1
        self.gather_rows += len(ids)
        if self.cache is not None:
            return self.cache.fetch(ids)
        return self.graph.features[np.asarray(ids, dtype=np.int64)]

    def gather_aggregate(self, ids: np.ndarray, neigh_idx: np.ndarray,
                         mode: str = "mean"):
        """Fused layer-0 read: the input-hop self rows and the masked
        neighbor aggregate (``mode``: mean or sum) in one call, returning
        numpy ``(h_dst (n_dst, F), agg (n_dst, F))`` where
        ``n_dst = neigh_idx.shape[0]`` (dst ids are the prefix of ``ids``).

        Host backend: fetch through the cache (same accounting as
        ``fetch``) and run the fused op's plain version with an
        all-sideband encoding, so both backends aggregate identical rows."""
        ids = np.asarray(ids, dtype=np.int64)
        rows = self.fetch(ids)           # counts the gather_* traffic
        enc = -np.arange(1, len(ids) + 1, dtype=np.int32)
        table = np.zeros((1, self.graph.feat_dim), np.float32)
        return _run_fused(enc, neigh_idx, torch.from_numpy(table), rows,
                          mode, torch.device("cpu"))

    def fused_inputs(self, ids: np.ndarray, cap: int):
        """Encoded layer-0 inputs for the all-hop fused train step
        (models/gnn.py ``make_train_step_allfused``): ``(enc (cap,) int32,
        aux (cap, F) float32, table)`` padded to the fixed input-level cap
        (graph/batch.py ``compute_level_caps``).  Padded enc entries are −1
        → ``aux[0]``, never referenced by a real dst row.

        Host backend: all-sideband encoding — rows are fetched through the
        cache (same accounting as ``fetch``), ``enc[i] = -(i+1)`` and the
        table is a 1-row dummy; the tensors lie on the CPU."""
        ids = np.asarray(ids, dtype=np.int64)
        n = len(ids)
        if n > cap:
            raise ValueError(f"{n} input ids exceed level cap {cap}")
        rows = self.fetch(ids)           # counts the gather_* traffic
        enc = np.full(cap, -1, np.int32)
        enc[:n] = -np.arange(1, n + 1, dtype=np.int32)
        aux = np.zeros((cap, self.graph.feat_dim), np.float32)
        aux[:n] = rows
        if self._fused_table is None:
            self._fused_table = torch.zeros((1, self.graph.feat_dim))
        return torch.from_numpy(enc), torch.from_numpy(aux), self._fused_table

    # -- writes (streaming updates) ------------------------------------------
    def subscribe_to(self, store) -> "FeaturePlane":
        """Wire this plane into a ``graph/storage.py`` ``FeatureStore``:
        every streamed ``update_rows`` patches cache-resident copies (the
        store already wrote the host rows).  Any previous subscription is
        detached first; the store is recorded so a plane swap
        (``Pipeline.reconfigure``) can migrate the subscription."""
        self.detach_store()
        self.store = store
        store.subscribe(self._on_store_update)
        return self

    def detach_store(self):
        if self.store is not None:
            self.store.unsubscribe(self._on_store_update)
            self.store = None

    def _on_store_update(self, ids: np.ndarray, rows: np.ndarray):
        """Store subscriber: patch resident copies (version bump → mirror
        re-sync).  Ids outside this plane's node universe are dropped."""
        c = self.cache
        if c is not None:
            ids = np.asarray(ids, dtype=np.int64)
            rows = np.asarray(rows, dtype=np.float32)
            in_universe = ids < self.graph.num_nodes
            if not in_universe.all():
                ids, rows = ids[in_universe], rows[in_universe]
            if len(ids):
                c.patch_resident(ids, rows)

    def fill_rows(self, ids: np.ndarray, rows: np.ndarray):
        """Overwrite feature rows ``ids`` in the host store, propagating to
        cache-resident copies (and so to the device mirror)."""
        ids = np.asarray(ids, dtype=np.int64)
        self.graph.features[ids] = rows
        if self.cache is not None:
            self.cache.patch_resident(ids, np.asarray(rows, dtype=np.float32))

    # -- reconfiguration -----------------------------------------------------
    def resize(self, volume_mb: float, keep_residents: bool = True):
        """Episode-boundary Θ swap, routed through the plane so backend
        state (device mirrors) tracks the cache."""
        if self.cache is not None:
            self.cache.resize(volume_mb, keep_residents=keep_residents)

    @property
    def stats(self):
        return self.cache.stats if self.cache is not None else None


HostFeaturePlane = FeaturePlane


def _run_fused(enc: np.ndarray, neigh_idx: np.ndarray, table: torch.Tensor,
               aux: np.ndarray, mode: str, device: torch.device):
    """Run ``gather_aggregate`` on ``device`` against ``table`` (already
    there) and return numpy ``(h_dst, agg)``.  An empty sideband becomes
    one zero row (the op needs at least one)."""
    from repro_torch.kernels.fused_gather_agg.ops import gather_aggregate
    if len(aux) == 0:
        aux = np.zeros((1, table.shape[1]), np.float32)
    h, a = gather_aggregate(
        torch.from_numpy(np.ascontiguousarray(enc, np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(neigh_idx, np.int32)).to(device),
        table, torch.from_numpy(np.ascontiguousarray(aux, np.float32)).to(
            device), mode=mode)
    return h.cpu().numpy(), a.cpu().numpy()


class DeviceFeaturePlane(FeaturePlane):
    """Device-resident gather: slot map + cache table as tensors on
    ``device``, batch lookup through the ``cache_gather`` kernel, miss
    fill from the host feature store.

    The ``FeatureCache`` stays the single source of truth for the slot
    assignment, the replacement policy and the accounting; this plane
    mirrors (storage, device_map) to the device and keeps the mirror
    coherent through ``FeatureCache.deltas_since``: dirty rows are written
    in place with ``index_copy_``; a full re-upload happens only on
    reallocation or when the bounded delta log was dropped.
    """

    backend = "device"

    def __init__(self, graph: Graph, cache: Optional[FeatureCache] = None,
                 device="cuda", incremental_sync: bool = True):
        super().__init__(graph, cache)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceFeaturePlane(device='cuda') needs a "
                               "CUDA device; pass device='cpu' to run the "
                               "plain gather on the host")
        self.incremental_sync = incremental_sync
        self._dev_table: Optional[torch.Tensor] = None
        self._dev_slots: Optional[torch.Tensor] = None
        self._version = -1
        self._epoch = -1
        # mirror-maintenance counters: full uploads move O(capacity) rows,
        # scatters move O(dirty rows)
        self.sync_full_uploads = 0
        self.sync_row_scatters = 0
        self.sync_rows_scattered = 0
        self.sync_bytes_uploaded = 0    # host→device mirror traffic, exact
        # per-cap persistent sidebands for the all-hop fused path: miss rows
        # are written into a buffer on ``device`` in place instead of
        # uploading a (cap, F) tensor per batch, so per-batch feature
        # traffic is O(misses), never O(cap)
        self._aux_bufs = {}
        # mode1 batch-gen workers share the plane: a mirror re-upload must
        # never race a gather in another thread, so sync + gather + insert
        # run under one lock
        self._lock = threading.Lock()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        # always a copy: on a CPU device the mirror must not alias the
        # cache's numpy storage
        return torch.from_numpy(a).to(self.device, copy=True)

    # -- device mirror -------------------------------------------------------
    def _ensure_synced(self):
        c = self.cache
        if self._dev_table is not None and self._version == c.version:
            return
        deltas = (c.deltas_since(self._version, self._epoch)
                  if self.incremental_sync and self._dev_table is not None
                  else None)
        if deltas is None:
            # reallocation (or the bounded delta log was dropped): drop the
            # stale mirror before uploading, so two tables never coexist
            self._dev_table = self._dev_slots = None
            self._dev_table = self._upload(c.storage)
            self._dev_slots = self._upload(c.device_map)
            self.sync_full_uploads += 1
            self.sync_bytes_uploaded += (c.storage.nbytes
                                         + c.device_map.nbytes)
        else:
            dirty_slots, dirty_ids = deltas
            if len(dirty_slots):
                k = len(dirty_slots)
                idx = np.full(bucket_plan(k), c.capacity, np.int32)
                idx[:k] = dirty_slots
                vals = np.zeros((len(idx), self.graph.feat_dim), np.float32)
                vals[:k] = c.storage[dirty_slots]
                self._dev_table.index_copy_(
                    0, self._upload(idx)[:k].long(), self._upload(vals)[:k])
                self.sync_bytes_uploaded += vals.nbytes + idx.nbytes
            if len(dirty_ids):
                k = len(dirty_ids)
                idx = np.full(bucket_plan(k), self.graph.num_nodes, np.int64)
                idx[:k] = dirty_ids
                vals = np.zeros(len(idx), np.int32)
                vals[:k] = c.device_map[dirty_ids]
                self._dev_slots.index_copy_(
                    0, self._upload(idx)[:k], self._upload(vals)[:k])
                self.sync_bytes_uploaded += vals.nbytes + idx.nbytes
            self.sync_row_scatters += 1
            self.sync_rows_scattered += len(dirty_slots) + len(dirty_ids)
        self._version = c.version
        self._epoch = c.epoch

    def device_bytes(self) -> int:
        """Footprint of the mirror on ``device`` (0 before the first
        upload)."""
        return sum(t.numel() * t.element_size()
                   for t in (self._dev_table, self._dev_slots)
                   if t is not None)

    # -- reads ---------------------------------------------------------------
    def fetch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        c = self.cache
        if c is None or not c.capacity:
            # nothing resident on device — same contract as the host plane
            return super().fetch(ids)
        with self._lock:
            return self._fetch_locked(ids, c)

    def _fetch_locked(self, ids: np.ndarray, c: FeatureCache) -> np.ndarray:
        from repro_torch.kernels.gather.ops import cache_gather
        self._ensure_synced()
        n = len(ids)
        out = np.empty((n, self.graph.feat_dim), np.float32)
        # the host-side device_map is bit-identical to the synced mirror
        # (both under this lock), so the miss set is known before the
        # device gather completes and the host-store gather for misses
        # overlaps the kernels; the kernel takes the slots directly
        slots_np = c.device_map[ids]
        miss = slots_np < 0
        slots = self._upload(slots_np)
        pending = []                     # (offset, rows on device) per chunk
        for a in range(0, n, GATHER_CHUNK_ROWS):
            rows, _ = cache_gather(slots[a:a + GATHER_CHUNK_ROWS],
                                   self._dev_table)
            pending.append((a, rows))
        miss_ids = ids[miss]
        host_rows = self.graph.features[miss_ids] if len(miss_ids) else None
        self.gather_dispatches += len(pending)
        self.gather_rows += n
        for a, rows in pending:
            out[a:a + len(rows)] = rows.cpu().numpy()    # the one sync
        if len(miss_ids):
            out[miss] = host_rows
        # one accounting implementation for both planes; a FIFO insert
        # bumps version → re-sync on the next fetch
        c.account_fetch(~miss, miss_ids)
        return out

    def _encode(self, ids: np.ndarray, c: FeatureCache, n_enc: int):
        """(enc (n_enc,) int32, hit mask, miss ids): resident rows as cache
        slots, misses as sideband rows -1, -2, …; entries past len(ids)
        are -1 padding."""
        slots = c.device_map[ids]
        hit = slots >= 0
        miss_ids = ids[~hit]
        enc = np.full(n_enc, -1, np.int32)
        enc[:len(ids)][hit] = slots[hit]
        enc[:len(ids)][~hit] = -np.arange(1, len(miss_ids) + 1,
                                          dtype=np.int32)
        return enc, hit, miss_ids

    def gather_aggregate(self, ids: np.ndarray, neigh_idx: np.ndarray,
                         mode: str = "mean"):
        """Fused layer-0 read against the device mirror: resident rows are
        addressed by cache slot, misses ride a host-gathered sideband, and
        one ``gather_aggregate`` kernel resolves and aggregates them.  Equal
        to the host plane's result: both resolve the same row values."""
        ids = np.asarray(ids, dtype=np.int64)
        c = self.cache
        if c is None or not c.capacity:
            return super().gather_aggregate(ids, neigh_idx, mode=mode)
        with self._lock:
            self._ensure_synced()
            enc, hit, miss_ids = self._encode(ids, c, len(ids))
            aux = self.graph.features[miss_ids]
            self.gather_dispatches += 1
            self.gather_rows += len(ids)
            out = _run_fused(enc, neigh_idx, self._dev_table, aux, mode,
                             self.device)
            c.account_fetch(hit, miss_ids)
        return out

    def fused_inputs(self, ids: np.ndarray, cap: int):
        """Device twin of the host ``fused_inputs``: resident rows are
        encoded as cache-table slots (no feature bytes move for them);
        misses are written into rows 0..m-1 of a persistent per-cap
        sideband on ``device``, in place, so per-batch feature traffic is
        O(miss rows), never O(cap).  The returned ``table`` is the live
        device mirror itself.

        The consuming train step must be serialized (the trainer reads the
        loss every step): the next batch writes into the same sideband."""
        ids = np.asarray(ids, dtype=np.int64)
        c = self.cache
        if c is None or not c.capacity:
            enc, aux, table = super().fused_inputs(ids, cap)
            return enc.to(self.device), aux.to(self.device), \
                table.to(self.device)
        n = len(ids)
        if n > cap:
            raise ValueError(f"{n} input ids exceed level cap {cap}")
        with self._lock:
            self._ensure_synced()
            enc, hit, miss_ids = self._encode(ids, c, cap)
            aux = self._aux_bufs.get(cap)
            if aux is None:
                aux = torch.zeros((cap, self.graph.feat_dim),
                                  device=self.device)
                self._aux_bufs[cap] = aux
            m = len(miss_ids)
            if m:
                aux[:m].copy_(torch.from_numpy(self.graph.features[miss_ids]))
            self.gather_dispatches += 1
            self.gather_rows += n
            c.account_fetch(hit, miss_ids)
            return self._upload(enc), aux, self._dev_table

    def fill_rows(self, ids: np.ndarray, rows: np.ndarray):
        with self._lock:
            super().fill_rows(ids, rows)

    def _on_store_update(self, ids: np.ndarray, rows: np.ndarray):
        with self._lock:
            super()._on_store_update(ids, rows)

    def resize(self, volume_mb: float, keep_residents: bool = True):
        with self._lock:
            super().resize(volume_mb, keep_residents=keep_residents)


def make_feature_plane(graph: Graph, cache: Optional[FeatureCache],
                       sampling_device: str = "cpu",
                       device="cuda") -> FeaturePlane:
    """Backend factory for the batch-generation gather stage.

    ``cpu`` → ``HostFeaturePlane``; ``device`` → ``DeviceFeaturePlane`` on
    ``device``; ``auto`` → the device plane when ``device`` is CUDA, the
    host plane when the caller asked for the CPU.  Nothing is probed.
    """
    if sampling_device == "auto":
        sampling_device = ("device" if torch.device(device).type == "cuda"
                           else "cpu")
    if sampling_device == "device":
        return DeviceFeaturePlane(graph, cache, device=device)
    if sampling_device in ("cpu", "host"):
        return HostFeaturePlane(graph, cache)
    raise ValueError(f"unknown sampling_device: {sampling_device!r} "
                     f"(expected cpu | device | auto)")
