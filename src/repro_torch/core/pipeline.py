"""Multi-level parallelism scheduling (paper §III-B, Fig. 4).

Three executors over the Algo.-1 stages (sample → batch-generate → train):

  * ``seq``    — one stage at a time; minimum memory, minimum throughput.
  * ``mode1``  — n workers each run (sample + batch-generate) and feed a
    bounded queue; the consumer trains.  Max throughput, n× working-set
    duplication (Eq. 3).
  * ``mode2``  — n workers run sampling only; batch generation (the
    contention-heavy stage: cache read/write) + training stay serialized on
    the consumer (Eq. 4/5).

On the host-TPU adaptation workers are threads (numpy sampling releases the
GIL in the hot gather ops) and the bounded queue doubles as the
double-buffer: while the device runs step k, workers prepare k+1.  Worker
failures are tolerated: a failed seed batch is re-issued on a spare sampler
(fault_tolerance.py provides the same machinery for the LM trainer).

The executor is RECONFIGURABLE at an episode boundary (the autotune
controller's drain → reconfigure → resume contract):

  * ``submit()`` / ``step()`` — producer/consumer decoupled; in-flight work
    is tracked so nothing is ever dropped.
  * ``drain()`` — consume (train on) every submitted-but-unconsumed batch.
  * ``reconfigure()`` — drain, then atomically swap any of (mode, workers,
    cache, weight_fn, batch_size); the worker pool is rebuilt lazily with
    the new sampler bias/cache on the next submit.
  * ``run()`` — the classic one-epoch entry point, now submit+drain on the
    persistent pool; ``shutdown()`` releases the worker threads.
"""
from __future__ import annotations

import inspect
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.cache import FeatureCache
from repro_torch.core.feature_plane import FeaturePlane, make_feature_plane
from repro_torch.core.sampling import NeighborSampler, MiniBatch, seed_loader
from repro_torch.graph.batch import generate_batch, batch_bytes

_UNSET = object()


@dataclass
class PipelineStats:
    steps: int = 0
    t_sample: float = 0.0
    t_batch: float = 0.0
    t_train: float = 0.0
    t_wall: float = 0.0
    peak_batch_bytes: int = 0
    queue_peak: int = 0
    losses: List[float] = field(default_factory=list)
    accs: List[float] = field(default_factory=list)
    reissued: int = 0

    def stage_times(self):
        from repro_torch.core.perf_model import StageTimes
        n = max(self.steps, 1)
        return StageTimes(self.t_sample / n, self.t_batch / n, self.t_train / n)

    def throughput_steps_per_s(self) -> float:
        return self.steps / self.t_wall if self.t_wall else 0.0


class _SampleWorker(threading.Thread):
    """Pulls seed batches from an index queue, produces (mini)batches.

    Stats are written into ``pipeline.stats`` (re-read on every item, so an
    episode-boundary ``begin_stats()`` swap takes effect immediately)."""

    def __init__(self, wid, sampler, pipeline, in_q, out_q, do_batchgen,
                 heartbeat, fail_after=None):
        super().__init__(daemon=True)
        self.wid = wid
        self.sampler = sampler
        self.pipe = pipeline
        self.in_q, self.out_q = in_q, out_q
        self.do_batchgen = do_batchgen
        self.heartbeat = heartbeat
        self.fail_after = fail_after        # fault-injection for tests
        self._count = 0

    def run(self):
        while True:
            item = self.in_q.get()
            if item is None:
                self.in_q.task_done()
                break
            idx, seeds = item
            try:
                if self.fail_after is not None and self._count >= self.fail_after:
                    raise RuntimeError(f"injected failure in worker {self.wid}")
                t0 = time.perf_counter()
                mb = self.sampler.sample(seeds)
                t1 = time.perf_counter()
                if self.do_batchgen:
                    mb = generate_batch(mb, self.pipe.plane, self.pipe.graph,
                                        fused=self.pipe.fused)
                t2 = time.perf_counter()
                with self.pipe._lock:
                    self.pipe.stats.t_sample += t1 - t0
                    self.pipe.stats.t_batch += t2 - t1
                self.heartbeat[self.wid] = time.time()
                self._count += 1
                self.out_q.put((idx, seeds, mb))
            except Exception:  # noqa: BLE001 — re-queue the work item
                self.heartbeat[self.wid] = -1.0   # mark dead
                self.out_q.put((idx, seeds, None))
            finally:
                self.in_q.task_done()


class Pipeline:
    """Persistent, reconfigurable executor over the Algo.-1 stages."""

    def __init__(self, graph, cfg, train_fn: Callable[[MiniBatch], tuple],
                 cache: Optional[FeatureCache] = None,
                 weight_fn=None, seed: int = 0,
                 plane: Optional[FeaturePlane] = None, device="cuda"):
        self.graph, self.cfg = graph, cfg
        self.train_fn = train_fn
        self.device = device            # where a device plane keeps its mirror
        # the feature plane is the ONLY seam batch generation fetches
        # through; `cache` remains the constructor currency (trainers own
        # the cache object) and the plane wraps it per sampling_device
        self.plane = plane if plane is not None else make_feature_plane(
            graph, cache, getattr(cfg, "sampling_device", "cpu"), device)
        self.sampling_device = self.plane.backend
        self.weight_fn = weight_fn
        self.seed = seed
        self.mode = cfg.parallel_mode
        # all-hop fused batch generation (any model family): feature work
        # is DEFERRED to the train step, which resolves the input hop
        # through FeaturePlane.fused_inputs (encoded slots + sideband)
        self.fused = getattr(cfg, "fused_gather_agg", False)
        # fused train fns take (mb, plane) so step-time encoding reads
        # the LIVE plane (reconfigure may swap it); legacy single-arg
        # train fns keep working unchanged
        self._train_wants_plane = (
            len(inspect.signature(train_fn).parameters) >= 2)
        self.workers_n = max(cfg.workers, 1)
        self.batch_size = cfg.batch_size
        self.stats = PipelineStats()
        self._lock = threading.Lock()
        self.heartbeat: Dict[int, float] = {}
        # pool state
        self._workers: List[_SampleWorker] = []
        self._in_q: Optional[queue.Queue] = None
        self._out_q: Optional[queue.Queue] = None
        self._pool_key = None                  # (do_batchgen, n) of live pool
        self._submit_idx = 0
        self._inflight = 0                     # parallel: submitted, unconsumed
        self._pending: List[np.ndarray] = []   # seq: submitted, unconsumed
        self._spare: Optional[NeighborSampler] = None
        self._seq_sampler: Optional[NeighborSampler] = None
        self._pool_transient = False
        self._epoch = 0                        # advances the seed shuffle

    def _make_sampler(self, s=0):
        return NeighborSampler(self.graph, self.cfg.fanout,
                               weight_fn=self.weight_fn, seed=self.seed + s)

    @property
    def cache(self) -> Optional[FeatureCache]:
        """The cache behind the plane (hit/miss accounting lives there)."""
        return self.plane.cache

    # -- stats windows -------------------------------------------------------
    def begin_stats(self) -> PipelineStats:
        """Open a fresh measurement window (e.g. one autotune episode)."""
        with self._lock:
            self.stats = PipelineStats()
            return self.stats

    # -- worker pool ---------------------------------------------------------
    def _start_pool(self, do_batchgen: bool, fail_worker=None):
        n = self.workers_n
        self._in_q = queue.Queue()
        self._out_q = queue.Queue(maxsize=2 * n)   # bounded double-buffer
        self._workers = []
        for w in range(n):
            fa = 2 if (fail_worker is not None and w == fail_worker) else None
            wk = _SampleWorker(w, self._make_sampler(w), self,
                               self._in_q, self._out_q, do_batchgen,
                               self.heartbeat, fail_after=fa)
            wk.start()
            self._workers.append(wk)
        self._pool_key = (do_batchgen, n)
        self._pool_transient = fail_worker is not None

    def _stop_pool(self):
        if self._workers:
            for _ in self._workers:
                self._in_q.put(None)
            for wk in self._workers:
                wk.join(timeout=5)
        self._workers = []
        self._in_q = self._out_q = None
        self._pool_key = None
        self._pool_transient = False

    def _ensure_pool(self, mode: str, fail_worker=None):
        do_batchgen = (mode == "mode1")
        want = (do_batchgen, self.workers_n)
        if (fail_worker is not None or self._pool_key != want
                or self._pool_transient):
            if self._inflight:
                self.drain()       # never discard queued work on a rebuild
            self._stop_pool()
            self._start_pool(do_batchgen, fail_worker)

    # -- produce / consume ---------------------------------------------------
    def submit(self, seed_batches, fail_worker=None):
        """Queue seed batches for execution under the CURRENT mode."""
        if self.mode == "seq":
            self._pending.extend(seed_batches)
            return
        self._ensure_pool(self.mode, fail_worker)
        for seeds in seed_batches:
            self._in_q.put((self._submit_idx, seeds))
            self._submit_idx += 1
            self._inflight += 1

    @property
    def inflight(self) -> int:
        return len(self._pending) + self._inflight

    def step(self) -> bool:
        """Consume (train on) exactly one submitted batch.  Returns False if
        nothing is in flight."""
        if self.mode == "seq" or self._pending:
            if not self._pending:
                return False
            seeds = self._pending.pop(0)
            if self._seq_sampler is None:
                self._seq_sampler = self._make_sampler()
            t0 = time.perf_counter()
            mb = self._seq_sampler.sample(seeds)
            t1 = time.perf_counter()
            mb = generate_batch(mb, self.plane, self.graph,
                                fused=self.fused)
            t2 = time.perf_counter()
            loss, acc = self._train(mb)
            t3 = time.perf_counter()
            with self._lock:
                st = self.stats
                st.t_sample += t1 - t0
                st.t_batch += t2 - t1
                self._record_train(st, mb, loss, acc, t3 - t2)
            return True
        if self._inflight == 0:
            return False
        do_batchgen = self._pool_key[0] if self._pool_key else True
        idx, seeds, mb = self._out_q.get()
        self._inflight -= 1
        with self._lock:
            self.stats.queue_peak = max(self.stats.queue_peak,
                                        self._out_q.qsize())
        if mb is None:                                 # failed worker → re-issue
            if self._spare is None:
                self._spare = self._make_sampler(997)  # straggler/failure spare
            t0 = time.perf_counter()
            mb = self._spare.sample(seeds)
            mb = generate_batch(mb, self.plane, self.graph,
                                fused=self.fused)
            with self._lock:
                self.stats.reissued += 1
                self.stats.t_sample += time.perf_counter() - t0
        elif not do_batchgen:                          # mode2: serialize batchgen
            t0 = time.perf_counter()
            mb = generate_batch(mb, self.plane, self.graph,
                                fused=self.fused)
            with self._lock:
                self.stats.t_batch += time.perf_counter() - t0
        t0 = time.perf_counter()
        loss, acc = self._train(mb)
        t1 = time.perf_counter()
        with self._lock:
            self._record_train(self.stats, mb, loss, acc, t1 - t0)
        return True

    def _train(self, mb):
        if self._train_wants_plane:
            return self.train_fn(mb, self.plane)
        return self.train_fn(mb)

    def _record_train(self, st: PipelineStats, mb, loss, acc, dt: float):
        st.t_train += dt
        st.steps += 1
        st.losses.append(float(loss))
        st.accs.append(float(acc))
        st.peak_batch_bytes = max(st.peak_batch_bytes, batch_bytes(mb))

    def drain(self):
        """Consume every in-flight batch (nothing is dropped)."""
        while self.step():
            pass

    # -- reconfiguration -----------------------------------------------------
    def reconfigure(self, mode: Optional[str] = None,
                    workers: Optional[int] = None,
                    cache: Any = _UNSET, weight_fn: Any = _UNSET,
                    batch_size: Optional[int] = None,
                    sampling_device: Optional[str] = None):
        """Drain → swap knobs → (lazy) resume.

        Safe at any point: all in-flight batches are trained under the OLD
        configuration first, then the pool is torn down so the next submit
        rebuilds samplers with the new bias/cache.  ``sampling_device``
        swaps the feature-plane backend LIVE (cpu ↔ device) around the same
        cache object — hit/miss accounting survives the migration."""
        self.drain()
        self._stop_pool()
        self._spare = None
        self._seq_sampler = None
        if mode is not None:
            self.mode = mode
        if workers is not None:
            self.workers_n = max(int(workers), 1)
        if cache is not _UNSET or sampling_device is not None:
            if sampling_device is not None:
                self.sampling_device = sampling_device
            new_cache = self.plane.cache if cache is _UNSET else cache
            # rebuild only on a real change — a same-cache re-sync (every
            # apply_live_config passes cache=) must keep the existing plane
            # so a device mirror is not pointlessly re-uploaded; in-place
            # cache mutation is covered by FeatureCache.version
            if (new_cache is not self.plane.cache
                    or self.sampling_device != self.plane.backend):
                old_plane = self.plane
                self.plane = make_feature_plane(self.graph, new_cache,
                                                self.sampling_device,
                                                self.device)
                self.sampling_device = self.plane.backend
                # a FeatureStore subscription follows the LIVE plane: the
                # dead plane detaches (no stale routing, nothing pinned)
                # and the successor observes all further streamed updates
                if old_plane.store is not None:
                    store = old_plane.store
                    old_plane.detach_store()
                    self.plane.subscribe_to(store)
        if weight_fn is not _UNSET:
            self.weight_fn = weight_fn
        if batch_size is not None:
            self.batch_size = int(batch_size)

    def shutdown(self):
        """Discard pending work and stop the workers.

        Unlike ``reconfigure`` this does NOT train the backlog: shutdown is
        called from ``finally`` blocks during exception unwind, where
        re-entering ``train_fn`` would mask the original error (or continue
        training after a fault).  Callers on the green path have already
        drained — ``run()`` consumes everything it submits."""
        self._pending.clear()
        self._inflight = 0
        # unblock any worker parked on a full out_q, and pull undispatched
        # items so the stop sentinels are consumed promptly
        for q_ in (self._out_q, self._in_q):
            if q_ is None:
                continue
            while True:
                try:
                    q_.get_nowait()
                except queue.Empty:
                    break
        self._stop_pool()

    # -- classic one-epoch entry point --------------------------------------
    def run(self, mode: Optional[str] = None, max_steps: Optional[int] = None,
            fail_worker: Optional[int] = None) -> PipelineStats:
        if mode is not None and mode != self.mode:
            self.reconfigure(mode=mode)
        stats = self.begin_stats()
        # each run window gets a fresh shuffle — autotune episodes must not
        # re-measure the identical batch prefix (a FIFO cache would look
        # steady-state-optimal on repeats)
        seed_batches = list(seed_loader(self.graph, self.batch_size,
                                        self.seed + self._epoch))
        self._epoch += 1
        if max_steps is not None:
            seed_batches = seed_batches[:max_steps]
        t_start = time.perf_counter()
        if self.mode == "seq":
            self.submit(seed_batches)
            self.drain()
        else:
            self.submit(seed_batches, fail_worker=fail_worker)
            self.drain()
            if fail_worker is not None:
                self._stop_pool()      # injected-failure pool is poisoned
        stats.t_wall = time.perf_counter() - t_start
        return stats
