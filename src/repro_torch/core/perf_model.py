"""Analytic throughput / memory models — Eqs. (2)–(5) of the paper.

These closed forms drive both the adaptive mode selection and the
auto-tuner's surrogate features.  Stage times come from profiling
(core/pipeline.py measures them per run).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StageTimes:
    t_sample: float      # s per iteration
    t_batch: float
    t_train: float


def throughput_seq(st: StageTimes, iters_per_epoch: int) -> float:
    """Sequential mode: stages serialized."""
    return 1.0 / ((st.t_sample + st.t_batch + st.t_train) * iters_per_epoch)


def throughput_mode1(st: StageTimes, n_workers: int, iters_per_epoch: int) -> float:
    """Eq. (2): sampling+batchgen parallelized over n workers, overlapped
    with training — bottleneck is max(producer/n, consumer)."""
    bottleneck = max((st.t_sample + st.t_batch) / max(n_workers, 1), st.t_train)
    return 1.0 / (bottleneck * iters_per_epoch)


def throughput_mode2(st: StageTimes, n_workers: int, iters_per_epoch: int) -> float:
    """Eq. (4): only sampling parallelized; batchgen+train serialized."""
    bottleneck = max(st.t_sample / max(n_workers, 1), st.t_batch + st.t_train)
    return 1.0 / (bottleneck * iters_per_epoch)


@dataclass
class MemoryTerms:
    cache_bytes: float     # Θ per device
    batch_bytes: float     # B: generated mini-batch
    model_bytes: float     # |M|: params + activations + grads
    runtime_bytes: float   # fixed stream/context overhead


def memory_mode1(mt: MemoryTerms, n_workers: int, num_dev: int = 1) -> float:
    """Eq. (3): worker duplication multiplies the working set."""
    return (num_dev * mt.cache_bytes
            + n_workers * (mt.batch_bytes + mt.runtime_bytes)
            + mt.model_bytes)


def memory_mode2(mt: MemoryTerms, n_workers: int, num_dev: int = 1) -> float:
    """Eq. (5): batch generation serialized → single batch buffer, but the
    runtime context is still duplicated per sampling worker."""
    return (num_dev * mt.cache_bytes + mt.batch_bytes
            + n_workers * mt.runtime_bytes + mt.model_bytes)


def memory_seq(mt: MemoryTerms, num_dev: int = 1) -> float:
    return (num_dev * mt.cache_bytes + mt.batch_bytes + mt.runtime_bytes
            + mt.model_bytes)


def bottleneck_step_time(mode: str, st: StageTimes, n_workers: int) -> float:
    """Per-step wall time under the mode's overlap structure (Eqs. 2/4)."""
    if mode == "seq":
        return st.t_sample + st.t_batch + st.t_train
    if mode == "mode1":
        return max((st.t_sample + st.t_batch) / max(n_workers, 1), st.t_train)
    if mode == "mode2":
        return max(st.t_sample / max(n_workers, 1), st.t_batch + st.t_train)
    raise ValueError(mode)


def predict(mode: str, st: StageTimes, mt: MemoryTerms, n_workers: int,
            iters_per_epoch: int, num_dev: int = 1):
    """(epochs/s, bytes) for a candidate configuration."""
    if mode == "seq":
        return (throughput_seq(st, iters_per_epoch), memory_seq(mt, num_dev))
    if mode == "mode1":
        return (throughput_mode1(st, n_workers, iters_per_epoch),
                memory_mode1(mt, n_workers, num_dev))
    if mode == "mode2":
        return (throughput_mode2(st, n_workers, iters_per_epoch),
                memory_mode2(mt, n_workers, num_dev))
    raise ValueError(mode)
