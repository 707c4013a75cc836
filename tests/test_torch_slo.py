"""Property tests for the port's SLO admission scheduler and its rolling
latency window (``repro_torch/serve/common.py``) — the decision logic every
fabric dispatch and door verdict runs through.  The same properties as the
JAX package's, held against the port's copy of the module.

Runs under the real ``hypothesis`` when installed, or the deterministic
``_hypothesis_compat`` sweep otherwise.
"""
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro_torch.serve.common import (LatencyStats, LatencyWindow,
                                      SLOAdmission)
from repro_torch.serve.gnn_engine import GNNRequest


def _req(submit, first, done):
    return GNNRequest(rid=-1, node=0, t_submit=submit, t_first=first,
                      t_done=done)


def _window(service_ms, n=16, maxlen=64):
    """A window whose service p50 is exactly ``service_ms``."""
    win = LatencyWindow(maxlen)
    for i in range(n):
        t = i * 0.01
        win.record(_req(t, t + 0.001, t + 0.001 + service_ms * 1e-3))
    return win


# ---------------------------------------------------------------------------
# SLOAdmission estimates
# ---------------------------------------------------------------------------

@given(service_ms=st.floats(0.1, 50.0), slots=st.integers(1, 64),
       b0=st.integers(0, 500), db=st.integers(0, 500))
@settings(max_examples=60, deadline=None)
def test_wait_estimate_monotone_in_backlog(service_ms, slots, b0, db):
    """More queued work can never SHRINK the wait estimate — the door
    must get strictly harder to pass as the backlog grows."""
    slo = SLOAdmission(10.0, _window(service_ms), slots=slots)
    lo, hi = slo.wait_estimate_ms(b0), slo.wait_estimate_ms(b0 + db)
    assert hi >= lo
    if db > 0:
        assert hi > lo                       # strictly, with real service time


@given(service_ms=st.floats(0.1, 50.0), backlog=st.integers(0, 500),
       slo_ms=st.floats(0.5, 100.0))
@settings(max_examples=60, deadline=None)
def test_on_offer_consistent_with_estimates(service_ms, backlog, slo_ms):
    """The door verdict is exactly the estimate inequality — no hidden
    state, so an admitted request really was projected to fit."""
    slo = SLOAdmission(slo_ms, _window(service_ms), slots=4)
    projected = slo.wait_estimate_ms(backlog) + slo.service_estimate_ms()
    verdict = slo.on_offer(backlog)
    assert verdict == ("shed" if projected > slo_ms else "admit")
    assert slo.offered == 1
    assert slo.shed == (1 if verdict == "shed" else 0)


@given(service_ms=st.floats(0.1, 50.0), slo_ms=st.floats(0.5, 100.0),
       over_ms=st.floats(0.0, 1000.0), has_capacity=st.booleans())
@settings(max_examples=60, deadline=None)
def test_on_dispatch_never_admits_aged_out(service_ms, slo_ms, over_ms,
                                           has_capacity):
    """A request whose queue age has already crossed the target (age +
    projected service > SLO) is NEVER admitted — completing it late
    would blow the very p99 the scheduler protects.  Aged-out beats
    capacity: even a free slot doesn't resurrect it."""
    slo = SLOAdmission(slo_ms, _window(service_ms), slots=4)
    aged_out = slo_ms - slo.service_estimate_ms() + 1e-6 + over_ms
    assert slo.on_dispatch(aged_out, has_capacity) == "shed"
    assert slo.admitted == 0


@given(age_frac=st.floats(0.0, 0.99), has_capacity=st.booleans())
@settings(max_examples=40, deadline=None)
def test_on_dispatch_inside_deadline_never_sheds(age_frac, has_capacity):
    """Inside the deadline the verdict is capacity-only: admit with a
    slot, defer without — shedding a still-viable request would be
    throwing away latency budget."""
    slo = SLOAdmission(20.0, _window(2.0), slots=4)
    age = age_frac * (20.0 - slo.service_estimate_ms())
    verdict = slo.on_dispatch(age, has_capacity)
    assert verdict == ("admit" if has_capacity else "defer")


@given(backlog=st.integers(0, 10_000), age_ms=st.floats(0.0, 10_000.0))
@settings(max_examples=40, deadline=None)
def test_disabled_slo_is_defer_only(backlog, age_ms):
    """slo_p99_ms ≤ 0: unconditional admission (the pre-SLO fabric) —
    nothing is ever shed, no matter the backlog or age."""
    slo = SLOAdmission(0.0, _window(25.0), slots=1)
    assert slo.on_offer(backlog) == "admit"
    assert slo.on_dispatch(age_ms, True) == "admit"
    assert slo.on_dispatch(age_ms, False) == "defer"
    assert slo.shed == 0


def test_cold_window_admits_everything():
    """No history → no estimate → admit (a cold fabric must learn its
    regime, not shed on superstition)."""
    slo = SLOAdmission(1.0, LatencyWindow(16), slots=1)
    assert slo.service_estimate_ms() == 0.0
    assert slo.on_offer(10_000) == "admit"


# ---------------------------------------------------------------------------
# LatencyWindow memoization
# ---------------------------------------------------------------------------

@given(n=st.integers(1, 40), maxlen=st.integers(1, 16))
@settings(max_examples=40, deadline=None)
def test_stats_memoized_until_record_or_reset(n, maxlen):
    """``stats()`` is cached between mutations (the scheduler consults
    it per offered request), and BOTH mutation paths invalidate it."""
    win = LatencyWindow(maxlen)
    for i in range(n):
        win.record(_req(i * 0.01, i * 0.01 + 0.001, i * 0.01 + 0.004))
    st1 = win.stats()
    assert st1 is win.stats()                # cached: identical object
    assert st1.window == min(n, maxlen)      # rolled to maxlen
    win.record(_req(1.0, 1.001, 1.004))
    st2 = win.stats()
    assert st2 is not st1                    # record() invalidated
    win.reset()
    assert len(win) == 0
    assert win.stats() == LatencyStats()     # reset() invalidated too


@given(vals=st.lists(st.floats(1e-4, 0.5), min_size=1, max_size=24))
@settings(max_examples=40, deadline=None)
def test_window_stats_match_fresh_computation(vals):
    """The memo is an optimization, never a semantic: cached stats equal
    a fresh computation over the same samples."""
    win = LatencyWindow(64)
    for i, total in enumerate(vals):
        win.record(_req(i * 1.0, i * 1.0 + total / 2, i * 1.0 + total))
    cached = win.stats()
    fresh = LatencyWindow(64)
    for i, total in enumerate(vals):
        fresh.record(_req(i * 1.0, i * 1.0 + total / 2, i * 1.0 + total))
    assert cached == fresh.stats()
    assert cached.p50_ms == pytest.approx(
        float(np.percentile([v * 1e3 for v in vals], 50)))
