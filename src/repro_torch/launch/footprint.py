"""One device's memory over a step, counted as PyTorch's CUDA caching
allocator counts it, without a device.

``LiveBytes`` is a ``TorchDispatchMode`` that follows every storage the
ops beneath it create: each new storage is counted once (a view shares
its storage), at ``allocator_block`` of its bytes, and taken off when it
dies (a weakref finalizer on its ``untyped_storage()``, which fires on
``meta`` tensors as on real ones).  It lets DTensor run first (it returns
``NotImplemented`` to a DTensor, as ``distributed/collectives
.CollectiveTraffic`` does), so over a sharded step it sees one rank's
local tensors; the fake tensors on which DTensor propagates an op's
layout are not counted.  A mode of its own changes one thing: autograd's
engine, which sums a second gradient into the one it holds in place
where either is the last reference to its storage, never does so under a
dispatch mode; the tracker counts such a sum as the card runs it
(``_accumulated_into``; a DTensor's sum is out of place on the card
too).  ``hold(*trees)`` counts tensors made before it (a step's
arguments) and ``mark_entry()`` takes the bytes live then as the step's
``entry_bytes``, the high-water mark from there on ``peak_bytes``.  So a
step traced on ``meta`` gives the number that ``torch.cuda
.max_memory_allocated`` reads over the same step on the card, the
arguments included (``step_peak`` reads the card's side).  What it
cannot see: a library's own workspace (a cuBLAS workspace is allocated
once a handle and stream and kept), a block the allocator reuses
without splitting (it counts up to 1 MiB more, ``allocator_slack``),
and anything a kernel allocates that its wrapper does not show (the
wrappers of this package allocate only through PyTorch).
"""
from __future__ import annotations

import functools
import weakref

import torch

MiB = 2**20
# DTensor derives each op's output layout by running the op on fake
# tensors of the global shape, under a FakeTensorMode: those are no
# allocation, and are not counted
_FAKE = torch._C._TorchDispatchModeKey.FAKE
_ADD = torch.ops.aten.add.Tensor


def allocator_block(nbytes: int) -> int:
    """The bytes PyTorch's caching allocator counts for a new ``nbytes``
    tensor in a fresh segment: the request rounded to 512 B; a request
    over 1 MiB takes a segment of 20 MiB (under 10 MiB) or rounded to 2 MiB,
    and keeps the segment's remainder when it is 1 MiB or less (the
    allocator splits off only a larger one)."""
    size = -(-nbytes // 512) * 512
    if size <= MiB:
        return size
    seg = 20 * MiB if size < 10 * MiB else -(-size // (2 * MiB)) * 2 * MiB
    return seg if seg - size <= MiB else size


def allocator_slack(nbytes: int) -> int:
    """The most the caching allocator can count beyond a tensor's bytes, in
    any segment: the 512-B rounding, and up to 1 MiB of unsplit remainder
    for a block over 1 MiB."""
    size = -(-nbytes // 512) * 512
    return size - nbytes + (MiB if size > MiB else 0)


def peak_tolerance(measured: int) -> float:
    """How far a traced peak may lie from the card's reading of the same
    window: 3% of the reading or 64 MiB, the larger (what the trace cannot
    see: a library's workspace, a reused block left unsplit)."""
    return max(0.03 * measured, 64 * MiB)


def _holders(t) -> tuple:
    """(holders of ``t``, holders of its storage) as a dispatch mode sees
    them."""
    return (t._use_count(),
            torch._C._storage_Use_Count(t.untyped_storage()._cdata))


@functools.lru_cache(maxsize=None)
def _sole_holders() -> tuple:
    """``_holders`` of a gradient that only autograd's buffer holds, read
    within this PyTorch's own dispatch (the counts include the references
    the dispatch itself makes): ``w * 2`` used twice, its two gradients
    summed by the engine."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class _Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is _ADD and torch._C._current_autograd_node() is not None:
                seen.append(_holders(args[0]))
            return func(*args, **(kwargs or {}))
    w = torch.ones(4, device="meta", requires_grad=True)
    with torch.enable_grad(), _Probe():
        a = w * 2
        torch.autograd.grad((a * 3).sum() + (a * 4).sum(), w)
    return seen[0]


def _sole(t) -> bool:
    """Whether autograd's engine could add into ``t`` in place: a plain
    contiguous tensor with no holder but the engine's buffer (the engine
    also takes a permuted dense one; none reaches it in the port's
    steps' sums)."""
    if type(t) is not torch.Tensor or not t.is_contiguous():
        return False
    return all(n <= m for n, m in zip(_holders(t), _sole_holders()))


def _accumulated_into(func, args, kwargs, out):
    """The tensor autograd's engine would sum two gradients into, where
    ``func`` is that sum, else None.  Without a dispatch mode, the engine
    adds a gradient to the one its buffer holds in place when either is
    the last reference to its storage; under a mode (this one) it never
    does, and allocates the sum.  So within a backward, a same-shaped
    ``add`` of two such gradients counts as the engine's in-place one."""
    if (func is not _ADD or kwargs or len(args) != 2
            or torch.is_grad_enabled()
            or torch._C._current_autograd_node() is None):
        return None
    a, b = args
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.shape == b.shape == out.shape and a.dtype == b.dtype):
        return None
    for t in (a, b):
        if _sole(t):
            return t
    return None


def _local(t):
    """A DTensor's local tensor; any other tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield _local(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def held_bytes(*trees) -> int:
    """The allocator blocks of the distinct storages of ``trees``' tensors
    (DTensors by their local tensors): what a step's arguments add to
    ``torch.cuda.memory_allocated`` when each was allocated alone."""
    seen = {}
    for tree in trees:
        for t in _tensors(tree):
            st = t.untyped_storage()
            seen[st.data_ptr() if st.device.type != "meta" else id(st)] = \
                st.nbytes()
    return sum(allocator_block(n) for n in seen.values())


def window_start(device=None) -> int:
    """Opens a step's window on the card: garbage collected first (tensors
    an earlier step left in a reference cycle, freed inside the window,
    would hide their bytes from its rise), then the peak reset; returns
    what is allocated at its start, ``step_peak``'s ``base``."""
    import gc
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def step_peak(base: int, *args, device=None) -> int:
    """A step's peak on the card as ``LiveBytes`` counts it: the most
    allocated over the window (``max_memory_allocated`` since the reset
    before the step) less what was allocated at its start (``base``), plus
    the arguments' blocks (``held_bytes``); what else the process held
    through the window (earlier results, a library's workspace) drops
    out.  ``base`` is ``window_start``'s."""
    return (torch.cuda.max_memory_allocated(device) - base
            + held_bytes(*args))


class LiveBytes:
    """Counts, while entered, the allocator bytes of the live storages the
    ops beneath it make (see the module docstring): ``live`` now,
    ``entry`` at ``mark_entry``, ``peak`` the most since then."""

    def __init__(self):
        self.live = 0
        self.entry = 0
        self.peak = 0
        self._seen = set()
        self._mode = None

    def _add(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        n = allocator_block(st.nbytes())
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n, *keep):
        self._seen.discard(key)
        self.live -= n

    def _alias(self, out, src):
        """``out`` reuses ``src``'s storage: it counts nothing, and keeps
        ``src``'s block live as long as it lives."""
        st = out.untyped_storage()
        self._seen.add(id(st))
        weakref.finalize(st, self._free, id(st), 0, src)

    def hold(self, *trees):
        """Counts the tensors of ``trees`` (dicts, lists, tuples; DTensors
        by their local tensors) made before the tracker."""
        for tree in trees:
            for t in _tensors(tree):
                self._add(t)

    def mark_entry(self):
        """The step starts: what is live now is its ``entry_bytes``."""
        self.entry = self.peak = self.live

    def summary(self) -> dict:
        return {"entry_bytes": self.entry, "peak_bytes": self.peak}

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        tracker = self
        _sole_holders()                 # read before this mode is pushed

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t.__name__ == "DTensor" for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if torch._C._get_dispatch_mode(_FAKE) is not None:
                    return out
                into = _accumulated_into(func, args, kwargs, out)
                if into is None:
                    tracker.hold(out)
                else:
                    tracker._alias(out, into)
                return out
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False
