"""Program spans on the profiler's clock.

``span(name)`` marks a stretch of the program's work: the TTA step and
its parts, the sampler step, each DiT block and the shared ops
(``ops/layers.py``, ``ops/attention.py``, ``ops/bsa.py``,
``ops/quant.py``). It is off unless a ``torch.profiler`` run is
recording; off, it returns one shared null context and records nothing.
On, each span

  - opens a profiler range of its name, so it sits in the kineto trace
    on the same clock as the kernels it launches;
  - records a CUDA event on the current stream as it opens and as it
    closes (when CUDA is in use);
  - reads the host clock as it opens and as it closes.

A recording begins at the first span entered while the profiler records
(that span clears the last recording and snapshots the counters) and
ends at ``totals()``, which returns per name the count, the host and
device seconds, and the self seconds (duration minus what the span's
child spans cover), and the counters' change from the recording's first
span to the close of its last outermost one.

A span's parent is the innermost span open on its thread. A span opened
on a thread that holds none, such as the autograd engine's device thread
re-running a checkpointed block in the backward, takes the innermost span
open on the recording's own thread. Closed spans are folded into the
totals, and their records and events reused, once their end events have
completed (``_Recorder.resolve``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
try:
    _Range = torch._C._profiler._RecordFunctionFast
except AttributeError:  # an older torch
    _Range = torch.profiler.record_function
_NULL = contextlib.nullcontext()
_RESOLVE_EVERY = 256  # closed spans pending before folding starts
_BATCH = 32           # closed spans between two looks at the pending ones
_MEMORY = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def span(name: str):
    """A context manager that records ``name`` while a profiler records,
    and does nothing otherwise."""
    if not _profiling():
        return _NULL
    try:
        s = _rec.free.pop()
    except IndexError:
        s = _Span()
    s.name = name
    return s


def _counters(cuda: bool) -> Dict[str, int]:
    """The port's kernel launch counters (B1-B5 and the q/k prologue) and,
    with CUDA, the caching allocator's device allocations, frees and
    retries."""
    from ..ops import bsa, qk_norm
    from ..ops import flash_attention as fa

    out = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.bwd_dq_launches,
           "flash_bwd_dkv": fa.bwd_dkv_launches, "bsa_block_sum": bsa.bsa_block_sum_launches,
           "bsa_fwd": bsa.bsa_launches, "bsa_fwd_qk_int8": bsa.bsa_int8_launches,
           "qk_norm_rope": qk_norm.launches, "qk_norm_rope_bwd": qk_norm.bwd_launches}
    if cuda:
        stats = torch.cuda.memory_stats_as_nested_dict()
        out.update({k: int(stats.get(k, 0)) for k in _MEMORY})
    return out


class _Recorder:
    """The spans of the current (or last) recording."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.open = False                      # a recording is under way
        self.cuda = False
        self.owner_stack: list = []            # the recording thread's open spans
        self.pending: collections.deque = collections.deque()  # closed, unresolved
        self.pool: list = []                   # events free for reuse
        # resolved spans for reuse: a span lives until its end event
        # completes, and fresh ones would outlive young garbage collections
        # and be promoted, making full collections (host pauses) more frequent
        self.free: list = []
        self.stream_key = None                 # the current stream, as last looked up
        self.stream = None
        self.by_name: Dict[str, list] = {}     # name -> [n, host, host self, device, self]
        self.start: Dict[str, int] = {}
        self.end: Dict[str, int] = {}

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def begin(self, stack: list) -> None:
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.pending.clear()
        self.by_name = {}
        self.owner_stack = stack
        self.start = self.end = _counters(self.cuda)
        self.open = True

    def event(self):
        """A timing event recorded on the current stream."""
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        if key != self.stream_key:
            self.stream_key = key
            self.stream = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                            device_type=key[2])
        try:
            ev = self.pool.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def close(self, s: "_Span") -> None:
        with self.lock:
            if not self.open:  # opened before ``totals()`` ended its recording
                return
            self.pending.append(s)
            if s.parent is None:
                self.end = _counters(self.cuda)
            n = len(self.pending)
            if n >= _RESOLVE_EVERY and n % _BATCH == 0:
                self.resolve(wait=False)

    def resolve(self, wait: bool) -> None:
        """Fold closed spans into the totals, oldest first, stopping at the
        first whose end event has not completed (all of them after a
        synchronize: ``wait``). A span closes after its children, so they
        are folded first. Folding as early as possible keeps few spans
        alive: a backlog would outlive young garbage collections, be
        promoted, and lengthen the full ones (host pauses)."""
        pending = self.pending
        n = len(pending)
        if not wait:
            for i, s in enumerate(pending):
                if s.e1 is not None and not s.e1.query():
                    n = i
                    break
        for _ in range(n):
            s = pending.popleft()
            dev = 0.0
            if s.e1 is not None:
                dev = s.e0.elapsed_time(s.e1) / 1e3
                self.pool += (s.e0, s.e1)
            host = s.t1 - s.t0
            tot = self.by_name.setdefault(s.name, [0, 0.0, 0.0, 0.0, 0.0])
            tot[0] += 1
            tot[1] += host
            tot[2] += host - s.child_host
            tot[3] += dev
            tot[4] += dev - s.child_dev
            if s.parent is not None:
                s.parent.child_dev += dev
            s.parent = s.e0 = s.e1 = s.rng = None
            self.free.append(s)


_rec = _Recorder()


class _Span:
    __slots__ = ("name", "parent", "rng", "e0", "e1", "t0", "t1", "child_host", "child_dev")

    def __enter__(self):
        rec = _rec
        stack = rec.stack()
        if not rec.open:
            rec.begin(stack)
        if stack:
            self.parent = stack[-1]
        else:
            owner = rec.owner_stack
            self.parent = owner[-1] if owner and owner is not stack else None
        self.child_host = self.child_dev = 0.0
        self.rng = _Range(self.name)
        self.rng.__enter__()
        self.e0 = rec.event() if rec.cuda else None
        self.e1 = None
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        rec = _rec
        if self.e0 is not None:
            self.e1 = rec.event()
        rec.stack().pop()
        self.rng.__exit__(*exc)
        if self.parent is not None:
            self.parent.child_host += self.t1 - self.t0
        rec.close(self)
        return False


def totals() -> Optional[Dict]:
    """The last recording, or None when there was none: ``{"spans":
    {name: {"n", "host_s", "host_self_s", "device_s", "self_s"}},
    "counters": {name: change}}``. Device seconds are 0 without CUDA.
    Synchronizes once and ends the recording; the next span entered
    while a profiler records begins a new one."""
    rec = _rec
    with rec.lock:
        if rec.open:
            if rec.cuda:
                torch.cuda.synchronize()
            rec.resolve(wait=True)
            rec.open = False
        if not rec.start:
            return None
        spans = {name: dict(zip(("n", "host_s", "host_self_s", "device_s", "self_s"), t))
                 for name, t in rec.by_name.items()}
        return {"spans": spans,
                "counters": {k: rec.end[k] - rec.start[k] for k in rec.start}}
