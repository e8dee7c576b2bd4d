"""Spans and the device trace of a ``--trace 1`` run.

``Spans`` records CUDA events on the stream at the benchmark's own marks
around the calls into the program's layers (and at the program's
``on_phase`` marks); a span lasts from its mark to the next one.

``summarize`` reduces a ``torch.profiler`` run to what the per-layer
readers and the result's ``breakdown`` need. Its busy time (the union of
kernel intervals) and ``kernel_kind`` are frozen copies of
``scripts/torch_profile_request.py::device_breakdown`` and
``::kernel_kind``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch


class Spans:
    """Marks on the device's stream: ``mark(name)`` starts a span named
    ``name`` and ends the one before; ``close()`` ends the last. Off
    (``enabled=False``) it records nothing."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.marks: List[Tuple[str, torch.cuda.Event]] = []

    def mark(self, name: str) -> None:
        if self.enabled:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    def close(self) -> None:
        self.mark("_end")

    def totals(self) -> Tuple[Dict[str, float], Optional[float]]:
        """({name: seconds summed over its spans}, seconds from the first
        mark to the last), or ({}, None) when nothing was recorded."""
        if len(self.marks) < 2:
            return {}, None
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / 1e3
        return out, self.marks[0][1].elapsed_time(self.marks[-1][1]) / 1e3


def kernel_kind(name: str) -> str:
    """Coarse class of a device kernel by its name: the port's own
    attention kernels, library GEMMs (cuBLAS/cuBLASLt, 16-bit and int8),
    convolutions, and everything else (elementwise, reductions, copies)."""
    if "bsa_fwd" in name or "block_sum" in name:
        return "bsa"
    if "flash_" in name:
        return "flash"
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "imma", "_mma_")):
        return "gemm"
    if "conv" in low or "implicit" in low:
        return "conv"
    return "elementwise"


@dataclass
class TraceSummary:
    busy_s: float
    kernel_s: Dict[str, float]                 # kernel name -> seconds
    kinds: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def time_of(self, part: str) -> float:
        """Seconds of the kernels whose name holds ``part``."""
        return sum(t for n, t in self.kernel_s.items() if part in n)

    def device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]


def _raw_events(prof):
    """(name, is_device, start_us, end_us) of every event of the run, read
    from the profiler's kineto results (no per-event Python objects)."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        yield e.name(), e.device_type() == cuda, e.start_ns() / 1e3, e.end_ns() / 1e3


def summarize(prof) -> Optional[TraceSummary]:
    """The trace's kernels: their busy union, time by name and by kind,
    and the ten longest gaps between kernels, each named by the innermost
    host operation running when it began. None when no kernel ran."""
    kernels, host = [], []
    for name, dev, s, e in _raw_events(prof):
        if dev:
            if "Command Buffer" not in name:
                kernels.append((s, e, name))
        else:
            host.append((s, e, name))
    if not kernels:
        return None
    kernels.sort()
    union = []
    cur_s, cur_e = kernels[0][0], kernels[0][1]
    for s, e, _ in kernels[1:]:  # union of kernel intervals
        if s > cur_e:
            union.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    union.append((cur_s, cur_e))
    busy_us = sum(e - s for s, e in union)
    by_name: Dict[str, float] = {}
    for s, e, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    kinds: Dict[str, float] = {}
    for name, t in by_name.items():
        k = kernel_kind(name)
        kinds[k] = kinds.get(k, 0.0) + t
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(union, union[1:])), reverse=True)[:10]
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for length, at in gaps:
        i = bisect.bisect_right(starts, at)
        name = "host: nothing recorded"
        for s, e, n in reversed(host[max(0, i - 2000):i]):  # innermost op running at ``at``
            if e >= at:
                name = n
                break
        idle.append((name, length / 1e6))
    return TraceSummary(busy_us / 1e6, by_name, kinds, idle)
