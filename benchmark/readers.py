"""What the per-layer readers (``metrics/<name>.py``) share: the work a
run did from its counted units and the op counts, and the kernels' least
time at the card's peaks. A reader returns a number, or None when the run
has nothing for it to read."""

from __future__ import annotations

from typing import Optional

from .kernels import Work, least_s


def total_work(run) -> Work:
    w = Work()
    for unit, n in run.units.items():
        for _ in range(n):
            w += run.work[unit]
    return w


def span_share(run, *names: str) -> Optional[float]:
    """% of the spans' window spent in the spans named ``names``."""
    if not run.span_window_s or not any(n in run.spans for n in names):
        return None
    return 100.0 * sum(run.spans.get(n, 0.0) for n in names) / run.span_window_s


def roofline(run, *kernels: str) -> Optional[float]:
    """% of the device time of the kernels named ``kernels`` that their
    launches' least time takes (recomputation under remat is in the
    device time and not in the least time)."""
    if run.trace is None:
        return None
    device_s = sum(run.trace.time_of(k) for k in kernels)
    least = 0.0
    for unit, n in run.units.items():
        least += n * sum(least_s(l, run.peaks) for l in run.work[unit].launches
                         if l.kernel in kernels)
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s


def step_mfu(run) -> Optional[float]:
    """% of the card's peak the window's products would take: their least
    time at the published rates over the window's time."""
    w = total_work(run)
    if w.flops + w.int8_ops <= 0 or run.window_s <= 0:
        return None
    least = w.flops / run.peaks["bf16_flops"] + w.int8_ops / run.peaks["int8_ops"]
    return 100.0 * least / run.window_s


def kind_share(run, kind: str) -> Optional[float]:
    if run.trace is None or not run.trace.kinds:
        return None
    return 100.0 * run.trace.kinds.get(kind, 0.0) / sum(run.trace.kinds.values())


def idle_share(run) -> Optional[float]:
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - run.trace.busy_s / run.window_s)
