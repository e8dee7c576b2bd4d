"""What the readers of the program's own spans share: the device seconds
that ``longcat_video_tta_tpu_torch/utils/spans.py`` recorded while the
benchmark's profiler ran, over the benchmark's span window
(``run.span_window_s``). A program without that module, or a run whose
spans hold no device seconds, gives None."""

from __future__ import annotations

from typing import Dict, Optional


def totals() -> Optional[Dict]:
    """The program's last recording of spans, or None."""
    try:
        from longcat_video_tta_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.totals()


def device_share(run, *names: str, self_time: bool = False) -> Optional[float]:
    """% of the span window in the device seconds of the program spans
    named ``names`` (their self seconds with ``self_time``)."""
    t = totals()
    if t is None or not run.span_window_s:
        return None
    spans = t["spans"]
    if not any(s["device_s"] > 0 for s in spans.values()):
        return None
    key = "self_s" if self_time else "device_s"
    return 100.0 * sum(spans[n][key] for n in names if n in spans) / run.span_window_s
