"""The harness: finds a cell's configuration, traffic mix, limits, op
counts and per-layer readers by name, runs the cell's driver on the
program, checks the timed path against the plain reference, and prints
the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs`` -> its file, whose ``backbone`` picks
``backbones/<b>.py``, ``reference/<b>.py`` and ``opcount/<b>.py``) and a
traffic mix (``traffic/<mix>.json``, whose ``driver`` picks
``drivers/<d>.py``); its limits are ``cells/<cell>.json``; each per-layer
metric is read by ``metrics/<metric>.py``. Adding a cell, a mix, a
configuration of a known backbone or a metric adds files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BUILD_DIR = os.path.join(BENCH_DIR, ".build", "kernels")
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "longcat_video_tta_tpu")
GIB = 2.0 ** 30


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def backbone(self) -> str:
        return self.config["backbone"]


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files
    (traffic and limits under ``<root>/benchmark/``)."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(wl)})")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = os.path.join(root, "benchmark")
    return Cell(
        name=name, chips=int(w["chips"]), config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(bench, "cells", name + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def load_cells(root: str = ROOT) -> List[Cell]:
    """Every cell of ``<root>/BENCHMARK.json``, each with its files."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    return [load_cell(w["name"], root) for w in spec["workloads"]]


def module_for(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py``: a backbone, reference, op count or
    driver."""
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def reader(metric: str) -> ModuleType:
    """``benchmark/metrics/<metric>.py`` (metric names hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics._{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_info(device) -> Dict:
    """The card's name (``torch.cuda.get_device_name``) and power limit."""
    name = torch.cuda.get_device_name(device)
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={torch.device(device).index or 0}"],
                             capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"name": name, "power_limit": limit}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Run:
    """What the readers of a run see."""

    cell: Cell
    geo: Dict
    peaks: Dict
    units: Dict[str, int]
    work: Dict[str, object]          # unit -> kernels.Work
    window_s: float
    spans: Dict[str, float] = field(default_factory=dict)
    span_window_s: Optional[float] = None
    trace: Optional[object] = None   # trace.TraceSummary


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             peaks: Optional[Dict] = None, log=None) -> Dict:
    """Set up, measure for ``seconds``, check, and return the result line's
    object (its ``checks`` last). ``peaks``: the card's published rates
    (``kernels.card_peaks``); ``log``: stderr lines."""
    from .trace import Spans, summarize

    say = log or (lambda line: print(line, file=sys.stderr, flush=True))
    device = torch.device(device)
    cuda = device.type == "cuda"
    backbone = module_for("backbones", cell.backbone)
    driver_mod = module_for("drivers", cell.traffic["driver"])

    from longcat_video_tta_tpu_torch.ops.flash_attention import kernel_build_dir

    with kernel_build_dir(BUILD_DIR):
        t_start = time.perf_counter()
        model = backbone.build(cell.config, seed, device)
        _sync(device)
        t_weights = time.perf_counter()
        drv = driver_mod.Driver(cell, model, seed, device)
        drv.setup()
        _sync(device)
        setup_s = time.perf_counter() - t0
        say(f"[setup] start and imports {t_start - t0:.3f} s, weights {t_weights - t_start:.3f} s, "
            f"kernels and warm-up {t0 + setup_s - t_weights:.3f} s")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        spans = Spans(trace, device)
        prof = None
        if trace and cuda:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        spans.mark("window")
        w0 = time.perf_counter()
        drv.window(w0 + seconds, spans)
        _sync(device)
        window_s = time.perf_counter() - w0
        spans.close()
        if prof is not None:
            prof.__exit__(None, None, None)
        peak_bytes = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        t_trace = time.perf_counter()
        summary = summarize(prof) if prof is not None else None
        if prof is not None:
            say(f"[trace] read in {time.perf_counter() - t_trace:.1f} s; kernel seconds by kind "
                f"{summary.kinds if summary else {}}")
        span_totals, span_window = spans.totals()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = drv.check()
        check_s = time.perf_counter() - t_check

    e2e = drv.end_to_end(window_s)
    e2e["setup_s"] = setup_s
    e2e["peak_mem_gib"] = peak_bytes / GIB
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise KeyError(f"the {cell.traffic['driver']} driver reports no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        geo = drv.geometry()
        opcount = module_for("opcount", cell.backbone)
        run = Run(cell, geo, peaks or {}, dict(drv.units),
                  {u: getattr(opcount, u)(cell.config, geo) for u in drv.units},
                  window_s, span_totals, span_window, summary)
        for m in cell.per_layer:
            v = reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = (drv.attempted > 0 and drv.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": cell.chips, "memory_peak_bytes": peak_bytes}
    out = {"correct": bool(correct), "attempted": int(drv.attempted), "failed": int(drv.failed),
           "metrics": metrics, "device": info}
    if trace:
        info["busy_s"] = summary.busy_s if summary is not None else 0.0
        info["window_s"] = window_s
        if summary is not None:
            out["breakdown"] = {"device_ops": [[n[:160], t] for n, t in summary.device_ops()],
                                "idle_gaps": [[n[:160], t] for n, t in summary.idle_gaps]}
    say(f"[bench] {cell.name} seed {seed}: setup {setup_s:.3f} s, window {window_s:.3f} s, "
        f"units {dict(drv.units)}, check {check_s:.1f} s, peak {peak_bytes / GIB:.3f} GiB")
    out["checks"] = checks
    return out


def main(args, t0: float) -> int:
    """The command line's run: refuse without the cards the cell asks for,
    run it, print the compared numbers last on stderr and the result line
    last on stdout."""
    from .kernels import card_peaks

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] {cell.name} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_info(device)
    peaks = card_peaks(card["name"])
    out = run_cell(cell, args.seed, float(args.seconds), bool(args.trace), device, t0, peaks)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"[bench] card {card['name']}, power.limit {card['power_limit']}", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
