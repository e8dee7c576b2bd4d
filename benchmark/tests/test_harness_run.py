"""The harness end to end on the CPU at tiny size: the result line's
shape, the cells found from files alone, the refusal without a card, and
the import rule (no module whose top-level name is jax, jaxlib, flax or
the JAX package's, compared whole; the reference imports nothing of the
program)."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import core

from .tiny import COGVIDEOX, LONGCAT, PEAKS, cell

ROOT = core.ROOT
CELLS = {"longcat_video_13b.gen_dense50": LONGCAT, "cogvideox_5b_i2v.tta_delta_a": COGVIDEOX,
         "longcat_video_13b.tta_delta_a": LONGCAT}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_result_line_shape(name):
    out = core.run_cell(cell(name, CELLS[name]), 2 ** 31 + 7, 0.5, False, "cpu",
                        time.perf_counter(), PEAKS)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in core.load_cell(name).end_to_end}
    assert set(line["metrics"]) == e2e and "setup_s" in e2e
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_every_cell_of_benchmark_json_has_its_files():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cells = core.load_cells()
    assert [c.name for c in cells] == [w["name"] for w in spec["workloads"]]
    for c in cells:
        for m in c.per_layer:
            assert callable(core.reader(m["name"]).read)
        assert core.module_for("drivers", c.traffic["driver"]).Driver
        opcount = core.module_for("opcount", c.backbone)
        assert c.limits["limits"] and c.limits["check"]
        unit = "train_step" if c.traffic["driver"] == "tta" else "denoise_step"
        assert getattr(opcount, unit)


def test_a_cell_added_from_files_alone_is_listed(tmp_path):
    """A new cell is an entry and files: a configuration file, a traffic
    file and a limits file, nothing else."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = dict(LONGCAT, name="longcat_dummy")
    (tmp_path / "benchmark" / "configs" / "longcat_dummy.json").write_text(json.dumps(cfg))
    t = json.load(open(os.path.join(ROOT, "benchmark", "traffic", "gen_dense50.json")))
    t.update(height=64, width=96, cond_latents=2, gen_latents=2, steps=4, text_valid_tokens=[4, 12])
    (tmp_path / "benchmark" / "traffic" / "gen_tiny4.json").write_text(json.dumps(t))
    limits = {"check": {"steps": 2}, "limits": {"step_gap": 1e-3}}
    (tmp_path / "benchmark" / "cells" / "longcat_dummy.gen_tiny4.json").write_text(
        json.dumps(limits))
    spec["configs"].append({"name": "longcat_dummy", "source": "test", "reduced": [],
                            "file": "benchmark/configs/longcat_dummy.json", "why": "test"})
    spec["workloads"].append({"name": "longcat_dummy.gen_tiny4", "config": "longcat_dummy",
                              "traffic": "gen_tiny4", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:  # the cell reports what cell 1 reports
        if "longcat_video_13b.gen_dense50" in m.get("workloads", ()):
            m["workloads"].append("longcat_dummy.gen_tiny4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    names = [c.name for c in core.load_cells(str(tmp_path))]
    assert names[-1] == "longcat_dummy.gen_tiny4"
    c = core.load_cell("longcat_dummy.gen_tiny4", str(tmp_path))
    out = core.run_cell(c, 5, 0.3, False, "cpu", time.perf_counter(), PEAKS)
    assert out["correct"] and set(out["metrics"]) == {"denoise_step_s", "peak_mem_gib", "setup_s"}


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_the_cards_the_cell_asks_for():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(["-m", "benchmark.run", "--workload", "longcat_video_13b.gen_dense50", "--seed",
              "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(["-m", "benchmark.run", "--workload", "longcat_video_13b.gen_dense50", "--seed",
              "1", "--seconds", "1", "--trace", "0"], str(tmp_path), env)
    assert p.returncode != 0 and p.stdout.strip() == ""


IMPORT_CHECK = r"""
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import core
from benchmark.tests.tiny import LONGCAT, COGVIDEOX, PEAKS, cell
import benchmark.run, benchmark.tools.readings
for name, cfg in [("longcat_video_13b.gen_dense50", LONGCAT),
                  ("cogvideox_5b_i2v.tta_delta_a", COGVIDEOX)]:
    core.run_cell(cell(name, cfg), 3, 0.2, False, "cpu", time.perf_counter(), PEAKS)
for c in core.load_cells():
    for m in c.per_layer:
        core.reader(m["name"])
print(json.dumps(core.forbidden_modules()))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    p = _run(["-c", IMPORT_CHECK.format(root=ROOT)], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    assert "longcat_video_tta_tpu_torch" not in core.FORBIDDEN  # whole names, no prefix


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, {root!r}); "
            "import benchmark.reference.longcat, benchmark.reference.cogvideox; "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('longcat_video_tta_tpu_torch', 'longcat_video_tta_tpu', 'jax', 'flax', 'jaxlib'))))")
    p = _run(["-c", code.format(root=ROOT)], ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "longcat_video_tta_tpu_torch_x", sys)
    assert core.forbidden_modules() == [] or all(
        m.split(".")[0] in core.FORBIDDEN for m in core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in core.forbidden_modules()
